"""The static probe's plain version (bito_tpu_torch/perflab/
perf_static_probe.py) against scripts/perf_static_probe.py's Pallas kernel,
run in interpret mode on the CPU: both variants (offsets from the tape and
offsets fixed at compile time) at R = 1 and R = 2, on the script's own
inputs.  Bound: within 1e-5 of max |out| (float32 contractions summed in
another order)."""
import numpy as np
import pytest
import torch

from bito_tpu_torch.perflab import perf_static_probe as probe

from pallas_scripts import interpret_pallas, load_script


@pytest.fixture(scope="module")
def script():
    module = load_script("perf_static_probe")
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(module, mp)
        yield module


def test_shapes_as_the_script():
    module = load_script("perf_static_probe")
    assert (probe.CA, probe.S, probe.M, probe.NS) == (
        module.CA, module.S, module.M, module.NS)
    assert probe.FMAS_PER_OP == 3072


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
@pytest.mark.parametrize("R", [1, 2])
def test_plain_matches_pallas_interpret(script, dynamic, R):
    fn, L = script.build(dynamic, R)
    want = np.asarray(fn(L))
    tape, L_t = probe.probe_inputs("cpu")
    np.testing.assert_array_equal(L_t.numpy(), np.asarray(L))
    got = probe.static_chain_ref(tape, L_t, dynamic=dynamic, R=R)
    assert got.shape == (8, probe.S) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    torch.testing.assert_close(
        probe.static_chain(tape, L_t, dynamic=dynamic, R=R), got,
        rtol=0, atol=0)


def test_dynamic_and_static_agree_and_count_no_cpu_launch():
    tape, L = probe.probe_inputs("cpu")
    before = probe.static_chain.launches
    torch.testing.assert_close(probe.static_chain(tape, L, dynamic=True, R=3),
                               probe.static_chain(tape, L, dynamic=False, R=3),
                               rtol=0, atol=0)
    assert probe.static_chain.launches == before


def test_fma_floor_of_the_launch_geometry():
    """256 blocks of 4 columns: on 132 SMs the busiest SM holds 2 blocks,
    8 columns x 3,072 FMAs over 128 lanes = 192 cycles an op."""
    assert probe.fma_floor_us(132, 1980.0) == pytest.approx(192 / 1980.0)
    assert probe.fma_floor_us(256, 1000.0) == pytest.approx(96 / 1000.0)
