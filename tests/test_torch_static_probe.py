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


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_fma_floor_of_the_launch_geometry(warps):
    """512 blocks of 2 columns, W warps each: on 132 SMs the busiest SM
    holds 4 blocks, 8 columns x 3,072 FMAs over 128 lanes = 192 cycles an
    op whatever W, and 8 W warps; on 600 SMs one block, 2 columns, 48
    cycles."""
    assert (probe.COLS_PER_BLOCK, probe.LAYOUTS) == (2, (1, 2, 4))
    assert probe.WARPS in probe.LAYOUTS
    assert probe.fma_floor_us(132, 1980.0) == pytest.approx(192 / 1980.0)
    assert probe.fma_floor_us(256, 1000.0) == pytest.approx(96 / 1000.0)
    assert probe.fma_floor_us(600, 1000.0) == pytest.approx(48 / 1000.0)
    assert probe.busiest_warps(132, warps) == 8 * warps
    assert probe.busiest_warps(600, warps) == 2 * warps


@pytest.fixture(scope="module")
def pallas_outs(script):
    """The Pallas kernel's output in interpret mode, by (dynamic, R)."""
    outs = {}

    def get(dynamic, R):
        if (dynamic, R) not in outs:
            fn, L_j = script.build(dynamic, R)
            outs[dynamic, R] = np.asarray(fn(L_j))
        return outs[dynamic, R]
    return get


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
@pytest.mark.parametrize("R", [1, 2])
def test_split_sum_emulation_matches_plain_and_pallas(pallas_outs, dynamic, R,
                                                      warps):
    """The kernel's sum order at W warps a column (a thread's 16 / W rows
    in three accumulators, one per stacked copy, then xor shuffles over
    the 2 W parts), in float32, within 1e-5 of max |out| of the plain
    version and of the Pallas kernel."""
    tape, L = probe.probe_inputs("cpu")
    got = probe.emulate_chain(tape, L, dynamic=dynamic, R=R, warps=warps)
    want = probe.static_chain_ref(tape, L, dynamic=dynamic, R=R).numpy()
    assert got.shape == (8, probe.S) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pallas = pallas_outs(dynamic, R)
    assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()


def test_split_sum_orders_differ_between_layouts():
    """The layouts add in another order, so the emulations differ in
    their last bits: each is held to the tolerance, not to another."""
    tape, L = probe.probe_inputs("cpu")
    outs = [probe.emulate_chain(tape, L, dynamic=True, R=1, warps=w)
            for w in probe.LAYOUTS]
    assert not np.array_equal(outs[0], outs[2])


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_split_sum_emulation_on_an_overlapping_tape(warps):
    """A tape whose ops write over their own source rows (dst = src + 1),
    chained into the output rows: emulation and plain version agree."""
    tape, L = probe.probe_inputs("cpu")
    tape[0] = torch.arange(52, 104, dtype=torch.int32)
    tape[1] = tape[0] + 1
    got = probe.emulate_chain(tape, L, dynamic=True, R=2, warps=warps)
    want = probe.static_chain_ref(tape, L, dynamic=True, R=2).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(want - probe.static_chain_ref(
        *probe.probe_inputs("cpu"), dynamic=True, R=2).numpy()).max() > 1e-3


def test_tape_overlap_needs_the_barrier_before_the_store():
    tape, _ = probe.probe_inputs("cpu")
    assert not probe.tape_overlaps(tape.numpy())   # dst = src + 2
    for shift in (0, 1):
        t = tape.numpy().copy()
        t[1, 7] = t[0, 7] + shift
        assert probe.tape_overlaps(t)
    t = tape.numpy().copy()
    t[1, 7] = t[0, 7] - 1                           # rows just below
    assert not probe.tape_overlaps(t)


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_thread_map_pairs_each_output_with_its_partner(warps):
    """At W warps a column, every output is summed by Q = 2 W neighbouring
    threads of one warp, one for each part of the rows (q = lane % Q),
    which the xor shuffles by 1 .. W join without leaving them; ev[o]
    meets ev[o + 16] in one thread, and the threads of part 0 store each
    of the 16 products once."""
    outs = probe.thread_outputs(warps)
    Q = 2 * warps
    threads = np.arange(32 * warps)
    assert outs.shape == (32 * warps, 2)
    for o in range(2 * probe.CA):
        holders = np.nonzero((outs == o).any(axis=1))[0]
        assert len(holders) == Q and len(set(holders // 32)) == 1
        assert sorted(holders % Q) == list(range(Q))
        for s in (1 << k for k in range(Q.bit_length() - 1)):
            assert set(holders ^ s) == set(holders)
    np.testing.assert_array_equal(outs[:, 1], outs[:, 0] + probe.CA)
    stores = outs[threads % Q == 0, 0]
    np.testing.assert_array_equal(np.sort(stores), np.arange(probe.CA))
