"""The pipe lab's plain versions (bito_tpu_torch/perflab/perf_pipe_lab.py)
against scripts/perf_pipe_lab.py's Pallas kernels (`run`'s kernel and
`run4d`'s kernel4 and kernel3), run in interpret mode on the CPU at 2
cells, on the script's own inputs and on blocks of small random integers.

Bounds: exact.  The outputs are sums of ones and small integers, exact in
float32.  The three experiments that do not fill their scratch have no
defined output on either side (an earlier cell's VMEM on the TPU, whatever
the allocation held here); for them only the shape is checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu_torch.perflab import perf_pipe_lab as lab

from pallas_scripts import interpret_pallas, load_script

CELLS = 2
FILLED = [name for name, exp in lab.EXPS.items() if exp[2]]


@pytest.fixture(scope="module")
def script():
    """scripts/perf_pipe_lab.py at CELLS = 2 and REPS = 1, its pallas_call
    in interpret mode; the script runs stubs in its sweeps, and the tests
    call the recorded kernels."""
    module = load_script("perf_pipe_lab")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "CELLS", CELLS)
        mp.setattr(module, "REPS", 1)
        built = interpret_pallas(module, mp, stub=True)
        yield module, built


def _random_block(shape, seed):
    """bf16 small integers in [0, 8), exact in bf16 and in float32 sums."""
    return np.random.default_rng(seed).integers(0, 8, shape).astype(np.float32)


def test_nine_experiments_as_the_script():
    assert lab.EXPS == load_script("perf_pipe_lab").EXPS
    assert (lab.CELLS, lab.S, lab.REPS) == (100, 1024, 40)
    assert len(FILLED) == 6


@pytest.mark.parametrize("name", FILLED)
def test_pipe_cell_plain_matches_pallas_interpret(script, name):
    module, built = script
    block_rows, scratch_rows, init, loops, stores = lab.EXPS[name]
    built.clear()
    module.run(name, *lab.EXPS[name])
    kernel = built[0]
    idx, big = lab.pipe_inputs(block_rows, scratch_rows, CELLS, "cpu")
    rand = _random_block(big.shape, 7)
    kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
              stores=stores)
    for block in (np.ones(big.shape, np.float32), rand):
        want = np.asarray(kernel(jnp.asarray(idx.numpy()),
                                 jnp.asarray(block, jnp.bfloat16)))
        tblock = torch.as_tensor(block).to(torch.bfloat16)
        got = lab.pipe_cell_ref(idx, tblock, **kw)
        assert got.dtype == torch.float32 and got.shape == (CELLS, 8, lab.S)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(lab.pipe_cell(idx, tblock, **kw).numpy(),
                                      want)


@pytest.mark.parametrize("name", [n for n in lab.EXPS if n not in FILLED])
def test_pipe_cell_without_fill_has_the_output_shape(name):
    block_rows, scratch_rows, init, loops, stores = lab.EXPS[name]
    idx, big = lab.pipe_inputs(block_rows, scratch_rows, CELLS, "cpu")
    out = lab.pipe_cell(idx, big, scratch_rows=scratch_rows, init=init,
                        loops=loops, stores=stores)
    assert out.shape == (CELLS, 8, lab.S) and out.dtype == torch.float32


def test_stream_sums_match_pallas_interpret(script):
    module, built = script
    built.clear()
    module.run4d(*lab.DMA4D)
    kernel4, kernel3 = built
    _, nslices, rows, cols = lab.DMA4D
    shape4 = (CELLS, nslices, rows, cols)
    for block in (np.ones(shape4, np.float32), _random_block(shape4, 11)):
        big4 = torch.as_tensor(block).to(torch.bfloat16)
        big3 = big4.reshape(CELLS, nslices * rows, cols)
        want4 = np.asarray(kernel4(jnp.asarray(block, jnp.bfloat16)))
        want3 = np.asarray(kernel3(jnp.asarray(block, jnp.bfloat16).reshape(
            big3.shape)))
        np.testing.assert_array_equal(want4, want3)
        for got in (lab.stream_sum_ref(big4), lab.stream_sum_ref(big3),
                    lab.stream_sum_4d(big4), lab.stream_sum_3d(big3)):
            assert got.shape == (CELLS, 8, cols)
            np.testing.assert_array_equal(got.numpy(), want4)
    assert want4.max() > 0


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    before = (lab.pipe_cell.launches, lab.stream_sum_4d.launches,
              lab.stream_sum_3d.launches)
    idx, big = lab.pipe_inputs(8, 1024, CELLS, "cpu")
    kw = dict(scratch_rows=1024, init=True, loops=52, stores=2)
    torch.testing.assert_close(lab.pipe_cell(idx, big, **kw),
                               lab.pipe_cell_ref(idx, big, **kw),
                               rtol=0, atol=0)
    big4 = torch.ones((CELLS, 2, 16, 128), dtype=torch.bfloat16)
    torch.testing.assert_close(lab.stream_sum_4d(big4),
                               lab.stream_sum_3d(big4.reshape(CELLS, 32, 128)),
                               rtol=0, atol=0)
    assert (lab.pipe_cell.launches, lab.stream_sum_4d.launches,
            lab.stream_sum_3d.launches) == before


def test_stream_sum_wrappers_check_the_layout():
    with pytest.raises(ValueError, match="big4"):
        lab.stream_sum_4d(torch.ones((CELLS, 32, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="big3"):
        lab.stream_sum_3d(torch.ones((CELLS, 2, 16, 128),
                                     dtype=torch.bfloat16))
