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


# The card's design (csrc/pipe_cell.cu): a block = one cell x a tile of T
# columns, the scratch and the block slice in shared memory.

EXPECTED_TILES = {  # pipe_plan's rule (its docstring)
    "tiny-block_tiny-scratch": 16, "big-block_tiny-scratch": 64,
    "tiny-block_big-scratch": 8, "tiny-block_big-scratch_init": 8,
    "big-block_big-scratch_init": 16, "tiny_big_init_loop28": 8,
    "tiny_big_init_loop28_st4": 8, "paired-like": 16,
    "double-scratch-4160": 8}


@pytest.mark.parametrize("name", list(lab.EXPS))
def test_pipe_plan_fits_every_experiment(name):
    block_rows, scratch_rows = lab.EXPS[name][:2]
    plan = lab.pipe_plan(block_rows, scratch_rows)
    assert plan.tile == EXPECTED_TILES[name]
    assert plan.smem == (plan.tile * (2 * block_rows + 4 * scratch_rows)
                         + 384 + 128) <= 232448
    assert lab.S % plan.tile == 0 and 16 * plan.tile <= 1024
    assert plan.stage_rows % 8 == 0 and plan.stage_rows <= 256
    assert block_rows % plan.stage_rows == 0
    fits = [t for t in lab.TILES
            if lab.pipe_smem(block_rows, scratch_rows, t) <= 232448]
    for tile in fits:  # every tile that fits can be asked for
        assert lab.pipe_plan(block_rows, scratch_rows, tile).tile == tile


def test_pipe_plan_refuses_what_does_not_fit():
    # 8,192 scratch rows: 262,664 bytes at 8 columns
    with pytest.raises(ValueError, match="shared memory"):
        lab.pipe_plan(8, 8192)
    assert lab.pipe_plan(8, 7000).tile == 8   # 224,520 bytes
    with pytest.raises(ValueError, match="tile 32"):
        lab.pipe_plan(8, 2080, 32)
    with pytest.raises(ValueError, match="multiple of 8"):
        lab.pipe_plan(12, 128)


def test_pipe_plan_edge_is_the_kernels_launch_limit():
    """The largest scratch that pipe_plan takes at 8 block rows fills the
    227 KB of a block as csrc/pipe_cell.cu's launch counts it: its dynamic
    bytes plus 128 of alignment within 232,448 less the kernel's 384
    static bytes.  One row more is refused on the host, so no plan reaches
    the launch's own refusal."""
    rows = lab.EDGE_SCRATCH_ROWS
    plan = lab.pipe_plan(8, rows)
    dynamic = 8 * (2 * 8 + 4 * rows)
    assert (rows, plan.tile, plan.smem) == (7244, 8, dynamic + 512)
    assert dynamic + 128 <= 232448 - 384 < dynamic + 128 + 8 * 4
    with pytest.raises(ValueError, match="shared memory"):
        lab.pipe_plan(8, rows + 1)


def _emulate_threads(idx, big, scratch_rows, init, loops, stores, seed):
    """csrc/pipe_cell.cu's schedule on the host, all columns at once: the
    fill (any order; a barrier follows it), then the loop of the 16
    threads of a column (i = 0..15) in a random interleaving of their
    steps, each step touching only rows = i (mod 16), which the emulation
    asserts.  Returns out [cells, 8, S]."""
    cells, _, cols = big.shape
    rng = np.random.default_rng(seed)
    out = np.empty((cells, 8, cols), np.float32)
    for cell in range(cells):
        scratch = np.full((scratch_rows, cols), np.nan, np.float32)
        if init:
            scratch[rng.permutation(scratch_rows)] = 1.0
        offs = idx[cell, 0].numpy()

        def program(i):
            for c in range(loops):
                yield ("read", lab.ROWS * (c % lab.OFFSETS) + i)
                for k in range(stores):
                    yield ("store", lab.ROWS * int(offs[(c + k) % lab.OFFSETS])
                           + i)

        threads = {i: program(i) for i in range(lab.ROWS)}
        held = {}
        while threads:
            i = int(rng.choice(list(threads)))
            step = next(threads[i], None)
            if step is None:
                del threads[i]
                continue
            kind, row = step
            assert row % lab.ROWS == i   # a thread's own rows only
            if kind == "read":
                held[i] = scratch[row] + np.float32(1.0)
            else:
                scratch[row] = held[i]
        out[cell] = scratch[:8] + big[cell, :8].float().numpy()
    return out


@pytest.mark.parametrize("name", FILLED)
def test_thread_ownership_emulation_matches_plain(name):
    """No barrier in the loop: any interleaving of the 16 row owners of a
    column gives the plain version's output exactly, at 2 cells, on the
    ones block and on small integers."""
    block_rows, scratch_rows, init, loops, stores = lab.EXPS[name]
    idx, big = lab.pipe_inputs(block_rows, scratch_rows, CELLS, "cpu")
    kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
              stores=stores)
    for seed, block in enumerate((big, torch.as_tensor(_random_block(
            big.shape, 3)).to(torch.bfloat16))):
        want = lab.pipe_cell_ref(idx, block, **kw).numpy()
        got = _emulate_threads(idx, block, scratch_rows, init, loops, stores,
                               seed)
        np.testing.assert_array_equal(got, want)


def test_scratch_bytes_and_bound_terms():
    """paired-like: 0.419 GB of fill and 1.022 GB of loop through shared
    memory, 1.44 GB at 128 B a clock on 132 SMs at 1,980 MHz (33.45 TB/s)
    is 0.0431 ms, against 55.7 MB of device memory, 0.0166 ms at
    3.35 TB/s.  With stores = 0 the loop feeds nothing and counts
    nothing; without init or loop the scratch counts nothing."""
    fill = 100 * 1024 * 1024 * 4
    loop = 100 * 52 * 16 * 3 * 1024 * 4
    assert (fill, loop) == (419_430_400, 1_022_361_600)
    assert lab.scratch_bytes(1024, True, 52, 2) == fill + loop
    assert lab.scratch_bytes(2080, True, 28, 0) == 100 * 2080 * 1024 * 4
    assert lab.scratch_bytes(2080, False, 0, 0) == 0
    assert lab.stream_bytes(256) == 100 * (256 + 256 * 1024 * 2 + 8 * 4096)
    hbm, smem = lab.pipe_bound_ms(*lab.EXPS["paired-like"], sms=132,
                                  clock_mhz=1980.0)
    assert hbm == pytest.approx(0.0166, abs=5e-5)
    assert smem == pytest.approx(0.0431, abs=5e-5)
    hbm, smem = lab.pipe_bound_ms(*lab.EXPS["tiny-block_tiny-scratch"],
                                  sms=132, clock_mhz=1980.0)
    assert smem == 0 and hbm > 0


def test_torch_stream_sum_is_the_plain_version():
    """The library call timed beside the stream sums computes the same
    grouped sums, into the output it is given."""
    big4 = torch.as_tensor(_random_block((CELLS, 2, 16, 24), 3)).to(
        torch.bfloat16)
    for big in (big4, big4.reshape(CELLS, 32, 24)):
        out = torch.empty((CELLS, 8, 24))
        assert lab.torch_stream_sum(big, out) is out
        torch.testing.assert_close(out, lab.stream_sum_ref(big), rtol=0,
                                   atol=0)
