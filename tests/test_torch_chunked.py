"""The chunked route (treelike/chunked.py) against bito_tpu's
pallas_chunked: the host tapes compared exactly, the plain versions of the
two chunked kernels against the Pallas kernels run in interpret mode on the
CPU, and the engine's kernel="chunked" against bito_tpu's scan engine.

Bounds: the float32 plain versions within 1e-5 relative of the Pallas
kernels on log likelihoods and within 5e-5 of the largest gradient
(bench.py's parity metric and guard); the Pallas kernels' own error
against the float64 scan is about 3e-7 (LL) and 3e-6 (gradients) at this
size.  In float64 the plain versions and the engine agree with the scan
tapes within 1e-10 (the same arithmetic in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_chunked, pallas_pruning
from bito_tpu.treelike.encode import encode_trees as jax_encode
from bito_tpu_torch.treelike import chunked, engine, prep
from bito_tpu_torch.treelike.encode import encode_trees

from torch_port_cases import (GTR, MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, per_tree_rows, torch_engine,
                              torch_params)

B = 4
PALLAS_W = 4  # bito_tpu's width at CA=16 (engine._chunk_W)

ENCODING_CASES = [
    dict(seed=1, num_taxa=8, num_trees=4, rooted=False),
    dict(seed=2, num_taxa=9, num_trees=3, rooted=True),
    dict(seed=3, num_taxa=27, num_trees=5, rooted=False),
]


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("kw", ENCODING_CASES)
def test_chunked_encoding_identical(kw, W):
    case = make_case(**kw)
    jc = pallas_chunked.build_chunked_encoding(
        jax_encode([t.topology for t in case.jax_trees]), W=W)
    tc = chunked.build_chunked_encoding(
        encode_trees([t.topology for t in case.torch_trees]), W)
    assert ((jc.num_taxa, jc.num_slots, jc.W, jc.Mc, jc.n_pair_slots)
            == (tc.num_taxa, tc.num_slots, tc.W, tc.Mc, tc.n_pair_slots))
    for field in ("post_dst", "post_e", "tip_slot", "node_row"):
        np.testing.assert_array_equal(getattr(jc, field), getattr(tc, field))


@pytest.mark.parametrize("W", [2, 4, 8])
def test_schedule_is_dependency_safe(W):
    """No op reads a slot that an op of its own chunk writes: every real
    op's destination lies in a strictly later chunk (or is the root), every
    tip is read by exactly one op, and every node with an edge owns one
    gradient row of the op that consumes it."""
    case = make_case(seed=5, num_taxa=27, num_trees=6)
    enc = encode_trees([t.topology for t in case.torch_trees])
    ce = chunked.build_chunked_encoding(enc, W)
    MW = ce.MW
    for b in range(enc.batch_size):
        real = [g for g in range(MW) if ce.post_dst[b, g] != ce.trash_slot]
        assert len(real) == int((enc.post_ops[b, :, 0] != enc.dummy).sum())
        assert sum(ce.post_dst[b, g] == ce.root_slot for g in real) == 1
        for g in real:
            dst = int(ce.post_dst[b, g])
            if dst != ce.root_slot:
                assert (dst // 2) // W > g // W, (b, g, dst)
        assert len(set(ce.tip_slot[b].tolist())) == enc.num_taxa
        rows = ce.node_row[b, : enc.node_counts[b] - 1]
        assert len(set(rows.tolist())) == len(rows) and rows.max() < 2 * MW


def _port_operands(te, case, params, W, dtype=torch.float32):
    """The chunked kernels' operands at width W from the port's engine."""
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    eig, rates, props, clock = te._model_ingredients(torch_params(params), B)
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e, row = (torch.as_tensor(x, dtype=torch.int32) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, dtype)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    return ops, dict(node_row=row, dP=dP,
                     edge_mask=torch.as_tensor(enc.edge_mask, dtype=dtype))


@pytest.fixture(scope="module")
def pallas_case():
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4, W=4: the Pallas kernels
    in interpret mode, the float64 scan engine, and the port's operands."""
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B)
    je = jax_engine(case, "gtr_gamma4")
    jp = jax_params(GTR)
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jp, B)
    sp = je.site_pattern
    P_blk, dP_blk, tips_flat, pivec, propvec, w = (
        pallas_pruning.prepare_inputs_grad(
            enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
            eig, rates, props, clock, bl, je.pattern_pad))
    ce = pallas_chunked.build_chunked_encoding(enc, W=PALLAS_W)
    dst, tip, e, row = (jnp.asarray(x) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    static = dict(Mc=ce.Mc, W=ce.W, T=ce.num_taxa, CA=pivec.shape[1],
                  s_tile=je._pallas_s_tile(), group=1, interpret=True)
    ll_pl, g_pl = pallas_chunked.chunked_ll_and_gradients(
        dst, tip, e, row, jnp.asarray(enc.edge_mask, jnp.float32), P_blk,
        dP_blk, tips_flat, pivec, propvec, w, num_slots=enc.num_slots,
        **static)
    llo_pl = pallas_chunked.chunked_log_likelihoods(
        dst, tip, P_blk, e, tips_flat, pivec * propvec, w, **static)
    ll_ref, g_ref = je.ll_and_branch_gradients(case.jax_trees, jp)
    te = torch_engine(case, "gtr_gamma4")
    return dict(
        pallas=(np.asarray(ll_pl), np.asarray(g_pl), np.asarray(llo_pl)),
        scan=(np.asarray(ll_ref), np.asarray(g_ref)),
        operands=_port_operands(te, case, GTR, PALLAS_W))


def test_ll_plain_matches_pallas_interpret(pallas_case):
    ops, _ = pallas_case["operands"]
    ll = chunked.chunked_log_likelihoods_ref(**ops)
    assert ll.dtype == torch.float32
    ll_pl, _, llo_pl = pallas_case["pallas"]
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_rel(ll.numpy(), pallas_case["scan"][0]) < 1e-5


def test_grad_plain_matches_pallas_interpret(pallas_case):
    ops, extra = pallas_case["operands"]
    ll, g = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    ll_pl, g_pl, _ = pallas_case["pallas"]
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5
    ll_ref, g_ref = pallas_case["scan"]
    assert max_rel(ll.numpy(), ll_ref) < 1e-5
    assert max_norm(g.numpy(), g_ref) < 5e-5


@pytest.mark.parametrize("model,rooted,W", [
    ("gtr_gamma4", False, chunked.W), ("gtr_gamma4", True, chunked.W),
    ("jc69", True, chunked.W), ("hky_weibull4", True, chunked.W),
    ("gtr_gamma4", False, 8)])
def test_plain_in_float64_matches_scan(model, rooted, W):
    """The chunked algorithm itself, without f32 rounding: in float64 the
    plain versions agree with the port's scan tape within 1e-10, on tapes
    built at the module's width and at a multiple of it."""
    case = make_case(seed=41, num_taxa=8, num_trees=B, rooted=rooted)
    te = torch_engine(case, model)
    params = MODELS[model][1]
    ops, extra = _port_operands(te, case, params, W, dtype=torch.float64)
    ll_ref, g_ref = (x.numpy() for x in te.ll_and_branch_gradients(
        case.torch_trees, torch_params(params)))
    ll, g = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10
    assert max_rel(chunked.chunked_log_likelihoods_ref(**ops).numpy(),
                   ll_ref) < 1e-10


@pytest.mark.parametrize("model", ["gtr_gamma4", "jc69", "hky_weibull4"])
def test_eigen_derivative_matches_q_times_p(model):
    """prep.prepare_inputs_grad's dP (the eigen derivative) against
    prepare_inputs_grad_q's dP = rate*clock * Q P, in float64."""
    case = make_case(seed=43, num_taxa=8, num_trees=B)
    te = torch_engine(case, model)
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    eig, rates, _props, clock = te._model_ingredients(
        torch_params(MODELS[model][1]), B)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, torch.float64)
    Pq, dPq = prep.prepare_inputs_grad_q(eig, rates, clock, bl, torch.float64)
    assert dP.dtype == torch.float64 and dP.shape == dPq.shape
    torch.testing.assert_close(P, Pq, rtol=0, atol=0)
    assert float((dP - dPq).abs().max()) < 1e-12
    assert float(dP[:, -1].abs().max()) == 0.0
    assert prep.prepare_inputs_grad(eig, rates, clock, bl)[1].dtype == (
        torch.float32)


def _chunked_launches():
    """The launch counts of both bodies of both kernels."""
    return (chunked.chunked_ll_onchip.launches,
            chunked.chunked_ll_global.launches,
            chunked.chunked_grad_onchip.launches,
            chunked.chunked_grad_global.launches)


# (model, rooted, batch)
ENGINE_CASES = [("gtr_gamma4", False, 4), ("gtr_gamma4", True, 3),
                ("jc69", False, 3), ("hky_weibull4", True, 4)]


@pytest.mark.parametrize("model,rooted,batch", ENGINE_CASES)
def test_engine_chunked_matches_bito_tpu_scan(model, rooted, batch):
    """kernel="chunked" on the CPU in float64 runs the chunked plain
    versions through every entry point and matches bito_tpu's scan engine
    within 1e-10, launching nothing."""
    case = make_case(seed=21, num_taxa=8, num_trees=batch, rooted=rooted)
    params = MODELS[model][1]
    je, te = jax_engine(case, model), torch_engine(case, model)
    te.kernel = "chunked"
    jp, tp = jax_params(params), torch_params(params)
    assert te._route(te._shared_model(tp)) == "chunked"
    launches = _chunked_launches()

    ll_ref = np.asarray(je.log_likelihoods(case.jax_trees, jp))
    assert max_rel(te.log_likelihoods(case.torch_trees, tp).numpy(),
                   ll_ref) < 1e-10
    ll_ref, g_ref = (np.asarray(x) for x in
                     je.ll_and_branch_gradients(case.jax_trees, jp))
    ll, g = (x.numpy() for x in te.ll_and_branch_gradients(case.torch_trees,
                                                           tp))
    assert g.shape == g_ref.shape
    assert max_rel(ll, ll_ref) < 1e-10 and max_norm(g, g_ref) < 1e-10

    jbl = je.branch_length_matrix(case.jax_trees,
                                  je.encode(case.jax_trees)) * 1.1
    tbl = te.branch_length_matrix(case.torch_trees,
                                  te.encode(case.torch_trees)) * 1.1
    ll_ref, g_ref = (np.asarray(x) for x in
                     je.branch_eval_fn(case.jax_trees, jp)(jbl))
    ll, g = (x.numpy() for x in te.branch_eval_fn(case.torch_trees, tp)(tbl))
    assert max_rel(ll, ll_ref) < 1e-10 and max_norm(g, g_ref) < 1e-10
    ll = te.ll_eval_fn(case.torch_trees, tp)(tbl).numpy()
    assert max_rel(ll, np.asarray(
        je.ll_eval_fn(case.jax_trees, jp)(jbl))) < 1e-10
    assert _chunked_launches() == launches


def test_engine_chunked_refuses_what_the_kernels_do_not_take():
    """Per-tree parameter rows raise (bito_tpu's forced kernel would use
    tree 0's model for the whole batch), and so does a model with other
    than 4 states."""
    case = make_case(seed=23, num_taxa=8, num_trees=2)
    te = torch_engine(case, "gtr_gamma4")
    te.kernel = "chunked"
    per_tree = torch_params(per_tree_rows(GTR, 2, seed=0))
    with pytest.raises(ValueError, match="per-tree"):
        te.log_likelihoods(case.torch_trees, per_tree)
    with pytest.raises(ValueError, match="per-tree"):
        te.branch_eval_fn(case.torch_trees, per_tree)
    te.num_states = 20
    with pytest.raises(ValueError, match="4-state"):
        te._route(True)
    te.kernel = "auto"
    assert te._route(True) == "scan"


def test_engine_has_no_per_node_route():
    """bito_tpu's engine cannot reach its per-node kernels; the port's
    cannot either."""
    source = open(engine.__file__).read()
    assert "pernode" not in vars(engine) and "pernode_" not in source


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    case = make_case(seed=51, num_taxa=8, num_trees=B)
    ops, extra = _port_operands(torch_engine(case, "gtr_gamma4"), case, GTR,
                                chunked.W)
    before = _chunked_launches()
    torch.testing.assert_close(chunked.chunked_log_likelihoods(**ops),
                               chunked.chunked_log_likelihoods_ref(**ops),
                               rtol=0, atol=0)
    got = chunked.chunked_ll_and_gradients(**ops, **extra)
    want = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _chunked_launches() == before


def test_operand_checks():
    case = make_case(seed=51, num_taxa=8, num_trees=B)
    ops, _ = _port_operands(torch_engine(case, "gtr_gamma4"), case, GTR, 4)
    chunked._check_chunked(**ops)
    cut = dict(ops, post_dst=ops["post_dst"][:, :-1],
               post_e=ops["post_e"][:, :-1])
    with pytest.raises(ValueError, match="chunks of W=2"):
        chunked._check_chunked(**cut)
    with pytest.raises(ValueError, match="weights"):
        chunked._check_chunked(**dict(ops, weights=ops["weights"][:-1]))
