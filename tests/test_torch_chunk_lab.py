"""The chunk lab (bito_tpu_torch/perflab/perf_chunk_lab.py) against
scripts/perf_chunk_lab.py: the script's variant bodies swapped into
bito_tpu's chunked Pallas LL kernel (with monkeypatch, so pallas_chunked
is left as it was found) and run in interpret mode on the CPU, on 10 taxa
x 3 trees x 128 patterns, GTR+Gamma4.

The port's plain version of each variant is held to the script's kernel
within 1e-5 relative on log likelihoods, the bound the chunked LL already
meets (tests/test_torch_chunked.py): v0 (the port's W = 2 tape against
the script's W = 4), w4, w8 and norescale.  notips' log likelihoods are 0
up to rounding in both (P's rows sum to 1); nodot, which is not a
likelihood, must be non-finite at the same places as the script's and
within the bound elsewhere.  The script's g1 and g2 give the same numbers:
the tree interleave, which has no counterpart on the card, changes no
result.  Then the port's own: every variant's plain version against the
chunked plain version in float64, fixstore's rows kept apart, and every
name the script takes either a counterpart or a reason."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_chunked, pallas_pruning
from bito_tpu_torch.perflab import perf_chunk_lab as lab
from bito_tpu_torch.treelike import chunked, paired, prep

from pallas_scripts import ROOT, load_script
from torch_port_cases import (GTR, jax_engine, jax_params, make_case,
                              max_rel, torch_engine, torch_params)

B = 3
F64 = torch.float64


@pytest.fixture(scope="module")
def case():
    """The Pallas kernel's operands (bito_tpu's engine, float32) and the
    port's engine and model in float64."""
    case = make_case(seed=41, num_taxa=10, num_sites=128, num_trees=B)
    je = jax_engine(case, "gtr_gamma4")
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    P_blk, tips_flat, piprop, w = pallas_pruning.prepare_inputs(
        enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights, eig,
        rates, props, clock, bl, je.pattern_pad)
    te = torch_engine(case, "gtr_gamma4")
    tenc = te.encode(case.torch_trees)
    teig, trates, tprops, tclock = te._model_ingredients(torch_params(GTR), B)
    pi, prop = prep.kernel_model(teig, tprops, F64)
    P = prep.prepare_inputs(teig, trates, tclock,
                            te.branch_length_matrix(case.torch_trees, tenc),
                            F64)
    return dict(jax_enc=enc, pallas=(P_blk, tips_flat, piprop, w),
                s_tile=je._pallas_s_tile(), enc=tenc, P=P, pi=pi,
                props=prop, tips=te._kernel_tips, weights=te._kernel_weights)


@pytest.fixture(scope="module")
def script():
    return load_script("perf_chunk_lab")


def _pallas(script, monkeypatch, case, name):
    """Per-tree log likelihoods of the script's variant `name`, parsed as
    the script parses it (perf_chunk_lab.py:138-153), in interpret mode."""
    script.ABLATE.clear()
    group, W = 2, 4
    for part in name.split("+"):
        if part.startswith("g") and part[1:].isdigit():
            group = int(part[1:])
        elif part.startswith("w") and part[1:].isdigit():
            W = int(part[1:])
        elif part != "v0":
            script.ABLATE.add(part)
    ce = pallas_chunked.build_chunked_encoding(case["jax_enc"], W=W)
    monkeypatch.setattr(pallas_chunked, "_chunk_post",
                        script._chunk_post_ablate)
    monkeypatch.setattr(pallas_chunked, "_chunk_evolve",
                        script._chunk_evolve_ablate)
    monkeypatch.setattr(pallas_chunked, "_init_tips", script._init_tips_ablate)
    if "unroll" in script.ABLATE:
        monkeypatch.setattr(pallas_chunked, "_ll_kernel",
                            script._ll_kernel_unroll)
    P_blk, tips_flat, piprop, w = case["pallas"]
    ll = pallas_chunked.chunked_log_likelihoods.__wrapped__(
        jnp.asarray(ce.post_dst), jnp.asarray(ce.tip_slot), P_blk,
        jnp.asarray(ce.post_e), tips_flat, piprop, w, Mc=ce.Mc, W=ce.W,
        T=ce.num_taxa, CA=16, s_tile=case["s_tile"], group=group,
        interpret=True)
    return np.asarray(ll, np.float64)


def _port(case, name):
    """Per-tree log likelihoods [B] of the port's plain version of `name`."""
    variant, W = lab.parse_name(name)
    ce = chunked.build_chunked_encoding(case["enc"], W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    rows = lab.chunk_variant(dst, tip, e, case["P"], case["tips"], case["pi"],
                             case["props"], variant=variant)
    assert rows.dtype == F64
    return (rows @ case["weights"]).numpy()


@pytest.mark.parametrize("name", ["v0", "w4", "w8", "norescale", "unroll"])
def test_variant_matches_the_script(script, monkeypatch, case, name):
    ll_pl = _pallas(script, monkeypatch, case, name)
    ll = _port(case, name)
    assert np.isfinite(ll).all() and max_rel(ll, ll_pl) < 1e-5


def test_notips_is_zero_in_both(script, monkeypatch, case):
    """Every leaf all ones: each LL is log 1 = 0 up to the rounding of P's
    row sums (and, in the script, of its bf16 hi/lo planes)."""
    scale = float(case["weights"].sum())
    ll_pl = _pallas(script, monkeypatch, case, "notips")
    ll = _port(case, "notips")
    assert np.abs(ll_pl).max() < 1e-5 * scale
    assert np.abs(ll).max() < 1e-10 * scale


def test_nodot_nonfinite_at_the_same_places(script, monkeypatch, case):
    """P = I: a pattern whose tips disagree has likelihood 0 (log -inf).
    Every pattern of this random alignment has tips that disagree, so each
    tree's LL is -inf in both, and so is each of the port's rows."""
    variant, W = lab.parse_name("nodot")
    ce = chunked.build_chunked_encoding(case["enc"], W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    rows = lab.chunk_variant(dst, tip, e, case["P"], case["tips"], case["pi"],
                             case["props"], variant=variant).numpy()
    ll_pl = _pallas(script, monkeypatch, case, "nodot")
    ll = _port(case, "nodot")
    np.testing.assert_array_equal(ll, ll_pl)
    assert (ll == -np.inf).all() and (rows == -np.inf).all()


def test_tree_interleave_changes_nothing(script, monkeypatch, case):
    """g1 and g2 (the script's G-way tree interleave) give the same log
    likelihoods: the interleave is scheduling only, which is why g<G> has
    no counterpart on the card."""
    g1 = _pallas(script, monkeypatch, case, "v0+g1")
    g2 = _pallas(script, monkeypatch, case, "v0+g2")
    np.testing.assert_array_equal(g1, g2)


@pytest.mark.parametrize("W", lab.WIDTHS)
@pytest.mark.parametrize("variant", ["v0", "norescale", "fixstore",
                                     "unroll"])
def test_plain_variants_match_the_chunked_plain_version(case, variant, W):
    """Every variant that is a likelihood, at every width, against
    chunked_log_likelihoods_ref in float64 within 1e-10."""
    ce = chunked.build_chunked_encoding(case["enc"], W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    ops = (dst, tip, e, case["P"], case["tips"], case["pi"], case["props"])
    rows = lab.chunk_variant_ref(*ops, variant=variant)
    ref = chunked.chunked_log_likelihoods_ref(*ops, case["weights"])
    assert max_rel((rows @ case["weights"]).numpy(), ref.numpy()) < 1e-10


def test_fixstore_rows_keep_live_outputs_apart():
    """fixstore's op m -> row m % R: no op that stores between an op and
    its consumer takes its row, and R is the least such count at or above
    the live rows; at the flagship's shape R is 12 against 10 live rows."""
    from bito_tpu_torch import _synthetic
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.treelike.encode import encode_trees

    text, _ = _synthetic.ds1_shaped(0, lab.BATCH)
    enc = encode_trees([t.topology for t in parse_newick_text(text).trees])
    for W in lab.WIDTHS:
        ce = chunked.build_chunked_encoding(enc, W)
        child = paired.child_tape(ce.post_dst, ce.tip_slot)
        _, live = paired.live_rows(ce.post_dst, child)
        R = lab.fixstore_rows(ce.post_dst, child, live)
        assert live <= R <= ce.MW
        cons = lab.consumers(child)
        M = ce.MW
        stored = (ce.post_dst != 2 * M + 1) & (ce.post_dst != 2 * M)
        for b in range(0, lab.BATCH, 37):
            for m in np.nonzero(cons[b] >= 0)[0]:
                later = np.arange(m + 1, cons[b, m])
                assert not (stored[b, later] & (later % R == m % R)).any()
        if R > live:
            assert lab.fixstore_rows(ce.post_dst, child, live) == R
            assert any(lab.fixstore_rows(ce.post_dst, child, r) != r
                       for r in range(live, R))
        if W == 2:
            assert (live, R, M) == (10, 12, lab.UNROLL_M)


def test_every_script_name_has_a_counterpart_or_a_reason():
    """The names the script's bodies and timings test for (`"x" in
    ABLATE`), and its w<W> and g<G>, are the lab's NAMES or listed in
    NO_COUNTERPART with a reason."""
    source = (ROOT / "scripts" / "perf_chunk_lab.py").read_text()
    names = set(re.findall(r'"(\w+)" (?:not )?in ABLATE', source))
    assert {"notips", "noinit", "norescale", "fixstore", "blockstore",
            "nosplit", "nodot", "unroll", "preponly", "fixedop"} <= names
    for name in names:
        assert name in lab.NAMES or name in lab.NO_COUNTERPART, name
    assert {"w2", "w4", "w8", "v0"} <= set(lab.NAMES)
    assert "g<G>" in lab.NO_COUNTERPART
    assert all(len(reason) > 20 for reason in lab.NO_COUNTERPART.values())


def test_wrapper_refuses_unknown_names_and_counts_no_cpu_launch(case):
    ce = chunked.build_chunked_encoding(case["enc"], chunked.W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    before = lab.chunk_variant.launches
    lab.chunk_variant(dst, tip, e, case["P"], case["tips"], case["pi"],
                      case["props"], variant="v0")
    assert lab.chunk_variant.launches == before
    for bad in ("nosplit", "w4", "unroll+norescale"):
        with pytest.raises(ValueError, match="unknown variant"):
            lab.chunk_variant(dst, tip, e, case["P"], case["tips"],
                              case["pi"], case["props"], variant=bad)
    with pytest.raises(ValueError, match="unknown name"):
        lab.parse_name("g2")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        lab.main(["v0"])
