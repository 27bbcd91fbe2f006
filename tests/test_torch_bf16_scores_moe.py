"""bf16 scores through the MoE family (deepseek-v2-lite: MLA and the
routed experts on the grouped kernels 5-7) against the JAX package, on
the CPU.

Kernels 5-7's plain versions on a bf16 score block against the
reference's grouped kernels in interpret mode (which widen the block to
f32 in their bodies): the masks exactly (an identity probe reads m * w
back), y and dx within f32 rounding (1e-5 of the scale), ds in bf16
within one ulp plus 1e-5 of the scale (both round one f32 value).  One
momentum train step of the SMOKE config on bf16 scores and moments
against the reference's jitted step: the loss to 1e-5, every stored
score and first moment within one bf16 ulp of the reference's value plus
1e-3 of the leaf's scale, with at most 0.1% of a leaf's elements more
than one ulp off (`_within_an_ulp`; the reason is in
tests/test_torch_score_dtype.py's note).  One round exactly: every
leaf's packed words, the codec's bits, bpp to 2**-23, theta's logit
within one bf16 ulp.  `convert` carries the bf16-score state both ways
bit for bit, its leaves of the reference's types; the in-place update
and the round reach the stacked (L, E, K, N) expert leaves piece by
piece (`steps.UPDATE_PIECE`) with the same bits as in one piece.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.kernels.masked_matmul import masked_matmul_grouped as jgrouped
from repro.kernels.masked_matmul import masked_matmul_grouped_ds as jgrouped_ds
from repro.kernels.masked_matmul import masked_matmul_grouped_dx as jgrouped_dx
from repro.launch import steps as jsteps

from repro_torch import convert
from repro_torch.core import aggregation, masking, tree
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ref
from repro_torch.launch import steps

from test_torch_score_dtype import (BF16, BF16_RTOL, C, RUN_SEED, _NONE,
                                    _jleaves, _jx, _np, _state, _tleaves,
                                    _ulps, _within_an_ulp)
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH = "deepseek-v2-lite-16b"
M32 = 0xFFFFFFFF
E, M, K, N = 3, 30, 40, 72
SEEDS = [7, M32, 123]
# group 0's stream crosses 2**32 inside the block, group 1 starts just
# past the wrap
OFFS = [(1 << 32) - 1000, ((1 << 32) - 1000 + K * N) & M32, 12345]


def _bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(BF16)


def _close(got, want, rtol, share):
    want = np.asarray(want, np.float32)
    d = np.abs(np.asarray(got, np.float32) - want)
    assert (d <= rtol * np.abs(want) + share * np.abs(want).max()).all(), \
        d.max()


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_grouped_plain_kernels_on_bf16_scores_match_jax(mode):
    """Kernels 5-7's plain versions on a bf16 score block against the
    reference's grouped kernels (interpret mode) on the same block, at
    wrapping stream offsets."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    g = rng.standard_normal((E, M, N)).astype(np.float32)
    w = _bf16(rng.standard_normal((E, K, N)))
    s = _bf16(2 * rng.standard_normal((E, K, N)))
    jw, js = _jx(w), _jx(s)
    seeds, offs = jnp.asarray(SEEDS, jnp.uint32), jnp.asarray(OFFS, jnp.uint32)
    kw = dict(mode=mode, tau=0.45)
    jkw = dict(interpret=True, mode=mode, tau=0.45)
    # the masks exactly: each group's identity probe reads m * w back
    probe = np.broadcast_to(np.eye(K, dtype=np.float32), (E, K, K)).copy()
    got = mm.masked_matmul_grouped(torch.from_numpy(probe), w, s, SEEDS,
                                   OFFS, **kw)
    want = np.asarray(jgrouped(jnp.asarray(probe), jw, js, seeds, offs,
                               **jkw))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ref.grouped_mask(s, SEEDS, OFFS, None, mode,
                                             0.45).float() * w.float())
    y = mm.masked_matmul_grouped(torch.from_numpy(x), w, s, SEEDS, OFFS,
                                 **kw)
    _close(y.numpy(), jgrouped(jnp.asarray(x), jw, js, seeds, offs, **jkw),
           1e-5, 1e-5)
    dx = mm.masked_matmul_grouped_dx(torch.from_numpy(g), w, s, SEEDS, OFFS,
                                     **kw)
    _close(dx.numpy(), jgrouped_dx(jnp.asarray(g), jw, js, seeds, offs,
                                   **jkw), 1e-5, 1e-5)
    ds = mm.masked_matmul_grouped_ds(torch.from_numpy(x), torch.from_numpy(g),
                                     w, s)
    jds = jgrouped_ds(jnp.asarray(x), jnp.asarray(g), jw, js, interpret=True)
    assert ds.dtype == BF16 and jds.dtype == jnp.bfloat16
    _close(ds.float().numpy(), jds, BF16_RTOL, 1e-5)


def _step_matches(arch, share=1e-3):
    """One momentum step of `arch` on bf16 scores, the port against the
    reference's jitted step: the loss to 1e-5, the scores by
    `_within_an_ulp`.  Returns (reference state before and after, port
    state after)."""
    japi, tapi, jstate = _state("momentum", arch)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 4, 16))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED)
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        score_dtype=jnp.bfloat16, **kw)))(
            jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(
        score_dtype=BF16, **kw))(tstate, {"tokens": torch.from_numpy(
            tokens)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    n = sum(a.size for a in _jleaves(jout["scores"]))
    off, far = _within_an_ulp(_jleaves(jout["scores"]),
                              _tleaves(tout["scores"]), share)
    assert off <= 1e-3 * n, (off, far)
    return jstate, jout, tout


def test_momentum_train_step_matches_jax():
    """deepseek-v2-lite SMOKE (a dense layer and 2 MoE layers of 4
    experts), 2 cohorts of batch 4 x 16 tokens, on bf16 scores and
    moments: the loss to 1e-5, every stored score and first moment
    within one bf16 ulp (see the module's note)."""
    _, jout, tout = _step_matches(ARCH)
    n = sum(a.size for a in _jleaves(jout["opt_m"]))
    off, far = _within_an_ulp(_jleaves(jout["opt_m"]),
                              _tleaves(tout["opt_m"]), 1e-3)
    assert off <= 1e-3 * n, (off, far)


def round_is_exact(arch):
    """One round of `arch` on bf16 scores (step 5, 2 cohorts, no
    downlink quantizer): every leaf's packed words as the reference's,
    the codec's bits, bpp and the measured rate to 2**-23, theta's logit
    within one bf16 ulp, the floats' mean exactly."""
    japi, tapi, jstate = _state("momentum", arch)
    jstate = dict(jstate, step=jnp.asarray(5, jnp.int32))
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    for i, sl in enumerate(jax.tree_util.tree_leaves(jstate["scores"],
                                                     is_leaf=_NONE)):
        if sl is None:
            continue
        rows = sl.reshape(C, -1)
        seeds = [masking.mask_stream_seed(5, 0, i, c, RUN_SEED)
                 for c in range(C)]
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            rows, jnp.asarray(seeds, jnp.uint32), use_kernel=True))
        tw = aggregation.sample_and_pack_rows(
            convert.to_torch(np.asarray(rows), "cpu"), seeds).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
    kw = dict(seed=RUN_SEED, downlink_bits=0)
    jout, jm = jax.jit(jsteps.make_round_step(japi, jsteps.StepConfig(
        score_dtype=jnp.bfloat16, **kw)))(jstate)
    tout, tm = steps.make_round_step(tapi, steps.StepConfig(
        score_dtype=BF16, **kw))(tstate)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert b.dtype == BF16
        assert (_ulps(a, b) <= 1).all()   # logit's last f32 bit, rounded
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b.float().numpy(), a.astype(np.float32))
    for key in ("bits_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    # torch's and XLA's CPU log2 may differ in the last bit, and XLA
    # divides bits_measured by the constant n*C through its reciprocal
    # (ROADMAP Queue 3), as tests/test_torch_hybrid.py's round notes
    for key in ("bpp", "bpp_measured"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2.0 ** -23, key
    assert 0.0 < float(tm["bpp"]) <= 1.0


def test_round_on_bf16_scores_is_exact():
    round_is_exact(ARCH)


def convert_both_ways(arch):
    """The port's bf16-score fed state, handed to the JAX package and
    carried back by `convert.state_from_jax`, bit for bit leaf for leaf,
    each leaf of the type the reference's own init gives it."""
    japi, tapi, _ = _state("momentum", arch)
    want = jax.eval_shape(lambda k: jsteps.init_fed_state(
        k, japi, jsteps.masking.MaskSpec(), C=C, score_dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    st = steps.init_fed_state(torch.Generator().manual_seed(8), tapi,
                              masking.MaskSpec(), C=C, score_dtype=BF16)
    jstate = {k: tree.tree_map(_jx, v) for k, v in st.items() if k != "step"}
    jstate["step"] = jnp.asarray(st["step"], jnp.int32)
    back = convert.state_from_jax(_np(jstate), "cpu")
    for key in ("scores", "opt_m", "floats", "weights"):
        types = [str(a.dtype) for a in jax.tree_util.tree_leaves(want[key])]
        ja, tb = _jleaves(jstate[key]), _tleaves(back[key])
        assert [str(t.dtype).replace("torch.", "") for t in tb] == types, key
        assert len(ja) == len(tb)
        for a, b in zip(ja, tb):
            again = np.asarray(_jx(b))
            assert a.dtype == again.dtype and a.shape == tuple(b.shape)
            assert a.tobytes() == again.tobytes(), key
    assert back["step"] == int(jstate["step"])
    return back


def test_convert_carries_the_bf16_state_both_ways():
    back = convert_both_ways(ARCH)
    experts = [t for p, t in tree.flatten_with_paths(back["scores"])
               if t is not None and p.startswith("moe_layers/moe/w_")]
    assert len(experts) == 3 and all(t.ndim == 5 and t.dtype == BF16
                                     for t in experts)


def pieces_reach(arch, picked, piece, monkeypatch):
    """One train step and one round (8-bit downlink) of `arch` on bf16
    scores with the update and the round cut into pieces of `piece`
    elements give the same bits as with the default pieces, and the
    update reaches every layer's block of the score leaves whose paths
    `picked` takes: each spans several pieces and its moments moved.
    Returns the number of such leaves."""
    _, tapi, jstate = _state("momentum", arch)
    cfg = steps.StepConfig(lam=1.0, lr=0.3, seed=RUN_SEED, downlink_bits=8,
                           score_dtype=BF16)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (C, 4, 16)))}
    out = []
    for size in (steps.UPDATE_PIECE, piece):
        monkeypatch.setattr(steps, "UPDATE_PIECE", size)
        st = convert.state_from_jax(_np(jstate), "cpu")
        m0 = [t.clone() for t in _tleaves(st["opt_m"])]
        st, _ = steps.make_train_step(tapi, cfg)(st, batch)
        moved = [(t != a).float().mean().item()
                 for a, t in zip(m0, _tleaves(st["opt_m"]))]
        after = {k: [t.clone() for t in _tleaves(st[k])]
                 for k in ("scores", "opt_m")}
        st, metrics = steps.make_round_step(tapi, cfg)(st)
        out.append((after, [t.clone() for t in _tleaves(st["scores"])],
                    float(metrics["bpp"]), moved))
    (a0, r0, b0, _), (a1, r1, b1, moved) = out
    for key in a0:
        for x, y in zip(a0[key], a1[key]):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16)), key
    for x, y in zip(r0, r1):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert b0 == b1
    paths = [p for p, t in tree.flatten_with_paths(
        convert.state_from_jax(_np(jstate), "cpu")["opt_m"]) if t is not None]
    reached = 0
    for p, frac, t in zip(paths, moved, a1["opt_m"]):
        if picked(p):
            block = t[0, 0].numel()   # one cohort's, one layer's block
            assert block >= 2 * piece and frac >= 0.9, (p, block, frac)
            reached += 1
    return reached


def test_update_pieces_reach_the_expert_leaves(monkeypatch):
    """The stacked (L, E, K, N) expert leaves of 4 x 64 x 32 scores a
    layer, in pieces of 128."""
    assert pieces_reach(ARCH, lambda p: p.startswith("moe_layers/moe/w_"),
                        128, monkeypatch) == 3
