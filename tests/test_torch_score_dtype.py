"""bf16 scores (`init_fed_state(score_dtype=torch.bfloat16)`) against the
JAX package: the fed state's types, kernels 1-4's plain versions on a
bf16 score block (the reference's kernels upcast it in their bodies),
one train step (momentum and adam, each in one batch and in 2
microbatches), one round, and `convert` on a bf16-score state.  The
tests marked `cuda` hold kernels 1-9's bf16-score builds against their
plain versions on the card and skip here (the MoE, SSM and hybrid
families' bf16-score steps are held against the JAX package in
tests/test_torch_bf16_scores_{moe,conv,hybrid}.py).

Tolerances.  Masks and packed words are exact.  Kernels 1-2's sums are
f32 sums in another order, then the cast to the activation's type: one
bf16 ulp (relative 2**-7) plus 1e-4 of the output's scale.  Kernel 3's
ds is an f32 value rounded once to bf16 in both packages: one bf16 ulp
of the reference's value plus 1e-5 of the scale.  The train step runs on
f32 float leaves, so every activation is f32 and only the order of f32
sums differs (per-element relative differences of the straight-through
gradient up to ~1e-3 where it cancels).  The port rounds the update
where the reference's jitted step rounds it (`steps._update_low`), so a
stored score or moment may differ from the reference's by one bf16 ulp
where that gradient difference crosses a rounding boundary, and by more
only where the gradient cancels to near zero: each element is held to
one ulp of the reference's value plus 1e-3 of the leaf's scale, and the
elements more than one ulp off to at most 0.1% of the leaf's (measured
on internlm2 SMOKE, 147,456 scores: one batch: 0 scores and 35
moments off, 8 by more than one ulp; 2 microbatches: 0 and 21, 1.
Adam: one batch: 44 scores, 1 first and 53 second moments off, 5, 0
and 17 by more than one ulp; 2 microbatches: 15, 1 and 33 off, 1, 0 and
3 by more).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.kernels import dispatch
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

C, RUN_SEED = 2, 17
BF16 = torch.bfloat16
BF16_RTOL = 2.0 ** -7
_NONE = lambda x: x is None


def _jx(t):
    if t is None:
        return None
    if t.dtype == BF16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def _jleaves(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        t, is_leaf=_NONE) if x is not None]


def _tleaves(t):
    return [x for x in tree.leaves(t) if x is not None]


def _ulps(a, b):
    """|a - b| in bf16 ulps, elementwise, for bf16 values a (numpy) and b
    (torch)."""
    def ordered(x):
        i = x.astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    ai = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    bi = b.view(torch.int16).numpy()
    return np.abs(ordered(ai) - ordered(bi))


def _within_an_ulp(want_leaves, got_leaves, share):
    """Each element within one bf16 ulp of the reference's value plus
    1e-3 of the leaf's scale, and at most `share` of a leaf's elements
    more than one ulp off.  Returns (elements off, elements off by more
    than one ulp)."""
    off = far = 0
    for a, b in zip(want_leaves, got_leaves):
        assert b.dtype == BF16
        u = _ulps(a, b)
        af = np.asarray(a, np.float32)
        d = np.abs(af - b.float().numpy())
        ulp = np.abs(af) * BF16_RTOL
        assert (d <= ulp + 1e-3 * np.abs(af).max()).all()
        assert (u > 1).mean() <= share, (u > 1).mean()
        off, far = off + int((u > 0).sum()), far + int((u > 1).sum())
    return off, far


@functools.lru_cache(maxsize=None)
def _state(optimizer="momentum", arch="internlm2-1.8b"):
    """(JAX api, port api, a bf16-score fed state of `arch`'s SMOKE config
    as the JAX package's, with spread scores, non-zero moments (adam's
    second moments positive) and f32 floats), drawn by the port's
    init."""
    japi = jbuild_model(jget_config(arch, smoke=True))
    tapi = build_model(get_config(arch, smoke=True))
    st = steps.init_fed_state(torch.Generator().manual_seed(5), tapi,
                              masking.MaskSpec(), C=C, score_dtype=BF16,
                              optimizer=optimizer)
    gen = torch.Generator().manual_seed(5)
    for s in _tleaves(st["scores"]):
        s.add_((2.0 * torch.randn(s.shape, generator=gen)).to(BF16))
    for m in _tleaves(st["opt_m"]):
        m.add_((0.01 * torch.randn(m.shape, generator=gen)).to(BF16))
    for v in _tleaves(st.get("opt_v")):
        v.add_((1e-9 * torch.randn(v.shape, generator=gen) ** 2).to(BF16))
    jstate = {k: tree.tree_map(_jx, v) for k, v in st.items()
              if k != "step"}
    jstate["floats"] = jax.tree_util.tree_map(
        lambda x: None if x is None else x.astype(jnp.float32),
        jstate["floats"], is_leaf=_NONE)
    return japi, tapi, dict(jstate, step=jnp.asarray(0, jnp.int32))


def test_init_fed_state_types_are_the_references():
    """Scores and moments (adam's v too) in the score type, the rest as
    with f32 scores: leaf for leaf the reference's types."""
    arch = "internlm2-1.8b"
    japi = jbuild_model(jget_config(arch, smoke=True))
    tapi = build_model(get_config(arch, smoke=True))
    want = jax.eval_shape(lambda k: jsteps.init_fed_state(
        k, japi, jsteps.masking.MaskSpec(), C=C, score_dtype=jnp.bfloat16,
        optimizer="adam"), jax.random.PRNGKey(0))
    got = steps.init_fed_state(torch.Generator().manual_seed(0), tapi,
                               masking.MaskSpec(), C=C, score_dtype=BF16,
                               optimizer="adam")
    for key in ("scores", "opt_m", "opt_v", "floats", "weights"):
        w = [(tuple(a.shape), str(a.dtype)) for a in
             jax.tree_util.tree_leaves(want[key])]
        g = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
             for a in _tleaves(got[key])]
        assert g == w, key
    assert {a.dtype for a in _tleaves(got["scores"])} == {BF16}


def test_plain_kernels_on_bf16_scores_match_jax():
    """Kernels 1-4's plain versions on a bf16 score block against the
    reference's kernels (interpret mode) on the same block: the masks
    exactly (a probe x = [I 0] reads m * w back), the sums at f32
    tolerance, ds in bf16 within one ulp, the packed words exactly."""
    rng = np.random.default_rng(0)
    M, K, N = 24, 96, 80
    x = rng.standard_normal((M, K)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(
        np.float32)).to(BF16)
    s = torch.from_numpy(2 * rng.standard_normal((K, N)).astype(
        np.float32)).to(BF16)
    jw, js = _jx(w), _jx(s)
    seed, off = 1234, 5 * K * N
    for xx, want in ((np.eye(K, dtype=np.float32)[:M], None), (x, None)):
        got = ref.masked_matmul(torch.from_numpy(xx), w, s, seed, off)
        want = np.asarray(jops.masked_dense(jnp.asarray(xx), jw, js,
                                            jnp.uint32(seed),
                                            jnp.uint32(off)))
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    probe = ref.masked_matmul(torch.eye(K)[:M], w, s, seed, off)
    wm = (ref.sample_mask(s, seed, off).float() * w.float())[:M]
    assert torch.equal(probe, wm)
    gw = jax.grad(lambda xs, ss: jnp.sum(
        jops.masked_dense(xs, jw, ss, jnp.uint32(seed), jnp.uint32(off))
        * jnp.asarray(g)), argnums=(0, 1))(jnp.asarray(x), js)
    dx = ref.masked_matmul_dx(torch.from_numpy(g), w, s, seed, off)
    assert np.abs(dx.numpy() - np.asarray(gw[0])).max() \
        <= 1e-5 * np.abs(np.asarray(gw[0])).max()
    ds = ref.masked_matmul_ds(torch.from_numpy(x), torch.from_numpy(g), w, s)
    assert ds.dtype == BF16 and gw[1].dtype == jnp.bfloat16
    a = np.asarray(gw[1], np.float32)
    assert (np.abs(ds.float().numpy() - a)
            <= BF16_RTOL * np.abs(a) + 1e-5 * np.abs(a).max()).all()
    rows = torch.from_numpy(2 * rng.standard_normal((C, 100_003)).astype(
        np.float32)).to(BF16)
    seeds = [11, 0x9E3779B9]
    for mode in ("sample", "threshold"):
        want = np.asarray(jref.sample_and_pack(
            _jx(rows), jnp.asarray(seeds, jnp.uint32), mode, 0.45)) \
            if hasattr(jref, "sample_and_pack") else None
        got = mm.sample_and_pack(rows, seeds, mode=mode, tau=0.45)
        up = mm.sample_and_pack(rows.float(), seeds, mode=mode, tau=0.45)
        assert torch.equal(got, up)     # the mask of the exact upcast
        if want is not None:
            assert np.array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_momentum_train_step_matches_jax(microbatch):
    """One fedpm_reg step on bf16 scores (2 cohorts of batch 4, in one
    batch or 2 microbatches): the loss to 1e-5, every stored score and
    first moment within one bf16 ulp (see the module's note)."""
    japi, tapi, jstate = _state()
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 4, 16))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED, microbatch=microbatch)
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        score_dtype=jnp.bfloat16, **kw)))(
            jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(
        score_dtype=BF16, **kw))(tstate, {"tokens": torch.from_numpy(
            tokens)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    s_off, _ = _within_an_ulp(_jleaves(jout["scores"]),
                              _tleaves(tout["scores"]), 1e-3)
    m_off, m_far = _within_an_ulp(_jleaves(jout["opt_m"]),
                                  _tleaves(tout["opt_m"]), 1e-3)
    n = sum(a.size for a in _jleaves(jout["scores"]))
    assert s_off <= 1e-3 * n and m_off <= 1e-3 * n, (s_off, m_off, m_far)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_adam_train_step_matches_jax(microbatch):
    """One adam step on bf16 scores (2 cohorts of batch 4, in one batch or
    2 microbatches, where the reference rounds the update at other
    points): the loss to 1e-5, every stored score, first and second
    moment within one bf16 ulp (see the module's note)."""
    japi, tapi, jstate = _state("adam")
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 4, 16))
    kw = dict(lam=1.0, lr=0.1, seed=RUN_SEED, microbatch=microbatch,
              optimizer="adam")
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        score_dtype=jnp.bfloat16, **kw)))(
            jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(
        score_dtype=BF16, **kw))(tstate, {"tokens": torch.from_numpy(
            tokens)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    n = sum(a.size for a in _jleaves(jout["scores"]))
    for key in ("scores", "opt_m", "opt_v"):
        off, far = _within_an_ulp(_jleaves(jout[key]), _tleaves(tout[key]),
                                  1e-3)
        assert off <= 1e-3 * n, (key, off, far)


def test_state_of_another_score_type_raises():
    """The steps update scores in place, in their own type: a state whose
    scores are not `StepConfig.score_dtype` raises in the train step and
    the round, where the reference's round would cast them."""
    _, tapi, jstate = _state()
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    batch = {"tokens": torch.zeros((C, 4, 16), dtype=torch.int64)}
    with pytest.raises(ValueError, match="score_dtype"):
        steps.make_train_step(tapi, steps.StepConfig())(tstate, batch)
    with pytest.raises(ValueError, match="score_dtype"):
        steps.make_round_step(tapi, steps.StepConfig())(tstate)
    assert tstate["step"] == 0


def test_round_on_bf16_scores_is_exact():
    """The round on bf16 scores: every leaf's packed words (sampled from
    the bf16 rows), theta's logit stored in bf16, the floats' mean and
    the codec's bits as the reference's; `convert` carries the bf16
    state both ways unchanged."""
    japi, tapi, jstate = _state()
    jstate = dict(jstate, step=jnp.asarray(5, jnp.int32))
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    for a, b in zip(_jleaves(jstate["scores"]), _tleaves(tstate["scores"])):
        assert b.dtype == BF16
        assert np.array_equal(a.view(np.int16), b.view(torch.int16).numpy())
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
    for key in ("bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    assert abs(float(tm["bpp"]) - float(jm["bpp"])) <= 2.0 ** -23
    assert 0.0 < float(tm["bpp"]) <= 1.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 2048, 1024), (200, 1000, 1500),
                                   (33, 70, 45)])
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
def test_card_kernels_1_to_3_on_bf16_scores(card, shape, act):
    M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(M, K, generator=gen, device=card).to(act)
    w = torch.randn(K, N, generator=gen, device=card).to(BF16)
    s = (2 * torch.randn(K, N, generator=gen, device=card)).to(BF16)
    g = torch.randn(M, N, generator=gen, device=card).to(act)
    before = dict(dispatch.LAUNCHES)
    for got, want in ((mm.masked_matmul(x, w, s, 7, 3 * K * N),
                       ref.masked_matmul(x, w, s, 7, 3 * K * N)),
                      (mm.masked_matmul_dx(g, w, s, 7, 3 * K * N),
                       ref.masked_matmul_dx(g, w, s, 7, 3 * K * N))):
        a, b = got.float(), want.float()
        assert ((a - b).abs() <= BF16_RTOL * b.abs()
                + 1e-4 * b.abs().max()).all()
    ds, want = mm.masked_matmul_ds(x, g, w, s), ref.masked_matmul_ds(x, g, w,
                                                                     s)
    assert ds.dtype == BF16
    a, b = ds.float(), want.float()
    assert ((a - b).abs() <= BF16_RTOL * b.abs() + 1e-5 * b.abs().max()).all()
    for name in ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds"):
        assert dispatch.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_008, 100_004, 100_003])
def test_card_sample_and_pack_on_bf16_scores(card, n):
    gen = torch.Generator(device=card).manual_seed(2)
    s = (2 * torch.randn(C, n, generator=gen, device=card)).to(BF16)
    for mode in ("sample", "threshold"):
        got = mm.sample_and_pack(s, [5, 6], mode=mode, tau=0.45)
        want = ref.sample_and_pack(s, torch.tensor([5, 6], device=card),
                                   mode, 0.45)
        assert torch.equal(got, want)


def _card_close(got, want, rtol, share):
    """Within `rtol` of the plain version's value plus `share` of its
    scale, elementwise."""
    a, b = got.float(), want.float()
    assert ((a - b).abs() <= rtol * b.abs() + share * b.abs().max()).all(), \
        float((a - b).abs().max())


# deepseek-v2-lite's expert shapes at the capacity M = 30, deepseek-v2-236b's
# 160 experts at M = 12 (its w_up), and a ragged cell (w's and s's rows off
# the 16-byte grid)
CARD_GROUPED = [(64, 30, 2048, 1408), (64, 30, 1408, 2048),
                (160, 12, 5120, 1536), (5, 29, 1000, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_GROUPED)
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_grouped_kernels_on_bf16_scores(card, shape, mode):
    """Kernels 5-7 on a bf16 score block against their plain versions at
    a non-zero stream offset: the masks exactly (an identity probe of
    group 0 reads m * w back), y and dx within f32 rounding (1e-5 of the
    scale), ds in bf16 within one ulp plus 1e-5 of the scale."""
    E, M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(E, M, K, generator=gen, device=card)
    g = torch.randn(E, M, N, generator=gen, device=card)
    w = torch.randn(E, K, N, generator=gen, device=card).to(BF16)
    s = (2 * torch.randn(E, K, N, generator=gen, device=card)).to(BF16)
    seeds = [(7 + e) * 0x9E3779B9 & 0xFFFFFFFF for e in range(E)]
    offs = [((3 * E + e) * K * N) & 0xFFFFFFFF for e in range(E)]
    kw = dict(mode=mode, tau=0.45)
    before = dict(dispatch.LAUNCHES)
    y = mm.masked_matmul_grouped(x, w, s, seeds, offs, **kw)
    dx = mm.masked_matmul_grouped_dx(g, w, s, seeds, offs, **kw)
    ds = mm.masked_matmul_grouped_ds(x, g, w, s)
    for name in ("masked_matmul_grouped", "masked_matmul_grouped_dx",
                 "masked_matmul_grouped_ds"):
        assert dispatch.LAUNCHES[name] == before[name] + 1
    _card_close(y, ref.masked_matmul_grouped(x, w, s, seeds, offs, **kw),
                1e-5, 1e-5)
    _card_close(dx, ref.masked_matmul_grouped_dx(g, w, s, seeds, offs,
                                                 **kw), 1e-5, 1e-5)
    assert ds.dtype == BF16
    _card_close(ds, ref.masked_matmul_grouped_ds(x, g, w, s), BF16_RTOL,
                1e-5)
    r = min(M, K)
    probe = torch.zeros(E, r, K, device=card)
    probe[:, :, :r] = torch.eye(r, device=card)
    want = (ref.grouped_mask(s, seeds, offs, None, mode, 0.45).float()
            * w.float())[:, :r]
    assert torch.equal(mm.masked_matmul_grouped(probe, w, s, seeds, offs,
                                                **kw), want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2304, 4096, 1001])
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_conv_kernels_on_bf16_scores(card, C, mode):
    """Kernels 8-9 on a bf16 score block at mamba2's and recurrentgemma's
    conv widths (and C % 4 != 0) against their plain versions at a
    non-zero offset: the forward and the flipped pass bit for bit (the
    same taps in the same order), ds in bf16 within one ulp plus 1e-5 of
    the scale, the "dw" correlation in f32."""
    B, S, W = 2, 128, 4
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(B, S, C, generator=gen, device=card).to(BF16)
    g = torch.randn(B, S, C, generator=gen, device=card)
    w = torch.randn(W, C, generator=gen, device=card).to(BF16)
    s = (2 * torch.randn(W, C, generator=gen, device=card)).to(BF16)
    off = (47 * W * C) & 0xFFFFFFFF
    kw = dict(mode=mode, tau=0.45)
    for inp, flip in ((x, False), (g, True)):
        got = mm.masked_conv1d(inp, w, s, 9, off, flip=flip, **kw)
        assert torch.equal(got, ref.masked_conv1d(inp, w, s, 9, off,
                                                  flip=flip, **kw))
    ds = mm.masked_conv1d_ds(x, g, w, s)
    assert ds.dtype == BF16
    _card_close(ds, ref.masked_conv1d_ds(x, g, w, s), BF16_RTOL, 1e-5)
    dw = mm.masked_conv1d_ds(x, g, w, s, epilogue="dw")
    assert dw.dtype == torch.float32
    _card_close(dw, ref.masked_conv1d_ds(x, g, w, s, "dw"), 1e-5, 1e-5)
