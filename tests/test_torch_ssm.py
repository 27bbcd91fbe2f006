"""The port's ssm family (mamba2: SSD chunked scan, depthwise conv on the
masked conv kernels) against the JAX package on mamba2 SMOKE, from one
state carried across by `convert.state_from_jax`: `ssd_chunked`, the
leaf layout, the fused masked forward, a train step, and a round that
must be exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jaggregation
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import aggregation, masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import build_model, ssm
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, C, RUN_SEED = "mamba2-370m", 2, 17
_NONE = lambda x: x is None


def _np(tree_):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), tree_, is_leaf=_NONE)


def _jleaves(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        t, is_leaf=_NONE) if x is not None]


def _tleaves(t):
    return [x.float().numpy() for x in tree.leaves(t) if x is not None]


@pytest.fixture(scope="module")
def apis():
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    init = jax.jit(lambda k: jsteps.init_fed_state(
        k, japi, jmasking.MaskSpec(), C=C))
    return japi, build_model(get_config(ARCH, smoke=True)), init


def _state(init, seed):
    """A JAX fed state whose cohorts differ and whose thetas spread over
    (0, 1)."""
    state = init(jax.random.PRNGKey(seed))
    k = jax.random.PRNGKey(seed + 100)
    state["scores"] = jax.tree_util.tree_map(
        lambda s: None if s is None else
        s + 2.0 * jax.random.normal(k, s.shape), state["scores"],
        is_leaf=_NONE)
    return state


@pytest.mark.parametrize("S,chunk", [(32, 16), (32, 32)])
def test_ssd_chunked_matches_jax(S, chunk):
    """f32 inputs, two chunks or one: y and the final state agree within
    float32 rounding of sums over up to S terms in another order."""
    rng = np.random.default_rng(S + chunk)
    Bsz, H, P, G, N = 2, 4, 8, 1, 16
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = (0.1 * np.abs(rng.normal(size=(Bsz, S, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, G, N)).astype(np.float32)
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               chunk=chunk)
    ty, tst = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                              chunk=chunk)
    for got, want in ((ty, jy), (tst, jst)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_ssd_backward_is_finite_with_steep_decay():
    """Off-mask differences are zeroed before the exp: a steep decay
    (exp(+big) off the mask) leaves the gradient finite."""
    x = torch.randn(1, 16, 2, 4, requires_grad=True)
    dt = torch.full((1, 16, 2), 30.0, requires_grad=True)
    A = -torch.tensor([16.0, 8.0])
    Bm, Cm = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    y, _ = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    y.sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()


def test_masked_leaves_and_flatten_order_match(apis):
    """Three masked leaves (w_in, conv/w_conv, w_out), stacked (L, ...);
    A_log, D, dt_bias, the conv bias and the norms stay float; paths and
    order are the reference's."""
    japi, tapi, init = apis
    jstate = init(jax.random.PRNGKey(0))
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    # (jax drops the None leaves of float paths from this listing)
    jmasked = [p for p, _ in jmasking.leaves_with_paths(jstate["scores"])]
    masked = [p for p, a in tree.flatten_with_paths(tstate["scores"])
              if a is not None]
    assert masked == jmasked == ["layers/conv/w_conv", "layers/w_in",
                                 "layers/w_out"]
    # the port's own init gives the same tree
    tmpl = tapi.init_params(torch.Generator().manual_seed(0))
    jtmpl = jax.eval_shape(japi.init_params, jax.random.PRNGKey(0))
    assert [p for p, _ in tree.flatten_with_paths(tmpl)] == \
        [p for p, _ in jmasking.leaves_with_paths(jtmpl)]
    assert [tuple(a.shape) for a in tree.leaves(tmpl)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jtmpl)]
    # C = d_in + 2 G N = 160: not a multiple of 128
    assert tuple(tstate["weights"]["layers"]["conv"]["w_conv"].shape) == \
        (2, 4, 160)


def _f32(tree_):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else x.astype(jnp.float32), tree_,
        is_leaf=_NONE)


@pytest.mark.parametrize("cohort,mode,dtype", [
    (0, "sample", "bf16"), (1, "threshold", "bf16"), (0, "sample", "f32")])
def test_smoke_logits_and_loss_match_jax(apis, cohort, mode, dtype):
    """The fused masked forward on the same state and tokens.  With the
    weights and floats (the embedding too) cast to f32 every activation
    is f32 in both packages, which checks the semantics free of bf16
    rounding placement."""
    japi, tapi, init = apis
    jstate = _state(init, 5)
    if dtype == "f32":
        jstate = dict(jstate, weights=_f32(jstate["weights"]),
                      floats=_f32(jstate["floats"]))
    np_state = _np(jstate)
    tokens = np.random.default_rng(0).integers(0, 256, (C, 2, 32))
    pick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t, is_leaf=_NONE)
    jparams = jmasking.masked_forward_tree(
        jmasking.MaskedParams(jstate["weights"], pick(jstate["scores"]),
                              pick(jstate["floats"])),
        lambda i: jmasking.mask_stream_seed(3, 0, i, cohort,
                                            run_seed=RUN_SEED),
        mode=mode, tau=0.5)
    jbatch = {"tokens": jnp.asarray(tokens[cohort], jnp.int32)}
    jout = jax.jit(japi.forward)(jparams, jbatch)
    jlogits = np.asarray(jout[0])
    jloss = float(japi.loss(jout, jbatch))

    tstate = convert.state_from_jax(np_state, "cpu")
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tparams = masking.masked_forward_tree(
        MaskedParams(tstate["weights"], tpick(tstate["scores"]),
                     tpick(tstate["floats"])),
        lambda i: masking.mask_stream_seed(3, 0, i, cohort, RUN_SEED),
        mode=mode, tau=0.5)
    tbatch = {"tokens": torch.from_numpy(tokens[cohort])}
    with torch.no_grad():
        tout = tapi.forward(tparams, tbatch)
        tloss = float(tapi.loss(tout, tbatch))
    tlogits = tout[0].numpy()
    assert tlogits.shape == jlogits.shape == (2, 32, 256)
    scale = np.abs(jlogits).max()
    diff = np.abs(tlogits - jlogits)
    if dtype == "f32":
        # f32 sums in another order through 2 layers and the SSD scan
        assert diff.max() <= 1e-4 * scale, diff.max() / scale
        assert diff.mean() <= 1e-5 * scale, diff.mean() / scale
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
        return
    # bf16 activations through 2 layers, each framework rounding its bf16
    # ops (silu, the gated norm, the residual adds) at its own points:
    # the internlm2 SMOKE bound of 6% of the logit scale at worst, 0.5% on
    # average; the loss to 0.2%
    assert diff.max() <= 0.06 * scale, diff.max() / scale
    assert diff.mean() <= 0.005 * scale, diff.mean() / scale
    assert abs(tloss - jloss) <= 2e-3 * abs(jloss)


def test_fused_forward_equals_materialized(apis):
    """The fused forward (dense and conv kernels' plain versions) and the
    materialized twin (`hash_effective`: m*w from the same streams, the
    plain product and the mask-free conv) give the same logits: the
    masks are the same bits, the conv the same taps in the same order."""
    _, tapi, init = apis
    tstate = convert.state_from_jax(_np(_state(init, 7)), "cpu")
    pick = lambda t: tree.tree_map(lambda x: None if x is None else x[0], t)
    mp = MaskedParams(tstate["weights"], pick(tstate["scores"]),
                      pick(tstate["floats"]))
    seed_fn = lambda i: masking.mask_stream_seed(2, 0, i, 0, RUN_SEED)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 32)))}
    with torch.no_grad():
        fused = tapi.forward(masking.masked_forward_tree(mp, seed_fn), batch)
        plain = tapi.forward(masking.hash_effective(mp, seed_fn), batch)
    scale = plain[0].abs().max()
    # the internlm2-sized bound for bf16 rounding placement
    assert (fused[0] - plain[0]).abs().max() <= 0.06 * scale
    assert (fused[0] - plain[0]).abs().mean() <= 0.005 * scale


def _update_agreement(s0, jtree, ttree):
    out = []
    for a0, a, b in zip(s0, _jleaves(jtree), _tleaves(ttree)):
        a0, a = a0.astype(np.float32), a.astype(np.float32)
        dj, dt = (a - a0).ravel(), (b - a0).ravel()
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


def test_train_step_matches(apis):
    """Loss and per-leaf score and float updates of one step within the
    bounds set for internlm2 SMOKE from the reference's own jit/eager
    spread of bf16 rounding (tests/test_torch_steps.py)."""
    japi, tapi, init = apis
    jstate = _state(init, 1)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 2, 32))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED)
    s0, f0 = _jleaves(jstate["scores"]), _jleaves(jstate["floats"])
    jstate, jm = jax.jit(jsteps.make_train_step(
        japi, jsteps.StepConfig(**kw)))(
            jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tstate, tm = steps.make_train_step(tapi, steps.StepConfig(**kw))(
        tstate, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-4 * abs(float(jm["loss"]))
    agree = _update_agreement(s0, jstate["scores"], tstate["scores"]) + \
        _update_agreement(f0, jstate["floats"], tstate["floats"])
    for rel, cos in agree:
        assert rel <= 0.3 and cos >= 0.97, (rel, cos)
    assert tstate["step"] == int(jstate["step"]) == 1


def assert_words_exact(jstate, step):
    flat = jax.tree_util.tree_leaves(jstate["scores"], is_leaf=_NONE)
    for i, sl in enumerate(flat):
        if sl is None:
            continue
        rows = sl.reshape(C, -1)
        seeds = [masking.mask_stream_seed(step, 0, i, c, RUN_SEED)
                 for c in range(C)]
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            rows, jnp.asarray(seeds, jnp.uint32), use_kernel=True))
        tw = aggregation.sample_and_pack_rows(
            torch.from_numpy(np.array(rows)), seeds).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
        assert np.array_equal(
            ref.popcount32(torch.from_numpy(tw)).sum(1).numpy(),
            np.asarray(jax.lax.population_count(jw)).sum(1))


def test_round_exact(apis):
    """On identical scores a round is exact: per-leaf masks as packed
    words and popcounts (every (L, W, C) conv and projection leaf
    flattened whole), theta and the codec's measured bits; bpp to the
    last bit of its log2."""
    japi, tapi, init = apis
    jstate = _state(init, 2)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    kw = dict(seed=RUN_SEED, downlink_bits=0)
    assert_words_exact(jstate, 5)
    jout, jm = jax.jit(jsteps.make_round_step(
        japi, jsteps.StepConfig(**kw)))(jstate)
    tout, tm = steps.make_round_step(tapi, steps.StepConfig(**kw))(tstate)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        # theta in {0, 1/2, 1} with C = 2: the same class, same logit
        assert np.array_equal(np.sign(b), np.sign(a))
        np.testing.assert_allclose(b, a, rtol=1e-6)
    for key in ("bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    # torch's and XLA's CPU log2 may differ in the last bit (ROADMAP
    # Queue 3): one float32 ulp of 1.0
    assert abs(float(tm["bpp"]) - float(jm["bpp"])) <= 2.0 ** -23
    assert 0.0 < float(tm["bpp"]) <= 1.0
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b.astype(np.float32), a.astype(np.float32))
    assert tout["step"] == int(jout["step"]) == 6
