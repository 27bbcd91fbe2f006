"""The port's train and round steps against the JAX package's
(`repro.launch.steps`, mesh=None) on internlm2 SMOKE, from one state
carried across by `convert.state_from_jax`.

Train steps agree within the bf16 rounding the two frameworks place
differently.  A round on identical scores is exact: the same hash
streams give the same words and popcounts, so theta (in {0, 1/2, 1}
with C = 2), bpp and the codec's measured bits are equal."""
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

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import aggregation, masking, tree
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

C = 2
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
    return (jbuild_model(jget_config("internlm2-1.8b", smoke=True)),
            build_model(get_config("internlm2-1.8b", smoke=True)))


def _state(japi, seed, optimizer="momentum", perturb=True):
    state = jsteps.init_fed_state(jax.random.PRNGKey(seed), japi,
                                  jmasking.MaskSpec(), C=C,
                                  optimizer=optimizer)
    if perturb:  # cohorts differ, thetas spread over (0, 1)
        k = jax.random.PRNGKey(seed + 100)
        state["scores"] = jax.tree_util.tree_map(
            lambda s: None if s is None else
            s + 2.0 * jax.random.normal(k, s.shape), state["scores"],
            is_leaf=_NONE)
    return state


def _update_agreement(s0, jtree, ttree):
    """Per leaf: (relative norm of the difference, cosine) between the
    port's and the reference's updates since s0."""
    out = []
    for a0, a, b in zip(s0, _jleaves(jtree), _tleaves(ttree)):
        a0, a = a0.astype(np.float32), a.astype(np.float32)
        dj, dt = (a - a0).ravel(), (b - a0).ravel()
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_two_train_steps_match(apis, optimizer):
    """Tolerances are set from the reference's own rounding spread: its
    jit and eager runs of these steps (bf16 activations rounded at other
    points) differ in loss by 0.02% after one step and 0.2% after two,
    and in the per-leaf score update, after one step, by relative norm
    <= 0.13 (cosine >= 0.99) under momentum and <= 0.36 (cosine >= 0.93)
    under adam, whose first update is about lr * sign(g); after two
    steps, whose masks are drawn from already different scores, by
    <= 0.55 (cosine >= 0.85)."""
    japi, tapi = apis
    jstate = _state(japi, 1, optimizer)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 2, 16))
    kw = dict(lam=1.0, lr=0.3, optimizer=optimizer, seed=17)
    jstep = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(**kw)))
    tstep = steps.make_train_step(tapi, steps.StepConfig(**kw))
    s0, f0 = _jleaves(jstate["scores"]), _jleaves(jstate["floats"])
    first = (0.3, 0.97) if optimizer == "momentum" else (0.5, 0.9)
    bounds = [(1e-4,) + first, (5e-3, 0.9, 0.7)]
    for i, (loss_rtol, max_rel, min_cos) in enumerate(bounds):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= loss_rtol * abs(float(jm["loss"]))
        # scores, and after the first step the float leaves (norm
        # scales, embedding tables) too
        agree = _update_agreement(s0, jstate["scores"], tstate["scores"])
        if i == 0:
            agree += _update_agreement(f0, jstate["floats"], tstate["floats"])
        for rel, cos in agree:
            assert rel <= max_rel and cos >= min_cos, (rel, cos)
    assert tstate["step"] == int(jstate["step"]) == 2


def test_train_step_regularizer_gradient_matches(apis):
    """With lam large the eq. 12 proxy's gradient (lam/n) sigmoid'(s)
    dominates the update, which then agrees to f32 rounding."""
    japi, tapi = apis
    jstate = _state(japi, 6)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(2).integers(0, 256, (C, 2, 16))
    kw = dict(lam=1e5, lr=0.01, seed=17)
    s0 = _jleaves(jstate["scores"])
    jstate, _ = jax.jit(jsteps.make_train_step(
        japi, jsteps.StepConfig(**kw)))(
            jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tstate, _ = steps.make_train_step(tapi, steps.StepConfig(**kw))(
        tstate, {"tokens": torch.from_numpy(tokens)})
    for rel, cos in _update_agreement(s0, jstate["scores"],
                                      tstate["scores"]):
        assert rel <= 0.01 and cos >= 0.9999, (rel, cos)
    for a, b in zip(_jleaves(jstate["opt_m"]), _tleaves(tstate["opt_m"])):
        assert np.linalg.norm(b - a) <= 0.01 * np.linalg.norm(a)


def _theta_class(scores):
    """Which of theta in {0, 1/2, 1} each reset score came from (scores
    are logit(theta) with theta clipped: negative, zero or positive)."""
    return np.sign(scores).astype(np.int8)


def _run_round(japi, tapi, jstate, cfg_kw, participation=None, codec=None,
               downlink_u=None):
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    jr = jax.jit(jsteps.make_round_step(japi, jsteps.StepConfig(**cfg_kw),
                                        codec=codec))
    tr = steps.make_round_step(tapi, steps.StepConfig(**cfg_kw), codec=codec)
    if participation is None:
        jout, jm = jr(jstate)
        tout, tm = tr(tstate, downlink_u=downlink_u)
    else:
        jout, jm = jr(jstate, jnp.asarray(participation))
        tout, tm = tr(tstate, participation, downlink_u=downlink_u)
    return jout, jm, tout, tm


def _words_match(jstate, cfg_kw):
    """Per-leaf packed words and per-cohort popcounts, exactly."""
    mode = cfg_kw.get("mask_mode", "sample")
    flat = jax.tree_util.tree_leaves(jstate["scores"], is_leaf=_NONE)
    step = int(jstate["step"])
    for i, sl in enumerate(flat):
        if sl is None:
            continue
        rows = sl.reshape(C, -1)
        seeds = [masking.mask_stream_seed(step, 0, i, c, 17)
                 for c in range(C)]
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            rows, jnp.asarray(seeds, jnp.uint32), use_kernel=True,
            mode=mode))
        tw = aggregation.sample_and_pack_rows(
            torch.from_numpy(np.array(rows)), seeds, mode=mode).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
        assert np.array_equal(
            ref.popcount32(torch.from_numpy(tw)).sum(1).numpy(),
            np.asarray(jax.lax.population_count(jw)).sum(1))


@pytest.mark.parametrize("algo,codec", [("fedpm_reg", "arithmetic"),
                                        ("fedpm_reg", "bitpack"),
                                        ("fedpm_reg", "golomb"),
                                        ("fedpm_reg", "signpack"),
                                        ("fedmask", "arithmetic")])
def test_round_exact(apis, algo, codec):
    japi, tapi = apis
    jstate = _state(japi, 2)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    kw = dict(seed=17, downlink_bits=0)
    if algo == "fedmask":
        kw.update(mask_mode="threshold", lam=0.0)
    _words_match(jstate, kw)
    jout, jm, tout, tm = _run_round(japi, tapi, jstate, kw, codec=codec)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert np.array_equal(_theta_class(b), _theta_class(a))
        np.testing.assert_allclose(b, a, rtol=1e-6)
    for key in ("bpp", "bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    assert 0.0 < float(tm["bpp"]) <= 1.0
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b.astype(np.float32), a.astype(np.float32))
    assert all(not m.any() for m in _tleaves(tout["opt_m"]))
    assert tout["step"] == int(jout["step"]) == 6


def test_round_with_participation_exact(apis):
    japi, tapi = apis
    jstate = _state(japi, 3)
    kw = dict(seed=17, downlink_bits=0)
    jout, jm, tout, tm = _run_round(japi, tapi, jstate, kw,
                                    participation=[1.0, 0.0])
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert np.array_equal(_theta_class(b), _theta_class(a))
        assert not (b == 0).any()  # one survivor: theta in {0, 1}
    for key in ("bpp", "bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key


def test_round_downlink_8bit_with_injected_uniforms(apis):
    """The downlink quantizer's threefry uniforms are injected, so the
    quantized theta levels are exactly the reference's."""
    japi, tapi = apis
    jstate = _state(japi, 4)
    kw = dict(seed=17, downlink_bits=8)
    step = int(jstate["step"])
    qkey = jax.random.PRNGKey(jmasking.mask_stream_seed(
        step, 0, jsteps._DOWNLINK_STREAM_LEAF, 0, run_seed=17))
    bodies = [s.shape[1:] for s in jax.tree_util.tree_leaves(
        jstate["scores"], is_leaf=_NONE) if s is not None]
    keys = jax.random.split(qkey, len(bodies))
    u = [torch.from_numpy(np.array(jax.random.uniform(k, b)))
         for k, b in zip(keys, bodies)]
    jout, jm, tout, tm = _run_round(japi, tapi, jstate, kw, downlink_u=u)
    level = lambda s: np.rint(torch.sigmoid(torch.tensor(s)).numpy()
                              * 255).astype(np.int64)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert np.array_equal(level(b), level(a))
    for key in ("bpp", "bits_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    assert float(tm["downlink_bpp"]) == 8.0


def test_generator_downlink_is_unbiased(apis):
    """Without injected uniforms the port quantizes with a seeded
    torch.Generator: levels straddle 255*theta and are reproducible."""
    _, tapi = apis
    theta = torch.full((4096,), 0.3)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    q1 = aggregation.quantize_theta([theta], g1)[0]
    q2 = aggregation.quantize_theta([theta], g2)[0]
    assert torch.equal(q1, q2)
    assert set(q1.unique().tolist()) == {76, 77}
    assert abs(float(aggregation.dequantize_theta([q1])[0].mean()) - 0.3) \
        < 2e-3
