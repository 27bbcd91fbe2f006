"""The port's MoE family (MLA attention, capacity-routed experts on the
grouped kernels) against the JAX package on deepseek-v2-lite SMOKE, from
one state carried across by `convert.state_from_jax`: logits, loss and
the summed aux loss of the fused masked forward, two train steps, and a
round that must be exact."""
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
from repro_torch.core.masking import MaskedParams
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, C, RUN_SEED = "deepseek-v2-lite-16b", 2, 17
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


def test_masked_leaves_and_flatten_order_match(apis):
    """19-leaf layout of the reference: 8 masked leaves in the dense
    stack, 11 in the MoE stack (MLA 5, shared 3, stacked experts 3), the
    router and the norm scales float, in the same flatten order."""
    japi, tapi, init = apis
    jstate = init(jax.random.PRNGKey(0))
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    js = jax.tree_util.tree_leaves(jstate["scores"], is_leaf=_NONE)
    ts = tree.leaves(tstate["scores"])
    assert [None if a is None else a.shape for a in js] == \
        [None if a is None else tuple(a.shape) for a in ts]
    assert sum(a is not None for a in ts) == 19
    paths = [p for p, _ in tree.flatten_with_paths(tstate["floats"])]
    floats = [p for p, a in zip(paths, tree.leaves(tstate["floats"]))
              if a is not None]
    assert "moe_layers/moe/router_w" in floats
    assert "moe_layers/attn/kv_norm_scale" in floats
    w_up = tstate["weights"]["moe_layers"]["moe"]["w_up"]
    assert tuple(w_up.shape) == (2, 4, 64, 32)  # (L, E, K, N)


@pytest.mark.parametrize("cohort,mode", [(0, "sample"), (1, "threshold")])
def test_smoke_logits_loss_and_aux_match_jax(apis, cohort, mode):
    japi, tapi, init = apis
    jstate = _state(init, 5)
    np_state = _np(jstate)
    tokens = np.random.default_rng(0).integers(0, 256, (C, 2, 16))
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
    jlogits, jaux = np.asarray(jout[0]), float(jout[1])
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
    tlogits, taux = tout[0].numpy(), float(tout[1])
    assert tlogits.shape == jlogits.shape == (2, 16, 256)
    # bf16 activations through 3 layers, each framework rounding its bf16
    # ops at its own points (the same bound as internlm2 SMOKE: 6% of the
    # logit scale at worst, 0.5% on average); the MoE aux loss sums
    # softmax means over 32 tokens whose inputs carry that rounding: 0.1%;
    # the loss (0.01 * aux included) to 0.2%
    scale = np.abs(jlogits).max()
    diff = np.abs(tlogits - jlogits)
    assert diff.max() <= 0.06 * scale, diff.max() / scale
    assert diff.mean() <= 0.005 * scale, diff.mean() / scale
    assert jaux > 0 and abs(taux - jaux) <= 1e-3 * jaux
    assert abs(tloss - jloss) <= 2e-3 * abs(jloss)


def test_fused_forward_equals_materialized(apis):
    """The fused forward (dense and grouped kernels' plain versions) and
    the materialized twin (`hash_effective`: m*w built once from the same
    streams, plain products) give the same logits and aux: the masks are
    the same bits, only bf16 rounding of the dense products differs."""
    _, tapi, init = apis
    tstate = convert.state_from_jax(_np(_state(init, 7)), "cpu")
    pick = lambda t: tree.tree_map(lambda x: None if x is None else x[0], t)
    mp = MaskedParams(tstate["weights"], pick(tstate["scores"]),
                      pick(tstate["floats"]))
    seed_fn = lambda i: masking.mask_stream_seed(2, 0, i, 0, RUN_SEED)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 16)))}
    with torch.no_grad():
        fused = tapi.forward(masking.masked_forward_tree(mp, seed_fn), batch)
        plain = tapi.forward(masking.hash_effective(mp, seed_fn), batch)
    scale = plain[0].abs().max()
    # the internlm2-sized bound for bf16 rounding placement
    assert (fused[0] - plain[0]).abs().max() <= 0.06 * scale
    assert (fused[0] - plain[0]).abs().mean() <= 0.005 * scale
    assert abs(float(fused[1]) - float(plain[1])) <= 1e-3 * float(plain[1])


def _update_agreement(s0, jtree, ttree):
    out = []
    for a0, a, b in zip(s0, _jleaves(jtree), _tleaves(ttree)):
        a0, a = a0.astype(np.float32), a.astype(np.float32)
        dj, dt = (a - a0).ravel(), (b - a0).ravel()
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


def test_two_train_steps_match(apis):
    """Loss and per-leaf score and float updates within the bounds set
    for internlm2 SMOKE from the reference's own jit/eager spread of
    bf16 rounding (tests/test_torch_steps.py); the router is a float
    leaf and moves with its gradient through the gates and the aux
    loss."""
    japi, tapi, init = apis
    jstate = _state(init, 1)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 2, 16))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED)
    jstep = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(**kw)))
    tstep = steps.make_train_step(tapi, steps.StepConfig(**kw))
    s0, f0 = _jleaves(jstate["scores"]), _jleaves(jstate["floats"])
    router_w = lambda st: st["floats"]["moe_layers"]["moe"]["router_w"]
    router0 = router_w(tstate).clone()
    bounds = [(1e-4, 0.3, 0.97), (5e-3, 0.9, 0.7)]
    for i, (loss_rtol, max_rel, min_cos) in enumerate(bounds):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= loss_rtol * abs(float(jm["loss"]))
        agree = _update_agreement(s0, jstate["scores"], tstate["scores"])
        if i == 0:
            agree += _update_agreement(f0, jstate["floats"], tstate["floats"])
        for rel, cos in agree:
            assert rel <= max_rel and cos >= min_cos, (rel, cos)
    assert not torch.equal(router_w(tstate), router0)
    assert tstate["step"] == int(jstate["step"]) == 2


def test_round_exact(apis):
    """On identical scores a round is exact: per-leaf words and
    popcounts (the (L, E, K, N) expert leaves flattened whole), theta and
    the codec's measured bits; bpp to the last bit of its log2."""
    japi, tapi, init = apis
    jstate = _state(init, 2)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    kw = dict(seed=RUN_SEED, downlink_bits=0)
    flat = jax.tree_util.tree_leaves(jstate["scores"], is_leaf=_NONE)
    for i, sl in enumerate(flat):
        if sl is None:
            continue
        rows = sl.reshape(C, -1)
        seeds = [masking.mask_stream_seed(5, 0, i, c, RUN_SEED)
                 for c in range(C)]
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            rows, jnp.asarray(seeds, jnp.uint32), use_kernel=True))
        tw = aggregation.sample_and_pack_rows(
            torch.from_numpy(np.array(rows)), seeds).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
        assert np.array_equal(
            ref.popcount32(torch.from_numpy(tw)).sum(1).numpy(),
            np.asarray(jax.lax.population_count(jw)).sum(1))
    jout, jm = jax.jit(jsteps.make_round_step(
        japi, jsteps.StepConfig(**kw)))(jstate)
    tout, tm = steps.make_round_step(tapi, steps.StepConfig(**kw))(tstate)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        # theta in {0, 1/2, 1} with C = 2: the same class, same logit
        assert np.array_equal(np.sign(b), np.sign(a))
        np.testing.assert_allclose(b, a, rtol=1e-6)
    for key in ("bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    # bpp is the binary entropy of the pooled popcount share, whose
    # inputs are equal above; torch's and XLA's CPU log2 differ in the
    # last bit on ~30% of arguments, so its value may differ by one
    # float32 ulp of 1.0
    assert abs(float(tm["bpp"]) - float(jm["bpp"])) <= 2.0 ** -23
    assert 0.0 < float(tm["bpp"]) <= 1.0
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b.astype(np.float32), a.astype(np.float32))
    assert tout["step"] == int(jout["step"]) == 6
