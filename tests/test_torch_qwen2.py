"""The dense configs that were missing, against the JAX package, from one
state carried across by `convert.state_from_jax`: qwen2-7b (GQA with qkv
bias, rope theta 1e6) and deepseek-7b (MHA) SMOKE logits and loss in
both mask modes, one qwen2 train step, a qwen2 round that must be exact
(masks, packed words, theta), the KV-cache decode of every position, the
float/masked split leaf for leaf with the biases as floats, and the
deepseek-v2-236b SMOKE logits (MLA with q-lora, 8 routed experts).

Tolerances.  With the float leaves (embedding, norms, biases) cast to
f32, every activation is f32 and only the order of the sums differs:
logits within 1e-4 of the logit scale (measured up to 2.5e-5), the loss
to 1e-5, the train
step's per-leaf updates within a relative norm of 1e-2 and a cosine of
0.9999 (the f32 bounds of tests/test_torch_steps.py), the f32 decode
within 2e-5 of the scale.  On the configs' bf16 activations each
framework rounds at its own points, and the reference's own jitted and
eager forwards differ by up to 8.3% of the logit scale at worst and
0.48% on average on these configs (qwen2-7b 6.2% / 0.47% sample, 8.3% /
0.48% threshold; deepseek-7b 1.7% / 0.20%; deepseek-v2-236b 7.9% /
0.21%), so the bf16 logits are held to twice that, 17% and 1%, and the
loss to 0.2%.  The round is exact but bpp, within one f32 ulp of 1.0
(log2)."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
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
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

C, RUN_SEED = 2, 17
_NONE = lambda x: x is None


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def _jleaves(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        t, is_leaf=_NONE) if x is not None]


def _tleaves(t):
    return [x.float().numpy() for x in tree.leaves(t) if x is not None]


def _jx(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _perturb_(state, seed):
    """Cohorts whose thetas spread over (0, 1), and non-zero biases (the
    init's are zero, which would hide them); in place."""
    gen = torch.Generator().manual_seed(seed)
    for s in tree.leaves(state["scores"]):
        if s is not None:
            s.add_(2.0 * torch.randn(s.shape, generator=gen))
    for p, f in tree.flatten_with_paths(state["floats"]):
        if f is not None and "bias" in p:
            f.add_((0.5 * torch.randn(f.shape, generator=gen)).to(f.dtype))
    return state


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(arch, JAX api, port api, a perturbed fed state as the JAX
    package's: jnp leaves, step int32), made once.  The state is drawn
    by the port's init (jitting the JAX init costs up to 19 s here) and
    handed to both packages."""
    japi = jbuild_model(jget_config(arch, smoke=True))
    tapi = build_model(get_config(arch, smoke=True))
    st = _perturb_(steps.init_fed_state(torch.Generator().manual_seed(5),
                                        tapi, masking.MaskSpec(), C=C), 5)
    jstate = {k: tree.tree_map(_jx, v) for k, v in st.items()
              if k != "step"}
    return arch, japi, tapi, dict(jstate, step=jnp.asarray(0, jnp.int32))


def _f32(state):
    """The state with its float leaves cast to f32."""
    return dict(state, floats=jax.tree_util.tree_map(
        lambda x: None if x is None else x.astype(jnp.float32),
        state["floats"], is_leaf=_NONE))


def _forward_both(japi, tapi, jstate, cohort, mode, tokens):
    pick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t, is_leaf=_NONE)
    jparams = jmasking.masked_forward_tree(
        jmasking.MaskedParams(jstate["weights"], pick(jstate["scores"]),
                              pick(jstate["floats"])),
        lambda i: jmasking.mask_stream_seed(3, 0, i, cohort,
                                            run_seed=RUN_SEED),
        mode=mode, tau=0.5)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jout = jax.jit(japi.forward)(jparams, jbatch)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tparams = masking.masked_forward_tree(
        MaskedParams(tstate["weights"], tpick(tstate["scores"]),
                     tpick(tstate["floats"])),
        lambda i: masking.mask_stream_seed(3, 0, i, cohort, RUN_SEED),
        mode=mode, tau=0.5)
    tbatch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        tout = tapi.forward(tparams, tbatch)
    return (np.asarray(jout[0]), float(japi.loss(jout, jbatch)),
            tout[0].numpy(), float(tapi.loss(tout, tbatch)))


@pytest.mark.parametrize("arch,cohort,mode", [
    ("qwen2-7b", 0, "sample"), ("qwen2-7b", 1, "threshold"),
    ("deepseek-7b", 0, "sample"), ("deepseek-7b", 1, "threshold"),
    ("deepseek-v2-236b", 0, "sample")])
def test_smoke_logits_and_loss_match_jax(arch, cohort, mode):
    """f32 activations: tight.  qwen2-7b's sample mode also on its bf16
    activations, within twice the reference's own spread."""
    _, japi, tapi, jstate = _pair(arch)
    tokens = np.random.default_rng(cohort).integers(0, 256, (2, 16))
    jl, jloss, tl, tloss = _forward_both(japi, tapi, _f32(jstate), cohort,
                                         mode, tokens)
    assert tl.shape == jl.shape == (2, 16, 256)
    scale = np.abs(jl).max()
    assert np.abs(tl - jl).max() <= 1e-4 * scale
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    if (arch, mode) == ("qwen2-7b", "sample"):
        jl, jloss, tl, tloss = _forward_both(japi, tapi, jstate, cohort,
                                             mode, tokens)
        scale = np.abs(jl).max()
        diff = np.abs(tl - jl)
        assert diff.max() <= 0.17 * scale, diff.max() / scale
        assert diff.mean() <= 0.01 * scale, diff.mean() / scale
        assert abs(tloss - jloss) <= 2e-3 * abs(jloss)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-7b",
                                  "deepseek-v2-236b"])
def test_split_leaf_for_leaf_with_biases_as_floats(arch):
    """`split_params` of the port's tree equals the reference's leaf for
    leaf; qwen2's biases are float leaves, 3 a layer stack."""
    _, japi, tapi, _ = _pair(arch)
    tparams = tapi.init_params(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_leaves(jmasking.split_params(
        tree.tree_map(_jx, tparams), jmasking.MaskSpec()))
    got = tree.leaves(masking.split_params(tparams, masking.MaskSpec()))
    assert [bool(g) for g in got] == [bool(w) for w in want]
    paths = [p for p, _ in tree.flatten_with_paths(tparams)]
    floats = {p for p, g in zip(paths, got) if not g}
    biases = {p for p in paths if "bias_" in p}
    if arch == "qwen2-7b":
        assert biases == {"layers/attn/bias_q", "layers/attn/bias_k",
                          "layers/attn/bias_v"}
    else:
        assert not biases
    assert biases <= floats
    # the reference's init makes the same tree: paths, shapes, dtypes
    ref = jax.eval_shape(japi.init_params, jax.random.PRNGKey(0))
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert jpaths == paths
    assert [(tuple(a.shape), str(a.dtype)) for a in
            jax.tree_util.tree_leaves(ref)] == \
        [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
         for a in tree.leaves(tparams)]


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-7b"])
def test_decode_every_position_matches_jax(arch):
    """All-f32 plain params (biases non-zero) and an f32 cache: 8 decode
    steps of the port against the reference's jitted decode."""
    _, japi, tapi, _ = _pair(arch)
    gen = torch.Generator().manual_seed(2)
    tp = tree.tree_map(lambda t: t.float(), tapi.init_params(gen))
    for p, t in tree.flatten_with_paths(tp):
        if "bias" in p:
            t.add_(0.5 * torch.randn(t.shape, generator=gen))
    jp = tree.tree_map(_jx, tp)
    cfg = japi.cfg
    B, S = 2, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    from repro.models import transformer as jtransformer
    jc = jtransformer.init_cache(cfg, B, S, dtype=jnp.float32)
    tc = tapi.init_cache(B, S, "cpu")
    tc = tree.tree_map(lambda t: t.float(), tc)
    dec = jax.jit(japi.decode_step)
    err, scale = 0.0, 0.0
    for t in range(S):
        jl, jc = dec(jp, jc, jnp.asarray(tokens[:, t], jnp.int32),
                     jnp.asarray(t, jnp.int32))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, t]), t)
        jl = np.asarray(jl)
        err = max(err, float(np.abs(tl.numpy() - jl).max()))
        scale = max(scale, float(np.abs(jl).max()))
    assert err <= 2e-5 * scale, (err, scale)


def _update_agreement(s0, jtree, ttree):
    out = []
    for a0, a, b in zip(s0, _jleaves(jtree), _tleaves(ttree)):
        a0, a = a0.astype(np.float32), a.astype(np.float32)
        dj, dt = (a - a0).ravel(), (b - a0).ravel()
        if not dj.any() and not dt.any():
            continue
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


def test_qwen2_train_step_matches():
    """One fedpm_reg step on f32 activations: the loss to 1e-5, every
    score leaf's update and every float leaf's update (the biases among
    them) within the f32 bounds; the biases move."""
    _, japi, tapi, jstate = _pair("qwen2-7b")
    jstate = _f32(jstate)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (C, 2, 16))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED)
    s0, f0 = _jleaves(jstate["scores"]), _jleaves(jstate["floats"])
    bias0 = tstate["floats"]["layers"]["attn"]["bias_q"].clone()
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        **kw)))(jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(**kw))(
        tstate, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    agree = _update_agreement(s0, jout["scores"], tout["scores"]) + \
        _update_agreement(f0, jout["floats"], tout["floats"])
    assert len(agree) >= 7 + 3
    for rel, cos in agree:
        assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)
    assert not torch.equal(tout["floats"]["layers"]["attn"]["bias_q"],
                           bias0)


def test_qwen2_round_exact():
    """On identical scores a round is exact: per-leaf packed words,
    theta, the floats' mean (biases included) and the codec's measured
    bits."""
    _, japi, tapi, jstate = _pair("qwen2-7b")
    jstate = dict(jstate, step=jnp.asarray(5, jnp.int32))
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    flat = jax.tree_util.tree_leaves(jstate["scores"], is_leaf=_NONE)
    for i, sl in enumerate(flat):
        if sl is None:
            continue
        seeds = [masking.mask_stream_seed(5, 0, i, c, RUN_SEED)
                 for c in range(C)]
        rows = np.asarray(sl).reshape(C, -1)
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            jnp.asarray(rows), jnp.asarray(seeds, jnp.uint32)))
        tw = aggregation.sample_and_pack_rows(torch.from_numpy(rows),
                                              seeds).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
    kw = dict(seed=RUN_SEED, downlink_bits=0)
    jout, jm = jax.jit(jsteps.make_round_step(
        japi, jsteps.StepConfig(**kw)))(jstate)
    tout, tm = steps.make_round_step(tapi, steps.StepConfig(**kw))(tstate)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert np.array_equal(np.sign(b), np.sign(a))
        np.testing.assert_allclose(b, a, rtol=1e-6)
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b.astype(np.float32), a.astype(np.float32))
    for key in ("bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    assert abs(float(tm["bpp"]) - float(jm["bpp"])) <= 2.0 ** -23
    assert 0.0 < float(tm["bpp"]) <= 1.0
