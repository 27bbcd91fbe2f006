"""The port's gemma3-4b (5 sliding-window local layers to 1 global, a
rope theta per kind, gelu-tanh MLPs) against the JAX package on gemma3
SMOKE (6 layers, window 8): `layer_windows`, the fused masked training
forward at 32 tokens, and the KV-cache decode over 24 tokens, full-cache
and `window_kv_cache` (ring caches that wrap), from one state carried
across.  Tolerances: f32 logits to 2e-5 of their scale for decode and
1e-4 for the forward (sums in another order); bf16 within the
reference's own jit-vs-eager spread."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.models import build_model, transformer
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, STEPS, RUN_SEED = "gemma3-4b", 24, 17
_NONE = lambda x: x is None
_WIN = lambda cfg: dataclasses.replace(cfg, window_kv_cache=True)


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def _f32(t):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, t, is_leaf=_NONE)


@pytest.mark.parametrize("arch,smoke", [
    ("gemma3-4b", True), ("gemma3-4b", False), ("internlm2-1.8b", False),
    ("deepseek-v2-lite-16b", False)])
def test_layer_windows_match_jax(arch, smoke):
    """Windows and thetas per layer; a global layer's window is None
    here and 1 << 30 (no window in effect) in the reference."""
    jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jw, jt = jtransformer.layer_windows(jcfg, jcfg.n_layers)
    tw, tt = transformer.layer_windows(cfg, cfg.n_layers)
    assert [jtransformer.NEG_BIG if w is None else w for w in tw] == \
        np.asarray(jw).tolist()
    assert np.array_equal(np.asarray(tt, np.float32), np.asarray(jt))
    if arch == "gemma3-4b":
        assert tw.count(None) == cfg.n_layers // 6 and \
            tw[5] is None and tw[0] == cfg.sliding_window


def test_config_matches_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)).items() <= \
            dataclasses.asdict(jget_config(ARCH, smoke=smoke)).items()


@pytest.fixture(scope="module")
def state():
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    st = jax.jit(lambda k: jsteps.init_fed_state(
        k, japi, jmasking.MaskSpec(), C=2))(jax.random.PRNGKey(5))
    k = jax.random.PRNGKey(105)
    st["scores"] = jax.tree_util.tree_map(
        lambda s: None if s is None else s + 2.0 * jax.random.normal(
            k, s.shape), st["scores"], is_leaf=_NONE)
    return japi, st


@pytest.mark.parametrize("cohort,mode,dtype", [
    (0, "sample", "bf16"), (1, "threshold", "bf16"), (0, "sample", "f32")])
def test_smoke_logits_and_loss_match_jax(state, cohort, mode, dtype):
    """The fused masked forward on 32 tokens (4 windows): every layer with
    its own window and theta.  With the weights and floats cast to f32
    every activation is f32 in both packages."""
    japi, jstate = state
    if dtype == "f32":
        jstate = dict(jstate, weights=_f32(jstate["weights"]),
                      floats=_f32(jstate["floats"]))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 2, 32))
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

    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tparams = masking.masked_forward_tree(
        MaskedParams(tstate["weights"], tpick(tstate["scores"]),
                     tpick(tstate["floats"])),
        lambda i: masking.mask_stream_seed(3, 0, i, cohort, RUN_SEED),
        mode=mode, tau=0.5)
    api = build_model(get_config(ARCH, smoke=True))
    tbatch = {"tokens": torch.from_numpy(tokens[cohort])}
    with torch.no_grad():
        tout = api.forward(tparams, tbatch)
        tloss = float(api.loss(tout, tbatch))
    tlogits = tout[0].numpy()
    assert tlogits.shape == jlogits.shape == (2, 32, 256)
    scale = np.abs(jlogits).max()
    diff = np.abs(tlogits - jlogits)
    if dtype == "f32":
        assert diff.max() <= 1e-4 * scale, diff.max() / scale
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
        return
    # bf16 activations through 6 layers, each framework rounding its bf16
    # ops at its own points: the reference's own jitted and eager
    # forwards of these states differ by up to 6.4% of the logit scale
    # (0.56% on average); the port is held to twice that, and the loss
    # to 0.2%
    assert diff.max() <= 0.13 * scale, diff.max() / scale
    assert diff.mean() <= 0.011 * scale, diff.mean() / scale
    assert abs(tloss - jloss) <= 2e-3 * abs(jloss)


@pytest.fixture(scope="module")
def frozen():
    """(JAX frozen sample-mode tree, its port twin) of one state."""
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    jmp = jax.jit(lambda k: jmasking.init_masked(
        k, japi.init_params(k), jmasking.MaskSpec()))(jax.random.PRNGKey(9))
    jfz = jax.jit(lambda m: jmasking.freeze_identity(
        m, jmasking.MaskIdentity(seed=13, mode="sample")))(jmp)
    return jfz, convert.tree_to_torch(_np(jfz), "cpu")


def test_windowed_cache_layout_matches_jax():
    jcfg, cfg = _WIN(jget_config(ARCH, smoke=True)), _WIN(
        get_config(ARCH, smoke=True))
    for S in (5, 24):
        jc = jtransformer.init_cache_windowed(jcfg, 2, S)
        tc = build_model(cfg).init_cache(2, S, "cpu")
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).split(".")[1] == jc[k].dtype.name
            assert np.array_equal(tc[k].float().numpy(),
                                  np.asarray(jc[k], np.float32))


def _decode_both(windowed, jtree, ttree, dtype, eager, B=2):
    """STEPS tokens through the reference's jitted decode (and, with
    `eager`, its eager one) and the port's; returns (port vs jit, eager
    vs jit, logit scale, final JAX cache, final port cache)."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if windowed:
        jcfg, cfg = _WIN(jcfg), _WIN(cfg)
    japi, api = jbuild_model(jcfg), build_model(cfg)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jinit = (jtransformer.init_cache_windowed if windowed
             else jtransformer.init_cache)
    tinit = (transformer.init_cache_windowed if windowed
             else transformer.init_cache)
    jc, je = (jinit(jcfg, B, STEPS, dtype=jdt) for _ in range(2))
    tc = tinit(cfg, B, STEPS, "cpu", dtype=dtype)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, STEPS))
    dec = jax.jit(japi.decode_step)
    port = spread = scale = 0.0
    for t in range(STEPS):
        tok, pos = jnp.asarray(tokens[:, t], jnp.int32), jnp.asarray(
            t, jnp.int32)
        jl, jc = dec(jtree, jc, tok, pos)
        if eager:
            with jax.disable_jit():
                el, je = japi.decode_step(jtree, je, tok, pos)
            spread = max(spread, float(np.abs(np.asarray(el)
                                              - np.asarray(jl)).max()))
        tl, tc = api.decode_step(ttree, tc, torch.from_numpy(tokens[:, t]),
                                 t)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        port = max(port, float(np.abs(tl.numpy() - jl).max()))
        scale = max(scale, float(np.abs(jl).max()))
    return port, spread, scale, jc, tc


@pytest.mark.parametrize("windowed", (False, True))
def test_decode_step_f32_matches_jax(frozen, windowed):
    """All-f32 tree and caches, 24 tokens (the rings of 8 wrap twice):
    the reference's logits to f32 rounding, 2e-5 of their scale; the
    caches to 1e-5 of their scales, the rings' positions exactly."""
    jfz, _ = frozen
    f32 = _f32(jfz)
    port, _, scale, jc, tc = _decode_both(
        windowed, f32, convert.tree_to_torch(_np(f32), "cpu"),
        torch.float32, eager=False)
    assert port <= 2e-5 * scale, (port, scale)
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    tflat = tree.flatten_with_paths(tc)
    assert len(jflat) == len(tflat)
    for (_, want), (k, got) in zip(jflat, tflat):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        if k.endswith("pos"):
            assert np.array_equal(got, want), k
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=k,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("windowed", (False, True))
def test_decode_step_bf16_within_reference_spread(frozen, windowed):
    """bf16 tree and caches: the port within twice the reference's own
    jit-vs-eager spread of its jitted decode (or 1e-3 of the scale).
    Over gemma3's 6 layers and gelu MLPs that spread is 3.7% (full
    cache) and 4.9% (rings) of the logit scale, and the port sits 4.1%
    and 5.2% from the jitted decode; it is also held within 10%."""
    jfz, tfz = frozen
    port, spread, scale, _, _ = _decode_both(windowed, jfz, tfz,
                                             torch.bfloat16, eager=True)
    assert port <= max(2 * spread, 1e-3 * scale), (port, spread, scale)
    assert port <= 0.1 * scale, (port, scale)


def test_windowed_decode_matches_full_cache():
    """The port's ring-cache decode against its full-cache decode on the
    same params, 24 tokens over a window of 8, within the reference's
    0.05 for the same property."""
    cfg = get_config(ARCH, smoke=True)
    full, ring = build_model(cfg), build_model(_WIN(cfg))
    gen = torch.Generator().manual_seed(5)
    params = full.init_params(gen)
    tokens = torch.randint(0, cfg.vocab, (2, STEPS), generator=gen)
    c1, c2 = full.init_cache(2, STEPS, "cpu"), ring.init_cache(2, STEPS,
                                                               "cpu")
    for t in range(STEPS):
        l1, c1 = full.decode_step(params, c1, tokens[:, t], t)
        l2, c2 = ring.decode_step(params, c2, tokens[:, t], t)
        assert float((l2 - l1).abs().max()) < 0.05, t
    bytes_ = lambda c: sum(x.numel() * x.element_size() for x in c.values()
                           for x in tree.leaves(x))
    big = (full.init_cache(1, 512, "cpu"), ring.init_cache(1, 512, "cpu"))
    assert bytes_(big[1]) < bytes_(big[0]) / 3
