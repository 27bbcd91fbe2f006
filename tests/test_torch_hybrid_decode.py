"""The port's hybrid decode (recurrentgemma: the RG-LRU step with its
conv buffer, the ring KV cache of the local MQA blocks, the rec tail)
against the JAX package on recurrentgemma SMOKE (5 layers: one (rec,
rec, attn) group and a 2-layer rec tail, window 8), from one frozen tree
carried across, over 12 tokens so the ring wraps: in f32 within twice the reference's
own spread under a one-ulp move of the RG-LRU gate's exp(2 log_a), in
bf16 within the reference's own jit-vs-eager spread, the caches
included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model, hybrid, transformer
from repro_torch.models import layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, STEPS = "recurrentgemma-9b", 12
_NONE = lambda x: x is None


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def _f32(t):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, t)


@pytest.fixture(scope="module")
def frozen():
    """(JAX api, JAX frozen sample-mode tree, port api)."""
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    jmp = jax.jit(lambda k: jmasking.init_masked(
        k, japi.init_params(k), jmasking.MaskSpec()))(jax.random.PRNGKey(8))
    jfz = jax.jit(lambda m: jmasking.freeze_identity(
        m, jmasking.MaskIdentity(seed=12, mode="sample")))(jmp)
    return japi, jfz, build_model(get_config(ARCH, smoke=True))


def test_init_cache_layout_matches_jax():
    """Keys, shapes, dtypes and contents (zeros, ring positions at
    -2**30) equal the reference's, the ring cut to the window."""
    cfg = jget_config(ARCH, smoke=True)
    for S in (5, 16):
        jc = jhybrid.init_cache(cfg, 3, S)
        tc = hybrid.init_cache(get_config(ARCH, smoke=True), 3, S, "cpu")
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).split(".")[1] == jc[k].dtype.name
            assert np.array_equal(tc[k].float().numpy(),
                                  np.asarray(jc[k], np.float32))
        assert tc["k"].shape[3] == min(S, cfg.sliding_window)
    assert transformer.NEG_BIG == jhybrid.NEG_POS


def test_ring_mask_hides_unwritten_slots():
    """The port's causal mask drops a key at -2**30 under any window, as
    the reference's does, and keeps the last `window` positions."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    q = np.array([3, 11], np.int64)
    k = np.array([-(1 << 30), 0, 3, 4, 10, 11], np.int32)
    for window in (None, 8):
        want = np.asarray(jlayers._attn_scores_mask(
            jnp.asarray(q), jnp.asarray(k), window))
        got = layers._causal_mask(torch.from_numpy(q), torch.from_numpy(k),
                                  window).numpy()
        assert np.array_equal(got, want)
        if window:
            assert (got[:, 0] < -1e29).all()


def _tokens(cfg, B=2):
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, STEPS))


def _jax_decode(japi, jtree, dtype, B=2):
    """STEPS tokens through a fresh jit of the reference's decode (fresh,
    so a patched `_rec_step` is traced anew); (logits (STEPS, B, V),
    final cache) as numpy."""
    cfg = japi.cfg
    tokens = _tokens(cfg, B)
    jc = jhybrid.init_cache(cfg, B, STEPS, dtype=dtype)
    dec = jax.jit(lambda *a: japi.decode_step(*a))
    logits = []
    for t in range(STEPS):
        jl, jc = dec(jtree, jc, jnp.asarray(tokens[:, t], jnp.int32),
                     jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(jl))
    return np.stack(logits), {k: np.asarray(v) for k, v in jc.items()}


def _port_decode(api, ttree, dtype, B=2):
    tokens = _tokens(api.cfg, B)
    tc = hybrid.init_cache(api.cfg, B, STEPS, "cpu", dtype=dtype)
    logits = []
    for t in range(STEPS):
        tl, tc = api.decode_step(ttree, tc, torch.from_numpy(tokens[:, t]),
                                 t)
        assert tl.dtype == torch.float32
        logits.append(tl.numpy())
    return np.stack(logits), tc


def _decode_both(japi, jtree, api, ttree, dtype, eager, B=2):
    """STEPS tokens through the reference's jitted decode (and, with
    `eager`, its eager one) and the port's; returns (port vs jit, eager
    vs jit, logit scale, final JAX cache, final port cache)."""
    cfg = japi.cfg
    tokens = _tokens(cfg, B)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = jhybrid.init_cache(cfg, B, STEPS, dtype=jdt)
    je = jhybrid.init_cache(cfg, B, STEPS, dtype=jdt)
    tc = hybrid.init_cache(api.cfg, B, STEPS, "cpu", dtype=dtype)
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


def _jax_rec_step(e2_ulps):
    """The reference's RG-LRU decode step (`repro.models.hybrid._rec_step`,
    copied op for op) with exp(2 log_a) moved `e2_ulps` f32 ulps up (0:
    the reference's step itself)."""
    L = jlayers

    def step(cfg, lp, x_t, h_prev, conv_buf):
        gate = jax.nn.gelu(
            L.masked_dense_apply(x_t, lp["w_y"]).astype(jnp.float32))
        u = L.masked_dense_apply(x_t, lp["w_x"])
        conv_buf, u = L.conv1d_step(lp["conv"], conv_buf, u)
        u = u.astype(jnp.float32)
        r = jax.nn.sigmoid(L.masked_dense_apply(u, lp["w_rg"])
                           .astype(jnp.float32) + lp["bias_rg"])
        i = jax.nn.sigmoid(L.masked_dense_apply(u, lp["w_ri"])
                           .astype(jnp.float32) + lp["bias_ri"])
        log_a = -jhybrid._C * jax.nn.softplus(lp["a_param"]) * r
        a = jnp.exp(log_a)
        e2 = jnp.exp(2 * log_a)
        for _ in range(e2_ulps):
            e2 = jnp.nextafter(e2, jnp.float32(np.inf))
        h = a * h_prev + jnp.sqrt(jnp.maximum(1 - e2, 1e-12)) * (i * u)
        return L.masked_dense_apply((h * gate).astype(x_t.dtype),
                                    lp["w_out"]), h, conv_buf

    return step


@pytest.fixture(scope="module")
def f32_reference(frozen):
    """The reference's f32 decode and its own spread: (f32 JAX tree, port
    tree, logits, final cache, logit spread, per-cache spread).  The
    spread is how far the reference's logits and caches move when the
    RG-LRU gate's exp(2 log_a) moves one f32 ulp up in every layer: the
    gate sqrt(1 - exp(2 log_a)) turns one ulp of exp into up to 4e-4 of
    the gate where a = exp(log_a) is near 1, and the recurrence carries
    it on.  torch's and XLA's CPU exp, softplus and gelu differ by one
    ulp on a few percent of their inputs (which ones depends on the
    machine's vector code), so the port sits inside that spread, not
    inside a fixed share of the scale."""
    japi, jfz, api = frozen
    f32 = _f32(jfz)
    logits, cache = _jax_decode(japi, f32, jnp.float32)
    orig = jhybrid._rec_step
    try:
        jhybrid._rec_step = _jax_rec_step(0)
        copy_logits, _ = _jax_decode(japi, f32, jnp.float32)
        jhybrid._rec_step = _jax_rec_step(1)
        up_logits, up_cache = _jax_decode(japi, f32, jnp.float32)
    finally:
        jhybrid._rec_step = orig
    # the copied step is the reference's, bit for bit
    assert np.array_equal(copy_logits, logits)
    spread = float(np.abs(up_logits - logits).max())
    cache_spread = {k: float(np.abs(up_cache[k].astype(np.float32)
                                    - cache[k].astype(np.float32)).max())
                    for k in cache}
    ttree = convert.tree_to_torch(_np(f32), "cpu")
    return api, ttree, logits, cache, spread, cache_spread


def _f32_violations(ref, port_logits, tc):
    """What of the port's f32 decode lies outside its bound: the logits
    beyond max(2 x the reference's one-ulp spread, 2e-5 of the logit
    scale), a cache beyond max(2 x its spread, 1e-4 of its scale), a ring
    position not equal."""
    _, _, logits, cache, spread, cache_spread = ref
    out = []
    scale = float(np.abs(logits).max())
    err = float(np.abs(port_logits - logits).max())
    if not err <= max(2 * spread, 2e-5 * scale):
        out.append(("logits", err, spread, scale))
    for k, want in cache.items():
        got = tc[k].float().numpy()
        want = want.astype(np.float32)
        if k == "k_pos":
            if not np.array_equal(got, want):
                out.append((k,))
            continue
        err = float(np.abs(got - want).max())
        sc = float(np.abs(want).max())
        if not err <= max(2 * cache_spread[k], 1e-4 * sc):
            out.append((k, err, cache_spread[k], sc))
    return out


def test_decode_step_f32_matches_jax(f32_reference):
    """All-f32 tree and caches: 12 steps (the ring of 8 wraps) within
    twice the reference's own one-ulp spread (`f32_reference`), never
    looser than 2e-5 of the logit scale and 1e-4 of each cache's scale;
    the ring's key positions exactly.  Measured on an AVX-512 CPU: the
    port 7.1e-5 from the reference's logits at a scale of 0.636, the
    spread 1.25e-4; the rec tail's state 9.4e-3 off at a scale of 32.1
    against a spread of 1.4e-2."""
    api, ttree, *_ = f32_reference
    port_logits, tc = _port_decode(api, ttree, torch.float32)
    assert _f32_violations(f32_reference, port_logits, tc) == []
    assert sorted(tc["k_pos"][0, 0].tolist()) == list(range(4, 12))


def _port_rec_step_wrong_gate(cfg, lp, x_t, h_prev, conv_buf):
    """The port's RG-LRU step with the gate sqrt(1 - a) in place of
    sqrt(1 - a^2): a wrong model the f32 bound must catch."""
    L = layers
    gate = L.ACTIVATIONS["gelu"](
        L.masked_dense_apply(x_t, lp["w_y"]).float())
    u = L.masked_dense_apply(x_t, lp["w_x"])
    u = L.conv1d_step(lp["conv"], conv_buf, u).float()
    r = torch.sigmoid(L.masked_dense_apply(u, lp["w_rg"]).float()
                      + lp["bias_rg"])
    i = torch.sigmoid(L.masked_dense_apply(u, lp["w_ri"]).float()
                      + lp["bias_ri"])
    a = torch.exp(-hybrid._C * L.softplus(lp["a_param"]) * r)
    h = a * h_prev + torch.sqrt(torch.clamp(1 - a, min=1e-12)) * (i * u)
    h_prev.copy_(h)
    return L.masked_dense_apply((h * gate).to(x_t.dtype), lp["w_out"])


@pytest.mark.parametrize("fault", ["wrong_gate", "skipped_tail"])
def test_decode_step_f32_bound_catches_a_wrong_model(f32_reference,
                                                      monkeypatch, fault):
    """The f32 bound is tight enough to fail the port with the RG-LRU
    gate sqrt(1 - a) for sqrt(1 - a^2), or with its 2-layer rec tail
    skipped."""
    api, ttree, *_ = f32_reference
    if fault == "wrong_gate":
        monkeypatch.setattr(hybrid, "_rec_step", _port_rec_step_wrong_gate)
    else:
        ttree = {k: v for k, v in ttree.items() if k != "tail"}
    port_logits, tc = _port_decode(api, ttree, torch.float32)
    bad = _f32_violations(f32_reference, port_logits, tc)
    assert bad and bad[0][0] == "logits", bad


def test_decode_step_bf16_within_reference_spread(frozen):
    """bf16 tree and caches: the port within twice the reference's own
    jit-vs-eager spread of its jitted decode (or 1e-3 of the scale).
    The hybrid's bf16 gates and recurrence move further than the dense
    families': the reference's jitted and eager decodes differ by 3.7%
    of the logit scale here, and the port sits 3.8% from the jitted one;
    it is also held within 6% of the scale, the SMOKE training forward's
    bound."""
    japi, jfz, api = frozen
    port, spread, scale, _, _ = _decode_both(
        japi, jfz, api, convert.tree_to_torch(_np(jfz), "cpu"),
        torch.bfloat16, eager=True)
    assert port <= max(2 * spread, 1e-3 * scale), (port, spread, scale)
    assert port <= 0.06 * scale, (port, scale)
