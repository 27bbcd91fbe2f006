"""The port's ssm decode (mamba2: the recurrent SSD step and the conv's
rolling buffer) against the JAX package on mamba2 SMOKE: `conv1d_step`
exactly in f32, and `decode_step` from one frozen tree carried across,
in f32 (to f32 rounding: 2e-5 of the logit scale) and in bf16 (within
the reference's own jit-vs-eager spread), its state included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import ssm as jssm

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking
from repro_torch.core.masking import MaskedLeaf
from repro_torch.models import build_model, layers, ssm
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH = "mamba2-370m"
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
        k, japi.init_params(k), jmasking.MaskSpec()))(jax.random.PRNGKey(7))
    jfz = jax.jit(lambda m: jmasking.freeze_identity(
        m, jmasking.MaskIdentity(seed=11, mode="sample")))(jmp)
    return japi, jfz, build_model(get_config(ARCH, smoke=True))


def _conv_inputs(B, W, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, W - 1, C)).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32),
            {"w_conv": rng.normal(size=(W, C)).astype(np.float32),
             "bias_conv": rng.normal(size=(C,)).astype(np.float32)})


def _conv_both(buf, x_t, p, dtype):
    """The reference's and the port's step on the same values, buffer,
    input and kernel in `dtype`; returns ((out, buf) JAX, (out, buf)
    port) as f32 numpy arrays."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = {"w_conv": jnp.asarray(p["w_conv"], jdt),
          "bias_conv": jnp.asarray(p["bias_conv"])}
    jbuf, jout = jlayers.conv1d_step(jp, jnp.asarray(buf, jdt),
                                     jnp.asarray(x_t, jdt))
    tp = {"w_conv": torch.from_numpy(p["w_conv"]).to(dtype),
          "bias_conv": torch.from_numpy(p["bias_conv"])}
    tbuf = torch.from_numpy(buf).to(dtype)
    tout = layers.conv1d_step(tp, tbuf, torch.from_numpy(x_t).to(dtype))
    f = lambda a: np.asarray(a, np.float32)
    return (f(jout), f(jbuf)), (tout.float().numpy(), tbuf.float().numpy())


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("B,W,C", [(2, 4, 48), (3, 3, 17), (4, 4, 64)])
def test_conv1d_step_matches_jax_exactly(B, W, C, dtype):
    """One rolling-buffer conv step on bf16-valued taps (the model's
    buffer and kernel dtype; here also carried in f32): every product is
    exact in f32, and the W products are summed in order, the bias added
    and the buffer shifted, bit for bit."""
    buf, x_t, p = _conv_inputs(B, W, C, B * 100 + C)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    buf, x_t, p["w_conv"] = bf(buf), bf(x_t), bf(p["w_conv"])
    (jout, jbuf), (tout, tbuf) = _conv_both(buf, x_t, p, dtype)
    assert np.array_equal(tout, jout)
    assert np.array_equal(tbuf, jbuf)


@pytest.mark.parametrize("B,W,C", [(2, 4, 48), (3, 3, 17)])
def test_conv1d_step_general_f32_to_one_rounding(B, W, C):
    """Full-precision f32 taps: the port sums the W products in order,
    each a fused multiply-add; XLA's CPU code fuses them for some rows
    and rounds each product for others, so the last bits differ (by a
    few f32 roundings of the W terms); the buffer shifts exactly."""
    buf, x_t, p = _conv_inputs(B, W, C, B * 100 + C)
    (jout, jbuf), (tout, tbuf) = _conv_both(buf, x_t, p, torch.float32)
    terms = np.abs(np.concatenate([buf, x_t[:, None]], 1)
                   * p["w_conv"]).sum(1) + np.abs(p["bias_conv"])
    assert (np.abs(tout - jout) <= W * 2.0 ** -23 * terms).all()
    assert np.array_equal(tbuf, jbuf)


def test_conv1d_step_masked_leaf_equals_frozen():
    """A `MaskedLeaf` kernel is materialized each step from the same
    stream `freeze_for_decode` uses: equal outputs and buffers."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 40, generator=gen).to(torch.bfloat16)
    s = 2 * torch.randn(4, 40, generator=gen)
    leaf = MaskedLeaf.build(w, s, seed=1234)
    bias = torch.randn(40, generator=gen)
    frozen = masking.freeze_for_decode({"w_conv": leaf})["w_conv"]
    x = torch.randn(2, 40, generator=gen).to(torch.bfloat16)
    b1 = torch.randn(2, 3, 40, generator=gen).to(torch.bfloat16)
    b2 = b1.clone()
    y1 = layers.conv1d_step({"w_conv": leaf, "bias_conv": bias}, b1, x)
    y2 = layers.conv1d_step({"w_conv": frozen, "bias_conv": bias}, b2, x)
    assert torch.equal(y1, y2) and torch.equal(b1, b2)


def _decode_both(japi, jtree, api, ttree, dtype, eager, steps=8, B=2):
    """`steps` tokens through the reference's jitted decode (and, with
    `eager`, its eager one) and the port's; returns (port vs jit, eager
    vs jit, logit scale, final JAX cache, final port cache)."""
    cfg = japi.cfg
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, steps))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = jssm.init_cache(cfg, B, steps, dtype=jdt)
    je = jssm.init_cache(cfg, B, steps, dtype=jdt)
    tc = ssm.init_cache(api.cfg, B, steps, "cpu", dtype=dtype)
    dec = jax.jit(japi.decode_step)
    port = spread = scale = 0.0
    for t in range(steps):
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


def test_init_cache_layout_matches_jax():
    cfg = jget_config(ARCH, smoke=True)
    jc = jssm.init_cache(cfg, 3, 16)
    tc = ssm.init_cache(get_config(ARCH, smoke=True), 3, 16, "cpu")
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[1] == jc[k].dtype.name
        assert not tc[k].any()


def test_decode_step_f32_matches_jax(frozen):
    """All-f32 tree and cache: 8 steps equal the reference's to f32
    rounding (sums in another order), 2e-5 of the logit scale (measured
    6.5e-7); the SSM state and conv buffer after them to 1e-5 of their
    scale (measured 7.5e-7)."""
    japi, jfz, api = frozen
    f32 = _f32(jfz)
    port, _, scale, jc, tc = _decode_both(
        japi, f32, api, convert.tree_to_torch(_np(f32), "cpu"),
        torch.float32, eager=False)
    assert port <= 2e-5 * scale, (port, scale)
    for k in jc:
        want = np.asarray(jc[k])
        np.testing.assert_allclose(tc[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_decode_step_bf16_within_reference_spread(frozen):
    """bf16 tree and conv buffer: each framework rounds its bf16 ops at
    its own points, and the reference's jitted and eager decodes differ
    between themselves (measured 1.2% of the logit scale).  The port
    must sit within twice that spread of the jitted reference (or 1e-3
    of the scale; measured 1.8%), and within 3% of the logit scale."""
    japi, jfz, api = frozen
    port, spread, scale, _, _ = _decode_both(
        japi, jfz, api, convert.tree_to_torch(_np(jfz), "cpu"),
        torch.bfloat16, eager=True)
    assert port <= max(2 * spread, 1e-3 * scale), (port, spread, scale)
    assert port <= 0.03 * scale, (port, scale)
