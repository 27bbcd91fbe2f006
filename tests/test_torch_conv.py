"""The port's masked depthwise conv (kernels 8-9) against the JAX package.

On the CPU the port's wrappers run their plain versions: their masks
must equal the JAX oracle's (up to the 1-ulp sigmoid boundary flips
explained in tests/test_torch_kernels.py) and the leaf's uplink
`sample_and_pack` stream, and their sums the JAX kernels' (interpret
mode) within float32 rounding, in the sample, threshold and plain modes,
with the taps flipped and with both ds epilogues.  The autograd
Functions' dx and ds must match `jax.grad` of the JAX ops.

The tests marked `cuda` hold the CUDA kernels against their plain
versions on the card (python -m pytest -m cuda tests/test_torch_conv.py)
and skip where there is none.
"""
import numpy as np
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.masked_matmul import masked_conv1d as jconv
    from repro.kernels.masked_matmul import masked_conv1d_ds as jconv_ds
except ImportError:  # a card machine without JAX runs the cuda tests only
    jax = None

from repro_torch.convert import to_torch
from repro_torch.core import aggregation, masking
from repro_torch.kernels import dispatch
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops, ref

ULP = 2.0 ** -23        # float32 ulp just below 1.0
BF16_RTOL = 2.0 ** -7   # one bfloat16 ulp, relative
M32 = 0xFFFFFFFF
W, B, S = 4, 2, 16
# an offset whose (W, C) block crosses 2**32 (C = 160: 640 indices)
WRAP_OFF = (1 << 32) - 300


@pytest.fixture(autouse=True)
def _reference(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed here")


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _operands(C, seed, x_dtype=jnp.bfloat16 if jax else None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, C)).astype(x_dtype)
    w = rng.normal(size=(W, C)).astype(jnp.bfloat16)
    s = (2 * rng.normal(size=(W, C))).astype(np.float32)
    g = rng.normal(size=(B, S, C)).astype(np.float32)
    return x, w, s, g


def _pad_c(a, C):
    """Zero-pad the channel (last) axis to a multiple of 128, as the JAX
    ops do for their vector unit (layout only: the hash keeps n_logical)."""
    pad = -C % 128
    return jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, pad)])


def _jax_conv(x, w, s, seed, off, mode, flip):
    """The JAX kernel (interpret mode) on the causally (or, flipped,
    trailing) padded input, C padded to 128 with n_logical = C."""
    C = x.shape[-1]
    pad = ((0, 0), (0, W - 1), (0, 0)) if flip else ((0, 0), (W - 1, 0),
                                                      (0, 0))
    xp = _pad_c(jnp.pad(jnp.asarray(x), pad), C)
    y = jconv(xp, _pad_c(w, C), _pad_c(s, C), jnp.uint32(seed),
              jnp.uint32(off), n_logical=C,
              interpret=True, mode=mode, tau=0.45, flip=flip)
    return np.asarray(y)[..., :C]


def _jax_mask(s, seed, off, mode):
    if mode == "threshold":
        return np.asarray(jref.threshold_mask(jnp.asarray(s), 0.45))
    return np.asarray(jref.sample_mask(jnp.asarray(s), seed, off))


def _assert_mask_matches(m_port, s, seed, off, mode):
    """Masks equal the JAX oracle's except where a uniform lies between
    torch's and JAX's sigmoid of the same score (1 ulp apart)."""
    m_jax = _jax_mask(s, seed, off, mode)
    flips = m_port != m_jax
    if flips.any():
        th_t = torch.sigmoid(_t(s)).numpy()
        th_j = np.asarray(jax.nn.sigmoid(jnp.asarray(s)))
        lo, hi = np.minimum(th_t, th_j), np.maximum(th_t, th_j)
        if mode == "threshold":
            gate = np.full_like(lo, 0.45)
        else:
            K, N = s.shape
            idx = (np.uint64(off) + np.arange(K, dtype=np.uint64)[:, None]
                   * np.uint64(N) + np.arange(N, dtype=np.uint64)) & M32
            gate = np.asarray(jref.hash_uniform(
                jnp.asarray(idx.astype(np.uint32)), seed))
        assert np.all((gate[flips] >= lo[flips] - ULP)
                      & (gate[flips] <= hi[flips] + ULP))
    assert flips.sum() <= 1
    return int(flips.sum())


@pytest.mark.parametrize("C,off", [(160, 12345), (256, WRAP_OFF)])
@pytest.mark.parametrize("mode", ["sample", "threshold", "plain"])
@pytest.mark.parametrize("flip", [False, True])
def test_conv_plain_version_matches_jax_kernel(C, off, mode, flip):
    """y (or the flipped dL/dx pass over an f32 cotangent) of the plain
    version against the JAX kernel: the same taps in the same order, so
    the f32 sums agree to float32 rounding (0 here: both add separately
    rounded products in t order)."""
    x, w, s, g = _operands(C, 1)
    inp = g if flip else x
    got = mm.masked_conv1d(_t(inp), _t(w), _t(s), 77, off, mode=mode,
                           tau=0.45, flip=flip)
    want = _jax_conv(inp, w, s if mode != "plain" else w, 77, off, mode,
                     flip)
    if mode != "plain":
        m = ref.conv_weight(torch.ones(W, C), _t(s), 77, off, None, mode,
                            0.45).numpy().astype(np.uint8)
        # (a boundary flip would move a sum by a whole tap; none here)
        assert _assert_mask_matches(m, s, 77, off, mode) == 0
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("C", [160, 256])
@pytest.mark.parametrize("epilogue", ["ste", "dw"])
@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_conv_ds_plain_version_matches_jax_kernel(C, epilogue, x_dtype):
    """ds (STE epilogue) and the raw correlation (dw epilogue) against
    the JAX kernel: f32 sums over B*S = 32 terms in another order."""
    x, w, s, g = _operands(C, 2, jnp.bfloat16 if x_dtype == "bf16"
                           else np.float32)
    got = mm.masked_conv1d_ds(_t(x), _t(g), _t(w), _t(s), epilogue=epilogue)
    xp = _pad_c(jnp.pad(jnp.asarray(x), ((0, 0), (W - 1, 0), (0, 0))), C)
    want = np.asarray(jconv_ds(xp, _pad_c(g, C), _pad_c(w, C), _pad_c(s, C),
                               interpret=True, epilogue=epilogue))[:, :C]
    assert got.dtype == torch.float32 and got.shape == (W, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_conv_ref_oracles_agree_with_jax_ref():
    """The plain forward and STE backward against the JAX package's own
    naive oracles (`ref.masked_conv1d`, `ref.masked_conv1d_bwd`)."""
    C = 160
    x, w, s, g = _operands(C, 3)
    y = ref.masked_conv1d(_t(x), _t(w), _t(s), 5, WRAP_OFF)
    jy = np.asarray(jref.masked_conv1d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(s), 5, WRAP_OFF))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6,
                               atol=1e-6 * np.abs(jy).max())
    dx, ds = ref.masked_conv1d_bwd(_t(x), _t(w), _t(s), 5, _t(g), WRAP_OFF)
    jdx, jds = jref.masked_conv1d_bwd(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(s), 5, jnp.asarray(g),
                                      WRAP_OFF)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx).astype(np.float32),
                               rtol=BF16_RTOL, atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jds)).max())


def test_conv_leaf_mask_is_its_uplink_stream_by_identity_probe():
    """Block l of a stacked (L, W, C) conv leaf, run at the MaskedLeaf
    offset l*W*C with w = 1 and a one-hot input in time, reads its mask
    back tap by tap; it equals bits l*W*C .. (l+1)*W*C - 1 of the words
    `sample_and_pack` packs for the flattened leaf, in the port and in
    the JAX package."""
    L_, C, seed = 3, 160, 0xC0FFEE
    s = (2 * np.random.default_rng(4).normal(size=(L_, W, C))).astype(
        np.float32)
    leaf = masking.MaskedLeaf.build(torch.ones(L_, W, C, dtype=torch.bfloat16),
                                    _t(s), seed)
    t_words = aggregation.sample_and_pack_rows(_t(s.reshape(1, -1)), [seed])
    j_words = np.asarray(jops.sample_and_pack(
        jnp.asarray(s.reshape(1, -1)), jnp.asarray([seed], jnp.uint32)))
    assert np.array_equal(t_words.numpy().view(np.uint32), j_words)
    bits = ref.unpack_bits(t_words, L_ * W * C)[0].reshape(L_, W, C)
    # one-hot at time W-1: y[s = W-1+... ] reads tap t at s = 2(W-1) - t
    probe = torch.zeros(1, 2 * W, C, dtype=torch.bfloat16)
    probe[0, W - 1] = 1
    for l in range(L_):
        blk = leaf.block(l)
        assert int(blk.off) == l * W * C
        y = mm.masked_conv1d(probe, blk.w, blk.s, int(blk.seed),
                             int(blk.off))
        read = torch.stack([y[0, 2 * (W - 1) - t] for t in range(W)])
        assert torch.equal(read.to(torch.uint8), bits[l])


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_masked_conv1d_autograd_matches_jax_grad(mode):
    """y, dL/dx (bf16) and dL/ds (f32) of the autograd Function against
    jax.grad through the JAX ops, for L = sum(y * cot), at the wrapping
    offset (sample) and C = 160."""
    C = 160
    x, w, s, cot = _operands(C, 5)
    if mode == "sample":
        jf = lambda x_, s_: jops.masked_conv1d(x_, jnp.asarray(w), s_, 9,
                                               WRAP_OFF)
        tf = lambda x_, s_: ops.masked_conv1d(x_, _t(w), s_, 9, WRAP_OFF)
    else:
        jf = lambda x_, s_: jops.masked_conv1d_threshold(
            x_, jnp.asarray(w), s_, 0.45)
        tf = lambda x_, s_: ops.masked_conv1d_threshold(x_, _t(w), s_, 0.45)
    jloss = lambda x_, s_: jnp.sum(jf(x_, s_) * cot)
    jy = np.asarray(jf(jnp.asarray(x), jnp.asarray(s)))
    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    xt = _t(x).requires_grad_()
    st = _t(s).requires_grad_()
    y = tf(xt, st)
    (y * _t(cot)).sum().backward()
    m = ref.conv_weight(torch.ones(W, C), _t(s), 9, WRAP_OFF, None, mode,
                        0.45).numpy().astype(np.uint8)
    assert _assert_mask_matches(m, s, 9, WRAP_OFF, mode) == 0
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-6,
                               atol=1e-6 * np.abs(jy).max())
    assert xt.grad.dtype == torch.bfloat16 and st.grad.dtype == torch.float32
    # dx: f32 sums cast to bf16, at most one bf16 ulp apart
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(jdx).astype(np.float32),
                               rtol=BF16_RTOL, atol=1e-6)
    # ds: f32 sums over B*S terms in another order
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jds)).max())


def test_conv1d_plain_autograd_matches_jax_grad():
    """The mask-free conv (materialized kernels): y, dL/dx and dL/dw
    against jax.grad of the JAX `conv1d_plain` (dw cast to bf16 in
    both)."""
    C = 160
    x, w, _, cot = _operands(C, 6)
    jloss = lambda x_, w_: jnp.sum(jops.conv1d_plain(x_, w_) * cot)
    jy = np.asarray(jops.conv1d_plain(jnp.asarray(x), jnp.asarray(w)))
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    xt = _t(x).requires_grad_()
    wt = _t(w).requires_grad_()
    y = ops.conv1d_plain(xt, wt)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-6,
                               atol=1e-6 * np.abs(jy).max())
    # the plain versions themselves: the forward and the raw correlation
    assert torch.equal(ref.conv1d_plain(_t(x), _t(w)), y.detach())
    np.testing.assert_allclose(
        ref.conv1d_plain_dw(_t(x), _t(cot), _t(w)).to(torch.bfloat16)
        .float().numpy(), np.asarray(jdw).astype(np.float32),
        rtol=BF16_RTOL, atol=1e-6)
    assert wt.grad.dtype == torch.bfloat16
    for got, want in ((xt.grad, jdx), (wt.grad, jdw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=BF16_RTOL, atol=1e-6)


def test_conv_wrappers_check_their_arguments():
    """A tensor that is not on the CPU goes to the kernel or raises (the
    plain version sees CPU tensors only); unknown modes and epilogues
    raise."""
    x = torch.zeros(1, 4, 8, device="meta")
    w = torch.zeros(W, 8, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        mm.masked_conv1d(x, w, w, 0)
    with pytest.raises((RuntimeError, ValueError)):
        mm.masked_conv1d_ds(x, x, w, w)
    with pytest.raises(ValueError, match="conv mode"):
        mm.masked_conv1d(torch.zeros(1, 4, 8), torch.zeros(W, 8), None,
                         mode="dense")
    with pytest.raises(ValueError, match="epilogue"):
        mm.masked_conv1d_ds(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8),
                            torch.zeros(W, 8), None, epilogue="raw")
    with pytest.raises(ValueError, match="mask mode"):
        mm.masked_matmul(torch.zeros(2, 2), torch.zeros(2, 2),
                         torch.zeros(2, 2), 0, mode="plain")


# ---------------------------------------------------------------------------
# Card-only: kernels 8-9 against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_operands(Bc, Sc, C, seed, dev, x_dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(Bc, Sc, C, generator=gen, device=dev).to(x_dtype)
    w = torch.randn(W, C, generator=gen, device=dev).to(torch.bfloat16)
    s = 2 * torch.randn(W, C, generator=gen, device=dev)
    g = torch.randn(Bc, Sc, C, generator=gen, device=dev)
    return x, w, s, g


# (B, S, C): mamba2-370m's conv, recurrentgemma-9b's, a ragged one, and
# one of C % 4 != 0 (the kernels' element path)
CARD_CONV_SHAPES = [(2, 128, 2304), (2, 128, 4096), (3, 37, 1000),
                    (2, 21, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_CONV_SHAPES)
@pytest.mark.parametrize("mode", ["sample", "threshold", "plain"])
@pytest.mark.parametrize("flip", [False, True])
def test_card_masked_conv1d_matches_plain(card, shape, mode, flip):
    """Separately rounded products added in t order on both sides: the
    kernel equals its plain version bit for bit."""
    Bc, Sc, C = shape
    x, w, s, g = _card_operands(Bc, Sc, C, 1, card)
    inp = g if flip else x
    off = (47 * W * C) & M32   # mamba2's last layer
    before = dispatch.LAUNCHES["masked_conv1d"]
    y = mm.masked_conv1d(inp, w, s, 7, off, mode=mode, tau=0.45, flip=flip)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["masked_conv1d"] == before + 1
    want = ref.masked_conv1d(inp, w, s, 7, off, mode, 0.45, flip=flip)
    assert torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_conv_masks_bit_exact_by_identity_probe(card, mode):
    """w = 1 and a one-hot input in time read every tap's mask bit."""
    C, off = 1000, (1 << 32) - 2000
    _, _, s, _ = _card_operands(1, 1, C, 2, card)
    w = torch.ones(W, C, dtype=torch.bfloat16, device=card)
    probe = torch.zeros(1, 2 * W, C, dtype=torch.bfloat16, device=card)
    probe[0, W - 1] = 1
    y = mm.masked_conv1d(probe, w, s, 3, off, mode=mode, tau=0.45)
    torch.cuda.synchronize()
    read = torch.stack([y[0, 2 * (W - 1) - t] for t in range(W)])
    want = ref.conv_weight(w, s, 3, off, None, mode, 0.45)
    assert torch.equal(read, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_CONV_SHAPES)
@pytest.mark.parametrize("epilogue", ["ste", "dw"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_card_masked_conv1d_ds_matches_plain(card, shape, epilogue, x_dtype):
    Bc, Sc, C = shape
    x, w, s, g = _card_operands(Bc, Sc, C, 3, card, x_dtype)
    before = dispatch.LAUNCHES["masked_conv1d_ds"]
    ds = mm.masked_conv1d_ds(x, g, w, s, epilogue=epilogue)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["masked_conv1d_ds"] == before + 1
    want = ref.masked_conv1d_ds(x, g, w, s, epilogue)
    # f32 sums over B*S terms in another order
    assert torch.allclose(ds, want, rtol=1e-5, atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_dense_kernels_take_f32_activations(card, mode):
    """Kernels 1-3 on f32 activations (recurrentgemma's gate projections
    at its lru width 4096, M = 256 tokens): f32 outputs within float32
    rounding of the plain versions."""
    gen = torch.Generator(device=card).manual_seed(4)
    M, K, N = 256, 4096, 4096
    x = torch.randn(M, K, generator=gen, device=card)
    w = torch.randn(K, N, generator=gen, device=card).to(torch.bfloat16)
    s = torch.randn(K, N, generator=gen, device=card)
    g = torch.randn(M, N, generator=gen, device=card)
    kw = dict(mode=mode, tau=0.45)
    got = (mm.masked_matmul(x, w, s, 5, 77, **kw),
           mm.masked_matmul_dx(g, w, s, 5, 77, **kw),
           mm.masked_matmul_ds(x, g, w, s))
    torch.cuda.synchronize()
    want = (ref.masked_matmul(x, w, s, 5, 77, mode=mode, tau=0.45),
            ref.masked_matmul_dx(g, w, s, 5, 77, mode=mode, tau=0.45),
            ref.masked_matmul_ds(x, g, w, s))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * b.abs().max())
