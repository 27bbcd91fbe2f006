"""The port's kernel layer against the JAX package.

On the CPU the port's wrappers run their plain versions; these must give
the JAX oracles' hash uniforms, masks and packed words exactly, and the
JAX kernels' (interpret mode) sums within float32 rounding.  Masks may
differ only where a uniform falls between torch's and JAX's sigmoid of
the same score, which differ by at most 1 ulp on ~0.4% of inputs: such
flips are counted and each is checked to be that boundary case.

The tests marked `cuda` hold each CUDA kernel against its plain version
on the card (python -m pytest -m cuda tests/test_torch_kernels.py) and
skip where there is none.
"""
import numpy as np
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp
    from repro.api import payloads as jpayloads
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.masked_matmul import masked_matmul as jmasked_matmul
    from repro.kernels.masked_matmul import masked_matmul_ds as jmasked_matmul_ds
    from repro.kernels.masked_matmul import masked_matmul_dx as jmasked_matmul_dx
    from repro.kernels.masked_matmul import sample_and_pack as jsample_and_pack
except ImportError:  # a card machine without JAX runs the cuda tests only
    jax = None

from repro_torch.api import payloads
from repro_torch.convert import to_torch
from repro_torch.kernels import dispatch
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops, ref

ULP = 2.0 ** -23        # float32 ulp just below 1.0
BF16_RTOL = 2.0 ** -7   # one bfloat16 ulp, relative


@pytest.fixture(autouse=True)
def _reference(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed here")


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _sigmoids(s):
    """(torch sigmoid, jax sigmoid) of the same f32 scores as numpy."""
    return (torch.sigmoid(_t(s)).numpy(),
            np.asarray(jax.nn.sigmoid(jnp.asarray(s))))


def _assert_boundary_flips(m_port, m_jax, u, s, max_flips):
    """Masks agree except where u lies between the two frameworks'
    sigmoid(s); returns the flip count."""
    th_t, th_j = _sigmoids(s)
    assert np.max(np.abs(th_t - th_j)) <= ULP
    flips = np.asarray(m_port) != np.asarray(m_jax)
    lo, hi = np.minimum(th_t, th_j), np.maximum(th_t, th_j)
    assert np.all((u[flips] >= lo[flips]) & (u[flips] < hi[flips]))
    assert flips.sum() <= max_flips, flips.sum()
    return int(flips.sum())


@pytest.mark.parametrize("seed,off", [(0, 0), (17, 12345), (0xFFFFFFFF, 7),
                                      (3, 3_000_000_000)])
def test_hash_uniform_bit_exact(seed, off):
    idx = (np.arange(1 << 16, dtype=np.uint64) + off) & 0xFFFFFFFF
    u_j = np.asarray(jref.hash_uniform(jnp.asarray(idx.astype(np.uint32)),
                                       seed))
    u_t = ref.hash_uniform(torch.from_numpy(idx.astype(np.int64)), seed)
    assert np.array_equal(u_t.numpy(), u_j)


@pytest.mark.parametrize("C,n", [(1, 64), (3, 100), (2, 1000)])
def test_sample_rows_and_pack_match_ref(C, n):
    rng = np.random.default_rng(n)
    s = rng.normal(size=(C, n)).astype(np.float32)
    seeds = (np.arange(C, dtype=np.uint32) * 7919 + 5).astype(np.uint32)
    m_t = ref.sample_rows(_t(s), seeds.astype(np.int64)).numpy()
    m_j = np.asarray(jref.sample_rows(jnp.asarray(s), jnp.asarray(seeds)))
    u = np.stack([np.asarray(jref.hash_uniform(
        jnp.arange(n, dtype=jnp.uint32), int(sd))) for sd in seeds])
    _assert_boundary_flips(m_t, m_j, u, s, max_flips=1)
    words_t = mm.sample_and_pack(_t(s), seeds.tolist()).numpy()
    words_j = np.asarray(jsample_and_pack(jnp.asarray(s),
                                          jnp.asarray(seeds),
                                          interpret=True))
    assert words_t.shape == (C, (n + 31) // 32)
    # the words are the masks packed: equal wherever the masks are
    assert np.array_equal(ref.unpack_bits(_t(words_t), n).numpy(), m_t)
    if np.array_equal(m_t, m_j):
        assert np.array_equal(words_t.view(np.uint32), words_j)


@pytest.mark.parametrize("tau", [0.5, 0.3])
def test_sample_and_pack_threshold_ragged(tau):
    rng = np.random.default_rng(1)
    s = rng.normal(size=(2, 77)).astype(np.float32)
    words_t = mm.sample_and_pack(_t(s), [1, 2], mode="threshold", tau=tau)
    words_j = np.asarray(jsample_and_pack(
        jnp.asarray(s), jnp.asarray([1, 2], jnp.uint32), interpret=True,
        mode="threshold", tau=tau))
    m_t = ref.unpack_bits(words_t, 77).numpy()
    m_j = np.asarray(jax.vmap(lambda w: jref.unpack_bits(w, 77))(
        jnp.asarray(words_j)))
    th_t, th_j = _sigmoids(s)
    flips = m_t != m_j
    assert np.all(np.minimum(th_t, th_j)[flips] <= tau)
    assert np.all(np.maximum(th_t, th_j)[flips] >= tau)
    # padding bits past n are zero
    assert not (words_t[:, -1].numpy().view(np.uint32) >> (77 % 32)).any()


@pytest.mark.parametrize("n", [320, 77])
def test_pack_unpack_round_trip_matches_ref(n):
    rng = np.random.default_rng(n)
    bits = (rng.random((n // 7, 7)) < 0.3).astype(np.uint8)
    w_t = payloads.pack_leaf(_t(bits))
    w_j = np.asarray(jpayloads.pack_leaf(jnp.asarray(bits)))
    assert np.array_equal(w_t.numpy().view(np.uint32), w_j)
    m = bits.size
    assert np.array_equal(ref.unpack_bits(w_t, m).numpy(),
                          np.asarray(jref.unpack_bits(jnp.asarray(w_j), m)))
    assert np.array_equal(ref.popcount32(w_t).numpy(),
                          np.asarray(jax.lax.population_count(
                              jnp.asarray(w_j))))


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    s = rng.normal(size=(K, N)).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_masked_matmul_plain_with_off_and_n_logical(mode):
    """Zero-padded operands with the hash indexed by the logical column
    count give the unpadded product; y, dx and ds of the plain versions
    equal the JAX kernels' (interpret mode, the reference's own padded
    launch) at a non-zero stream offset."""
    M, K, N, Np, off = 128, 128, 100, 128, 4321
    x, w, s = _operands(M, K, N, 3)
    wp = np.pad(w, ((0, 0), (0, Np - N)))
    sp = np.pad(s, ((0, 0), (0, Np - N)))
    y_t = mm.masked_matmul(_t(x), _t(w), _t(s), 29, off, mode=mode,
                           tau=0.45).numpy()
    y_tp = mm.masked_matmul(_t(x), _t(wp), _t(sp), 29, off, n_logical=N,
                            mode=mode, tau=0.45).numpy()[:, :N]
    np.testing.assert_array_equal(y_tp, y_t)
    y_j = np.asarray(jmasked_matmul(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(sp), 29, off, bm=128,
        bn=128, bk=128, n_logical=N, interpret=True, mode=mode,
        tau=0.45))[:, :N]
    # f32 sums in another order: relative 1e-5 of the output scale
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5,
                               atol=1e-5 * np.abs(y_j).max())
    g = np.random.default_rng(4).normal(size=(M, Np)).astype(np.float32)
    g[:, N:] = 0.0
    dx_t = mm.masked_matmul_dx(_t(g), _t(wp), _t(sp), 29, off, n_logical=N,
                               mode=mode, tau=0.45).numpy()
    dx_j = np.asarray(jmasked_matmul_dx(
        jnp.asarray(g), jnp.asarray(wp), jnp.asarray(sp), 29, off, bm=128,
        bn=128, bk=128, n_logical=N, interpret=True, mode=mode, tau=0.45))
    np.testing.assert_allclose(dx_t, dx_j, rtol=1e-5,
                               atol=1e-5 * np.abs(dx_j).max())
    ds_t = mm.masked_matmul_ds(_t(x), _t(g), _t(wp), _t(sp)).numpy()
    ds_j = np.asarray(jmasked_matmul_ds(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(wp), jnp.asarray(sp),
        bm=128, bn=128, bk=128, interpret=True))
    np.testing.assert_allclose(ds_t, ds_j, rtol=1e-5,
                               atol=1e-5 * np.abs(ds_j).max())


def test_masked_dense_identity_probe_recovers_ref_mask():
    """y = I @ (m*w) with w = 1 is the mask itself: the port's forward
    draws the JAX oracle's mask at (seed, off), up to boundary flips."""
    K, N = 100, 60
    s = np.random.default_rng(5).normal(size=(K, N)).astype(np.float32)
    for off in (0, 12345, 3 * K * N):
        m_t = ops.masked_dense(torch.eye(K), torch.ones(K, N), _t(s), 31,
                               off).numpy()
        m_j = np.asarray(jref.sample_mask(jnp.asarray(s), 31, off))
        idx = (off + np.arange(K * N, dtype=np.uint64)) & 0xFFFFFFFF
        u = np.asarray(jref.hash_uniform(
            jnp.asarray(idx.astype(np.uint32)), 31)).reshape(K, N)
        _assert_boundary_flips(m_t, m_j, u, s, max_flips=1)


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_masked_dense_autograd_matches_jax_grad(mode):
    """y, dx and ds of the port's autograd Function against jax.grad of
    repro.kernels.ops.masked_dense (fused kernels in interpret mode),
    in bfloat16 as the model runs them."""
    M, K, N, off = 24, 40, 72, 999
    x, w, s = _operands(M, K, N, 7)
    x = x.astype(jnp.bfloat16)
    w = w.astype(jnp.bfloat16)
    rng = np.random.default_rng(8)
    cot = rng.normal(size=(M, N)).astype(jnp.bfloat16)

    if mode == "sample":
        jf = lambda x_, s_: jops.masked_dense(x_, jnp.asarray(w), s_, 13, off)
        tf = lambda x_, s_: ops.masked_dense(x_, _t(w), s_, 13, off)
    else:
        jf = lambda x_, s_: jops.masked_dense_threshold(
            x_, jnp.asarray(w), s_, 0.4)
        tf = lambda x_, s_: ops.masked_dense_threshold(x_, _t(w), s_, 0.4)
    y_j, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(s))
    dx_j, ds_j = vjp(jnp.asarray(cot))

    xt = _t(x).requires_grad_()
    st = _t(s).requires_grad_()
    y_t = tf(xt, st)
    y_t.backward(_t(cot))
    assert y_t.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == torch.float32
    f = lambda a: np.asarray(a, np.float32)
    # y and dx are f32 sums cast to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(f(y_t.detach().float()), f(y_j),
                               rtol=BF16_RTOL, atol=1e-2)
    np.testing.assert_allclose(f(xt.grad.float()), f(dx_j),
                               rtol=BF16_RTOL, atol=1e-2)
    # ds stays f32: sums over M=24 bf16-exact products, order only
    np.testing.assert_allclose(st.grad.numpy(), f(ds_j), rtol=1e-5,
                               atol=1e-6)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is only ever called with CPU tensors."""
    calls = []
    monkeypatch.setattr(mm, "masked_matmul_plain",
                        lambda *a, **k: calls.append(a[0].device))
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        mm.masked_matmul(x, x, x, 0)
    assert calls == []
    mm.masked_matmul(torch.zeros(4, 4), torch.zeros(4, 4),
                     torch.zeros(4, 4), 0)
    assert calls == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# Card-only: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_operands(M, K, N, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=dev).to(torch.bfloat16)
    s = torch.randn(K, N, generator=g, device=dev)
    gy = torch.randn(M, N, generator=g, device=dev).to(torch.bfloat16)
    return x, w, s, gy


def _close_bf16(a, b):
    """f32 sums in another order, then a bf16 cast: one bf16 ulp."""
    a, b = a.float(), b.float()
    tol = BF16_RTOL * b.abs() + 1e-4 * b.abs().max()
    return bool(((a - b).abs() <= tol).all())


# (M, K, N): M = 1, M = 600 (three 256-row blocks), mamba2's w_in (N
# ragged against 64) and internlm2's w_k and w_down at the main path's M
CARD_SHAPES = [(256, 128, 192), (33, 70, 45), (256, 2048, 1024),
               (1, 2048, 2048), (600, 512, 384), (256, 1024, 4384),
               (256, 8192, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_masked_matmul_fwd_dx_match_plain(card, shape, mode):
    M, K, N = shape
    x, w, s, gy = _card_operands(M, K, N, 1, card)
    kw = dict(mode=mode, tau=0.45)
    before = dict(dispatch.LAUNCHES)
    y = mm.masked_matmul(x, w, s, 7, 5 * K * N, **kw)
    dx = mm.masked_matmul_dx(gy, w, s, 7, 5 * K * N, **kw)
    torch.cuda.synchronize()
    for name in ("masked_matmul_fwd", "masked_matmul_dx"):
        assert dispatch.LAUNCHES[name] == before[name] + 1
    assert _close_bf16(y, ref.masked_matmul(x, w, s, 7, 5 * K * N, **kw))
    assert _close_bf16(dx, ref.masked_matmul_dx(gy, w, s, 7, 5 * K * N,
                                                **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 8192, 2048), (200, 1000, 1500)])
def test_card_masked_matmul_fwd_dx_deterministic(card, shape):
    """The reduction split over a cluster is summed in a fixed order: two
    launches on the same inputs give the same bits."""
    M, K, N = shape
    x, w, s, gy = _card_operands(M, K, N, 4, card)
    for f, a in ((mm.masked_matmul, x), (mm.masked_matmul_dx, gy)):
        first = f(a, w, s, 11, 77)
        second = f(a, w, s, 11, 77)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_masked_matmul_f32_activations_match_plain(card, mode):
    """f32 x and g (recurrentgemma's gate projections) run the SIMT body:
    f32 results within float32 rounding of the plain version."""
    M, K, N = 70, 300, 200
    x, w, s, gy = _card_operands(M, K, N, 5, card)
    x, gy = x.float(), gy.float()
    kw = dict(mode=mode, tau=0.45)
    for got, want in ((mm.masked_matmul(x, w, s, 3, 999, **kw),
                       ref.masked_matmul(x, w, s, 3, 999, **kw)),
                      (mm.masked_matmul_dx(gy, w, s, 3, 999, **kw),
                       ref.masked_matmul_dx(gy, w, s, 3, 999, **kw))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        # f32 sums of bf16-exact weights in another order
        assert torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_masks_bit_exact_by_identity_probe(card, mode):
    """x = I recovers m*w exactly from the forward, g = I from dx: both
    equal the plain mask times w (same sigmoid on the card: no flips)."""
    K, N, off = 96, 80, 123_456
    _, w, s, _ = _card_operands(K, K, N, 2, card)
    eye = torch.eye(K, device=card, dtype=torch.bfloat16)
    m = ref.threshold_mask(s, 0.45) if mode == "threshold" else \
        ref.sample_mask(s, 9, off)
    wm = (m.float() * w.float()).to(torch.bfloat16)
    y = mm.masked_matmul(eye, w, s, 9, off, mode=mode, tau=0.45)
    eye_n = torch.eye(N, device=card, dtype=torch.bfloat16)
    dx = mm.masked_matmul_dx(eye_n, w, s, 9, off, mode=mode, tau=0.45)
    torch.cuda.synchronize()
    assert torch.equal(y, wm)
    assert torch.equal(dx, wm.T.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_card_masked_matmul_ds_matches_plain(card, shape):
    M, K, N = shape
    x, w, s, gy = _card_operands(M, K, N, 3, card)
    ds = mm.masked_matmul_ds(x, gy, w, s)
    torch.cuda.synchronize()
    want = ref.masked_matmul_ds(x, gy, w, s)
    # f32 sums over M bf16-exact products in another order
    assert torch.allclose(ds, want, rtol=1e-5, atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_card_masked_matmul_ds_f32_activations_match_plain(card, shape):
    """f32 x and g (recurrentgemma's gate projections): the tensor-core
    body multiplies three bf16 parts of each and drops the three
    smallest cross products; f32 results within float32 rounding of the
    plain version."""
    M, K, N = shape
    x, w, s, gy = _card_operands(M, K, N, 6, card)
    x = x.float() + 1e-3 * torch.randn(M, K, device=card)
    gy = gy.float() + 1e-3 * torch.randn(M, N, device=card)
    ds = mm.masked_matmul_ds(x, gy, w, s)
    torch.cuda.synchronize()
    want = ref.masked_matmul_ds(x, gy, w, s)
    assert ds.dtype == torch.float32
    assert torch.allclose(ds, want, rtol=1e-5, atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128, 192), (33, 70, 45)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_masked_matmul_ds_layout_probe(card, shape, dtype):
    """x = [I; 0] makes x^T g the first rows of g exactly, so ds equals
    the plain version to a few float32 ulps (the sigmoid's): a wrong
    operand layout or transpose flag moves whole rows or columns."""
    M, K, N = shape
    _, w, s, gy = _card_operands(M, K, N, 7, card)
    gy = gy.to(dtype)
    x = torch.zeros(M, K, device=card, dtype=dtype)
    r = min(M, K)
    x[:r, :r] = torch.eye(r, device=card, dtype=dtype)
    ds = mm.masked_matmul_ds(x, gy, w, s)
    torch.cuda.synchronize()
    want = ref.masked_matmul_ds(x, gy, w, s)
    assert torch.allclose(ds, want, rtol=4 * ULP, atol=0.0)
    assert not ds[r:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 8192, 2048), (200, 1000, 1500)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_masked_matmul_ds_deterministic(card, shape, dtype):
    """Each tile sums all of M in one block, in a fixed order: two
    launches on the same inputs give the same bits."""
    M, K, N = shape
    x, w, s, gy = _card_operands(M, K, N, 8, card)
    x, gy = x.to(dtype), gy.to(dtype)
    first = mm.masked_matmul_ds(x, gy, w, s)
    second = mm.masked_matmul_ds(x, gy, w, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n", [(2, 4096), (3, 1000), (1, 31),
                                 (2, 100_003), (2, 100_004), (4, 33)])
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_sample_and_pack_matches_plain(card, C, n, mode):
    g = torch.Generator(device=card).manual_seed(n)
    s = torch.randn(C, n, generator=g, device=card)
    seeds = [11 + 7919 * c for c in range(C)]
    words = mm.sample_and_pack(s, seeds, mode=mode, tau=0.45)
    torch.cuda.synchronize()
    want = ref.sample_and_pack(s, torch.tensor(seeds, device=card), mode,
                               0.45)
    assert torch.equal(words, want)


# (E, M, K, N): the main path's experts, the ragged misaligned cell (w's
# row pitch of 3000 bytes off the 16-byte grid), and 8 experts at the row
# counts where kernels 5-6's blocks change (one 64-row wgmma tile full,
# two, four, two M blocks of 256)
GROUPED_CARD_SHAPES = [(8, 30, 256, 192), (3, 33, 70, 45),
                       (64, 30, 2048, 1408), (5, 29, 1000, 1500),
                       (8, 64, 2048, 1408), (8, 65, 2048, 1408),
                       (8, 240, 2048, 1408), (8, 300, 2048, 1408)]


def _card_grouped_operands(E, M, K, N, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(E, M, K, generator=g, device=dev)
    w = torch.randn(E, K, N, generator=g, device=dev).to(torch.bfloat16)
    s = torch.randn(E, K, N, generator=g, device=dev)
    gy = torch.randn(E, M, N, generator=g, device=dev)
    return x, w, s, gy


def _grouped_coords(E, K, N, layer=2):
    """Layer `layer`'s per-expert seeds and stream offsets."""
    offs = [((layer * E + e) * K * N) & 0xFFFFFFFF for e in range(E)]
    return [0x9E3779B9] * E, offs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_CARD_SHAPES)
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_grouped_fwd_dx_match_plain(card, shape, mode):
    E, M, K, N = shape
    x, w, s, gy = _card_grouped_operands(E, M, K, N, 4, card)
    seeds, offs = _grouped_coords(E, K, N)
    kw = dict(mode=mode, tau=0.45)
    before = dict(dispatch.LAUNCHES)
    y = mm.masked_matmul_grouped(x, w, s, seeds, offs, **kw)
    dx = mm.masked_matmul_grouped_dx(gy, w, s, seeds, offs, **kw)
    torch.cuda.synchronize()
    for name in ("masked_matmul_grouped", "masked_matmul_grouped_dx"):
        assert dispatch.LAUNCHES[name] == before[name] + 1
    # f32 sums over bf16-exact weights in another order
    for got, want in ((y, ref.masked_matmul_grouped(x, w, s, seeds, offs,
                                                    **kw)),
                      (dx, ref.masked_matmul_grouped_dx(gy, w, s, seeds,
                                                        offs, **kw))):
        assert got.dtype == torch.float32
        assert torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 30, 1408, 2048), (5, 29, 1000, 1500),
                                   (8, 300, 2048, 1408)])
def test_card_grouped_fwd_dx_deterministic(card, shape):
    """The reduction split over a cluster is summed in rank order: two
    launches on the same inputs give the same bits."""
    E, M, K, N = shape
    x, w, s, gy = _card_grouped_operands(E, M, K, N, 7, card)
    seeds, offs = _grouped_coords(E, K, N)
    for f, a in ((mm.masked_matmul_grouped, x),
                 (mm.masked_matmul_grouped_dx, gy)):
        first = f(a, w, s, seeds, offs)
        second = f(a, w, s, seeds, offs)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_card_grouped_launch_after_plans_of_other_rows(card):
    """The occupancy query behind a plan for 256 rows asks for fewer bytes
    of shared memory than a 64-row launch needs: a 64-row launch after
    it still launches and agrees with the plain version."""
    E, K, N = 3, 512, 384
    seeds, offs = _grouped_coords(E, K, N)
    for M in (30, 240, 30):
        x, w, s, _ = _card_grouped_operands(E, M, K, N, 9, card)
        y = mm.masked_matmul_grouped(x, w, s, seeds, offs)
        torch.cuda.synchronize()
        want = ref.masked_matmul_grouped(x, w, s, seeds, offs)
        assert torch.allclose(y, want, rtol=1e-5,
                              atol=1e-5 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["fwd", "dx"])
def test_card_grouped_f32_rows_across_the_exponent_range(card, orient):
    """Kernels 5-6 multiply three bf16 parts of each f32 value of x or g:
    with its rows scaled by 2**-60 .. 2**60, every output row holds to
    float32 rounding of its own scale."""
    E, M, K, N = 8, 30, 2048, 1408
    x, w, s, gy = _card_grouped_operands(E, M, K, N, 8, card)
    scale = torch.exp2(torch.linspace(-60, 60, E * M, device=card).round())
    seeds, offs = _grouped_coords(E, K, N)
    if orient == "fwd":
        a = x * scale.view(E, M, 1)
        got = mm.masked_matmul_grouped(a, w, s, seeds, offs)
        want = ref.masked_matmul_grouped(a, w, s, seeds, offs)
    else:
        a = gy * scale.view(E, M, 1)
        got = mm.masked_matmul_grouped_dx(a, w, s, seeds, offs)
        want = ref.masked_matmul_grouped_dx(a, w, s, seeds, offs)
    torch.cuda.synchronize()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    assert bool(got.isfinite().all())
    assert bool(((got - want).abs() <= 1e-5 * want.abs()
                 + 1e-5 * rowmax).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_card_grouped_masks_bit_exact_by_identity_probe(card, mode):
    """x[e] = I reads m[e]*w[e] back exactly (f32), g[e] = I its
    transpose: every group's mask equals the plain one."""
    E, K, N = 4, 96, 80
    _, w, s, _ = _card_grouped_operands(E, 1, K, N, 5, card)
    seeds, offs = _grouped_coords(E, K, N)
    wm = ref.grouped_mask(s, seeds, offs, mode=mode,
                          tau=0.45).float() * w.float()
    eye = torch.eye(K, device=card).expand(E, K, K).contiguous()
    y = mm.masked_matmul_grouped(eye, w, s, seeds, offs, mode=mode,
                                 tau=0.45)
    eye_n = torch.eye(N, device=card).expand(E, N, N).contiguous()
    dx = mm.masked_matmul_grouped_dx(eye_n, w, s, seeds, offs, mode=mode,
                                     tau=0.45)
    torch.cuda.synchronize()
    assert torch.equal(y, wm)
    assert torch.equal(dx, wm.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_CARD_SHAPES)
def test_card_grouped_ds_matches_plain(card, shape):
    E, M, K, N = shape
    x, w, s, gy = _card_grouped_operands(E, M, K, N, 6, card)
    ds = mm.masked_matmul_grouped_ds(x, gy, w, s)
    torch.cuda.synchronize()
    want = ref.masked_matmul_grouped_ds(x, gy, w, s)
    # f32 sums over M terms in another order
    assert torch.allclose(ds, want, rtol=1e-5, atol=1e-5 * want.abs().max())
