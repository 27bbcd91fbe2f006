"""The port's bit packing (kernels 10-11 and their plain versions)
against the JAX package.

On the CPU `ops.pack_bits` / `ops.unpack_bits` run their plain versions;
their words must equal, as uint32, the JAX Pallas kernels' (interpret
mode, as the JAX package's own tests run them) and the jnp trio's in
`repro.core.aggregation`, and unpacking must give the bits back exactly.
Integer results: no tolerance.

The tests marked `cuda` hold each CUDA kernel against its plain version
on the card (python -m pytest -m cuda tests/test_torch_bitpack.py),
aligned and misaligned rows alike, and skip where there is none.
"""
import numpy as np
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

try:
    import jax.numpy as jnp
    from repro.core import aggregation as jaggregation
    from repro.kernels import bitpack as jbitpack
    from repro.kernels import ops as jops
except ImportError:  # a card machine without JAX runs the cuda tests only
    jnp = None

from repro_torch.api import payloads
from repro_torch.core import aggregation
from repro_torch.kernels import bitpack, ops
from repro_torch.kernels import dispatch

NS = (32, 1000, 4103)


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed here")


def _bits(shape, seed, p=0.5):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pack_matches_jax_kernel_and_trio(n, dtype):
    """ops.pack_bits (zero-pad to 32, then pack) against the Pallas
    kernel through `repro.kernels.ops.pack_bits` and against the jnp
    trio's pad_to_words + pack_bits: words equal as uint32."""
    m = _bits(n, n).astype(dtype)
    got = _u32(ops.pack_bits(torch.from_numpy(m)))
    want_kernel = np.asarray(jops.pack_bits(jnp.asarray(m)))
    flat, pad = jaggregation.pad_to_words(jnp.asarray(m))
    want_trio = np.asarray(jaggregation.pack_bits(flat))
    assert got.shape == ((n + 31) // 32,)
    assert np.array_equal(got, want_kernel)
    assert np.array_equal(got, want_trio)
    assert pad == (-n) % 32
    # the port's own trio gives the same words
    tflat, tpad = aggregation.pad_to_words(torch.from_numpy(m))
    assert tpad == pad
    assert np.array_equal(_u32(aggregation.pack_bits(tflat)), want_trio)


@pytest.mark.parametrize("n", NS)
def test_unpack_matches_jax_kernel_and_trio(n):
    """Random words (every bit pattern, padding bits set too) unpack to
    the JAX kernel's and the trio's bits, truncated to n."""
    W = (n + 31) // 32
    w = np.random.default_rng(n + 1).integers(0, 1 << 32, W,
                                              dtype=np.uint64)
    w = w.astype(np.uint32)
    got = ops.unpack_bits(torch.from_numpy(w.view(np.int32)), n).numpy()
    want_kernel = np.asarray(jbitpack.unpack_bits(jnp.asarray(w), n,
                                                  interpret=True))
    want_trio = np.asarray(jaggregation.unpack_bits(jnp.asarray(w), n))
    assert got.dtype == np.uint8 and got.shape == (n,)
    assert np.array_equal(got, want_kernel)
    assert np.array_equal(got, want_trio)
    assert np.array_equal(aggregation.unpack_bits(
        torch.from_numpy(w.view(np.int32)), n).numpy(), want_trio)


@pytest.mark.parametrize("n", NS)
def test_rows_match_vmapped_reference(n):
    """(R, n) rows in one call equal the reference's per-row (vmapped)
    pack and unpack; the round's mean over the rows equals
    `repro.api.payloads.mean_from_words`."""
    from repro.api import payloads as jpayloads
    R = 3
    m = _bits((R, n), 7 * n, p=0.3)
    words = ops.pack_bits(torch.from_numpy(m))
    assert words.shape == (R, (n + 31) // 32)
    for r in range(R):
        assert np.array_equal(_u32(words[r]),
                              np.asarray(jops.pack_bits(jnp.asarray(m[r]))))
    back = ops.unpack_bits(words, n)
    assert back.shape == (R, n) and np.array_equal(back.numpy(), m)
    want = np.asarray(jpayloads.mean_from_words(
        jnp.asarray(_u32(words)), n))
    got = payloads.mean_from_words(words, n).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", NS + (1,))
def test_round_trip(n):
    m = _bits(n, 3 * n)
    back = ops.unpack_bits(ops.pack_bits(torch.from_numpy(m)), n)
    assert np.array_equal(back.numpy(), m)
    # bool bits pack to the same words as uint8 ones
    assert torch.equal(ops.pack_bits(torch.from_numpy(m.astype(bool))),
                       ops.pack_bits(torch.from_numpy(m)))


def test_unpack_rejects_n_beyond_words():
    with pytest.raises(ValueError):
        ops.unpack_bits(torch.zeros(2, dtype=torch.int32), 65)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises, or,
    on the meta device, gets an empty meta result of the kernel's shape
    and launches nothing; the plain versions are only ever called with
    CPU tensors."""
    calls = []
    monkeypatch.setattr(bitpack, "pack_bits_plain",
                        lambda b: calls.append(b.device))
    monkeypatch.setattr(bitpack, "unpack_bits_plain",
                        lambda w, n: calls.append(w.device))
    dispatch.reset_launch_counts()
    words = bitpack.pack_bits(torch.zeros(64, dtype=torch.uint8,
                                          device="meta"))
    assert (words.device.type, tuple(words.shape), words.dtype) == (
        "meta", (2,), torch.int32)
    bits = bitpack.unpack_bits(torch.zeros(2, dtype=torch.int32,
                                           device="meta"), 64)
    assert (bits.device.type, tuple(bits.shape), bits.dtype) == (
        "meta", (64,), torch.uint8)
    with pytest.raises((RuntimeError, ValueError)):
        bitpack.pack_bits(torch.zeros(64, dtype=torch.float32,
                                      device="meta"))
    with pytest.raises((RuntimeError, ValueError)):
        bitpack.unpack_bits(torch.zeros(2, dtype=torch.int64, device="meta"),
                            64)
    assert calls == [] and not any(dispatch.LAUNCHES.values())
    bitpack.pack_bits(torch.zeros(64, dtype=torch.uint8))
    bitpack.unpack_bits(torch.zeros(2, dtype=torch.int32), 64)
    assert calls == [torch.device("cpu")] * 2


# ---------------------------------------------------------------------------
# Card-only: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


# (R, n): aligned rows (n % 16 == 0, a partial last word at 48), ragged
# rows whose starts are not 16-byte aligned, and one long row
CARD_SHAPES = [(1, 32), (2, 48), (3, 1000), (2, 4103), (3, 37_005),
               (1, 1 << 22)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,n", CARD_SHAPES)
def test_card_pack_unpack_match_plain(card, R, n):
    gen = torch.Generator(device=card).manual_seed(n)
    bits = (torch.rand(R, n, generator=gen, device=card) < 0.4).to(
        torch.uint8)
    before = dict(dispatch.LAUNCHES)
    words = bitpack.pack_bits(bits)
    back = bitpack.unpack_bits(words, n)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["pack_bits"] == before["pack_bits"] + 1
    assert dispatch.LAUNCHES["unpack_bits"] == before["unpack_bits"] + 1
    assert torch.equal(words, bitpack.pack_bits_plain(bits))
    assert torch.equal(back, bits)
    # random words with the padding bits set: those never reach the rows
    w = torch.randint(-2**31, 2**31, words.shape, generator=gen,
                      device=card, dtype=torch.int64).to(torch.int32)
    assert torch.equal(bitpack.unpack_bits(w, n),
                       bitpack.unpack_bits_plain(w, n))


@pytest.mark.cuda
def test_card_pack_misaligned_view(card):
    """A row base off the 16-byte grid through a storage offset (n a
    multiple of 16): the pack kernel's byte path.  The unpack kernel
    allocates its output, so its byte path is the ragged n above."""
    gen = torch.Generator(device=card).manual_seed(1)
    buf = (torch.rand(2 * 4096 + 3, generator=gen, device=card) < 0.5).to(
        torch.uint8)
    bits = buf[3:].view(2, 4096)
    assert bits.data_ptr() % 16 != 0
    words = bitpack.pack_bits(bits)
    torch.cuda.synchronize()
    assert torch.equal(words, bitpack.pack_bits_plain(bits))
    assert torch.equal(bitpack.unpack_bits(words, 4096), bits)
