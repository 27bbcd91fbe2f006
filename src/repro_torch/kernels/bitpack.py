"""Wrappers of the two bit-packing CUDA kernels, each beside its plain
PyTorch version.

    pack_bits    (R, n) {0,1} rows -> (R, ceil(n/32)) words  csrc/pack_bits.cu
    unpack_bits  (R, W) words, n   -> (R, n) uint8 rows    csrc/unpack_bits.cu

Bit j of word w of a row is element 32w + j (little-endian), the JAX
reference's layout; `pack_bits` zero-fills the bits at or past n, as the
reference's zero-pad to 32 does.  Words are int32 tensors holding the
uint32 bit patterns.  A 1-D input is one row.

Dispatch is by the tensor's device: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises, a meta tensor gets an empty
meta result of the kernel's shape (`kernels.dispatch`).  Each
launch adds one to `dispatch.LAUNCHES[name]`; each wrapper runs inside
`dispatch.kernel_boundary`, one opaque op to the op walker.  The kernels take
contiguous uint8 (or bool) bits and int32 words and raise on anything
else rather than copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, dispatch, ref


def pack_bits_plain(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) {0,1} -> (..., ceil(n/32)) words, bits past n zero."""
    pad = (-bits.shape[-1]) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return ref.pack_bits(bits)


unpack_bits_plain = ref.unpack_bits


def _aligned(t: torch.Tensor, row_bytes: int) -> int:
    """1 when every row of `t` starts on a 16-byte boundary."""
    return int(t.data_ptr() % 16 == 0 and row_bytes % 16 == 0)


def _rows(t: torch.Tensor, name: str, dtypes) -> torch.Tensor:
    if t.dtype not in dtypes or t.ndim not in (1, 2) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous 1-D or 2-D "
                         f"{' or '.join(map(str, dtypes))} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
    return t.reshape(1, -1) if t.ndim == 1 else t


@dispatch.kernel_boundary("pack_bits")
def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits: (n,) or (R, n) {0,1} -> (ceil(n/32),) or (R, ceil(n/32))
    int32 words; bits at or past n are zero."""
    where = dispatch.placement(bits)
    if where == "cpu":
        return pack_bits_plain(bits)
    b2 = _rows(bits, "bits", (torch.uint8, torch.bool))
    R, n = b2.shape
    words = torch.empty((R, (n + 31) // 32), dtype=torch.int32,
                        device=bits.device)
    dispatch.count_work("pack_bits", 0, dispatch.nbytes(b2, words))
    if where == "cuda" and R and n:
        build.launch("pack_bits", b2.data_ptr(), words.data_ptr(), R, n,
                     _aligned(b2, n), dispatch.stream(b2))
        dispatch.LAUNCHES["pack_bits"] += 1
    return words.reshape(-1) if bits.ndim == 1 else words


@dispatch.kernel_boundary("unpack_bits")
def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """words: (W,) or (R, W) int32 -> (n,) or (R, n) uint8, n <= 32W."""
    n = int(n)
    if not 0 <= n <= 32 * words.shape[-1]:
        raise ValueError(f"unpack_bits: n={n} does not fit "
                         f"{words.shape[-1]} words")
    where = dispatch.placement(words)
    if where == "cpu":
        return unpack_bits_plain(words, n)
    w2 = _rows(words, "words", (torch.int32,))
    R, W = w2.shape
    bits = torch.empty((R, n), dtype=torch.uint8, device=words.device)
    dispatch.count_work("unpack_bits", 0, dispatch.nbytes(w2, bits))
    if where == "cuda" and R and n:
        build.launch("unpack_bits", w2.data_ptr(), bits.data_ptr(), R, W, n,
                     _aligned(bits, n), dispatch.stream(w2))
        dispatch.LAUNCHES["unpack_bits"] += 1
    return bits.reshape(-1) if words.ndim == 1 else bits
