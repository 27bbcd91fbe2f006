"""Server-side aggregation (eq. 8): bit packing, the round step's pieces,
the host-side folds over client lists, the buffered-async helpers
(staleness weights, count folds and records, the wire checksum), the
mask means over a mesh's ranks (bf16 all-reduce or packed all-gather)
and the stochastic k-bit theta downlink.

Packed words are int32 tensors holding uint32 bit patterns: bit i of
word w is stream position 32*w + i (little-endian), the reference's
layout.  `pack_bits` and `unpack_bits` run the bit-packing kernels for a
CUDA tensor and their plain versions for a CPU one (`kernels.ops`).
"""
from __future__ import annotations

import warnings
import zlib
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree as tu
from repro_torch.kernels import bitpack, ops
from repro_torch.kernels import ref as kref

Pytree = Any


def pack_bits(mask_flat: torch.Tensor) -> torch.Tensor:
    """Pack a flat {0,1} vector whose length is a multiple of 32."""
    if mask_flat.ndim != 1 or mask_flat.numel() % 32:
        raise ValueError("pack_bits takes a flat vector of 32k bits; "
                         "pad with pad_to_words first")
    return ops.pack_bits(mask_flat)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_bits -> uint8 vector of length n; (R, W) word rows
    give (R, n) (one launch for a round's cohorts)."""
    return ops.unpack_bits(words, n)


def pad_to_words(x: torch.Tensor, word_bits: int = 32):
    """Flatten and zero-pad to a multiple of `word_bits`; (flat, pad)."""
    x = x.reshape(-1)
    pad = (-x.numel()) % word_bits
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x, pad


def sample_and_pack_rows(flat_scores: torch.Tensor, seeds, mode="sample",
                         tau: float = 0.5) -> torch.Tensor:
    """(C, n) score rows + C uint32 seeds -> (C, ceil(n/32)) words of
    m ~ Bern(sigmoid(scores)) (or 1[sigmoid > tau]), row c drawn from
    seeds[c]'s hash stream: the fused kernel on the card."""
    return ops.sample_and_pack(flat_scores, seeds, mode=mode, tau=tau)


def quantize_theta(theta: Pytree, generator: Optional[torch.Generator] = None,
                   bits: int = 8, u: Optional[list] = None) -> Pytree:
    """Unbiased stochastic k-bit quantization of theta for the downlink:
    levels in [0, 2^bits - 1] (uint8 for bits <= 8, else int32).  The
    uniforms come from `generator`, one draw per leaf in flatten order,
    or are injected as `u` (a list over the non-None leaves)."""
    levels = (1 << bits) - 1
    dtype = torch.uint8 if bits <= 8 else torch.int32
    it = iter(u) if u is not None else None

    def one(t):
        if t is None:
            return None
        x = torch.clamp(t.float(), 0.0, 1.0) * levels
        lo = torch.floor(x)
        uu = next(it) if it is not None else torch.rand(
            t.shape, generator=generator, device=t.device)
        return (lo + (uu < (x - lo)).float()).to(dtype)

    return tu.tree_map(one, theta)


def dequantize_theta(q: Pytree, bits: int = 8) -> Pytree:
    levels = (1 << bits) - 1
    return tu.tree_map(lambda t: None if t is None else t.float() / levels, q)


# ---------------------------------------------------------------------------
# Host-side aggregation over a list of client mask trees
# ---------------------------------------------------------------------------


def _weighted_f32_sum(trees, ws, cast_back: bool):
    def one(*ls):
        if ls[0] is None:
            return None
        acc = torch.zeros(ls[0].shape, dtype=torch.float32,
                          device=ls[0].device)
        for w, l in zip(ws, ls):
            acc = acc + w * l.float()
        return acc.to(ls[0].dtype) if cast_back else acc

    return tu.tree_map(one, *trees)


def _normalized(weights, k: int) -> list:
    if weights is None:
        weights = [1.0] * k
    wsum = float(sum(weights))
    return [w / wsum for w in weights]


def aggregate_masks(masks: Sequence[Pytree],
                    weights: Optional[Sequence[float]] = None) -> Pytree:
    """eq. 8: theta(t+1) = sum_i |D_i| m_i / sum_k |D_k| over a list of
    client mask trees ({0,1} leaves or None), in f32, client by client."""
    return _weighted_f32_sum(masks, _normalized(weights, len(masks)),
                             cast_back=False)


def aggregate_bayesian(masks: Sequence[Pytree], alpha0: float = 1.0,
                       beta0: float = 1.0) -> Pytree:
    """FedPM's Beta(alpha0 + ones, beta0 + zeros) posterior mean."""
    k = len(masks)

    def one(*ms):
        if ms[0] is None:
            return None
        ones = torch.zeros(ms[0].shape, dtype=torch.float32,
                           device=ms[0].device)
        for m in ms:
            ones = ones + m.float()
        return (alpha0 + ones) / (alpha0 + beta0 + k)

    return tu.tree_map(one, *masks)


def aggregate_floats(float_trees: Sequence[Pytree],
                     weights: Optional[Sequence[float]] = None) -> Pytree:
    """FedAvg of the float leaves (norms, biases) in f32, cast back to
    each leaf's dtype."""
    return _weighted_f32_sum(float_trees,
                             _normalized(weights, len(float_trees)),
                             cast_back=True)


# ---------------------------------------------------------------------------
# Buffered-async support: staleness-discounted weights, count folds and
# the wire-integrity checksum
# ---------------------------------------------------------------------------


def staleness_weight(staleness, alpha: float = 1.0):
    """FedBuff's polynomial discount (1 + s)^-alpha: exactly 1.0 at s = 0.
    A tensor gives f32, a numpy array numpy f32, a number a float."""
    if isinstance(staleness, torch.Tensor):
        return (1.0 + staleness.float()) ** (-alpha)
    if isinstance(staleness, np.ndarray):
        return (np.float32(1.0) + staleness) ** (-alpha)
    return float((1.0 + staleness) ** (-alpha))


def staleness_weights(sizes, staleness, alpha: float = 1.0) -> torch.Tensor:
    """Normalized fold weights of a commit buffer: |D_i| discounted by
    staleness and renormalized, the formula `run_round` applies to its
    participation vector, so an all-fresh buffer weighs as a synchronous
    round does."""
    sizes = torch.as_tensor(sizes, dtype=torch.float32)
    disc = staleness_weight(torch.as_tensor(staleness, dtype=torch.float32,
                                            device=sizes.device), alpha)
    # s == 0 contributes exactly `sizes` (the discount is exactly 1.0)
    w = torch.where(disc == 1.0, sizes, sizes * disc)
    return w / torch.clamp(w.sum(), min=1e-9)


def _as_words(words) -> torch.Tensor:
    """int32-stored uint32 words from a tensor or a numpy uint32 array."""
    if isinstance(words, torch.Tensor):
        return words
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(words, np.uint32)).view(np.int32))


def fold_popcount(acc_ones, words) -> int:
    """Add one arrival's set-bit count to a host accumulator (an unbounded
    Python int, so the fold is exact at any scale)."""
    return int(acc_ones) + int(kref.popcount32(_as_words(words)).sum())


def fold_bit_counts(acc, words) -> torch.Tensor:
    """Add one client's (W,) or a chunk of clients' (B, W) packed words
    into an int32 per-bit count accumulator over the padded word domain
    (P = 32 W).  Integer counts: any grouping of clients gives the same
    accumulator."""
    w = _as_words(words)
    if w.ndim == 1:
        w = w[None, :]
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    # an arithmetic shift, then & 1: exact on negative int32 words too
    bits = (w.to(torch.int32)[:, :, None] >> shifts) & 1
    return torch.as_tensor(acc, dtype=torch.int32, device=w.device) + \
        bits.reshape(w.shape[0], -1).sum(dim=0, dtype=torch.int32)


_COUNT_DTYPES = {8: "<u1", 16: "<u2", 32: "<u4"}


def host_words(words) -> np.ndarray:
    """Packed words as host uint32: an int32-stored tensor, read back from
    its device, or a numpy array."""
    if isinstance(words, torch.Tensor):
        t = words.detach().cpu().contiguous()
        return t.numpy().view(np.uint32) if t.dtype == torch.int32 \
            else np.asarray(t.numpy(), np.uint32)
    return np.asarray(words, np.uint32)


def pack_counts(counts, acc_bits: int = 16) -> np.ndarray:
    """Fixed-width host serialization of a count accumulator into uint32
    words, little-endian, `acc_bits` (8, 16 or 32) a count: the record's
    size depends only on the number of counts.  A count that does not fit
    its field raises OverflowError (truncation would forge the fold)."""
    if acc_bits not in _COUNT_DTYPES:
        raise ValueError(f"acc_bits must be one of 8/16/32, got {acc_bits}")
    c = (counts.detach().cpu().numpy() if isinstance(counts, torch.Tensor)
         else np.asarray(counts)).reshape(-1)
    if c.size and (int(c.max()) >> acc_bits or int(c.min()) < 0):
        raise OverflowError(f"count {int(c.max())} does not fit "
                            f"{acc_bits}-bit accumulator field")
    per = 32 // acc_bits
    pad = (-c.size) % per
    c = c.astype(np.uint64)
    if pad:
        c = np.concatenate([c, np.zeros((pad,), np.uint64)])
    return np.ascontiguousarray(
        c.astype(_COUNT_DTYPES[acc_bits])).view("<u4").astype(np.uint32)


def unpack_counts(words, n: int, acc_bits: int = 16) -> np.ndarray:
    """Inverse of `pack_counts`: words -> int64 (n,) counts."""
    if acc_bits not in _COUNT_DTYPES:
        raise ValueError(f"acc_bits must be one of 8/16/32, got {acc_bits}")
    w = np.ascontiguousarray(host_words(words).astype("<u4"))
    return w.view(_COUNT_DTYPES[acc_bits])[:n].astype(np.int64)


def packed_count_bits(n_positions: int, acc_bits: int = 16) -> int:
    """Serialized bits of one `pack_counts` record (word-aligned)."""
    per = 32 // acc_bits
    return 32 * ((n_positions + per - 1) // per)


def words_checksum(arrays) -> int:
    """CRC32 over word streams' little-endian uint32 bytes, in order (the
    `WireMessage` integrity header).  Each array is numpy uint32 or an
    int32-stored word tensor, which is read back to the host."""
    h = 0
    for a in arrays:
        b = np.ascontiguousarray(host_words(a).astype("<u4")).tobytes()
        h = zlib.crc32(b, h)
    return int(h & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Collectives over a process group (a mesh's `group(axis_names)`): each
# rank holds its own mask tree, theta is the mean over the group's ranks
# ---------------------------------------------------------------------------


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(R, ...) on each of the group's k ranks -> (k R, ...) in group rank
    order, through one `all_gather_into_tensor` (the name both PyTorch
    releases the port runs on have; later ones deprecate it for
    `all_gather_single`)."""
    k = dist.get_world_size(group)
    out = torch.empty((k * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*all_gather_into_tensor",
                                FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def mask_mean_psum(mask: Pytree, group) -> Pytree:
    """bf16 path: theta = the mean over the ranks of `group`, an
    all-reduce of the masks in bf16 (16 bits a parameter), in f32."""
    k = dist.get_world_size(group)

    def one(m):
        if m is None:
            return None
        s = m.to(torch.bfloat16, copy=True)
        dist.all_reduce(s, group=group)
        return s.float() / k

    return tu.tree_map(one, mask)


def mask_mean_packed(mask: Pytree, group, use_kernel: bool = False) -> Pytree:
    """Bit-packed path: each leaf packs 32 mask bits a word, the ranks of
    `group` all-gather the words (1 bit a parameter and rank on the wire)
    and each unpacks them and takes the f32 mean.  `use_kernel` packs
    with kernel 10 (`pack_bits`) and unpacks with kernel 11 on the card;
    without it both are the plain versions, as the reference's jnp
    path."""
    k = dist.get_world_size(group)
    pack, unpack = ((pack_bits, unpack_bits) if use_kernel else
                    (bitpack.pack_bits_plain, bitpack.unpack_bits_plain))

    def one(m):
        if m is None:
            return None
        flat, _ = pad_to_words(m.reshape(-1))
        gathered = all_gather_rows(pack(flat)[None], group)
        return unpack(gathered, m.numel()).float().mean(
            dim=0).reshape(m.shape)

    return tu.tree_map(one, mask)


def uplink_bits(mask: Pytree, packed: bool = True) -> int:
    """Bits a client sends for this mask tree: word-aligned 1 Bpp packed,
    16 Bpp as bf16."""
    n = sum(m.numel() for m in tu.leaves(mask) if m is not None)
    if packed:
        return ((n + 31) // 32) * 32
    return n * 16
