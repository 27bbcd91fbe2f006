"""Server-side aggregation pieces of the round step (eq. 8), bit packing
and the stochastic k-bit theta downlink.

Packed words are int32 tensors holding uint32 bit patterns: bit i of
word w is stream position 32*w + i (little-endian), the reference's
layout.  `pack_bits` and `unpack_bits` run the bit-packing kernels for a
CUDA tensor and their plain versions for a CPU one (`kernels.ops`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import tree as tu
from repro_torch.kernels import ops

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
