"""Binary uplink transport helpers (part of `repro.api.payloads`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import aggregation


def pack_leaf(m: torch.Tensor) -> torch.Tensor:
    """Bitpack one {0,1} leaf into a flat word vector."""
    flat, _ = aggregation.pad_to_words(m.reshape(-1))
    return aggregation.pack_bits(flat)


def mean_from_words(words: torch.Tensor, n: int,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted mean of K bitpacked clients: (K, W) words -> (n,) f32
    (eq. 8); `weights` defaults to the uniform mean."""
    bits = aggregation.unpack_bits(words, n).float()
    if weights is None:
        return bits.mean(dim=0)
    return torch.tensordot(weights.float(), bits, dims=([0], [0]))
