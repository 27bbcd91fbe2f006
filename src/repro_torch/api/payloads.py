"""Binary uplink payloads and their transport helpers (part of
`repro.api.payloads`).

`BitpackedMasks` is the deployable mask artifact's layout: one word
vector per masked leaf, 32 bits to an int32-stored uint32 word, packed
by the bit-packing kernel on the card.  It is a plain dataclass (the
reference registers it as a pytree for `jit`; nothing here traces)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import aggregation, masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

Pytree = Any


def pack_leaf(m: torch.Tensor) -> torch.Tensor:
    """Bitpack one {0,1} leaf into a flat word vector; the bits past the
    leaf's size are zero (the kernel pads by index)."""
    return ops.pack_bits(m.reshape(-1))


def mean_from_words(words: torch.Tensor, n: int,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted mean of K bitpacked clients: (K, W) words -> (n,) f32
    (eq. 8); `weights` defaults to the uniform mean.  The K rows unpack
    in one launch of the unpack kernel on the card."""
    bits = aggregation.unpack_bits(words, n).float()
    if weights is None:
        return bits.mean(dim=0)
    return torch.tensordot(weights.float(), bits, dims=([0], [0]))


@dataclasses.dataclass
class BitpackedMasks:
    """Binary masks, 32 bits to a word, per leaf.

    words:  tree mirroring the mask tree; (W,) int32 word vectors at
            masked leaves, None where the model keeps float leaves.
    floats: optional float sidecar (norms, biases), not counted in the
            mask's bits per parameter.
    shapes: the masked leaves' shapes in flatten order, for unpacking."""
    words: Pytree
    floats: Pytree
    shapes: tuple

    @classmethod
    def from_masks(cls, masks: Pytree, floats: Pytree = None
                   ) -> "BitpackedMasks":
        words = tu.tree_map(lambda m: None if m is None else pack_leaf(m),
                            masks)
        shapes = tuple(tuple(m.shape) for m in tu.leaves(masks)
                       if m is not None)
        return cls(words, floats, shapes)

    @classmethod
    def from_path_dict(cls, masks: dict, floats: Pytree = None
                       ) -> "BitpackedMasks":
        """The inverse of `as_path_dict`, for a loaded artifact's
        {path: (words, shape)}: a flat tree keyed by path, so `to_masks`
        gives {path: mask}."""
        words = {p: w for p, (w, _) in masks.items()}
        return cls(words, floats,
                   tuple(tuple(masks[p][1]) for p in sorted(masks)))

    def to_masks(self) -> Pytree:
        it = iter(self.shapes)

        def one(w):
            if w is None:
                return None
            sh = next(it)
            return aggregation.unpack_bits(w, math.prod(sh)).reshape(sh)

        return tu.tree_map(one, self.words)

    def num_params(self) -> int:
        return sum(math.prod(sh) for sh in self.shapes)

    def wire_bits(self) -> int:
        return sum(32 * ((math.prod(sh) + 31) // 32) for sh in self.shapes)

    def bpp(self) -> torch.Tensor:
        """Empirical entropy of the transmitted bits (eq. 13), float32;
        padding bits are zero and n counts real parameters only."""
        ones = sum(int(kref.popcount32(w).sum()) for w in
                   tu.leaves(self.words) if w is not None)
        n = self.num_params()
        if n == 0:
            return torch.tensor(0.0)
        f32 = torch.float32
        return regularizer.binary_entropy(
            torch.tensor(float(ones), dtype=f32)
            / torch.tensor(float(n), dtype=f32))

    def as_path_dict(self) -> dict:
        """{path: (words, shape)}: the artifact layout
        `ckpt.save_artifact` writes."""
        it = iter(self.shapes)
        return {path: (w, next(it))
                for path, w in masking.leaves_with_paths(self.words)}
