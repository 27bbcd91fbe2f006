"""Typed payloads in both directions and their transport helpers
(`repro.api.payloads`).

Every client sends one `UplinkPayload` a round, and its type fixes the
reported bits per parameter:

  * `BitpackedMasks`: binary masks, one word vector per masked leaf, 32
    bits to an int32-stored uint32 word, packed by the bit-packing
    kernel on the card (also the deployable mask artifact's layout); the
    empirical entropy of the transmitted bits (eq. 13), at most 1;
  * `SignVotes`: bitpacked gradient signs (MV-SignSGD), exactly 1;
  * `FloatDeltas`: raw float tensors (FedAvg), the dtype width.

The server's broadcast is a
`DownlinkPayload`: `ProbBroadcast` puts the stochastic k-bit theta
quantization on the wire, `FloatBroadcast` the raw floats.

Payloads are plain dataclasses (the reference registers them as pytrees
for `jit` and `vmap`; nothing here traces).  The round engine collects
one payload per client and stacks them (`stack_payloads`): every tensor
leaf then carries a leading client axis, and `batched_packed_mean`
reduces the K clients' words in one launch of the unpack kernel."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.api import codecs as codecs_lib
from repro_torch.core import aggregation, masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.kernels import ops

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


def mean_from_counts(counts: torch.Tensor, n: int,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean from pooled per-bit counts: (C, P) integer counts of
    C weight classes (P over the padded word domain) and (C,) per-client
    class weights -> (n,) f32, sum_c weights[c] * counts[c] -- the
    per-class twin of `mean_from_words` an aggregator tree's root reduces
    through."""
    c = torch.as_tensor(counts).float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=c.device)
    return torch.tensordot(w, c, dims=([0], [0]))[:n]


class UplinkPayload:
    """One client's uplink: `num_params` and `wire_bits` are ints, `bpp`
    the reported bits per parameter (a 0-d f32 tensor)."""

    def num_params(self) -> int:
        return sum(math.prod(sh) for sh in self.shapes)

    def wire_bits(self) -> int:
        """Exact serialized size in bits (word-aligned where packed)."""
        raise NotImplementedError

    def bpp(self) -> torch.Tensor:
        raise NotImplementedError


def _packed_wire_bits(shapes) -> int:
    return sum(32 * ((math.prod(sh) + 31) // 32) for sh in shapes)


@dataclasses.dataclass
class BitpackedMasks(UplinkPayload):
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

    def wire_bits(self) -> int:
        return _packed_wire_bits(self.shapes)

    def bpp(self) -> torch.Tensor:
        """Empirical entropy of the transmitted bits (eq. 13), float32;
        padding bits are zero and n counts real parameters only."""
        ones = codecs_lib.popcount_total(self)
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


@dataclasses.dataclass
class SignVotes(UplinkPayload):
    """Bitpacked gradient signs (MV-SignSGD), exactly 1 bit a parameter:
    bit 1 is +1, bit 0 is -1.  The wire has no zero: a sign of exactly 0
    goes out as -1, so a sender with exact-zero gradients breaks the tie
    first (the registered `mv_signsgd` flips a fair coin)."""
    words: Pytree
    shapes: tuple

    @classmethod
    def from_signs(cls, signs: Pytree) -> "SignVotes":
        """One pack launch a leaf on the card."""
        words = tu.tree_map(lambda s: None if s is None else pack_leaf(
            (s > 0).to(torch.uint8)), signs)
        return cls(words, _leaf_shapes(signs))

    def to_signs(self) -> Pytree:
        """The f32 +-1 signs, one unpack launch a leaf on the card."""
        it = iter(self.shapes)

        def one(w):
            if w is None:
                return None
            sh = next(it)
            return (2.0 * aggregation.unpack_bits(
                w, math.prod(sh)).float() - 1.0).reshape(sh)

        return tu.tree_map(one, self.words)

    def wire_bits(self) -> int:
        return _packed_wire_bits(self.shapes)

    def bpp(self) -> torch.Tensor:
        return torch.tensor(0.0 if self.num_params() == 0 else 1.0)


@dataclasses.dataclass
class FloatDeltas(UplinkPayload):
    """Raw float tensors (deltas or full params): the dtype width on the
    wire, 32 Bpp for f32, the reference the paper compresses."""
    values: Pytree
    shapes: tuple
    bits: tuple   # each leaf's dtype width, flatten order

    @classmethod
    def from_tree(cls, values: Pytree) -> "FloatDeltas":
        return cls(values, _leaf_shapes(values), _float_bits(values))

    def wire_bits(self) -> int:
        return sum(math.prod(sh) * b for sh, b in zip(self.shapes, self.bits))

    def bpp(self) -> torch.Tensor:
        n = self.num_params()
        return torch.tensor(0.0 if n == 0 else self.wire_bits() / n,
                            dtype=torch.float32)


def _leaf_shapes(tree: Pytree) -> tuple:
    return tuple(tuple(l.shape) for l in tu.leaves(tree) if l is not None)


def _float_bits(tree: Pytree) -> tuple:
    return tuple(l.element_size() * 8 for l in tu.leaves(tree)
                 if l is not None)


# ---------------------------------------------------------------------------
# Downlink payloads: what the server broadcasts each round
# ---------------------------------------------------------------------------


class DownlinkPayload:
    """One round's server broadcast."""

    def num_params(self) -> int:
        raise NotImplementedError

    def wire_bits(self) -> int:
        """Exact serialized size in bits (word-aligned where packed)."""
        raise NotImplementedError

    def sidecar_bits(self) -> int:
        """Float side-channel bits riding along (norms, biases)."""
        return 0

    def bpp(self) -> torch.Tensor:
        n = self.num_params()
        if n == 0:
            return torch.tensor(0.0)
        return torch.tensor(self.wire_bits() / n, dtype=torch.float32)


@dataclasses.dataclass
class ProbBroadcast(DownlinkPayload):
    """theta quantized stochastically to k bits on the downlink wire
    (`aggregation.quantize_theta`).

    q:      uint8 (k <= 8) or int32 levels in [0, 2^k - 1], None at float
            leaves; an unbiased estimator of theta.
    floats: the averaged float leaves broadcast alongside (sidecar).
    bits:   the quantization width k."""
    q: Pytree
    floats: Pytree
    bits: int

    @classmethod
    def from_theta(cls, theta: Pytree,
                   generator: Optional[torch.Generator] = None,
                   bits: int = 8, floats: Pytree = None,
                   u: Optional[list] = None) -> "ProbBroadcast":
        """Uniforms from `generator`, one draw per leaf in flatten order,
        or injected as `u`."""
        return cls(aggregation.quantize_theta(theta, generator, bits=bits,
                                              u=u), floats, bits)

    def to_theta(self) -> Pytree:
        """What the clients receive: the dequantized theta."""
        return aggregation.dequantize_theta(self.q, bits=self.bits)

    def num_params(self) -> int:
        return sum(l.numel() for l in tu.leaves(self.q) if l is not None)

    def wire_bits(self) -> int:
        return sum(codecs_lib.word_align(l.numel() * self.bits)
                   for l in tu.leaves(self.q) if l is not None)

    def sidecar_bits(self) -> int:
        return codecs_lib.float_tree_bits(self.floats)


@dataclasses.dataclass
class FloatBroadcast(DownlinkPayload):
    """Raw float broadcast (server params or scores): the dtype width on
    the wire, the 32-Bpp downlink reference."""
    values: Pytree
    shapes: tuple
    bits: tuple

    @classmethod
    def from_tree(cls, values: Pytree) -> "FloatBroadcast":
        return cls(values, _leaf_shapes(values), _float_bits(values))

    def num_params(self) -> int:
        return sum(math.prod(sh) for sh in self.shapes)

    def wire_bits(self) -> int:
        return sum(math.prod(sh) * b for sh, b in zip(self.shapes, self.bits))


# ---------------------------------------------------------------------------
# Engine-batched payloads: a leading client axis on every tensor leaf
# ---------------------------------------------------------------------------

_STATIC = ("shapes", "bits")   # dataclass fields that carry no tensors


def _map_payloads(fn, payloads):
    first = payloads[0]
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(p, f.name) for p in payloads]
        kw[f.name] = vals[0] if f.name in _STATIC or vals[0] is None \
            else tu.tree_map(lambda *ls: None if ls[0] is None else fn(ls),
                             *vals)
    return type(first)(**kw)


def stack_payloads(payloads) -> Any:
    """Stack same-structure payloads into one engine-batched payload (every
    tensor leaf gains a leading axis): the round engine's form of a
    cohort's uplinks, which `aggregate` reduces."""
    if not payloads:
        raise ValueError("stack_payloads needs at least one payload")
    return _map_payloads(torch.stack, list(payloads))


def slice_payload(payload, i: int):
    """Client i's payload out of an engine-batched one."""
    return _map_payloads(lambda ls: ls[0][i], [payload])


def batched_packed_mean(payload, weights: torch.Tensor) -> Pytree:
    """Weighted mean of K clients' bits straight from the packed words
    (eq. 8), for any packed payload with `words` and `shapes`
    (`BitpackedMasks` -> theta, `SignVotes` -> the vote fraction): every
    words leaf is (K, W); the mean comes back in the leaves' shapes, one
    unpack launch a leaf."""
    it = iter(payload.shapes)

    def one(w):
        if w is None:
            return None
        sh = next(it)
        return mean_from_words(w, math.prod(sh), weights).reshape(sh)

    return tu.tree_map(one, payload.words)


def batched_float_mean(tree: Pytree, weights: torch.Tensor) -> Pytree:
    """Weighted mean over the leading K axis, in f32, cast back to each
    leaf's dtype."""
    return tu.tree_map(
        lambda f: None if f is None else torch.tensordot(
            weights.float(), f.float(), dims=([0], [0])).to(f.dtype), tree)
