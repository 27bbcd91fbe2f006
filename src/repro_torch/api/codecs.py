"""Uplink wire meters (part of `repro.api.codecs`) and the CommLedger.

A codec meters what its encoder would put on the wire, exactly, in bits:
`measure_bits(payload)` for one client's `BitpackedMasks` (the round
engine, `api.protocol.run_round`), `measure_pooled_words(words, n)` for
a cohort's pooled, bit-packed uplink (the pod-scale round step), and
`sidecar_bits(payload)` for the float leaves riding along.  Both meters
here need only the word count and the popcount, so the mask is never
unpacked for metering.  The arithmetic coder's size formula runs in IEEE
float32 scalars (numpy), the reference's own host formula.  The encoders
and decoders themselves are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import tree as tu
from repro_torch.kernels import ref as kref

WORD_BITS = 32


def word_align(bits: int) -> int:
    """Round a bit count up to whole uint32 words."""
    return (bits + (WORD_BITS - 1)) // WORD_BITS * WORD_BITS


def _popcount(words: torch.Tensor) -> int:
    return int(kref.popcount32(words).sum())


def popcount_total(payload) -> int:
    """Ones over every word leaf of a packed payload (padding bits are
    zero), with one read back to the host."""
    parts = [kref.popcount32(w).sum() for w in tu.leaves(payload.words)
             if w is not None]
    return int(torch.stack(parts).sum()) if parts else 0


def float_tree_bits(tree) -> int:
    """Serialized size of a float tree, each leaf word-aligned."""
    return sum(word_align(l.numel() * l.element_size() * 8)
               for l in tu.leaves(tree) if l is not None)


def _payload_n(payload) -> int:
    return sum(math.prod(sh) for sh in payload.shapes)


class Codec:
    """A wire codec's meters: `measure_bits` is the coded size of one
    payload excluding its float sidecar, `sidecar_bits` the sidecar's."""

    name: str = "abstract"

    def accepts(self, payload_cls: type) -> bool:
        from repro_torch.api import payloads as plds
        return issubclass(payload_cls, plds.BitpackedMasks)

    def measure_bits(self, payload) -> int:
        raise NotImplementedError

    def sidecar_bits(self, payload) -> int:
        floats = getattr(payload, "floats", None)
        return float_tree_bits(floats) if floats is not None else 0

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class Bitpack32(Codec):
    """Pooled bits, 32 -> 1 words: exactly align32(n) bits."""

    name = "bitpack"

    def measure_pooled_words(self, words: torch.Tensor, n: int) -> int:
        return word_align(n)

    def measure_bits(self, payload) -> int:
        return word_align(_payload_n(payload))


class ArithmeticBernoulli(Codec):
    """Bernoulli-prior arithmetic coding of the pooled bits: a 32-bit
    header with the 16-bit quantized prior p1, then ~n*H(p1) bits plus a
    fixed termination slack, word-aligned."""

    name = "arithmetic"
    _PSCALE = 1 << 16

    @classmethod
    def _p1_scaled(cls, ones: int, n: int) -> int:
        p = np.float32(ones) / np.float32(n)
        s = np.round(p * np.float32(cls._PSCALE))
        return int(np.clip(np.int64(s), 1, cls._PSCALE - 1))

    @classmethod
    def _target_bits(cls, ones: int, n: int, p1c: int) -> int:
        f32 = np.float32
        p1 = f32(p1c) / f32(cls._PSCALE)
        ideal = -(f32(ones) * np.log2(p1) + f32(n - ones) * np.log2(
            f32(1) - p1))
        slack = 48 + (n >> 13)
        return word_align(int(np.ceil(ideal)) + 32 + slack)

    def measure_pooled_words(self, words: torch.Tensor, n: int) -> int:
        if n == 0:
            return 0
        ones = _popcount(words)
        return self._target_bits(ones, n, self._p1_scaled(ones, n))

    def measure_bits(self, payload) -> int:
        n = _payload_n(payload)
        if n == 0:
            return 0
        ones = popcount_total(payload)
        return self._target_bits(ones, n, self._p1_scaled(ones, n))


CODECS = {c.name: c for c in (Bitpack32(), ArithmeticBernoulli())}


def available() -> tuple:
    return tuple(sorted(CODECS))


def get_codec(name: str):
    if name not in CODECS:
        raise KeyError(f"unknown codec {name!r}; available: "
                       f"{', '.join(available())}")
    return CODECS[name]


def resolve(codec, payload_spec) -> Codec:
    """None -> the spec's default codec; a name -> the registry's codec; a
    Codec -> itself.  Checks that it can serialize the spec's payload
    class."""
    if codec is None:
        codec = payload_spec.default_codec
    if isinstance(codec, str):
        codec = get_codec(codec)
    if not codec.accepts(payload_spec.cls):
        raise ValueError(f"codec {codec.name!r} cannot serialize "
                         f"{payload_spec.cls.__name__} payloads")
    return codec


@dataclasses.dataclass
class CommLedger:
    """Measured wire bits across rounds, both directions (MB = 1e6 B)."""

    uplink_bits: float = 0.0
    downlink_bits: float = 0.0
    rounds: int = 0

    def update(self, metrics: Dict[str, Any]) -> "CommLedger":
        self.uplink_bits += float(metrics.get("uplink_bits_measured", 0.0))
        self.downlink_bits += float(metrics.get("downlink_bits", 0.0))
        self.rounds += 1
        return self

    @property
    def uplink_mb(self) -> float:
        return self.uplink_bits / 8e6

    @property
    def downlink_mb(self) -> float:
        return self.downlink_bits / 8e6

    @property
    def total_mb(self) -> float:
        return self.uplink_mb + self.downlink_mb

    def as_dict(self) -> Dict[str, float]:
        return {"rounds": self.rounds,
                "cumulative_uplink_mb": self.uplink_mb,
                "cumulative_downlink_mb": self.downlink_mb,
                "cumulative_total_mb": self.total_mb}
