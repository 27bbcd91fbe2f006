"""Pluggable wire codecs (`repro.api.codecs`): real serialization,
metered on the wire.

The payload layer (`api.payloads`) fixes what a client transmits; a
`Codec` fixes how it is coded into uint32 words and what that costs,
exactly:

    msg     = codec.encode(payload)          # host numpy, real words
    payload = codec.decode(msg)              # the lossless inverse
    bits    = codec.measure_bits(payload)    # encode's size, without
                                             # encoding

`encode` and `decode` run on the host in numpy, as the reference's do: a
payload's words and floats on the card are read back with `.cpu()`, and
`decode` rebuilds the payload's tensors on the CPU.  Words are int32
tensors holding uint32 patterns; the host views them as uint32, so the
streams and their CRC32 are byte-identical to the reference's.  The
meters stay on the payload's device: a popcount or a chunked scan over
the packed words, never the unpacked mask.  For `Bitpack32`, `SignPack`,
`GolombRice` and `Float32Raw` the meter equals the encoder's size
exactly; `ArithmeticBernoulli` pads its stream to the target its meter
computes, in the same IEEE f32 host formula, so the two agree too (the
reference's traced meter may differ from its encoder by one word).

Binary codecs pool every mask leaf into one bitstream with one header:
the eq. 13 entropy bound is computed over the pooled bits, and pooling
lets a real coder approach it without a header a leaf.

    codec       class                wire format                rate
    ----------  -------------------  -------------------------  -----------
    bitpack     Bitpack32            pooled bits, 32 -> 1 words  1 Bpp
    golomb      GolombRice           Rice codes of the 1-gaps   << 1 sparse
    arithmetic  ArithmeticBernoulli  Bernoulli arithmetic code  ~H(p) + eps
    signpack    SignPack             sign bits, 32 -> 1 words    1 Bpp
    float32     Float32Raw           raw IEEE words             dtype width

`CommLedger` adds up the measured two-way traffic across rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core import tree as tu
from repro_torch.kernels import ref as kref

WORD_BITS = 32

# words of a packed stream that `GolombRice`'s meters expand to bit lanes
# at once (8 M bits: 32 MB of lanes, up to 64 MB of positions)
GOLOMB_CHUNK_WORDS = 1 << 18


def word_align(bits: int) -> int:
    """Round a bit count up to whole uint32 words."""
    return (bits + (WORD_BITS - 1)) // WORD_BITS * WORD_BITS


# ---------------------------------------------------------------------------
# Host bit IO (numpy).  Bit i of word w is stream position 32*w + i, the
# order of `aggregation.pack_bits`.
# ---------------------------------------------------------------------------


class _BitWriter:
    """Collects a stream's bits in order; `to_array` packs them."""

    def __init__(self):
        self.bits = bytearray()

    @property
    def pos(self) -> int:
        return len(self.bits)

    def write(self, value: int, nbits: int) -> None:
        self.bits.extend((value >> i) & 1 for i in range(nbits))

    def to_array(self, pad_to_bits: Optional[int] = None) -> np.ndarray:
        total = self.pos if pad_to_bits is None else pad_to_bits
        if total < self.pos:
            raise ValueError(
                f"stream is {self.pos} bits, cannot pad to {total}")
        arr = np.zeros(((total + WORD_BITS - 1) // WORD_BITS,), np.uint32)
        words = _np_pack(np.frombuffer(bytes(self.bits), np.uint8))
        arr[: words.size] = words
        return arr


class _BitReader:
    """Reads a packed stream bit by bit; past its end it reads zeros."""

    def __init__(self, words: np.ndarray):
        words = np.asarray(words, np.uint32)
        self.bits = _np_unpack(words, words.size * WORD_BITS).tolist()
        self.pos = 0
        self.limit = len(self.bits)

    def read_bit(self) -> int:
        if self.pos >= self.limit:       # zero padding past the stream
            return 0
        self.pos += 1
        return self.bits[self.pos - 1]

    def read(self, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            v |= self.read_bit() << i
        return v


def _np_unpack(words: np.ndarray, n: int) -> np.ndarray:
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (np.asarray(words, np.uint32)[:, None] >> shifts) & np.uint32(1)
    return bits.reshape(-1)[:n].astype(np.uint8)


def _np_pack(bits: np.ndarray) -> np.ndarray:
    pad = (-bits.size) % WORD_BITS
    if pad:
        bits = np.concatenate([bits, np.zeros((pad,), bits.dtype)])
    bits = bits.astype(np.uint32).reshape(-1, WORD_BITS)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (bits << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# WireMessage
# ---------------------------------------------------------------------------


# the per-message integrity header: one uint32 CRC32 over the words and
# the sidecar, metered apart from the payload (`header_bits`, like the
# sidecar), so `wire_bits` stays exactly what the codec puts on the stream
HEADER_BITS = WORD_BITS


class ChecksumError(ValueError):
    """A WireMessage failed its integrity check (corrupted in transit)."""


@dataclasses.dataclass
class WireMessage:
    """One client's serialized transmission.

    words:    the coded streams (np.uint32 arrays), the metered payload
              (masks, signs or floats).
    sidecar:  the raw float side channel (norms and biases averaged
              beside bitpacked masks) as uint32 views: counted in the
              ledger, not in the mask's bits per parameter.
    meta:     what decoding needs (tree structures, shapes, dtypes).
    checksum: CRC32 over words + sidecar (`aggregation.words_checksum`),
              stamped at encode time; `decode` raises `ChecksumError`
              when the streams no longer match it.  It costs
              `HEADER_BITS`, reported as `header_bits` beside `wire_bits`.
    """
    codec: str
    payload_cls: type
    words: List[np.ndarray]
    sidecar: List[np.ndarray]
    meta: Dict[str, Any]
    word_bits: int = WORD_BITS
    checksum: Optional[int] = None

    def __post_init__(self):
        if self.checksum is None:
            self.checksum = self.compute_checksum()

    def compute_checksum(self) -> int:
        return aggregation.words_checksum(
            list(self.words) + list(self.sidecar))

    def verify(self) -> bool:
        """True when the streams still match the stamped checksum."""
        return self.checksum == self.compute_checksum()

    def verify_or_raise(self) -> None:
        if not self.verify():
            raise ChecksumError(
                f"WireMessage({self.codec}) checksum mismatch: header "
                f"{self.checksum:#010x} != stream "
                f"{self.compute_checksum():#010x}")

    @property
    def wire_bits(self) -> int:
        return sum(int(w.size) for w in self.words) * self.word_bits

    @property
    def sidecar_bits(self) -> int:
        return sum(int(w.size) for w in self.sidecar) * self.word_bits

    @property
    def header_bits(self) -> int:
        return HEADER_BITS

    @property
    def total_bits(self) -> int:
        return self.wire_bits + self.sidecar_bits + self.header_bits


# ---------------------------------------------------------------------------
# The float sidecar's serialization, shared by every codec
# ---------------------------------------------------------------------------


def _encode_float_tree(tree):
    """A float tree -> (one uint32 array a leaf, its raw bytes zero-padded
    to a word; meta with the structure, shapes and torch dtypes)."""
    leaves, treedef = tu.flatten(tree)
    arrays, shapes, dtypes = [], [], []
    for l in leaves:
        if l is None:
            shapes.append(None)
            dtypes.append(None)
            continue
        t = l.detach().cpu().contiguous()
        shapes.append(tuple(t.shape))
        dtypes.append(t.dtype)
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        raw += b"\x00" * ((-len(raw)) % 4)
        arrays.append(np.frombuffer(raw, np.uint32).copy())
    return arrays, {"treedef": treedef, "shapes": tuple(shapes),
                    "dtypes": tuple(dtypes)}


def _decode_float_tree(arrays, meta):
    it = iter(arrays)
    leaves = []
    for sh, dt in zip(meta["shapes"], meta["dtypes"]):
        if sh is None:
            leaves.append(None)
            continue
        raw = next(it).tobytes()[: math.prod(sh) * dt.itemsize]
        leaves.append(torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
                      .view(dt).reshape(sh))
    return tu.unflatten(meta["treedef"], leaves)


def float_tree_bits(tree) -> int:
    """Serialized size of a float tree, each leaf word-aligned."""
    return sum(word_align(l.numel() * l.element_size() * 8)
               for l in tu.leaves(tree) if l is not None)


# ---------------------------------------------------------------------------
# Codec protocol
# ---------------------------------------------------------------------------


class Codec:
    """`encode`/`decode` are host-side and lossless; `measure_bits` is
    the size of encode's output for the same payload, computed on the
    payload's device."""

    name: str = "abstract"

    def accepts(self, payload_cls: type) -> bool:
        raise NotImplementedError

    def encode(self, payload) -> WireMessage:
        raise NotImplementedError

    def decode(self, msg: WireMessage):
        raise NotImplementedError

    def measure_bits(self, payload):
        """Coded wire bits, excluding the float sidecar."""
        raise NotImplementedError

    def sidecar_bits(self, payload) -> int:
        """Bits of the float side channel riding along."""
        floats = getattr(payload, "floats", None)
        return float_tree_bits(floats) if floats is not None else 0

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


# ---------------------------------------------------------------------------
# Packed binary codecs (BitpackedMasks, SignVotes)
# ---------------------------------------------------------------------------


def _pooled_bits_np(payload):
    """Host: every non-None leaf's bits concatenated, padding dropped."""
    leaves, treedef = tu.flatten(payload.words)
    chunks, it = [], iter(payload.shapes)
    for w in leaves:
        if w is None:
            continue
        chunks.append(_np_unpack(aggregation.host_words(w),
                                 math.prod(next(it))))
    bits = np.concatenate(chunks) if chunks else np.zeros((0,), np.uint8)
    return bits, treedef, [w is None for w in leaves]


def _packed_meta(payload, treedef, none_mask):
    side_arrays, fmeta = _encode_float_tree(getattr(payload, "floats", None))
    return side_arrays, {
        "words_treedef": treedef,
        "none_mask": tuple(none_mask),
        "shapes": payload.shapes,
        "has_floats": hasattr(payload, "floats"),
        "floats_meta": fmeta,
    }


def _rebuild_packed(payload_cls, bits: np.ndarray, msg: WireMessage):
    """Split pooled bits back into each leaf's packed words and rebuild
    the payload as its client sent it (CPU tensors)."""
    meta = msg.meta
    shapes_it = iter(meta["shapes"])
    leaves, off = [], 0
    for is_none in meta["none_mask"]:
        if is_none:
            leaves.append(None)
            continue
        n = math.prod(next(shapes_it))
        leaves.append(torch.from_numpy(
            _np_pack(bits[off:off + n]).view(np.int32)))
        off += n
    words = tu.unflatten(meta["words_treedef"], leaves)
    if meta["has_floats"]:
        floats = _decode_float_tree(msg.sidecar, meta["floats_meta"])
        return payload_cls(words, floats, meta["shapes"])
    return payload_cls(words, meta["shapes"])


def _msg_n(msg: WireMessage) -> int:
    return sum(math.prod(sh) for sh in msg.meta["shapes"])


def _payload_n(payload) -> int:
    return sum(math.prod(sh) for sh in payload.shapes)


def _chunks(words: torch.Tensor):
    step = GOLOMB_CHUNK_WORDS
    for s in range(0, words.shape[0], step):
        yield s, words[s:s + step]


def _popcount(words: torch.Tensor) -> int:
    """Ones in a word vector (padding bits are zero), chunk by chunk on
    the words' device, with one read back."""
    tot = torch.zeros((), dtype=torch.int64, device=words.device)
    for _, w in _chunks(words.reshape(-1)):
        tot += kref.popcount32(w).sum()
    return int(tot)


def popcount_total(payload) -> int:
    """Ones over every word leaf of a packed payload (padding bits are
    zero), with one read back to the host."""
    parts = [kref.popcount32(w).sum() for w in tu.leaves(payload.words)
             if w is not None]
    return int(torch.stack(parts).sum()) if parts else 0


class _PackedCodec(Codec):
    def accepts(self, payload_cls: type) -> bool:
        from repro_torch.api import payloads as plds
        return issubclass(payload_cls, (plds.BitpackedMasks, plds.SignVotes))

    def measure_pooled_bits(self, bits: torch.Tensor) -> int:
        """Wire size of one client's pooled {0,1} vector."""
        raise NotImplementedError


class Bitpack32(_PackedCodec):
    """The paper's artifact format: pooled bits, 32 -> 1 uint32 words,
    exactly align32(n) bits, the word-aligned 1 Bpp reference every
    entropy coder is measured against."""

    name = "bitpack"

    def encode(self, payload) -> WireMessage:
        bits, treedef, none_mask = _pooled_bits_np(payload)
        side, meta = _packed_meta(payload, treedef, none_mask)
        return WireMessage(self.name, type(payload), [_np_pack(bits)],
                           side, meta)

    def decode(self, msg: WireMessage):
        msg.verify_or_raise()
        bits = _np_unpack(msg.words[0], _msg_n(msg))
        return _rebuild_packed(msg.payload_cls, bits, msg)

    def measure_pooled_bits(self, bits: torch.Tensor) -> int:
        return word_align(bits.shape[0])

    def measure_pooled_words(self, words: torch.Tensor, n: int) -> int:
        """The word-aligned size depends only on n."""
        return word_align(n)

    def measure_bits(self, payload) -> int:
        return word_align(_payload_n(payload))


class SignPack(Bitpack32):
    """Bitpack32 with sign semantics (+1 -> 1, -1 -> 0): MV-SignSGD's
    1-bit wire, the same word layout under the sign payloads' default
    name."""

    name = "signpack"


def _rice_k(n: int, ones: int) -> int:
    """Rice parameter from the integer mean gap (the reference's compare
    chain over 2^1 .. 2^15)."""
    gbar = (n - ones) // max(ones, 1)
    return sum(1 for t in range(1, 16) if gbar >= (1 << t))


def _rice_body_bits(chunks, k: int, device) -> int:
    """sum over the ones of (gap >> k) + 1 + k, the gap being the zeros
    since the previous one (or the stream's start), over a stream given
    as (global position of its first bit, {0,1} bits) chunks in order.
    Each chunk's ones are listed in order (`nonzero`, one host sync a
    chunk), so a gap is a difference of neighbours; the last one's
    position carries to the next chunk on the device.  (A running-max
    scan over the bits is the reference's form; torch's 1-D `cummax`
    runs one block on the card.)"""
    acc = torch.zeros((), dtype=torch.int64, device=device)
    prev = torch.full((1,), -1, dtype=torch.int64, device=device)
    for base, bits in chunks:
        pos = torch.nonzero(bits).reshape(-1) + base
        if pos.numel() == 0:
            continue
        gap = pos - torch.cat([prev, pos[:-1]]) - 1
        acc += ((gap >> k) + (1 + k)).sum()
        prev = pos[-1:]
    return int(acc)


def _word_bit_chunks(words: torch.Tensor, base: int = 0, n: int = None):
    """(position, bits) chunks of a packed word vector's first n bits
    (all 32 W by default); an arithmetic shift then & 1 reads each bit
    exactly, negative int32 words included."""
    n = 32 * words.shape[0] if n is None else n
    lanes = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    for s, w in _chunks(words.reshape(-1)):
        take = min(n - WORD_BITS * s, WORD_BITS * w.shape[0])
        if take <= 0:
            return
        bits = ((w.to(torch.int32)[:, None] >> lanes) & 1).reshape(-1)
        yield base + WORD_BITS * s, bits[:take]


class GolombRice(_PackedCodec):
    """Run-length coding of the gaps between ones, Rice(2^k) a gap.

    Stream: a 32-bit header [k:5 | ones:27], then for each one the gap g
    to the previous one as unary(g >> k) + the k low bits of g.  Trailing
    zeros are implicit (the decoder knows n and the ones).  For very
    sparse regularized masks.  The meters scan the packed words in
    chunks of `GOLOMB_CHUNK_WORDS` on their device, with no loop a word.
    """

    name = "golomb"

    _MAX_ONES = (1 << 27) - 1

    def encode(self, payload) -> WireMessage:
        bits, treedef, none_mask = _pooled_bits_np(payload)
        side, meta = _packed_meta(payload, treedef, none_mask)
        n, ones = bits.size, int(bits.sum())
        if ones > self._MAX_ONES:
            raise ValueError(f"GolombRice supports < 2^27 ones per "
                             f"payload, got {ones}")
        k = _rice_k(n, ones)
        wr = _BitWriter()
        wr.write(k | (ones << 5), 32)
        gaps = np.diff(np.flatnonzero(bits), prepend=-1) - 1
        wr.bits += _rice_codes(gaps, k).tobytes()
        return WireMessage(self.name, type(payload),
                           [wr.to_array(word_align(wr.pos))], side, meta)

    def decode(self, msg: WireMessage):
        msg.verify_or_raise()
        n = _msg_n(msg)
        words = msg.words[0]
        header = int(words[0]) if words.size else 0
        k, ones = header & 31, header >> 5
        # the body, with k + 1 zeros of padding past its end
        body = np.concatenate([_np_unpack(words, words.size * WORD_BITS)[32:],
                               np.zeros((k + 1,), np.uint8)])
        L = body.size
        idx = np.arange(L)
        # first zero at or after each position: where a unary code ends
        next_zero = np.minimum.accumulate(
            np.where(body == 0, idx, L)[::-1])[::-1].tolist()
        low = np.zeros((L,), np.int64)        # k bits read at each position
        for j in range(k):
            low[: L - j] |= body[j:].astype(np.int64) << j
        low = low.tolist()
        gaps, at = [], 0
        for _ in range(ones):
            z = next_zero[at]
            gaps.append(((z - at) << k) | low[z + 1])
            at = z + 1 + k
        bits = np.zeros((n,), np.uint8)
        if ones:
            bits[np.cumsum(np.asarray(gaps, np.int64) + 1) - 1] = 1
        return _rebuild_packed(msg.payload_cls, bits, msg)

    @staticmethod
    def _total(body_bits: int) -> int:
        return word_align(32 + body_bits)

    def measure_pooled_bits(self, bits: torch.Tensor) -> int:
        n = bits.shape[0]
        if n == 0:
            return WORD_BITS
        k = _rice_k(n, int(bits.to(torch.int64).sum()))
        step = WORD_BITS * GOLOMB_CHUNK_WORDS
        return self._total(_rice_body_bits(
            ((s, bits[s:s + step]) for s in range(0, n, step)), k,
            bits.device))

    def measure_pooled_words(self, words: torch.Tensor, n: int) -> int:
        """`measure_pooled_bits` straight off packed words whose bits
        past n are zero (every one of the 32 W positions counts, as in
        the reference: zero padding only lengthens runs)."""
        if n == 0:
            return WORD_BITS
        k = _rice_k(n, _popcount(words))
        return self._total(_rice_body_bits(_word_bit_chunks(words), k,
                                           words.device))

    def measure_bits(self, payload) -> int:
        """The pooled stream of every leaf's first n bits, each leaf's
        padding dropped, scanned leaf by leaf."""
        n = _payload_n(payload)
        if n == 0:
            return WORD_BITS
        k = _rice_k(n, popcount_total(payload))
        leaves = [w for w in tu.leaves(payload.words) if w is not None]

        def chunks():
            base = 0
            for w, sh in zip(leaves, payload.shapes):
                m = math.prod(sh)
                yield from _word_bit_chunks(w, base, m)
                base += m

        return self._total(_rice_body_bits(chunks(), k, leaves[0].device))


def _rice_codes(gaps: np.ndarray, k: int) -> np.ndarray:
    """The Rice codes of `gaps` as one {0,1} uint8 stream: for each gap g,
    g >> k ones, a zero, then g's k low bits, least significant first."""
    gaps = np.asarray(gaps, np.int64)
    q = gaps >> k
    lens = q + 1 + k
    starts = np.cumsum(lens) - lens
    out = np.zeros((int(lens.sum()),), np.uint8)
    # the unary runs [start, start + q): +1 at each start, -1 at each end
    edge = np.zeros((out.size + 1,), np.int64)
    np.add.at(edge, starts, 1)
    np.add.at(edge, starts + q, -1)
    out[:] = np.cumsum(edge[:-1]) > 0
    for j in range(k):
        out[starts + q + 1 + j] = (gaps >> j) & 1
    return out


class ArithmeticBernoulli(_PackedCodec):
    """Bernoulli-prior binary arithmetic coding of the pooled bits, the
    coder that realizes the paper's sub-1-Bpp uplink.

    Stream: a 32-bit header [p1 scaled to 16 bits | reserved], then a
    CACM87-style carry-free arithmetic code of the n bits under the
    static prior p1.  The size is align32(32 + ceil(n H(p1q)) + slack)
    with a fixed slack for termination and finite precision; the encoder
    pads its stream to that target, so the meter equals the wire, within
    a few words of the eq. 13 entropy bound.  The meter needs only a
    popcount of the packed words.
    """

    name = "arithmetic"

    _PSCALE = 1 << 16
    _HALF = 1 << 31
    _QTR = 1 << 30

    @classmethod
    def _p1_scaled(cls, ones: int, n: int) -> int:
        """The quantized prior in IEEE f32, as the reference computes it."""
        p = np.float32(ones) / np.float32(n)
        s = np.round(p * np.float32(cls._PSCALE))
        return int(np.clip(np.int64(s), 1, cls._PSCALE - 1))

    @classmethod
    def _target_bits(cls, ones: int, n: int, p1c: int) -> int:
        """The ideal Bernoulli code length + header + termination slack,
        word-aligned."""
        f32 = np.float32
        p1 = f32(p1c) / f32(cls._PSCALE)
        ideal = -(f32(ones) * np.log2(p1) + f32(n - ones) * np.log2(
            f32(1) - p1))
        slack = 48 + (n >> 13)
        return word_align(int(np.ceil(ideal)) + 32 + slack)

    def _measure_from_counts(self, ones: int, n: int) -> int:
        if n == 0:
            return 0
        return self._target_bits(ones, n, self._p1_scaled(ones, n))

    def encode(self, payload) -> WireMessage:
        bits, treedef, none_mask = _pooled_bits_np(payload)
        side, meta = _packed_meta(payload, treedef, none_mask)
        n, ones = bits.size, int(bits.sum())
        wr = _BitWriter()
        if n == 0:
            return WireMessage(self.name, type(payload), [wr.to_array(0)],
                               side, meta)
        p1c = self._p1_scaled(ones, n)
        target = self._target_bits(ones, n, p1c)
        wr.write(p1c, 32)
        self._ac_encode(bits, p1c, wr)
        if wr.pos > target:   # the slack term keeps this from firing
            raise RuntimeError(
                f"arithmetic stream {wr.pos}b exceeded target {target}b")
        return WireMessage(self.name, type(payload), [wr.to_array(target)],
                           side, meta)

    def decode(self, msg: WireMessage):
        msg.verify_or_raise()
        n = _msg_n(msg)
        if n == 0:
            return _rebuild_packed(msg.payload_cls, np.zeros((0,), np.uint8),
                                   msg)
        rd = _BitReader(msg.words[0])
        p1c = rd.read(32) & (self._PSCALE - 1)
        return _rebuild_packed(msg.payload_cls, self._ac_decode(rd, n, p1c),
                               msg)

    def measure_pooled_bits(self, bits: torch.Tensor) -> int:
        n = bits.shape[0]
        return self._measure_from_counts(
            int(bits.to(torch.int64).sum()) if n else 0, n)

    def measure_pooled_words(self, words: torch.Tensor, n: int) -> int:
        """From packed words (padding bits zero) and the true bit count
        n: the formula needs only (ones, n), so a popcount replaces
        unpacking."""
        return self._measure_from_counts(_popcount(words) if n else 0, n)

    def measure_bits(self, payload) -> int:
        n = _payload_n(payload)
        return self._measure_from_counts(
            popcount_total(payload) if n else 0, n)

    # -- the CACM87 carry-free coder --------------------------------------

    @classmethod
    def _ac_encode(cls, bits: np.ndarray, p1c: int, wr: _BitWriter) -> None:
        HALF, QTR = cls._HALF, cls._QTR
        p0c = cls._PSCALE - p1c
        lo, hi, pending = 0, (1 << 32) - 1, 0
        out = wr.bits

        for b in bits.tolist():
            span = hi - lo + 1
            split = lo + ((span * p0c) >> 16) - 1
            if b:
                lo = split + 1
            else:
                hi = split
            while True:
                if hi < HALF:
                    out.append(0)
                    out.extend(b"\x01" * pending)
                    pending = 0
                elif lo >= HALF:
                    out.append(1)
                    out.extend(b"\x00" * pending)
                    pending = 0
                    lo -= HALF
                    hi -= HALF
                elif lo >= QTR and hi < 3 * QTR:
                    pending += 1
                    lo -= QTR
                    hi -= QTR
                else:
                    break
                lo <<= 1
                hi = (hi << 1) | 1
        last = 0 if lo < QTR else 1
        out.append(last)
        out.extend(bytes([1 - last]) * (pending + 1))

    @classmethod
    def _ac_decode(cls, rd: _BitReader, n: int, p1c: int) -> np.ndarray:
        HALF, QTR = cls._HALF, cls._QTR
        p0c = cls._PSCALE - p1c
        lo, hi = 0, (1 << 32) - 1
        code = 0
        for _ in range(32):
            code = (code << 1) | rd.read_bit()
        out = bytearray(n)
        for i in range(n):
            span = hi - lo + 1
            split = lo + ((span * p0c) >> 16) - 1
            if code <= split:
                hi = split
            else:
                out[i] = 1
                lo = split + 1
            while True:
                if hi < HALF:
                    pass
                elif lo >= HALF:
                    lo -= HALF
                    hi -= HALF
                    code -= HALF
                elif lo >= QTR and hi < 3 * QTR:
                    lo -= QTR
                    hi -= QTR
                    code -= QTR
                else:
                    break
                lo <<= 1
                hi = (hi << 1) | 1
                code = (code << 1) | rd.read_bit()
        return np.frombuffer(bytes(out), np.uint8)


# ---------------------------------------------------------------------------
# The float codec (FloatDeltas)
# ---------------------------------------------------------------------------


class Float32Raw(Codec):
    """Raw IEEE words, the uncompressed reference the paper divides by:
    any float dtype, each leaf at its own width."""

    name = "float32"

    def accepts(self, payload_cls: type) -> bool:
        from repro_torch.api import payloads as plds
        return issubclass(payload_cls, plds.FloatDeltas)

    def encode(self, payload) -> WireMessage:
        arrays, fmeta = _encode_float_tree(payload.values)
        meta = {"floats_meta": fmeta, "shapes": payload.shapes,
                "bits": payload.bits}
        return WireMessage(self.name, type(payload), arrays, [], meta)

    def decode(self, msg: WireMessage):
        msg.verify_or_raise()
        values = _decode_float_tree(msg.words, msg.meta["floats_meta"])
        return msg.payload_cls(values, msg.meta["shapes"], msg.meta["bits"])

    def measure_bits(self, payload) -> np.float32:
        tot = sum(word_align(math.prod(sh) * b)
                  for sh, b in zip(payload.shapes, payload.bits))
        # f32, as the reference's: 32 Bpp of a large model overflows int32
        return np.float32(tot)

    def sidecar_bits(self, payload) -> int:
        return 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


CODECS: Dict[str, Codec] = {
    c.name: c for c in (Bitpack32(), GolombRice(), ArithmeticBernoulli(),
                        SignPack(), Float32Raw())
}


def available() -> tuple:
    return tuple(sorted(CODECS))


def get_codec(name: str) -> Codec:
    if name not in CODECS:
        raise KeyError(f"unknown codec {name!r}; available: "
                       f"{', '.join(available())}")
    return CODECS[name]


def default_for(payload_cls: type) -> str:
    from repro_torch.api import payloads as plds
    if issubclass(payload_cls, plds.SignVotes):
        return "signpack"
    if issubclass(payload_cls, plds.BitpackedMasks):
        return "arithmetic"
    return "float32"


def resolve(codec, payload_spec) -> Codec:
    """None -> the spec's default codec (else `default_for` its payload
    class); a name -> the registry's codec; a Codec -> itself.  Checks
    that it can serialize the spec's payload class."""
    if codec is None:
        codec = getattr(payload_spec, "default_codec", None) \
            or default_for(payload_spec.cls)
    if isinstance(codec, str):
        codec = get_codec(codec)
    if not codec.accepts(payload_spec.cls):
        raise ValueError(f"codec {codec.name!r} cannot serialize "
                         f"{payload_spec.cls.__name__} payloads")
    return codec


# ---------------------------------------------------------------------------
# CommLedger: cumulative two-way traffic over a run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommLedger:
    """Measured wire bits across rounds, both directions, fed with the
    round metrics (`uplink_bits_measured`, `downlink_bits`); the
    benchmarks plot accuracy against `total_mb` (MB = 1e6 bytes)."""

    uplink_bits: float = 0.0
    downlink_bits: float = 0.0
    rounds: int = 0
    # an aggregator tree's root traffic (pooled fold records on the edge
    # -> root hop)
    root_bits: float = 0.0

    def update(self, metrics: Dict[str, Any]) -> "CommLedger":
        self.uplink_bits += float(metrics.get("uplink_bits_measured", 0.0))
        self.downlink_bits += float(metrics.get("downlink_bits", 0.0))
        self.root_bits += float(metrics.get("root_bits_measured", 0.0))
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

    @property
    def root_mb(self) -> float:
        return self.root_bits / 8e6

    def as_dict(self) -> Dict[str, float]:
        return {"rounds": self.rounds,
                "cumulative_uplink_mb": self.uplink_mb,
                "cumulative_downlink_mb": self.downlink_mb,
                "cumulative_root_mb": self.root_mb,
                "cumulative_total_mb": self.total_mb}
