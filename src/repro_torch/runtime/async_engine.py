"""Buffered-async round engine: quorum commits, staleness-weighted mask
folds, live transport faults, crash-consistent resume
(`repro.runtime.async_engine`).

The synchronous engine (`api.protocol.run_round`) is a barrier: a round
waits for every client's uplink before it aggregates.  This engine
replaces the barrier with a FedBuff-style buffer:

  * every tick the server LAUNCHES the current cohort through
    `protocol.client_phase`, the client side of `run_round`: the
    downlink first, then each client's `client_update` in turn, all
    drawing from one generator made anew for the tick (below);
  * each client's payload is read back to the host (one copy for the
    whole tick) and ENCODED to a real `WireMessage` (packed uint32 words,
    the float sidecar, a CRC32 header) and handed to the transport, where
    `runtime.fault.FaultInjector` may crash it, drop its pod, delay it
    whole ticks, or flip bits in transit;
  * arrivals FOLD into the round buffer as they land: the checksum is
    verified first (a corrupt uplink is rejected and retransmitted with
    bounded backoff, then cut), the decoded payload joins the buffer and
    a running popcount (`aggregation.fold_popcount`) tracks its ones;
  * the round COMMITS when the buffer reaches quorum (or a deadline
    forces it): the fold weights are `aggregation.staleness_weights`
    (|D_i| discounted by (1+s)^-alpha and renormalized over the buffer)
    and the buffered payloads, stacked and moved to the state's device,
    go through the algorithm's own `aggregate` (for packed payloads one
    unpack launch a masked leaf on the card), as in `run_round`.  With
    zero faults and quorum_frac = 1 every commit is bit-identical to
    `run_round` on the tick's generator, wire bits included.

Randomness: the reference keys tick t by `fold_in(key, t)`.  Here tick t
draws from `torch.Generator(device).manual_seed(counter_seed(seed, t,
S_TICK))` (`runtime.fault`), made anew each tick, so a restored engine
draws what the uninterrupted one drew; `tick(data, uniforms=...)`
injects the draws instead, as `run_round` allows.

Crash consistency: `save()` writes the whole engine (server state,
buffered payloads, in-flight messages, tick and version counters, comm
totals, the event log) through `ckpt.save_bundle` (tmp + os.replace,
manifest last).  Fault draws are counter hashes of (seed, round, client,
attempt), so a restored engine replays the identical fault sequence.

Accounting: `uplink_bits_measured` counts every delivered attempt's
wire_bits + sidecar_bits (rejected attempts consumed the wire too); the
CRC32 header is metered apart as `uplink_header_bits`.  `host_seconds`
adds up the host's share of the ticks: the read back, encode, decode and
fold.

Construction runs client 0's update once on a throwaway generator to
learn the payload's structure (the reference's `eval_shape`): the
template the restore path rebuilds buffered payloads and wire messages
with.  On the card that packs each masked leaf once (kernel 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import codecs as codecs_lib
from repro_torch.api import payloads as plds
from repro_torch.api import protocol
from repro_torch.ckpt import checkpoint as ckptlib
from repro_torch.core import aggregation
from repro_torch.core import tree as tu
from repro_torch.runtime import fault
from repro_torch.runtime.fault import FaultInjector

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Commit policy of the buffered-async engine.

    quorum_frac:     commit once ceil(quorum_frac * n_clients) uplinks
                     are buffered (1.0 = the synchronous barrier).
    deadline_rounds: force-commit a non-empty buffer after this many
                     ticks without a commit (no quorum starvation).
    max_staleness:   arrivals trained against a theta more than this
                     many commits old are discarded, not folded.
    staleness_alpha: discount exponent of (1 + s)^-alpha.
    """
    quorum_frac: float = 1.0
    deadline_rounds: int = 4
    max_staleness: int = 4
    staleness_alpha: float = 0.5

    @property
    def alpha(self) -> float:
        return self.staleness_alpha

    def quorum_count(self, n_clients: int) -> int:
        k = int(np.ceil(self.quorum_frac * n_clients))
        return min(max(k, 1), n_clients)


@dataclasses.dataclass
class _InFlight:
    """One uplink on the wire (client -> server, not yet accepted)."""
    client: int
    version: int          # server commit count the client trained from
    round: int            # tick the client was launched at
    deliver: int          # tick the current attempt lands
    attempt: int          # 0 = first transmission
    size: float           # |D_i|
    msg: codecs_lib.WireMessage
    metrics: Dict[str, float]


@dataclasses.dataclass
class _Buffered:
    """One verified arrival waiting in the round buffer."""
    client: int
    version: int
    round: int
    size: float
    payload: Any
    metrics: Dict[str, float]


# ---------------------------------------------------------------------------
# Payload leaves: a payload's tensor fields flattened, and back
# ---------------------------------------------------------------------------


def _payload_fields(p) -> list:
    return [f.name for f in dataclasses.fields(p)
            if f.name not in plds._STATIC]


def payload_leaves(p) -> list:
    """A payload's leaves (None included) over its tensor fields, in
    field order."""
    return tu.leaves([getattr(p, f) for f in _payload_fields(p)])


def payload_with_leaves(p, leaves) -> Any:
    """A payload shaped as `p` holding `leaves`."""
    names = _payload_fields(p)
    _, tdef = tu.flatten([getattr(p, f) for f in names])
    vals = tu.unflatten(tdef, list(leaves))
    return dataclasses.replace(p, **dict(zip(names, vals)))


def _map_leaves(fn, p):
    return payload_with_leaves(p, [None if l is None else fn(l)
                                   for l in payload_leaves(p)])


def payloads_to_host(payloads: list) -> list:
    """The payloads with every tensor on the CPU, through one device ->
    host copy of all their bytes (each leaf's bytes 8-aligned in one
    buffer)."""
    leaves = [l for p in payloads for l in payload_leaves(p)
              if l is not None]
    if not leaves or all(l.device.type == "cpu" for l in leaves):
        return payloads
    chunks, spans, off = [], [], 0
    for l in leaves:
        b = l.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 8
        chunks.append(b)
        if pad:
            chunks.append(b.new_zeros(pad))
        spans.append((off, b.numel(), l.dtype, tuple(l.shape)))
        off += b.numel() + pad
    host = torch.cat(chunks).cpu()
    it = iter(spans)

    def back(_):
        o, n, dt, sh = next(it)
        return host[o:o + n].view(dt).reshape(sh)

    return [_map_leaves(back, p) for p in payloads]


def payload_to(p, device):
    return _map_leaves(lambda l: l.to(device), p)


def _wsum(vals, wn: torch.Tensor) -> torch.Tensor:
    """sum_i wn_i * vals_i in f32 on wn's device: `run_round`'s formula
    for its weighted metrics."""
    col = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                       device=wn.device) for v in vals])
    return (col * wn).sum()


def _leaf_bytes(l) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(
        ckptlib._to_numpy(l)).tobytes(), dtype=np.uint8)


class AsyncRoundEngine:
    """Host-sim buffered-async server around one `FedAlgorithm`.

    Drive it one tick at a time::

        eng = AsyncRoundEngine(algo, state, data_like, sizes, seed,
                               config=AsyncConfig(quorum_frac=0.8),
                               injector=FaultInjector(K, crash_prob=.3))
        for t in range(T):
            commits = eng.tick(data_t)      # 0 or 1 commits a tick
        eng.flush()                         # fold any tail arrivals

    `data_like` is one tick's client batch tree (leading axes [K, H,
    ...]); `sizes` the clients' |D_i|; `seed` the run seed every tick's
    generator derives from."""

    def __init__(self, algo, state, data_like, sizes, seed: int,
                 config: Optional[AsyncConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 codec=None):
        self.algo = algo
        self.state = state
        self.config = config or AsyncConfig()
        self.injector = injector
        self.codec = (algo.codec if codec is None
                      else codecs_lib.get_codec(codec)
                      if isinstance(codec, str) else codec)
        self.sizes = np.asarray(torch.as_tensor(sizes).cpu(), np.float32)
        self.n_clients = int(self.sizes.shape[0])
        self.seed = int(seed)
        self.device = next(l.device for l in tu.leaves(state)
                           if isinstance(l, torch.Tensor))

        self.tick_idx = 0
        self.version = 0            # commits so far = theta generation
        self.last_commit_tick = 0
        self.buffer: List[_Buffered] = []
        self.pending: List[_InFlight] = []
        self.events: List[dict] = []
        self._event_seq = 0         # monotone event ordering cursor
        self.buffer_ones = 0        # running popcount over the buffer
        self.totals = {"uplink_bits_measured": 0.0,
                       "uplink_header_bits": 0.0,
                       "downlink_bits": 0.0, "commits": 0}
        self._since_commit = {"uplink_bits_measured": 0.0,
                              "uplink_header_bits": 0.0,
                              "downlink_bits": 0.0}
        self._last_downlink_bpp = 0.0
        self.metric_names: List[str] = []   # the clients' metrics, launched
        self.host_seconds = {"readback": 0.0, "encode": 0.0,
                             "decode": 0.0, "fold": 0.0}

        # the payload template: its structure, as a zero payload on the
        # host, and the wire meta restored messages are rebuilt with
        gen = torch.Generator(device=self.device).manual_seed(0)
        p0, _ = algo.client_update(
            state, tu.tree_map(lambda v: v[0], data_like), gen)
        template = _map_leaves(
            lambda l: torch.zeros(l.shape, dtype=l.dtype), p0)
        del p0
        self._payload_template = template
        tleaves = payload_leaves(template)
        self._payload_none = tuple(l is None for l in tleaves)
        tmsg = self.codec.encode(template)
        self._wire_meta = tmsg.meta
        self._payload_cls = tmsg.payload_cls
        self._degraded_restore = False

    # -- policy shorthands ------------------------------------------------

    @property
    def quorum(self) -> int:
        return self.config.quorum_count(self.n_clients)

    def tick_generator(self, t: int) -> torch.Generator:
        """The generator tick t's client phase draws from."""
        return torch.Generator(device=self.device).manual_seed(
            fault.counter_seed(self.seed, t, fault.S_TICK))

    def _event(self, kind: str, **kw):
        """Append an event record with a monotone `seq` (a total order
        over the engine's life that survives save/restore); per-delivery
        events also carry the transmission `attempt`."""
        self.events.append(dict(kind=kind, seq=self._event_seq,
                                tick=self.tick_idx, **kw))
        self._event_seq += 1

    # -- tick: launch -> deliver -> maybe commit --------------------------

    def tick(self, data, uniforms: Optional[dict] = None) -> List[dict]:
        """One engine tick.  Returns the (possibly empty) list of commit
        metric dicts produced this tick."""
        t = self.tick_idx
        self._launch(data, t, uniforms)
        self._deliver(t)
        out = self._maybe_commit(t)
        self.tick_idx = t + 1
        return out

    def flush(self) -> List[dict]:
        """Drain the wire (advancing ticks, no new launches) and
        force-commit whatever ends up buffered.  Bounded: retries are
        capped, so pending empties."""
        out: List[dict] = []
        for _ in range(100_000):
            t = self.tick_idx
            self._deliver(t)
            if not self.pending:
                out.extend(self._maybe_commit(t, force=True))
                return out
            out.extend(self._maybe_commit(t))
            self.tick_idx = t + 1
        raise RuntimeError("flush did not drain the pending queue")

    def _launch(self, data, t: int, uniforms: Optional[dict] = None):
        gen = None if uniforms is not None else self.tick_generator(t)
        dl, payloads, metrics = protocol.client_phase(
            self.algo, self.state, data, self.n_clients, gen, uniforms)
        if dl is not None:
            self._last_downlink_bpp = float(dl.bpp())
            dbits = float(dl.wire_bits() + dl.sidecar_bits()
                          ) * self.n_clients
            self._since_commit["downlink_bits"] += dbits
            self.totals["downlink_bits"] += dbits
        inj = self.injector
        dropped = (inj.dropped(t) if inj is not None
                   else np.zeros(self.n_clients, bool))
        delays = (inj.delay_rounds(t) if inj is not None
                  else np.zeros(self.n_clients, np.int64))
        ts = time.perf_counter()
        names = self.metric_names = list(metrics[0])
        host_metrics = torch.stack([torch.stack([
            torch.as_tensor(m[k], dtype=torch.float32, device=self.device)
            for k in names]) for m in metrics]).cpu().numpy()
        host = payloads_to_host(payloads)
        del payloads
        self.host_seconds["readback"] += time.perf_counter() - ts
        for c in range(self.n_clients):
            if dropped[c]:
                self._event("drop", client=c, round=t)
                continue
            ts = time.perf_counter()
            msg = self.codec.encode(host[c])
            self.host_seconds["encode"] += time.perf_counter() - ts
            if int(delays[c]) > 0:
                self._event("straggle", client=c, round=t,
                            late=int(delays[c]))
            self.pending.append(_InFlight(
                client=c, version=self.version, round=t,
                deliver=t + int(delays[c]), attempt=0,
                size=float(self.sizes[c]), msg=msg,
                metrics={k: float(host_metrics[c, j])
                         for j, k in enumerate(names)}))

    def _decode(self, msg):
        ts = time.perf_counter()
        payload = self.codec.decode(msg)
        self.host_seconds["decode"] += time.perf_counter() - ts
        return payload

    def _transmit(self, e: _InFlight, t: int):
        """One delivery attempt over the faulty wire: meters it and
        returns the message as it arrived if it verifies, else None
        (after scheduling the retry or cutting the client)."""
        inj = self.injector
        msg = e.msg
        if inj is not None and inj.corrupt_attempt(e.round, e.client,
                                                   e.attempt):
            msg = dataclasses.replace(
                e.msg, words=inj.corrupt_words(e.msg.words, e.round,
                                               e.client, e.attempt))
        # the delivery consumed the wire whether or not it verifies
        abits = float(msg.wire_bits + msg.sidecar_bits)
        self._since_commit["uplink_bits_measured"] += abits
        self.totals["uplink_bits_measured"] += abits
        self._since_commit["uplink_header_bits"] += msg.header_bits
        self.totals["uplink_header_bits"] += msg.header_bits
        if msg.verify():
            return msg, None
        if e.attempt >= (inj.max_retries if inj else 0):
            self._event("cut", client=e.client, round=e.round,
                        attempts=e.attempt + 1)
            return None, None
        backoff = max(1, int(np.ceil(inj.backoff_rounds * (e.attempt + 1))))
        self._event("corrupt_reject", client=e.client, round=e.round,
                    attempt=e.attempt, retry_at=t + backoff)
        return None, dataclasses.replace(e, attempt=e.attempt + 1,
                                         deliver=t + backoff)

    def _deliver(self, t: int):
        still: List[_InFlight] = []
        for e in self.pending:
            if e.deliver > t:
                still.append(e)
                continue
            msg, retry = self._transmit(e, t)
            if msg is None:
                if retry is not None:
                    still.append(retry)
                continue
            staleness = self.version - e.version
            if staleness > self.config.max_staleness:
                self._event("stale_drop", client=e.client,
                            round=e.round, staleness=staleness,
                            attempt=e.attempt)
                continue
            payload = self._decode(msg)
            ts = time.perf_counter()
            acc = self.buffer_ones
            for w in tu.leaves(getattr(payload, "words", ())):
                if w is not None:
                    acc = aggregation.fold_popcount(acc, w)
            ones = acc - self.buffer_ones
            self.buffer_ones = acc
            self.host_seconds["fold"] += time.perf_counter() - ts
            self.buffer.append(_Buffered(
                client=e.client, version=e.version, round=e.round,
                size=e.size, payload=payload, metrics=e.metrics))
            self._event("fold", client=e.client, round=e.round,
                        staleness=staleness, ones=ones,
                        attempt=e.attempt)
        self.pending = still

    def _maybe_commit(self, t: int, force: bool = False) -> List[dict]:
        # prune anything the buffer outlived
        fresh: List[_Buffered] = []
        for e in self.buffer:
            if self.version - e.version <= self.config.max_staleness:
                fresh.append(e)
            else:
                self._event("stale_drop", client=e.client,
                            round=e.round,
                            staleness=self.version - e.version)
        self.buffer = fresh
        if not self.buffer:
            return []
        deadline = (t - self.last_commit_tick
                    >= self.config.deadline_rounds)
        if len(self.buffer) < self.quorum and not (force or deadline):
            return []
        return [self._commit(t, forced=force or deadline)]

    def _commit(self, t: int, forced: bool = False) -> dict:
        entries, self.buffer = self.buffer, []
        self.buffer_ones = 0
        B = len(entries)
        dev = self.device
        batched = payload_to(
            plds.stack_payloads([e.payload for e in entries]), dev)
        sizes = torch.tensor([e.size for e in entries], dtype=torch.float32,
                             device=dev)
        stal = torch.tensor([self.version - e.version for e in entries],
                            dtype=torch.float32, device=dev)
        wn = aggregation.staleness_weights(sizes, stal,
                                           self.config.staleness_alpha)
        self.state = self.algo.aggregate(
            self.state, batched, wn, torch.ones(B, dtype=torch.bool,
                                                device=dev))
        up_bpp = _wsum([e.payload.bpp() for e in entries], wn)
        stal_max = int(max(self.version - e.version for e in entries))
        self.version += 1
        self.last_commit_tick = t
        self.totals["commits"] += 1
        out = {"uplink_bpp": float(up_bpp),
               "downlink_bpp": self._last_downlink_bpp,
               "n_folded": B,
               "version": self.version,
               "tick": t,
               "forced": bool(forced),
               "staleness_max": stal_max,
               "clients": [e.client for e in entries]}
        out.update({k: self._since_commit[k] for k in self._since_commit})
        for k in entries[0].metrics:
            out[k] = float(_wsum([e.metrics[k] for e in entries], wn))
        self._since_commit = {k: 0.0 for k in self._since_commit}
        self._event("commit", version=self.version, folded=B,
                    forced=bool(forced))
        return out

    # -- crash-consistent checkpointing -----------------------------------

    @staticmethod
    def _payload_checksum(payload) -> int:
        """`aggregation.words_checksum` over the raw bytes of a payload's
        leaves (or any tree's; ints as `ckpt` stores them): the integrity
        tag `restore` re-verifies before trusting a saved buffer entry."""
        leaves = (payload_leaves(payload)
                  if dataclasses.is_dataclass(payload)
                  else tu.leaves(payload))
        return aggregation.words_checksum(
            [_leaf_bytes(l) for l in leaves if l is not None])

    def save(self, path: str) -> str:
        """Atomically persist the whole engine.  A coordinator killed right
        after `save` resumes byte-identically (`restore`), and the
        replayed fault sequence is identical too."""
        arrays, extra = self._save_payload()
        return ckptlib.save_bundle(path, arrays, extra)

    def _save_payload(self):
        """(arrays, extra) the bundle persists; subclasses extend."""
        arrays: Dict[str, Any] = {}
        for j, l in enumerate(tu.leaves(self.state)):
            arrays[f"state/{j}"] = l
        for i, e in enumerate(self.buffer):
            for j, l in enumerate(payload_leaves(e.payload)):
                arrays[f"buf{i}/{j}"] = l
        for i, e in enumerate(self.pending):
            for j, w in enumerate(e.msg.words):
                arrays[f"pend{i}/w{j}"] = w
            for j, w in enumerate(e.msg.sidecar):
                arrays[f"pend{i}/s{j}"] = w
        extra = {
            "tick": self.tick_idx, "version": self.version,
            "last_commit_tick": self.last_commit_tick,
            "buffer_ones": self.buffer_ones,
            "totals": self.totals,
            "since_commit": self._since_commit,
            "last_downlink_bpp": self._last_downlink_bpp,
            "events": self.events,
            "event_seq": self._event_seq,
            "buffer": [{"client": e.client, "version": e.version,
                        "round": e.round, "size": e.size,
                        "metrics": e.metrics,
                        "checksum": self._payload_checksum(e.payload)}
                       for e in self.buffer],
            "pending": [self._msg_meta(e) for e in self.pending],
        }
        return arrays, extra

    @staticmethod
    def _msg_meta(e: _InFlight) -> dict:
        return {"client": e.client, "version": e.version,
                "round": e.round, "deliver": e.deliver,
                "attempt": e.attempt, "size": e.size,
                "metrics": e.metrics, "checksum": int(e.msg.checksum),
                "n_words": len(e.msg.words),
                "n_side": len(e.msg.sidecar)}

    def _msg_from(self, arrays, prefix: str, meta: dict) -> _InFlight:
        """An in-flight entry rebuilt from its saved streams and meta."""
        words = [aggregation.host_words(arrays[f"{prefix}/w{j}"])
                 for j in range(int(meta["n_words"]))]
        side = [aggregation.host_words(arrays[f"{prefix}/s{j}"])
                for j in range(int(meta["n_side"]))]
        msg = codecs_lib.WireMessage(
            self.codec.name, self._payload_cls, words, side,
            self._wire_meta, checksum=int(meta["checksum"]))
        return _InFlight(
            client=int(meta["client"]), version=int(meta["version"]),
            round=int(meta["round"]), deliver=int(meta["deliver"]),
            attempt=int(meta["attempt"]), size=float(meta["size"]),
            msg=msg, metrics=dict(meta["metrics"]))

    def restore(self, path: str) -> "AsyncRoundEngine":
        """Inverse of `save` onto a freshly constructed engine (same algo,
        sizes, seed, config and injector).

        Every buffered payload is re-verified against the checksum `save`
        stored for it.  On any mismatch the engine refuses the buffer and
        takes the degraded theta-only path: server state and counters
        survive, the buffer and in-flight queue are dropped, and the cut
        clients re-enter at their next launch."""
        arrays, extra = ckptlib.load_bundle(path)
        return self._load_payload(arrays, extra)

    def _load_payload(self, arrays, extra) -> "AsyncRoundEngine":
        self._degraded_restore = False
        sleaves, sdef = tu.flatten(self.state)
        self.state = tu.unflatten(sdef, [
            None if arrays.get(f"state/{j}") is None
            else ckptlib._like(arrays[f"state/{j}"], l)
            for j, l in enumerate(sleaves)])
        self.tick_idx = int(extra["tick"])
        self.version = int(extra["version"])
        self.last_commit_tick = int(extra["last_commit_tick"])
        self.buffer_ones = int(extra["buffer_ones"])
        self.totals = dict(extra["totals"])
        self._since_commit = dict(extra["since_commit"])
        self._last_downlink_bpp = float(extra["last_downlink_bpp"])
        self.events = list(extra["events"])
        self._event_seq = int(extra.get("event_seq", len(self.events)))
        self.buffer = []
        for i, meta in enumerate(extra["buffer"]):
            payload = payload_with_leaves(self._payload_template, [
                None if none else arrays[f"buf{i}/{j}"]
                for j, none in enumerate(self._payload_none)])
            stored = meta.get("checksum")
            if stored is not None and \
                    self._payload_checksum(payload) != int(stored):
                return self._restore_degraded(meta, i)
            self.buffer.append(_Buffered(
                client=int(meta["client"]),
                version=int(meta["version"]),
                round=int(meta["round"]), size=float(meta["size"]),
                payload=payload, metrics=dict(meta["metrics"])))
        self.pending = [self._msg_from(arrays, f"pend{i}", meta)
                        for i, meta in enumerate(extra["pending"])]
        return self

    def _restore_degraded(self, meta: dict, slot: int
                          ) -> "AsyncRoundEngine":
        """Checksum-mismatch fallback: keep the restored server state and
        counters (theta is what matters), refuse the buffered payloads
        and the in-flight queue wholesale.  Dropped contributors re-enter
        at their next launch; staleness weighting absorbs the lost
        partial round."""
        self.buffer = []
        self.pending = []
        self.buffer_ones = 0
        self._degraded_restore = True
        self._event("restore_degraded", client=int(meta["client"]),
                    round=int(meta["round"]), slot=int(slot))
        return self
