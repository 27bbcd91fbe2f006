"""Hierarchical aggregator tree: Byzantine-filtered edge folds,
aggregator failure domains, and O(params) root traffic
(`repro.runtime.agg_tree`).

The flat buffered-async engine (`runtime.async_engine`) delivers every
client's `WireMessage` straight to the coordinator, so a commit's root
traffic is O(clients x params).  This module puts a fanout-configurable
aggregator layer between the transport and the commit:

  * clients uplink through the same faulty transport (CRC32 verify,
    bounded retransmit, staleness discard), but each lands at its EDGE
    aggregator (client // fanout), not at the root;
  * the edge folds verified arrivals on the host into exact int64
    per-bit-position counts (one accumulator per (|D_i|, trained-from
    version) weight class), plus pooled float-sidecar, metric and
    entropy sums;
  * at commit every edge forwards ONE `PooledFoldRecord` upstream:
    fixed-width packed counts (`aggregation.pack_counts`), class headers,
    the client count and a fold checksum.  Root traffic a round is
    O(params) x n_edges whatever the client count
    (`analysis.comm_model.tree_root_record_bits` is its static twin);
  * the root deserializes the records, merges classes in exact integers,
    recomputes staleness discounts against the current version and, on
    the state's device, reduces the mask mean through
    `payloads.mean_from_counts` (eq. 8 over pooled counts) into the
    algorithm's `pooled_aggregate` seam.

Bit-identity: integer count pooling is associative and lossless, so at
zero faults and no adversaries a tree commit equals the flat engine's
theta and measured wire bits whenever the commit weights are dyadic
(equal sizes, a power-of-two cohort).

Failure domains: an edge aggregator may crash or partition
(`FaultInjector.agg_crashed` / `agg_partitioned`).  A crash destroys the
edge's uncommitted fold; its verified arrivals are REPLAYED from the
edge's fold log and re-routed to the next alive sibling (failover) or
retried next tick.  Replays are metered as wire traffic again and keep
their attempt index, so the counter-hashed fault draws, and a restored
run, stay deterministic.  A partitioned edge delays its deliveries one
tick without using the wire.

Byzantine filter (at the edge, before anything enters a fold):

  1. DECLARATION check, before decoding: the launch-time popcount of the
     encoded stream (a 32-bit commitment metered as `decl_bits`) against
     the arrived words; a tamper that forges the CRC cannot forge it;
  2. absolute mask-density bounds (all-ones bombs, all-zero uplinks);
  3. popcount z-score against running Welford statistics (std floored,
     after a warm-up cohort);
  4. trimmed fold: if the z-filter would quarantine more than trim_frac
     of a tick's arrivals, only the most extreme trim_frac are.

Crash consistency: `save`/`restore` extend the base engine's bundle with
the per-edge fold logs, the declarations and the filter statistics;
restore REFOLDS the logs into fresh accumulators, and a checksum
mismatch degrades as in the base engine.

`TreeTopology` is the launcher's static form for the barrier round, and
`python -m repro_torch.runtime.agg_tree` the engine's chaos command
(`repro_torch.tools.chaos_smoke --tree`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.comm_model import CLASS_HEADER_BITS
from repro_torch.api import codecs as codecs_lib
from repro_torch.api import payloads as plds
from repro_torch.core import aggregation
from repro_torch.core import tree as tu
from repro_torch.runtime import fault as faultlib
from repro_torch.runtime.async_engine import AsyncConfig, \
    AsyncRoundEngine, _InFlight

Pytree = Any

# one uint32 popcount commitment per launched uplink (the Byzantine
# filter's pre-decode declaration), metered next to the CRC header
DECL_BITS = 32


def _unpack_bits_np(words) -> np.ndarray:
    """Host unpack of uint32 words to a {0,1} uint8 vector of 32 a word
    (bit j of word i is position 32 i + j)."""
    a = np.ascontiguousarray(aggregation.host_words(words).astype("<u4"))
    return np.unpackbits(a.view(np.uint8), bitorder="little")


def _wire_popcount(words) -> int:
    """Total ones over a WireMessage's coded streams (host-side)."""
    tot = 0
    for w in words:
        a = np.ascontiguousarray(aggregation.host_words(w).astype("<u4"))
        tot += int(np.unpackbits(a.view(np.uint8)).sum())
    return tot


def _payload_popcount(payload) -> int:
    return _wire_popcount([w for w in tu.leaves(getattr(payload, "words",
                                                        ()))
                           if w is not None])


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Aggregator-tree topology and Byzantine filter policy.

    fanout:       clients an edge aggregator (edge = client // fanout).
    acc_bits:     packed count field width on the edge -> root wire
                  (8/16/32); an edge folds at most 2^acc_bits - 1 clients
                  a class before `pack_counts` raises.
    min_density / max_density: absolute per-client mask-density bounds.
    z_thresh:     quarantine when |density - mean| / std exceeds this
                  (0 disables the statistical filter).
    z_floor:      std floor, so a converged cohort cannot divide by ~0.
    min_cohort:   Welford warm-up: no z decisions before this many
                  admitted folds.
    trim_frac:    trimmed fold: if the z-filter flags more than this
                  share of a tick's arrivals, quarantine only the most
                  extreme ceil(trim_frac * m) and fold the rest.
    failover:     re-parent a crashed edge's deliveries to the next
                  alive sibling this tick (else they retry next tick).
    """
    fanout: int = 32
    acc_bits: int = 16
    min_density: float = 0.01
    max_density: float = 0.99
    z_thresh: float = 6.0
    z_floor: float = 0.02
    min_cohort: int = 8
    trim_frac: float = 0.25
    failover: bool = True

    def n_edges(self, n_clients: int) -> int:
        return max(1, -(-n_clients // self.fanout))

    def edge_of(self, client: int) -> int:
        return client // self.fanout


# ---------------------------------------------------------------------------
# Byzantine filter
# ---------------------------------------------------------------------------


class ByzantineFilter:
    """Density z-score screen with the trimmed-fold fallback: running
    Welford statistics over ADMITTED mask densities, one population for
    all edges.  Plain float arithmetic, so its state survives
    save/restore exactly."""

    def __init__(self, cfg: TreeConfig):
        self.cfg = cfg
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def zscore(self, density: float) -> float:
        if self.n < self.cfg.min_cohort or self.cfg.z_thresh <= 0:
            return 0.0
        std = max(math.sqrt(self.m2 / self.n), self.cfg.z_floor)
        return abs(density - self.mean) / std

    def admit(self, density: float) -> None:
        self.n += 1
        d = density - self.mean
        self.mean += d / self.n
        self.m2 += d * (density - self.mean)

    def screen(self, densities: List[float]
               ) -> Tuple[List[int], Dict[int, float], bool]:
        """(admitted indices, {quarantined index: z}, trimmed?) for one
        tick's arrivals.  Does not update the statistics: the caller
        admits the survivors (skipping replays)."""
        m = len(densities)
        flags = [(self.zscore(d), i) for i, d in enumerate(densities)]
        flags = [(z, i) for z, i in flags if z > self.cfg.z_thresh]
        cap = max(1, int(np.ceil(self.cfg.trim_frac * m)))
        trimmed = len(flags) > cap
        if trimmed:
            flags.sort(key=lambda t: (-t[0], t[1]))
            flags = flags[:cap]
        quarantined = {i: z for z, i in flags}
        admitted = [i for i in range(m) if i not in quarantined]
        return admitted, quarantined, trimmed

    def state_dict(self) -> dict:
        return {"n": int(self.n), "mean": float(self.mean),
                "m2": float(self.m2)}

    def load_state(self, d: dict) -> None:
        self.n = int(d["n"])
        self.mean = float(d["mean"])
        self.m2 = float(d["m2"])


# ---------------------------------------------------------------------------
# Edge fold state and the pooled wire record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ClassAcc:
    """One edge's running fold of one (|D_i|, version) weight class."""
    size: float
    version: int
    count: int
    counts: List[np.ndarray]        # int64[P] a word leaf (exact)
    fsums: List[np.ndarray]         # f32 a float leaf
    msums: Dict[str, float]
    bpp_sum: float
    clients: List[Tuple[int, int]]  # (client, round) in fold order


@dataclasses.dataclass
class _Edge:
    classes: Dict[Tuple[float, int], _ClassAcc]
    log: List[_InFlight]            # pristine verified messages


@dataclasses.dataclass
class ClassFold:
    """One weight class inside a `PooledFoldRecord` (wire form)."""
    size: float
    version: int
    count: int
    count_words: List[np.ndarray]   # `aggregation.pack_counts` streams
    float_sums: List[np.ndarray]
    metric_sums: Dict[str, float]
    bpp_sum: float


@dataclasses.dataclass
class PooledFoldRecord:
    """The ONE record an edge forwards upstream a commit.  `wire_bits`
    is the packed counts and the class headers, `sidecar_bits` the pooled
    float, metric and entropy sums, `header_bits` the CRC32 fold
    checksum: all O(params), nothing scales with the folded clients."""
    edge: int
    acc_bits: int
    classes: List[ClassFold]
    checksum: Optional[int] = None

    def __post_init__(self):
        if self.checksum is None:
            self.checksum = self.compute_checksum()

    def compute_checksum(self) -> int:
        streams = []
        for cf in self.classes:
            streams.extend(cf.count_words)
        return aggregation.words_checksum(streams)

    def verify(self) -> bool:
        return self.checksum == self.compute_checksum()

    @property
    def wire_bits(self) -> int:
        tot = 0
        for cf in self.classes:
            tot += sum(32 * int(w.size) for w in cf.count_words)
            tot += CLASS_HEADER_BITS
        return tot

    @property
    def sidecar_bits(self) -> int:
        tot = 0
        for cf in self.classes:
            tot += 32 * (sum(int(f.size) for f in cf.float_sums)
                         + len(cf.metric_sums) + 1)
        return tot

    @property
    def header_bits(self) -> int:
        return codecs_lib.HEADER_BITS

    @classmethod
    def from_edge(cls, edge_id: int, edge: _Edge, acc_bits: int
                  ) -> "PooledFoldRecord":
        folds = []
        for key in sorted(edge.classes):
            a = edge.classes[key]
            folds.append(ClassFold(
                size=float(a.size), version=int(a.version),
                count=int(a.count),
                count_words=[aggregation.pack_counts(c, acc_bits)
                             for c in a.counts],
                float_sums=[np.asarray(f, np.float32) for f in a.fsums],
                metric_sums=dict(a.msums), bpp_sum=float(a.bpp_sum)))
        return cls(edge=edge_id, acc_bits=acc_bits, classes=folds)


# ---------------------------------------------------------------------------
# The tree engine
# ---------------------------------------------------------------------------


class TreeRoundEngine(AsyncRoundEngine):
    """`AsyncRoundEngine` with a fanout-configurable aggregator layer
    between the transport and the commit: the same tick / flush / save /
    restore surface and commit metrics (plus `root_bits_measured`,
    `edges` and `seq`).  Needs an algorithm with the `pooled_aggregate`
    seam (packed payloads); float-delta algorithms cannot ride the tree.

    `adversary` maps client -> role for the Byzantine drills: "ones" /
    "zeros" encode a self-consistent density bomb (caught by the density
    bounds), "flip" is a transit tamper that flips one coded bit and
    forges the CRC (caught by the pre-decode declaration)."""

    def __init__(self, algo, state, data_like, sizes, seed: int,
                 config: Optional[AsyncConfig] = None,
                 injector=None, codec=None,
                 tree: Optional[TreeConfig] = None,
                 adversary: Optional[Dict[int, str]] = None):
        if getattr(algo, "pooled_aggregate", None) is None:
            raise ValueError(
                f"algorithm {algo.name!r} has no pooled_aggregate seam; "
                "only packed-payload algorithms can ride the aggregator "
                "tree")
        super().__init__(algo, state, data_like, sizes, seed,
                         config=config, injector=injector, codec=codec)
        self.tree = tree or TreeConfig()
        self.n_edges = self.tree.n_edges(self.n_clients)
        self.adversary = dict(adversary or {})

        for k in ("root_bits_measured", "root_header_bits", "decl_bits"):
            self.totals[k] = 0.0
            self._since_commit[k] = 0.0

        # static payload geometry: per word leaf its padded bit-position
        # count P and true parameter count n, per float leaf its shape
        # and dtype
        tmpl = self._payload_template
        wleaves, self._words_def = tu.flatten(tmpl.words)
        self._words_none = tuple(w is None for w in wleaves)
        self._leaf_P = tuple(int(w.numel()) * 32 for w in wleaves
                             if w is not None)
        self._leaf_n = tuple(math.prod(sh) for sh in tmpl.shapes)
        self._leaf_shapes = tmpl.shapes
        self._has_floats = hasattr(tmpl, "floats")
        fleaves, self._floats_def = tu.flatten(getattr(tmpl, "floats",
                                                       None))
        self._floats_none = tuple(f is None for f in fleaves)
        self._float_shapes = tuple(tuple(f.shape) for f in fleaves
                                   if f is not None)
        self._float_dtypes = tuple(f.dtype for f in fleaves
                                   if f is not None)
        self._reset_tree_state()

    def _reset_tree_state(self):
        self.edges = [_Edge(classes={}, log=[])
                      for _ in range(self.n_edges)]
        self._decl: Dict[Tuple[int, int], int] = {}
        self._replayed: set = set()
        self.byz = ByzantineFilter(self.tree)
        self.byz_quarantined: Dict[str, int] = {}

    # -- launch: adversary mutation + popcount declaration ---------------

    def _bomb_message(self, role: str) -> codecs_lib.WireMessage:
        """A malicious client's self-consistent uplink: every mask bit set
        ("ones") or cleared ("zeros"), packed on the state's device and
        encoded through the real codec with a valid CRC."""
        bit = 1 if role == "ones" else 0
        tmpl = self._payload_template
        it = iter(tmpl.shapes)
        words = tu.tree_map(
            lambda w: None if w is None else plds.pack_leaf(torch.full(
                next(it), bit, dtype=torch.uint8,
                device=self.device)).cpu(), tmpl.words)
        return self.codec.encode(dataclasses.replace(tmpl, words=words))

    def _launch(self, data, t: int, uniforms=None):
        n0 = len(self.pending)
        super()._launch(data, t, uniforms)
        for e in self.pending[n0:]:
            role = self.adversary.get(e.client)
            if role in ("ones", "zeros"):
                e.msg = self._bomb_message(role)
                self._event("adversary", client=e.client, round=t,
                            role=role)
            # the client commits to its stream's popcount at launch; the
            # edge checks the commitment before decoding
            self._decl[(e.round, e.client)] = _wire_popcount(e.msg.words)
            self._since_commit["decl_bits"] += DECL_BITS
            self.totals["decl_bits"] += DECL_BITS
            if role == "flip":
                # transit tamper AFTER the declaration: flip one coded bit
                # and restamp (forge) the CRC so verify() passes
                tampered = [np.asarray(w, np.uint32).copy()
                            for w in e.msg.words]
                tampered[0][0] ^= np.uint32(1)
                e.msg = dataclasses.replace(e.msg, words=tampered,
                                            checksum=None)
                self._event("adversary", client=e.client, round=t,
                            role=role)

    # -- deliver: failure domains -> transport -> Byzantine screen -------

    def _edge_alive(self, t: int):
        inj = self.injector
        if inj is None:
            z = np.zeros(self.n_edges, bool)
            return z, z
        return (inj.agg_crashed(t, self.n_edges),
                inj.agg_partitioned(t, self.n_edges))

    def _failover_target(self, home: int, crashed: np.ndarray
                         ) -> Optional[int]:
        if not self.tree.failover:
            return None
        for step in range(1, self.n_edges):
            sib = (home + step) % self.n_edges
            if not crashed[sib]:
                return sib
        return None

    def _crash_edge(self, eid: int, t: int):
        """The edge's uncommitted fold is gone: replay its logged
        (verified) arrivals from the client-side retransmit queue with
        the same attempt index, so the counter-hashed corrupt draw
        repeats its outcome; the redelivery is metered as wire traffic."""
        edge = self.edges[eid]
        lost = sum(a.count for a in edge.classes.values())
        # the lost fold's ones leave the running buffer total too; the
        # replayed arrivals re-add them when they fold again
        self.buffer_ones -= sum(int(c.sum())
                                for a in edge.classes.values()
                                for c in a.counts)
        self._event("agg_crash", edge=eid, lost=lost)
        for le in edge.log:
            self._event("replay", client=le.client, round=le.round,
                        edge=eid, attempt=le.attempt)
            self._replayed.add((le.round, le.client, le.attempt))
            self.pending.append(dataclasses.replace(le, deliver=t))
        edge.classes = {}
        edge.log = []

    def _deliver(self, t: int):
        crashed, parted = self._edge_alive(t)
        for eid in np.flatnonzero(crashed):
            self._crash_edge(int(eid), t)
        still: List[_InFlight] = []
        arrivals: List[Tuple[_InFlight, int]] = []
        for e in self.pending:
            if e.deliver > t:
                still.append(e)
                continue
            home = self.tree.edge_of(e.client) % self.n_edges
            target = home
            if crashed[home]:
                sib = self._failover_target(home, crashed)
                if sib is None:
                    self._event("agg_unavailable", client=e.client,
                                round=e.round, edge=home,
                                attempt=e.attempt)
                    still.append(dataclasses.replace(e, deliver=t + 1))
                    continue
                self._event("failover", client=e.client, round=e.round,
                            edge=home, to=int(sib), attempt=e.attempt)
                target = int(sib)
            if parted[target]:
                self._event("agg_partition", client=e.client,
                            round=e.round, edge=int(target),
                            attempt=e.attempt)
                still.append(dataclasses.replace(e, deliver=t + 1))
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
            # declaration check BEFORE decode: a forged CRC cannot forge
            # the launch-time popcount commitment
            decl = self._decl.get((e.round, e.client))
            if decl is not None and _wire_popcount(msg.words) != decl:
                self._quarantine(e, int(target), "decl_mismatch")
                continue
            arrivals.append((e, int(target)))
        self.pending = still
        self._screen_and_fold(t, arrivals)

    def _quarantine(self, e: _InFlight, edge: int, reason: str, **kw):
        self.byz_quarantined[reason] = \
            self.byz_quarantined.get(reason, 0) + 1
        self._event("byz_quarantine", client=e.client, round=e.round,
                    edge=edge, reason=reason, attempt=e.attempt, **kw)

    def _screen_and_fold(self, t: int, arrivals):
        """The Byzantine screen over one tick's verified arrivals, then
        the survivors' folds into their edges' class accumulators."""
        if not arrivals:
            return
        cand = []
        for e, target in arrivals:
            payload = self._decode(e.msg)
            n = max(payload.num_params(), 1)
            ones = _payload_popcount(payload)
            density = ones / n
            if density < self.tree.min_density \
                    or density > self.tree.max_density:
                self._quarantine(e, target, "density",
                                 density=round(density, 6))
                continue
            cand.append((e, target, payload, density, ones))
        if not cand:
            return
        admitted, quarantined, trimmed = self.byz.screen(
            [c[3] for c in cand])
        if trimmed:
            self._event("trimmed_fold", flagged=len(quarantined),
                        cohort=len(cand))
        for i, z in sorted(quarantined.items()):
            e, target = cand[i][0], cand[i][1]
            self._quarantine(e, target, "zscore", z=round(z, 4))
        for i in admitted:
            e, target, payload, density, ones = cand[i]
            rkey = (e.round, e.client, e.attempt)
            if rkey in self._replayed:
                self._replayed.discard(rkey)  # statistics already counted
            else:
                self.byz.admit(density)
            self._accumulate(target, e, payload)
            self.buffer_ones += ones
            self._event("fold", client=e.client, round=e.round,
                        staleness=self.version - e.version, ones=ones,
                        attempt=e.attempt, edge=target)

    def _accumulate(self, eid: int, e: _InFlight, payload) -> None:
        """Exact integer fold of one verified payload into the edge's
        class accumulator (and its replay log), on the host.  Pure
        accumulation, no events and no metering, so the restore path
        refolds logs byte-identically."""
        ts = time.perf_counter()
        edge = self.edges[eid]
        key = (float(e.size), int(e.version))
        acc = edge.classes.get(key)
        if acc is None:
            acc = _ClassAcc(
                size=float(e.size), version=int(e.version), count=0,
                counts=[np.zeros((p,), np.int64) for p in self._leaf_P],
                fsums=[np.zeros(sh, np.float32)
                       for sh in self._float_shapes],
                msums={k: 0.0 for k in e.metrics}, bpp_sum=0.0,
                clients=[])
            edge.classes[key] = acc
        wl = [w for w in tu.leaves(payload.words) if w is not None]
        for i, w in enumerate(wl):
            acc.counts[i] += _unpack_bits_np(w).astype(np.int64)
        if self._has_floats:
            fl = [f for f in tu.leaves(payload.floats) if f is not None]
            for i, f in enumerate(fl):
                acc.fsums[i] += f.detach().cpu().float().numpy()
        for k, v in e.metrics.items():
            acc.msums[k] = acc.msums.get(k, 0.0) + float(v)
        acc.bpp_sum += float(payload.bpp())
        acc.count += 1
        acc.clients.append((int(e.client), int(e.round)))
        edge.log.append(dataclasses.replace(e))
        self.host_seconds["fold"] += time.perf_counter() - ts

    # -- commit: pooled records cross the edge -> root hop ---------------

    def _folded_total(self) -> int:
        return sum(a.count for edge in self.edges
                   for a in edge.classes.values())

    def _maybe_commit(self, t: int, force: bool = False) -> List[dict]:
        # prune whole classes the fold outlived (every member of a class
        # has the same staleness)
        for edge in self.edges:
            for key in sorted(edge.classes):
                size, ver = key
                if self.version - ver <= self.config.max_staleness:
                    continue
                acc = edge.classes.pop(key)
                for c, r in acc.clients:
                    self._event("stale_drop", client=c, round=r,
                                staleness=self.version - ver)
                edge.log = [le for le in edge.log
                            if (float(le.size), int(le.version)) != key]
        folded = self._folded_total()
        if folded == 0:
            return []
        deadline = (t - self.last_commit_tick
                    >= self.config.deadline_rounds)
        if folded < self.quorum and not (force or deadline):
            return []
        return [self._commit(t, forced=force or deadline)]

    def _root_phase(self, state, counts, fsums, msums, bpps, sizes, stal,
                    kcounts):
        """The root reduction on the state's device: staleness-discounted
        per-client class weights, theta through `mean_from_counts` (eq. 8
        over pooled exact counts), the pooled float, metric and entropy
        means, then the algorithm's `pooled_aggregate` transition."""
        dev, f32 = self.device, torch.float32
        disc = aggregation.staleness_weight(
            torch.as_tensor(stal, dtype=f32, device=dev),
            self.config.staleness_alpha)
        sizes = torch.as_tensor(sizes, dtype=f32, device=dev)
        w = torch.where(disc == 1.0, sizes, sizes * disc)
        kc = torch.as_tensor(kcounts, dtype=f32, device=dev)
        wn = w / torch.clamp((kc * w).sum(), min=1e-9)
        it = iter(range(len(self._leaf_n)))
        qleaves = []
        for none in self._words_none:
            if none:
                qleaves.append(None)
                continue
            i = next(it)
            qleaves.append(plds.mean_from_counts(
                torch.from_numpy(counts[i]).to(dev), self._leaf_n[i], wn
            ).reshape(self._leaf_shapes[i]))
        q = tu.unflatten(self._words_def, qleaves)
        fleaves, fi = [], 0
        for none in self._floats_none:
            if none:
                fleaves.append(None)
                continue
            fleaves.append(torch.tensordot(
                wn, torch.from_numpy(fsums[fi]).to(dev), dims=([0], [0])
            ).to(self._float_dtypes[fi]))
            fi += 1
        floats = tu.unflatten(self._floats_def, fleaves)
        new_state = self.algo.pooled_aggregate(state, q, floats, kc.sum())
        up_bpp = (wn * torch.as_tensor(bpps, dtype=f32, device=dev)).sum()
        mmeans = {mk: (wn * torch.as_tensor(mv, dtype=f32, device=dev)
                       ).sum() for mk, mv in msums.items()}
        return new_state, up_bpp, mmeans

    def _commit(self, t: int, forced: bool = False) -> dict:
        # 1. every edge serializes its pooled fold: the ONLY bytes that
        # cross the edge -> root hop, metered into root_bits_measured
        records: List[PooledFoldRecord] = []
        clients: List[int] = []
        for eid, edge in enumerate(self.edges):
            if not edge.classes:
                continue
            for acc in edge.classes.values():
                clients.extend(c for c, _ in acc.clients)
            rec = PooledFoldRecord.from_edge(eid, edge, self.tree.acc_bits)
            rbits = float(rec.wire_bits + rec.sidecar_bits)
            self._since_commit["root_bits_measured"] += rbits
            self.totals["root_bits_measured"] += rbits
            self._since_commit["root_header_bits"] += rec.header_bits
            self.totals["root_header_bits"] += rec.header_bits
            records.append(rec)
        # 2. the root verifies and DESERIALIZES the records (the packed
        # wire form is what crosses), merging classes in exact integers
        merged: Dict[Tuple[float, int], dict] = {}
        for rec in records:
            if not rec.verify():
                raise codecs_lib.ChecksumError(
                    f"edge {rec.edge} pooled fold failed its checksum")
            for cf in rec.classes:
                counts = [aggregation.unpack_counts(wd, p, rec.acc_bits)
                          for wd, p in zip(cf.count_words, self._leaf_P)]
                key = (float(cf.size), int(cf.version))
                m = merged.get(key)
                if m is None:
                    merged[key] = {
                        "count": int(cf.count), "counts": counts,
                        "fsums": [f.copy() for f in cf.float_sums],
                        "msums": dict(cf.metric_sums),
                        "bpp": float(cf.bpp_sum)}
                    continue
                m["count"] += int(cf.count)
                for i, c in enumerate(counts):
                    m["counts"][i] = m["counts"][i] + c
                for i, f in enumerate(cf.float_sums):
                    m["fsums"][i] = m["fsums"][i] + f
                for mk, mv in cf.metric_sums.items():
                    m["msums"][mk] = m["msums"].get(mk, 0.0) + mv
                m["bpp"] += float(cf.bpp_sum)
        keys = sorted(merged)
        sizes = np.asarray([k[0] for k in keys], np.float32)
        stal = np.asarray([self.version - k[1] for k in keys], np.float32)
        kcounts = np.asarray([merged[k]["count"] for k in keys], np.float32)
        counts = [np.stack([merged[k]["counts"][i] for k in keys])
                  for i in range(len(self._leaf_P))]
        fsums = [np.stack([merged[k]["fsums"][i] for k in keys])
                 for i in range(len(self._float_shapes))]
        mkeys = sorted(merged[keys[0]]["msums"])
        msums = {mk: np.asarray([merged[k]["msums"][mk] for k in keys],
                                np.float32) for mk in mkeys}
        bpps = np.asarray([merged[k]["bpp"] for k in keys], np.float32)
        new_state, up_bpp, mmeans = self._root_phase(
            self.state, counts, fsums, msums, bpps, sizes, stal, kcounts)
        self.state = new_state
        B = int(kcounts.sum())
        stal_max = int(max(self.version - k[1] for k in keys))
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
               "clients": sorted(clients),
               "edges": len(records)}
        out.update({k: self._since_commit[k] for k in self._since_commit})
        for mk in mkeys:
            out[mk] = float(mmeans[mk])
        self._since_commit = {k: 0.0 for k in self._since_commit}
        for edge in self.edges:
            edge.classes = {}
            edge.log = []
        self.buffer_ones = 0
        live = {(e.round, e.client) for e in self.pending}
        self._decl = {k: v for k, v in self._decl.items() if k in live}
        self._event("commit", version=self.version, folded=B,
                    forced=bool(forced), edges=len(records))
        out["seq"] = self.events[-1]["seq"]
        return out

    # -- crash-consistent checkpointing ----------------------------------

    def _save_payload(self):
        arrays, extra = super()._save_payload()
        edges_meta = []
        for eid, edge in enumerate(self.edges):
            log_meta = []
            for i, le in enumerate(edge.log):
                for j, w in enumerate(le.msg.words):
                    arrays[f"elog{eid}_{i}/w{j}"] = w
                for j, s in enumerate(le.msg.sidecar):
                    arrays[f"elog{eid}_{i}/s{j}"] = s
                log_meta.append(self._msg_meta(le))
            edges_meta.append({"log": log_meta})
        extra["tree"] = {
            "decl": [[int(r), int(c), int(o)]
                     for (r, c), o in sorted(self._decl.items())],
            "filter": self.byz.state_dict(),
            "quarantined": dict(self.byz_quarantined),
            "replayed": sorted([list(k) for k in self._replayed]),
            "edges": edges_meta,
        }
        return arrays, extra

    def _load_payload(self, arrays, extra):
        super()._load_payload(arrays, extra)
        self._reset_tree_state()
        te = extra.get("tree")
        if te is None or self._degraded_restore:
            return self
        self._decl = {(int(r), int(c)): int(o) for r, c, o in te["decl"]}
        self.byz.load_state(te["filter"])
        self.byz_quarantined = {k: int(v)
                                for k, v in te["quarantined"].items()}
        self._replayed = {tuple(int(x) for x in k)
                          for k in te["replayed"]}
        for eid, em in enumerate(te["edges"]):
            for i, meta in enumerate(em["log"]):
                le = self._msg_from(arrays, f"elog{eid}_{i}", meta)
                # the fold log is state: a corrupt entry degrades the
                # restore as a corrupt buffer entry would
                if not le.msg.verify():
                    return self._restore_degraded(meta, i)
                # refold: the logs are the single source of truth for the
                # edge accumulators
                self._accumulate(eid, le, self._decode(le.msg))
        return self

    def _restore_degraded(self, meta, slot):
        self._reset_tree_state()
        return super()._restore_degraded(meta, slot)


# ---------------------------------------------------------------------------
# The barrier-path topology of launch/train.py
# ---------------------------------------------------------------------------


class TreeTopology:
    """Static client -> edge map and aggregator fault draws for the
    SYNCHRONOUS train loop.  The barrier round has no retransmit window:
    every client homed on a crashed edge misses the round, and if every
    edge crashed the lowest-id edge is rescued so a round never folds an
    empty cohort.  Root traffic is metered statically
    (`analysis.comm_model.tree_root_record_bits` x surviving edges)."""

    def __init__(self, n_clients: int, fanout: int,
                 agg_fault_prob: float = 0.0, seed: int = 0):
        self.cfg = TreeConfig(fanout=max(1, fanout))
        self.n_clients = n_clients
        self.n_edges = self.cfg.n_edges(n_clients)
        self.agg_fault_prob = float(agg_fault_prob)
        self.seed = seed

    def crashed_edges(self, round_idx: int) -> np.ndarray:
        u = faultlib.counter_uniform(self.seed, round_idx,
                                     faultlib._S_AGG_CRASH, self.n_edges)
        crashed = u < self.agg_fault_prob
        if crashed.all():
            crashed = crashed.copy()
            crashed[0] = False      # rescue: the root adopts one edge
        return crashed

    def surviving_edges(self, round_idx: int) -> int:
        return int((~self.crashed_edges(round_idx)).sum())

    def round_mask(self, alive: np.ndarray, round_idx: int) -> np.ndarray:
        """Participation after aggregator faults: clients of crashed
        edges miss the barrier whatever their own liveness."""
        crashed = self.crashed_edges(round_idx)
        out = np.asarray(alive, bool).copy()
        for c in np.flatnonzero(out):
            if crashed[self.cfg.edge_of(int(c)) % self.n_edges]:
                out[c] = False
        return out


# ---------------------------------------------------------------------------
# The command line: the target of repro_torch.tools.chaos_smoke --tree
# ---------------------------------------------------------------------------


def _build_engine(args):
    """The reference command line's engine: the tiny CNN (Conv 8-8,
    dense 16, 4 classes, 8x8 images), fedpm_reg with 2 local steps of
    batch 8 on 24 images a client, edge crashes at --agg-fault-prob and
    partitions at half of it, on args.device (cuDNN in its deterministic
    mode)."""
    from repro_torch import api
    from repro_torch.core import masking
    from repro_torch.data import partition, synthetic
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import cnn

    dev = resolve_device(args.device)
    # a resumed run must redo exactly what the killed one did: cuDNN's
    # default conv backward sums in a nondeterministic order
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cfg = cnn.ConvConfig("t", (8, 8), (16,), n_classes=4, img_size=8)
    task = synthetic.make_image_task(gen, n=24 * args.clients, img=8,
                                     n_classes=4, noise=0.3)
    params = cnn.init_params(gen, cfg)
    apply_fn = lambda p, b: cnn.forward(p, cfg, b["images"])
    rng = np.random.default_rng(args.seed)
    cidx = partition.partition_iid(rng, task.y.cpu().numpy(), args.clients)
    data = synthetic.federated_batches(gen, task, cidx, args.clients, 2, 8)
    sizes = torch.tensor([len(c) for c in cidx], dtype=torch.float32,
                         device=dev)
    algo = api.get_algorithm("fedpm_reg", apply_fn, cnn.ce_loss,
                             spec=masking.MaskSpec(), local_steps=2)
    inj = faultlib.FaultInjector(
        args.clients, seed=args.seed,
        agg_crash_prob=args.agg_fault_prob,
        agg_partition_prob=args.agg_fault_prob * 0.5)
    eng = TreeRoundEngine(
        algo, algo.init(gen, params), data, sizes, args.seed,
        config=AsyncConfig(quorum_frac=args.quorum_frac,
                           deadline_rounds=args.deadline),
        injector=inj, tree=TreeConfig(fanout=args.fanout))
    return eng, data


def _main(argv=None):
    import argparse
    import os

    from repro_torch.ckpt import checkpoint as ckptlib

    ap = argparse.ArgumentParser(
        description="aggregator-tree chaos run: tick a TreeRoundEngine "
                    "with a crash-consistent save every tick (the SIGKILL "
                    "target of repro_torch.tools.chaos_smoke --tree)")
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--fanout", type=int, default=2)
    ap.add_argument("--agg-fault-prob", type=float, default=0.0)
    ap.add_argument("--quorum-frac", type=float, default=1.0)
    ap.add_argument("--deadline", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--marker", default="",
                    help="file to create after the first commit is "
                         "durably saved (the kill signal)")
    ap.add_argument("--tick-sleep", type=float, default=0.0,
                    help="widen the kill window (never affects results)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    eng, data = _build_engine(args)
    bundle = os.path.join(args.ckpt_dir, "engine")
    if ckptlib.bundle_exists(bundle):
        eng.restore(bundle)
        print(f"resumed at tick {eng.tick_idx} (version {eng.version}, "
              f"seq {eng._event_seq})", flush=True)
    for _ in range(eng.tick_idx, args.ticks):
        commits = eng.tick(data)
        eng.save(bundle)     # durable BEFORE the commit is announced
        for c in commits:
            print(f"commit v={c['version']} seq={c['seq']} "
                  f"tick={c['tick']}", flush=True)
        if args.marker and commits and not os.path.exists(args.marker):
            with open(args.marker, "w") as f:
                f.write(str(commits[-1]["version"]))
        if args.tick_sleep:
            time.sleep(args.tick_sleep)
    for c in eng.flush():
        eng.save(bundle)
        print(f"commit v={c['version']} seq={c['seq']} "
              f"tick={c['tick']}", flush=True)
    eng.save(bundle)
    digest = AsyncRoundEngine._payload_checksum(eng.state)
    print(f"theta digest {digest:08x} version {eng.version}", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    _main()
