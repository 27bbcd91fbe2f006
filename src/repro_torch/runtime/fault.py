"""Fault tolerance and straggler mitigation for federated runs
(`repro.runtime.fault`, numpy as there).

A round aggregates whatever masks arrive, the weighted mean renormalized
over the survivors (`launch.steps.make_round_step` and
`api.protocol.run_round` both renormalize).  This module produces the
per-round participation vectors and the transport-seam fault injections
from failure and straggler models, so one mechanism covers:

  * node crash           -> client missing this round
  * network partition    -> whole cohort missing
  * straggler            -> client past deadline, cut by policy
  * corrupted uplink     -> checksum fails, bounded retransmit, then cut
  * elastic scale-down   -> trailing clients permanently removed

Every draw is RESTART-DETERMINISTIC: failures derive from
``(seed, round, client, stream)`` through a splitmix64 counter hash —
there is no mutable generator whose state a coordinator crash would
lose, and every draw equals the reference's bit for bit.  The port's
own uses of the same hash: `counter_seed` seeds a fresh
`torch.Generator` per (seed, index, stream), which is how the launcher
draws a step's batch and the async engine a tick's client draws, so a
resumed run replays them too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# stream ids for the counter hash — one per independent failure process
_S_ALIVE = 1
_S_POD = 2
_S_LAT_A = 3
_S_LAT_B = 4
_S_RESCUE = 5
_S_CRASH = 6
_S_PART = 7
_S_DELAY = 8
_S_DELAY_N = 9
_S_CORRUPT = 10
_S_BITFLIP = 11
_S_AGG_CRASH = 12
_S_AGG_PART = 13
# the port's generator seeds (`counter_seed`)
S_BATCH = 14
S_TICK = 15


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the counter-hash core (vectorized u64)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def counter_uniform(seed: int, round_idx: int, stream: int,
                    n: int) -> np.ndarray:
    """n uniforms in [0, 1) from (seed, round, stream, 0..n-1) — pure
    counter mode, no carried state.  The restart-determinism primitive:
    the same coordinates always reproduce the same draw."""
    with np.errstate(over="ignore"):
        base = (np.uint64(np.uint64(seed) & np.uint64(0xFFFFFFFF))
                * np.uint64(0xD1342543DE82EF95)
                ^ np.uint64(round_idx) * np.uint64(0xAF251AF3B0F025B5)
                ^ np.uint64(stream) * np.uint64(0x9E3779B97F4A7C15))
        ctr = base + np.arange(n, dtype=np.uint64)
    h = _splitmix64(ctr)
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def counter_seed(seed: int, round_idx: int, stream: int) -> int:
    """A 63-bit `torch.Generator` seed from (seed, round, stream): the
    counter hash's first draw, so a generator made anew from it at any
    restart point draws what an uninterrupted run drew."""
    with np.errstate(over="ignore"):
        base = (np.uint64(np.uint64(seed) & np.uint64(0xFFFFFFFF))
                * np.uint64(0xD1342543DE82EF95)
                ^ np.uint64(round_idx) * np.uint64(0xAF251AF3B0F025B5)
                ^ np.uint64(stream) * np.uint64(0x9E3779B97F4A7C15))
    return int(_splitmix64(np.asarray([base]))[0] >> np.uint64(1))


def counter_normal(seed: int, round_idx: int, stream_a: int,
                   stream_b: int, n: int) -> np.ndarray:
    """Standard normals via Box-Muller over two counter streams."""
    u1 = np.maximum(counter_uniform(seed, round_idx, stream_a, n),
                    1e-12)
    u2 = counter_uniform(seed, round_idx, stream_b, n)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based cohort cut: keep the first `quorum_frac` arrivals,
    drop the rest (they are simply absent from the weighted mean).
    `overprovision` asks the selector for K' > K clients so the expected
    number of arrivals still meets the target cohort size."""
    quorum_frac: float = 0.8
    overprovision: float = 1.25

    def cut(self, latencies: np.ndarray) -> np.ndarray:
        k = len(latencies)
        keep = max(int(round(k * self.quorum_frac)), 1)
        order = np.argsort(latencies)
        mask = np.zeros(k, bool)
        mask[order[:keep]] = True
        return mask


@dataclasses.dataclass
class FaultSimulator:
    """Per-round iid failures + heavy-tailed latencies (lognormal) +
    optional correlated pod-level outages.

    Draws are keyed by (seed, round): `sample_round(round_idx=r)` is a
    pure function, and the internal `cursor` only provides the default
    round index for callers that sample sequentially.  On restart, set
    ``cursor`` to the resumed round (or pass ``round_idx``) and the
    fault sequence replays identically.
    """
    n_clients: int
    fail_prob: float = 0.05
    pod_size: int = 0            # >0: clients grouped into pods
    pod_outage_prob: float = 0.0
    latency_sigma: float = 0.5
    seed: int = 0
    cursor: int = 0              # next round index for cursor-mode calls

    def latencies(self, round_idx: int) -> np.ndarray:
        """Lognormal per-client round latencies for round `round_idx`."""
        z = counter_normal(self.seed, round_idx, _S_LAT_A, _S_LAT_B,
                           self.n_clients)
        return np.exp(self.latency_sigma * z)

    def sample_round(self, policy: Optional[StragglerPolicy] = None,
                     round_idx: Optional[int] = None) -> np.ndarray:
        r = int(self.cursor if round_idx is None else round_idx)
        if round_idx is None:
            self.cursor = r + 1
        u = counter_uniform(self.seed, r, _S_ALIVE, self.n_clients)
        alive = u >= self.fail_prob
        if self.pod_size and self.pod_outage_prob > 0:
            n_pods = (self.n_clients + self.pod_size - 1) // self.pod_size
            pod_down = counter_uniform(self.seed, r, _S_POD,
                                       n_pods) < self.pod_outage_prob
            for p in np.where(pod_down)[0]:
                alive[p * self.pod_size:(p + 1) * self.pod_size] = False
        if policy is not None:
            lat = self.latencies(r)
            lat[~alive] = np.inf
            alive &= policy.cut(lat)
        if not alive.any():      # server never stalls: keep one survivor
            pick = counter_uniform(self.seed, r, _S_RESCUE, 1)[0]
            alive[int(pick * self.n_clients)] = True
        return alive


def participation_vector(sim: Optional[FaultSimulator], n_clients: int,
                         policy: Optional[StragglerPolicy] = None,
                         round_idx: Optional[int] = None, device="cpu"):
    """The round's bool participation tensor on `device` (all True
    without a simulator)."""
    if sim is None:
        return torch.ones((n_clients,), dtype=torch.bool, device=device)
    return torch.as_tensor(sim.sample_round(policy, round_idx=round_idx),
                           device=device)


# ---------------------------------------------------------------------------
# Transport-seam injection (the async engine's chaos source)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Deterministic fault injection at the TRANSPORT seam, for the
    buffered-async engine (`runtime.async_engine`):

      * crash      — the uplink is never sent (client died mid-round)
      * partition  — a whole pod's uplinks are dropped (correlated)
      * straggler  — delivery is delayed whole rounds past the deadline
      * corrupt    — the packed words are bit-flipped in transit; the
                     receiver's `WireMessage` checksum rejects them and
                     the client retransmits with backoff, up to
                     `max_retries`, after which it is cut from the round

    Every decision is a pure function of (seed, round, client[, try]):
    a coordinator restart replays the identical fault sequence.
    """
    n_clients: int
    seed: int = 0
    crash_prob: float = 0.0
    pod_size: int = 0
    partition_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_rounds_max: int = 2   # uniform 1..max extra rounds late
    corrupt_prob: float = 0.0       # per delivery attempt
    max_retries: int = 2
    backoff_rounds: float = 0.5     # extra delay per retransmit
    agg_crash_prob: float = 0.0     # per-tick edge-aggregator crash
    agg_partition_prob: float = 0.0  # per-tick edge-aggregator partition

    def dropped(self, round_idx: int) -> np.ndarray:
        """bool[n_clients]: uplink never arrives (crash or partition)."""
        u = counter_uniform(self.seed, round_idx, _S_CRASH,
                            self.n_clients)
        out = u < self.crash_prob
        if self.pod_size and self.partition_prob > 0:
            n_pods = (self.n_clients + self.pod_size - 1) // self.pod_size
            down = counter_uniform(self.seed, round_idx, _S_PART,
                                   n_pods) < self.partition_prob
            for p in np.where(down)[0]:
                out[p * self.pod_size:(p + 1) * self.pod_size] = True
        return out

    def delay_rounds(self, round_idx: int) -> np.ndarray:
        """int[n_clients]: whole rounds each delivery lands late
        (0 = within this round's deadline)."""
        u = counter_uniform(self.seed, round_idx, _S_DELAY,
                            self.n_clients)
        extra = counter_uniform(self.seed, round_idx, _S_DELAY_N,
                                self.n_clients)
        late = u < self.straggler_prob
        k = 1 + (extra * self.straggler_rounds_max).astype(np.int64)
        return np.where(late, np.minimum(k, self.straggler_rounds_max),
                        0).astype(np.int64)

    def agg_crashed(self, round_idx: int, n_aggs: int) -> np.ndarray:
        """bool[n_aggs]: edge aggregator crashes this tick, losing its
        uncommitted partial fold (an aggregator-level failure domain)."""
        u = counter_uniform(self.seed, round_idx, _S_AGG_CRASH, n_aggs)
        return u < self.agg_crash_prob

    def agg_partitioned(self, round_idx: int, n_aggs: int) -> np.ndarray:
        """bool[n_aggs]: edge aggregator unreachable this tick —
        deliveries destined for it are delayed one tick, not lost."""
        u = counter_uniform(self.seed, round_idx, _S_AGG_PART, n_aggs)
        return u < self.agg_partition_prob

    def corrupt_attempt(self, round_idx: int, client: int,
                        attempt: int) -> bool:
        """Does transmission attempt `attempt` arrive corrupted?"""
        u = counter_uniform(
            self.seed, round_idx, _S_CORRUPT,
            (client + 1) * (self.max_retries + 2))[
                (client + 1) * (self.max_retries + 2) - 1 - attempt]
        return bool(u < self.corrupt_prob)

    def corrupt_words(self, words, round_idx: int, client: int,
                      attempt: int):
        """Flip one deterministic bit in the serialized word streams —
        what a corrupted-in-transit message looks like on arrival."""
        out = [np.array(w, np.uint32, copy=True) for w in words]
        total = sum(int(w.size) for w in out)
        if total == 0:
            return out
        u = counter_uniform(self.seed, round_idx, _S_BITFLIP,
                            self.n_clients * (self.max_retries + 2))
        pick = int(u[client * (self.max_retries + 2) + attempt]
                   * total * 32)
        w_idx, bit = divmod(pick, 32)
        for arr in out:
            if w_idx < arr.size:
                arr[w_idx] ^= np.uint32(1 << bit)
                break
            w_idx -= arr.size
        return out
