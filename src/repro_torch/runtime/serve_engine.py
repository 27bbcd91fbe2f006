"""Multi-tenant serving engine: continuous batching over one shared
frozen weight copy (`repro.runtime.serve_engine`).

A deployed tenant is a 1-bit mask over the same frozen random network
`w`, a `masking.MaskIdentity`.  The engine holds one `MaskedParams` (one
`w` on the device) for every tenant, freezes each tenant's decode tree
once with `masking.freeze_identity` and keeps at most `cache_capacity`
of them in an exact-LRU `masking.FreezeCache`, so resident memory is
1 x w + min(tenants, capacity) x the masked leaves, however many tenants
rotate through.

Each tick admits queued requests into free slots and advances every
active slot by one token: a newly admitted request prefills (consumes
its next prompt token) while resident slots decode, and a freed slot
admits the next request on the same tick.  By default every slot steps
through the same single-request `api.decode_step` with its own KV cache,
so a tenant's logits are bit-identical to that tenant decoded alone,
whatever traffic shares the engine.  `lockstep=True` instead keeps the
slots' trees and caches as slot-major (B, ...) stacks, written at
admission (`_scatter_slot`), and advances all slots in one vmapped call
a tick (`launch.steps.make_multi_serve_step`): fewer dispatches, but
numerically equivalent rather than bit-exact, so it is opt-in.

Timing: the first admission runs one step on a scratch cache off the
clock; every step (lockstep: every tick, its time shared evenly by the
active slots' tokens) is timed with `time.perf_counter` after a device
synchronize, prefill and decode on separate clocks, and each tree's
freeze likewise (`freeze_s`).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import masking
from repro_torch.core import tree as tu
from repro_torch.core.masking import FreezeCache, MaskedParams, MaskIdentity
from repro_torch.launch import steps as steplib

Pytree = Any


@dataclasses.dataclass
class Request:
    """One generation request bound to a tenant identity."""
    rid: int
    tenant: str
    prompt: np.ndarray           # (P,) int32 prompt token ids
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    """A finished request: the generated ids and the decode-step logits
    that produced them (`decode_logits[i]` -> `tokens[i]`, f32 CPU
    tensors)."""
    rid: int
    tenant: str
    prompt: np.ndarray
    tokens: List[int]
    decode_logits: List[torch.Tensor]
    prefill_steps: int
    decode_steps: int


class _Slot:
    """One batch slot: its own KV cache and the tenant's frozen tree."""
    __slots__ = ("req", "tree", "cache", "pos", "t", "tokens", "logits",
                 "last_token")

    def __init__(self):
        self.req: Optional[Request] = None
        self.tree = None
        self.cache = None
        self.pos = 0           # next cache write position
        self.t = 0             # tokens consumed so far (prompt + generated)
        self.tokens: List[int] = []
        self.logits: List[torch.Tensor] = []
        self.last_token = 0

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def prefilling(self) -> bool:
        # the step consuming the last prompt token emits the logits that
        # start generation, so it already counts as decode work
        return self.active and self.t < len(self.req.prompt) - 1

    def free(self):
        self.req = None
        self.tree = None
        self.cache = None
        self.tokens = []
        self.logits = []


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Freezer:
    """The freeze-cache's build function: one tenant's frozen tree, its
    build timed after a device synchronize.  It holds no reference to the
    engine (a bound method would make a cycle through the cache), so an
    engine's trees and caches are freed as soon as its caller drops it."""

    def __init__(self, mp: MaskedParams, scores: dict, device):
        self.mp, self.scores, self.device = mp, scores, device
        self.seconds, self.count = 0.0, 0

    def __call__(self, ident: MaskIdentity) -> Pytree:
        _sync(self.device)
        t0 = time.perf_counter()
        tree = masking.freeze_identity(self.mp, ident,
                                       scores=self.scores.get(ident))
        _sync(self.device)
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return tree


class ServeEngine:
    """Continuous-batching scheduler over one shared frozen `w`.

    api:            `repro_torch.models.ModelApi` of the served arch.
    mp:             the shared `MaskedParams` (one frozen weight copy, on
                    the serving device); every tenant is a mask identity
                    over it.
    slots:          concurrent batch slots (in-flight requests).
    cache_capacity: bound on resident frozen trees (exact LRU).
    max_seq:        per-slot KV-cache length (>= prompt + generated).
    lockstep:       False: per-slot `decode_step` calls (the bit-identity
                    contract); True: one vmapped step for all slots a
                    tick.
    """

    def __init__(self, api, mp: MaskedParams, *, slots: int = 4,
                 cache_capacity: int = 2, max_seq: int = 64,
                 lockstep: bool = False):
        if slots < 1:
            raise ValueError(f"need >= 1 slot, got {slots}")
        self.api = api
        self.mp = mp
        self.device = next(w for w in tu.leaves(mp.weights)
                           if w is not None).device
        self.max_seq = int(max_seq)
        self.lockstep = bool(lockstep)
        self._vstep = steplib.make_multi_serve_step(api) if lockstep \
            else None
        # lockstep state: the slots' trees and caches, slot-major stacks
        self._stacked_tree = None
        self._stacked_cache = None
        self._tenants: Dict[str, MaskIdentity] = {}
        self._scores: Dict[MaskIdentity, Pytree] = {}
        self._freezer = _Freezer(mp, self._scores, self.device)
        self.cache = FreezeCache(self._freezer, cache_capacity)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: collections.deque = collections.deque()
        self.completions: Dict[int, Completion] = {}
        self._next_rid = 0
        self._warm = False
        self.ticks = 0
        self.mixed_ticks = 0       # ticks with prefill and decode slots
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.max_occupancy = 0

    # -- tenants ------------------------------------------------------------

    def register_tenant(self, name: str,
                        ident: Optional[MaskIdentity] = None, *,
                        seed: Optional[int] = None,
                        mode: str = "threshold", tau: float = 0.5,
                        scores: Optional[Pytree] = None) -> MaskIdentity:
        """Bind `name` to a mask identity (built from `seed` when not
        given).  `scores` carries the tenant's own score tree over the
        shared `w`; distinct score trees need distinct identities
        (`MaskIdentity.tag`)."""
        if ident is None:
            if seed is None:
                raise ValueError("register_tenant needs ident= or seed=")
            ident = MaskIdentity(seed=int(seed), mode=mode, tau=tau,
                                 tag=name if scores is not None else "")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if scores is not None and ident in self._scores \
                and self._scores[ident] is not scores:
            raise ValueError(
                f"identity {ident} already bound to a different score "
                "tree; disambiguate with MaskIdentity.tag")
        self._tenants[name] = ident
        if scores is not None:
            self._scores[ident] = scores
        return ident

    # -- requests -----------------------------------------------------------

    def submit(self, tenant: str, prompt, max_new_tokens: int) -> int:
        """Queue one request; returns its id."""
        if tenant not in self._tenants:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {sorted(self._tenants)}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq ({self.max_seq})")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, tenant, prompt, int(max_new_tokens)))
        return rid

    # -- scheduling ---------------------------------------------------------

    def _token(self, tok: int) -> torch.Tensor:
        return torch.tensor([tok], dtype=torch.int64, device=self.device)

    def _admit(self, i: int, req: Request):
        slot = self.slots[i]
        slot.req = req
        slot.tree = self.cache.get(self._tenants[req.tenant])
        self.max_occupancy = max(self.max_occupancy, len(self.cache))
        slot.cache = self.api.init_cache(1, self.max_seq, self.device)
        slot.pos = 0
        slot.t = 0
        slot.tokens = []
        slot.logits = []
        slot.last_token = int(req.prompt[0])
        if self.lockstep:
            self._scatter_slot(i, slot)
        if not self._warm:
            # first-use costs (allocator, library handles) off the clock:
            # one throwaway step on a scratch cache
            if self.lockstep:
                B = len(self.slots)
                scratch = tu.tree_map(torch.clone, self._stacked_cache)
                self._vstep(self._stacked_tree, scratch,
                            torch.zeros((B, 1), dtype=torch.int64,
                                        device=self.device),
                            torch.zeros((B,), dtype=torch.int64,
                                        device=self.device))
            else:
                scratch = self.api.init_cache(1, self.max_seq, self.device)
                self.api.decode_step(slot.tree, scratch,
                                     self._token(slot.last_token), 0)
            _sync(self.device)
            self._warm = True

    def _scatter_slot(self, i: int, slot: _Slot):
        """Write the slot's frozen tree and fresh cache into row i of the
        slot-major stacks (lockstep mode); the first admission allocates
        the stacks, every row a copy of this slot's."""
        if self._stacked_tree is None:
            B = len(self.slots)
            stack = lambda a: a[None].expand(B, *a.shape).clone()
            self._stacked_tree = tu.tree_map(stack, slot.tree)
            self._stacked_cache = tu.tree_map(stack, slot.cache)
            return
        copy = lambda b, a: b[i].copy_(a)
        tu.tree_map(copy, self._stacked_tree, slot.tree)
        tu.tree_map(copy, self._stacked_cache, slot.cache)

    def step(self) -> bool:
        """One tick: admit queued requests into free slots, then advance
        every active slot by one token.  False when idle."""
        for i, slot in enumerate(self.slots):
            if not slot.active and self.queue:
                self._admit(i, self.queue.popleft())
        phases = [slot.prefilling for slot in self.slots if slot.active]
        if not phases:
            return False
        if any(phases) and not all(phases):
            self.mixed_ticks += 1
        if self.lockstep:
            self._tick_lockstep()
        else:
            for slot in self.slots:
                if slot.active:
                    self._advance_exact(slot)
        self.ticks += 1
        return True

    def run(self) -> Dict[int, Completion]:
        """Tick until queue and slots drain; completions by request id."""
        while self.step():
            pass
        return self.completions

    # -- exact (per-slot) execution -----------------------------------------

    def _advance_exact(self, slot: _Slot):
        tok = self._token(slot.last_token)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, slot.cache = self.api.decode_step(slot.tree, slot.cache, tok,
                                                  slot.pos)
        _sync(self.device)
        dt = time.perf_counter() - t0
        self._consume(slot, logits[0], dt)

    # -- lockstep (vmapped) execution ---------------------------------------

    def _tick_lockstep(self):
        """One vmapped step over every slot; an idle slot steps on token 0
        at position 0 of its stale row, which its next admission
        overwrites."""
        B = len(self.slots)
        toks = torch.zeros((B, 1), dtype=torch.int64)
        poss = torch.zeros((B,), dtype=torch.int64)
        for i, slot in enumerate(self.slots):
            if slot.active:
                toks[i, 0] = slot.last_token
                poss[i] = slot.pos
        toks, poss = toks.to(self.device), poss.to(self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, self._stacked_cache = self._vstep(
            self._stacked_tree, self._stacked_cache, toks, poss)
        _sync(self.device)
        dt = time.perf_counter() - t0
        rows = logits[:, 0].float().cpu()
        active = [i for i, slot in enumerate(self.slots) if slot.active]
        for i in active:
            self._consume(self.slots[i], rows[i], dt / len(active))

    def _consume(self, slot: _Slot, logits_row: torch.Tensor, dt: float):
        req = slot.req
        P = len(req.prompt)
        if slot.t < P - 1:
            # prefill: logits discarded, the next input is the next prompt
            # token
            self.prefill_s += dt
            self.prefill_tokens += 1
            slot.t += 1
            slot.pos += 1
            slot.last_token = int(req.prompt[slot.t])
            return
        # decode: these logits give the next generated token
        self.decode_s += dt
        self.decode_tokens += 1
        row = logits_row.float().cpu()
        nxt = int(torch.argmax(row))
        slot.logits.append(row)
        slot.tokens.append(nxt)
        slot.t += 1
        slot.pos += 1
        slot.last_token = nxt
        if len(slot.tokens) >= req.max_new_tokens:
            self.completions[req.rid] = Completion(
                rid=req.rid, tenant=req.tenant, prompt=req.prompt,
                tokens=slot.tokens, decode_logits=slot.logits,
                prefill_steps=P - 1, decode_steps=len(slot.tokens))
            slot.free()

    # -- accounting ---------------------------------------------------------

    def hbm_report(self) -> dict:
        """Resident device memory by the engine's accounting: one shared
        `w` plus one masked-leaf delta per resident frozen tree."""
        delta = masking.masked_delta_bytes(self.mp)
        occ = len(self.cache)
        return {
            "weight_bytes": delta,
            "delta_bytes_per_tree": delta,
            "resident_tree_count": occ,
            "resident_bytes": delta + occ * delta,
            "mask_artifact_bytes": masking.mask_artifact_bytes(self.mp),
            "tenants": len(self._tenants),
        }

    def stats(self) -> dict:
        out = {"ticks": self.ticks, "mixed_ticks": self.mixed_ticks,
               "prefill_s": self.prefill_s, "decode_s": self.decode_s,
               "prefill_tokens": self.prefill_tokens,
               "decode_tokens": self.decode_tokens,
               "prefill_tok_s": (self.prefill_tokens / self.prefill_s
                                 if self.prefill_s > 0 else 0.0),
               "decode_tok_s": (self.decode_tokens / self.decode_s
                                if self.decode_s > 0 else 0.0),
               "freeze_s": self._freezer.seconds,
               "freezes": self._freezer.count,
               "max_occupancy": self.max_occupancy}
        out.update(self.cache.stats())
        out.update(self.hbm_report())
        return out
