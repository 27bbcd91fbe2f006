"""A small optax-style optimizer library (`repro.optim.optimizers`).

An Optimizer is a pair of plain functions on trees of tensors:

    init(params)                 -> state
    update(grads, state, params) -> (updates, state)

applied with `apply_updates`.  Every transform maps over the leaves of a
nested dict/list tree (`core.tree`) and passes None leaves through, so a
masked model's score tree (None at its float leaves) goes in as it is.
Scalars are computed in float32, as the reference computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import tree as tu

Pytree = Any
_F32 = torch.float32


def _map(f, *trees):
    return tu.tree_map(lambda *xs: None if xs[0] is None else f(*xs),
                       *trees)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Pytree]
    update: Callable[..., tuple]


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    """p + u, computed in the promoted dtype and cast back to p's."""
    return _map(lambda p, u: (p.to(torch.promote_types(p.dtype, u.dtype))
                              + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------


def sgd(lr: float) -> Optimizer:
    return Optimizer(
        init=lambda p: (),
        update=lambda g, s, p=None: (_map(lambda x: -lr * x, g), s))


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    def update(g, m, p=None):
        m = _map(lambda mi, gi: beta * mi + gi, m, g)
        if nesterov:
            upd = _map(lambda mi, gi: -lr * (beta * mi + gi), m, g)
        else:
            upd = _map(lambda mi: -lr * mi, m)
        return upd, m

    return Optimizer(lambda p: _map(torch.zeros_like, p), update)


class AdamState(NamedTuple):
    count: torch.Tensor   # 0-d int32 step count
    mu: Pytree
    nu: Pytree


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         ) -> Optimizer:
    def init(p):
        zeros = lambda x: torch.zeros_like(x, dtype=_F32)
        return AdamState(torch.zeros((), dtype=torch.int32),
                         _map(zeros, p), _map(zeros, p))

    def update(g, st, p=None):
        c = st.count + 1
        mu = _map(lambda m, gi: b1 * m + (1 - b1) * gi.float(), st.mu, g)
        nu = _map(lambda v, gi: b2 * v + (1 - b2) * torch.square(gi.float()),
                  st.nu, g)
        bc1 = 1 - _f32(b1) ** c.float()
        bc2 = 1 - _f32(b2) ** c.float()
        upd = _map(lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
                   mu, nu)
        return upd, AdamState(c, mu, nu)

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(g, st, p):
        upd, st = base.update(g, st, p)
        upd = _map(lambda u, pi: u - lr * weight_decay * pi.float(), upd, p)
        return upd, st

    return Optimizer(base.init, update)


# ---------------------------------------------------------------------------
# Gradient transforms and schedules
# ---------------------------------------------------------------------------


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def update(g, s, p=None):
        sq = sum(torch.sum(torch.square(x.float()))
                 for x in tu.leaves(g) if x is not None)
        scale = torch.clamp(max_norm / (torch.sqrt(_f32(sq)) + 1e-12),
                            max=1.0)
        return _map(lambda x: x.to(torch.promote_types(x.dtype, _F32))
                    * scale.to(x.device), g), s

    return Optimizer(lambda p: (), update)


def chain(*opts: Optimizer) -> Optimizer:
    def init(p):
        return tuple(o.init(p) for o in opts)

    def update(g, states, p=None):
        new_states = []
        for o, s in zip(opts, states):
            g, s = o.update(g, s, p)
            new_states.append(s)
        return g, tuple(new_states)

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step), max=total_steps) / total_steps
        return base_lr * (min_frac + (1 - min_frac)
                          * 0.5 * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                  min_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step):
        s = _f32(step)
        return torch.where(s < warmup, base_lr * (s + 1) / warmup,
                           cos(s - warmup))
    return fn


class SchedState(NamedTuple):
    count: torch.Tensor   # 0-d int32 step count
    inner: Any


def scale_by_schedule(opt_fn: Callable[[float], Optimizer],
                      schedule: Callable) -> Optimizer:
    """Wrap an lr -> Optimizer factory with a schedule on a step count."""
    unit = opt_fn(1.0)

    def init(p):
        return SchedState(torch.zeros((), dtype=torch.int32), unit.init(p))

    def update(g, st, p=None):
        upd, inner = unit.update(g, st.inner, p)
        lr = schedule(st.count)
        upd = _map(lambda u: u * lr.to(u.device), upd)
        return upd, SchedState(st.count + 1, inner)

    return Optimizer(init, update)
