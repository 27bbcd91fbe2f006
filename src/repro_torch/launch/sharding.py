"""Sharding rules: tree path + shape -> PartitionSpec (the reference's
`repro.launch.sharding`, rule for rule).

Strategy:
  * weights/scores/optimizer state: last dim -> "model" (TP), the
    second-to-last -> "data" (FSDP-style).  Leading stack axes (layer /
    group / expert scan dims) are never sharded, except MoE expert axes,
    which go to "model" (EP) when the feature dims are too small to make
    TP worthwhile (deepseek-v2 experts: d_ff 1408/1536).
  * activations/batch: batch dim -> ("pod", "data"); long-context decode
    (batch 1) shards the KV-cache sequence dim instead (SP).
  * norms/scalars: replicated.

A dim is only sharded if divisible by the mesh axis size; otherwise the
next candidate dim is tried.

`NamedSharding(mesh, spec)` places a global tensor on a rank: `index`
is this rank's block of a global shape (JAX's `addressable_shards[i]
.index`), `local` cuts that block out.  The rules read only a mesh's
`.shape` (axis name -> size) and `.axis_names`, so they run on any
object that has them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as tu

Pytree = Any


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), an axis name, or a tuple of
    axis names (major to minor; a 1-tuple is stored as its name, as JAX
    stores it).  Dims past its length are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, (tuple, list)) and len(p) == 1 else
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _dim_axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, and the block of a global tensor it gives this
    rank (the mesh's `coords`)."""
    mesh: Any
    spec: PartitionSpec

    def _parts(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more dims than {ndim}")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def _splits(self, shape) -> list:
        out = []
        for d, part in zip(shape, self._parts(len(shape))):
            k = math.prod(self.mesh.shape[a] for a in _dim_axes(part))
            if d % k:
                raise ValueError(f"dim {d} does not split over {part} "
                                 f"({k} ranks) in spec {self.spec}")
            out.append(k)
        return out

    def global_shape(self, local_shape) -> tuple:
        return tuple(d * k for d, k in zip(
            local_shape, self._splits([0] * len(local_shape))))

    def index(self, shape) -> tuple:
        """This rank's block of a global `shape`, one slice a dim: over an
        axis tuple the block counts major to minor in tuple order."""
        out = []
        for d, k, part in zip(shape, self._splits(shape),
                              self._parts(len(shape))):
            b = 0
            for a in _dim_axes(part):
                b = b * self.mesh.shape[a] + self.mesh.coords[a]
            size = d // k
            out.append(slice(b * size, (b + 1) * size))
        return tuple(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor `x` (a view)."""
        return x[self.index(tuple(x.shape))]


@dataclasses.dataclass(frozen=True)
class SpecExplanation:
    """Why `param_spec` chose (or declined) a sharding for one leaf:
    `rule` names the decision branch, `skipped` every dim a branch tried
    to shard but could not (divisibility)."""
    path: str
    shape: tuple
    spec: PartitionSpec
    rule: str            # replicate-small | embed | moe-expert |
    #                      generic | scalar
    skipped: tuple


def explain_spec(path: str, shape, mesh, *,
                 scan_dims: int = 1) -> SpecExplanation:
    """`param_spec` with its decision trace (same spec)."""
    nd = len(shape)
    dmodel = _axis_size(mesh, "model")
    ddata = _axis_size(mesh, "data")
    spec = [None] * nd
    skipped: list = []

    def done(rule):
        return SpecExplanation(path, tuple(shape), P(*spec), rule,
                               tuple(skipped))

    def try_dim(dim, axis, size):
        if shape[dim] % size == 0:
            spec[dim] = axis
            return True
        skipped.append(f"dim {dim % nd - nd} ({shape[dim]}) % "
                       f"{axis} ({size}) != 0")
        return False

    if nd == 0:
        return done("scalar")
    lp = path.lower()
    # scalars / 1D / norms / small: replicate
    if nd <= scan_dims or all(s == 1 for s in shape):
        return done("replicate-small")

    # embeddings: (V, D) with no scan dim
    if "embed" in lp or "lm_head" in lp:
        try_dim(-2, "data", ddata)
        try_dim(-1, "model", dmodel)
        return done("embed")

    # MoE stacked experts: (..., E, d_in, d_out), expert axis -> model
    if ("w_up" in lp or "w_gate" in lp or "w_down" in lp) and \
            nd - scan_dims == 3:
        if try_dim(nd - 3, "model", dmodel):
            try_dim(-2, "data", ddata)
            return done("moe-expert")
        # expert axis indivisible: fall through to the generic rule

    # generic 2D body: last -> model, second-to-last -> data
    try_dim(-1, "model", dmodel)
    if nd - scan_dims >= 2:
        try_dim(-2, "data", ddata)
    # 1D body (biases): shard on model if large & divisible
    if nd - scan_dims == 1 and shape[-1] % dmodel == 0 \
            and shape[-1] >= 4 * dmodel:
        spec[-1] = "model"
    return done("generic")


def param_spec(path: str, shape, mesh, *, scan_dims: int = 1) -> P:
    """PartitionSpec for a parameter-like leaf; `scan_dims` leading
    stacked axes (layers/groups) are skipped."""
    return explain_spec(path, shape, mesh, scan_dims=scan_dims).spec


def tree_map_with_path(fn, tree) -> Pytree:
    """`fn(path, leaf)` over a tree's leaves (None included), with
    '/'-joined paths (the reference's `_path_str`)."""
    flat, tdef = tu.flatten(tree)
    paths = [p for p, _ in tu.flatten_with_paths(tree)]
    return tu.unflatten(tdef, [fn(p, x) for p, x in zip(paths, flat)])


def tree_param_shardings(tree: Pytree, mesh, scan_dims_fn=None,
                         tp_only: bool = False) -> Pytree:
    """NamedSharding tree for a parameter tree (tensors, meta or fake
    tensors: only shapes are read).  None leaves stay None.  tp_only=True
    drops the FSDP ("data") dims: the inference layout."""
    def one(p, leaf):
        if leaf is None:
            return None
        sd = scan_dims_fn(p, leaf) if scan_dims_fn else _default_scan_dims(p)
        sd = min(sd, max(len(leaf.shape) - 1, 0))
        ps = param_spec(p, leaf.shape, mesh, scan_dims=sd)
        if tp_only:
            ps = P(*[None if a == "data" else a for a in ps])
        return NamedSharding(mesh, ps)
    return tree_map_with_path(one, tree)


def _default_scan_dims(path: str) -> int:
    lp = path.lower()
    if "groups" in lp:          # hybrid: (n_groups, ...)
        return 1
    if "embed" in lp or "final_norm" in lp or "lm_head" in lp \
            or "pos_embed" in lp:
        return 0
    return 1                    # stacked layers


def batch_spec(mesh) -> P:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(axes)


def batch_shardings(batch_tree: Pytree, mesh) -> Pytree:
    """Batch dim -> the client axes where it divides them.  (The
    reference iterates over the spec's entry, which on a mesh with "data"
    alone is the name itself, and raises there; this counts the axes.)"""
    axes = _dim_axes(batch_spec(mesh)[0])

    def one(leaf):
        if leaf is None:
            return None
        nd = len(leaf.shape)
        if nd == 0:
            return NamedSharding(mesh, P())
        spec = [None] * nd
        if axes and leaf.shape[0] % math.prod(
                mesh.shape[a] for a in axes) == 0:
            spec[0] = axes
        return NamedSharding(mesh, P(*spec))
    return tu.tree_map(one, batch_tree)


def cache_shardings(cache_tree: Pytree, mesh, batch: int) -> Pytree:
    """KV caches: (L, B, S, heads, hd), batch -> client axes when
    divisible, else sequence -> "data" (SP for batch-1 long context);
    heads -> "model" when divisible, else seq -> model."""
    client = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    csize = int(np.prod([mesh.shape[a] for a in client])) if client else 1
    dmodel = _axis_size(mesh, "model")

    def one(path, leaf):
        if leaf is None:
            return None
        shape = leaf.shape
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2 and shape[1] % csize == 0 and csize > 1:
            spec[1] = client
            # heads or seq on model
            if nd >= 4 and shape[3] % dmodel == 0:
                spec[3] = "model"
            elif nd >= 3 and shape[2] % dmodel == 0:
                spec[2] = "model"
        elif nd >= 3:
            # batch too small: shard seq across data (+ model if needed)
            if shape[2] % (csize * dmodel) == 0 and csize > 1:
                spec[2] = client + ("model",)
            elif shape[2] % dmodel == 0:
                spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(one, cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
