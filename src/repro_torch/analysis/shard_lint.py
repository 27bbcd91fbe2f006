"""Declared-vs-held sharding lint for the launch layer (the reference's
`repro.analysis.shard_lint`).

Two checks:

  * silent replication -- `launch/sharding.py`'s rules shard a dim only
    when the mesh axis size divides it; when nothing divides, the leaf
    silently replicates and every rank stores (and, with optimizer
    state, updates) the whole tensor.  `explain_spec` records each
    skipped dim; this engine flags leaves whose spec came out fully
    replicated WITH at least one recorded skip and a body big enough to
    matter (norms and scalars, replicated by policy, record no skip).
    Rule ``shard-silent-replication``.

  * declared vs held -- the reference compares the declared
    NamedShardings with the compiled executable's input shardings.  The
    port has no compiler; its twin compares what is declared with what a
    rank holds: after `elastic.reshard_server` places the state, each
    rank's tensor of every state leaf must have exactly the shape and the
    contents of the block `NamedSharding.index` names.  A mismatch means
    a rank trains on another block than the round's collectives assume.
    Rule ``shard-spec-mismatch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core import tree as tu
from repro_torch.launch import sharding as shd

# replicated bodies smaller than this are noise, not a capacity problem
_MIN_ELEMS = 1024


@dataclasses.dataclass(frozen=True)
class AxisSizes:
    """A mesh's axis sizes with no process group behind them, seen from
    the rank at its origin: all the sharding rules read (the production
    mesh (2, 16, 16), say)."""
    shape: dict
    axis_names: tuple
    coords: dict

    @classmethod
    def of(cls, shape, axis_names):
        return cls(dict(zip(axis_names, shape)), tuple(axis_names),
                   dict.fromkeys(axis_names, 0))


def silent_replication_report(tree_shapes, mesh, *, scan_dims_fn=None,
                              min_elems: int = _MIN_ELEMS,
                              label: str = "") -> dict:
    """Explain every leaf's spec; flag big fully-replicated leaves whose
    replication came from divisibility skips, not policy."""
    findings, explanations = [], []

    def one(p, leaf):
        if leaf is None:
            return
        sd = (scan_dims_fn(p, leaf) if scan_dims_fn
              else shd._default_scan_dims(p))
        sd = min(sd, max(len(leaf.shape) - 1, 0))
        ex = shd.explain_spec(p, tuple(leaf.shape), mesh, scan_dims=sd)
        explanations.append(ex)
        body = tuple(leaf.shape)[sd:]
        if (ex.skipped and all(e is None for e in tuple(ex.spec))
                and int(math.prod(body)) >= min_elems):
            findings.append(Finding(
                "shard-silent-replication", f"{label}{p}",
                f"{list(leaf.shape)} fully replicated by fallback: "
                + "; ".join(ex.skipped)))

    shd.tree_map_with_path(one, tree_shapes)
    return {"findings": findings, "explanations": explanations}


def _flat_positions(n: int, k: int) -> torch.Tensor:
    """k flat positions spread over [0, n), first and last included (in
    integers: a float grid rounds past n - 1 at a billion elements)."""
    return torch.unique(torch.arange(k, dtype=torch.int64) * (n - 1)
                        // max(k - 1, 1))


def placement_mismatches(held, declared, host, label: str = "",
                         positions: Optional[int] = None) -> list:
    """Each held tensor against the block of the host-global tensor its
    declared `NamedSharding` names: the same shape, type and contents.
    `positions` compares the contents at that many flat positions spread
    over the block (first and last included) instead of all of them,
    for states too large to copy back whole."""
    out = []
    for (p, x), sh, g in zip(tu.flatten_with_paths(held),
                             tu.leaves(declared), tu.leaves(host)):
        if not isinstance(x, torch.Tensor):
            continue
        want = sh.local(torch.as_tensor(g))
        if tuple(x.shape) != tuple(want.shape) or x.dtype != want.dtype:
            out.append(Finding(
                "shard-spec-mismatch", f"{label}{p}",
                f"declared {sh.spec} names a {tuple(want.shape)} "
                f"{want.dtype} block but the rank holds "
                f"{tuple(x.shape)} {x.dtype}"))
            continue
        if positions is None:
            same = torch.equal(x.cpu(), want)
        else:
            idx = _flat_positions(x.numel(), positions)
            got = x.reshape(-1)[idx.to(x.device)].cpu()
            same = torch.equal(got, want.reshape(-1)[idx])
        if not same:
            out.append(Finding(
                "shard-spec-mismatch", f"{label}{p}",
                f"the rank's {tuple(x.shape)} tensor is not the block "
                f"{[(s.start, s.stop) for s in sh.index(tuple(g.shape))]} "
                f"that {sh.spec} names"))
    return out


def round_shard_report(mesh, C: int, *, start, positions=None) -> dict:
    """Both checks over one round cell on this rank: silent replication
    across the state's frozen weights, and declared vs held after
    `elastic.reshard_server` places this rank's block of `start` (an
    `(api, host state)` pair, `launch.mesh_round.global_state`)."""
    from repro_torch.launch import steps as steplib
    from repro_torch.runtime import elastic

    _, host = start
    sh = steplib.fed_state_shardings(host, mesh)
    rep = silent_replication_report(host["weights"], mesh,
                                    label="weights/")
    placed = elastic.reshard_server(host, sh)
    mism = []
    for key in sorted(k for k in sh if k != "step"):
        mism += placement_mismatches(placed[key], sh[key], host[key],
                                     label=f"state/{key}/",
                                     positions=positions)
    return {"findings": rep["findings"] + mism,
            "explanations": rep["explanations"],
            "n_leaves": len(rep["explanations"])}


def arch_shard_report(arch: str, *, mesh, smoke: bool = True,
                      C: Optional[int] = None,
                      place_state: bool = False) -> dict:
    """Silent replication over an arch's parameter tree (its shapes on
    the meta device; `mesh` may be `AxisSizes`) and, with `place_state`,
    the round cell's declared-vs-held check on this rank of `mesh`."""
    from repro_torch.analysis import stream_cover
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh_round
    from repro_torch.launch import steps as steplib

    if place_state:
        if C is None:
            C = max(steplib.n_cohorts(mesh), 1)
        return round_shard_report(
            mesh, C, start=mesh_round.global_state(arch, C, smoke=smoke))
    params = stream_cover.meta_params(get_config(arch, smoke=smoke))
    return silent_replication_report(params, mesh, label=f"{arch}/")
