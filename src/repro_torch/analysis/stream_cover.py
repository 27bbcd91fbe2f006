"""Mask-stream coverage checker, the "stream race detector" (the
reference's `repro.analysis.stream_cover`).

Given a federated state (real tensors or meta tensors: only shapes are
read), rebuild the hash-stream coordinates the fused forward uses
through the port's own builder (`masking.masked_forward_tree`, seeded by
`masking.mask_stream_seed`, so this checker cannot drift from the code
it guards), and prove:

  * per leaf -- every trailing-2D block samples ONE seed and the block
    `off` intervals tile ``[0, flat_size)`` with no gap and no overlap.
    A gap means the forward's masks are not the flat stream
    `sample_and_pack` packs for the uplink; an overlap means two blocks
    draw correlated masks;
  * globally -- no two (leaf, shard, cohort) streams share a seed.  Every
    stream starts at flat index 0, so two equal seeds always overlap.
    `mask_stream_seed` is a pure function, so the whole (shard, cohort)
    grid is enumerated without devices.

Owners are written as `jax.tree_util.keystr` writes a path (``['k'][0]``),
so the port's findings read as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis.report import Finding
from repro_torch.core import masking
from repro_torch.core import tree as tu


@dataclasses.dataclass(frozen=True)
class StreamInterval:
    """One trailing-2D block's slice of its owner's flat hash stream."""

    owner: str       # masked-leaf path
    seed: int        # uint32 stream id
    lo: int          # flat start index (the block's `off`)
    hi: int          # flat end index   (off + K*N)
    flat_size: int   # the owning leaf's total flat size


def keyed_leaves(tree, prefix: str = "") -> list:
    """[(keystr path, leaf)] in flatten order: ``['key']`` for a dict
    key, ``[i]`` for a sequence index, ``.field`` for a named tuple."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(type(tree), "_fields", None)
        return [kl for i, v in enumerate(tree) for kl in keyed_leaves(
            v, f"{prefix}.{fields[i]}" if fields else f"{prefix}[{i}]")]
    return [(prefix or "<root>", tree)]


def collect_intervals(tree, owner_prefix: str = "") -> list:
    """Every `MaskedLeaf`'s (seed, off, flat_size) intervals from a
    forward tree built by `masking.masked_forward_tree`.  Grouped
    (E, K, N) expert leaves and layer-stacked (L, K, N) leaves give one
    interval per trailing-2D block."""
    out = []
    for path, leaf in keyed_leaves(tree):
        if not isinstance(leaf, masking.MaskedLeaf):
            continue
        K, N = leaf.w.shape[-2:]
        blk = int(K) * int(N)
        seeds = np.asarray(leaf.seed, np.uint32).reshape(-1)
        offs = np.asarray(leaf.off, np.uint32).reshape(-1)
        flat_size = blk * seeds.size
        for sd, off in zip(seeds.tolist(), offs.tolist()):
            out.append(StreamInterval(owner_prefix + path, int(sd), int(off),
                                      int(off) + blk, flat_size))
    return out


def check_intervals(intervals: Sequence[StreamInterval]) -> list:
    """``stream-gap`` / ``stream-overlap`` findings over a set of
    intervals: each owner's tiling of ``[0, flat_size)`` and seed
    collisions across owners."""
    findings = []
    by_owner: dict = {}
    for iv in intervals:
        by_owner.setdefault(iv.owner, []).append(iv)
    for owner, ivs in sorted(by_owner.items()):
        if len({iv.seed for iv in ivs}) > 1:
            findings.append(Finding(
                "stream-gap", owner,
                f"blocks sample {len({iv.seed for iv in ivs})} distinct "
                "seeds — the leaf's flat uplink stream is not covered "
                "by one stream"))
            continue
        cur = 0
        for iv in sorted(ivs, key=lambda i: (i.lo, i.hi)):
            if iv.lo < cur:
                findings.append(Finding(
                    "stream-overlap", owner,
                    f"block [{iv.lo}, {iv.hi}) overlaps the already "
                    f"covered [0, {cur})"))
            elif iv.lo > cur:
                findings.append(Finding(
                    "stream-gap", owner,
                    f"hole [{cur}, {iv.lo}) before the block at "
                    f"{iv.lo}"))
            cur = max(cur, iv.hi)
        if cur != ivs[0].flat_size:
            findings.append(Finding(
                "stream-gap", owner,
                f"blocks cover [0, {cur}) of flat size "
                f"{ivs[0].flat_size}"))
    seed_owners: dict = {}
    for iv in intervals:
        seed_owners.setdefault(iv.seed, set()).add(iv.owner)
    for sd, owners in sorted(seed_owners.items()):
        if len(owners) > 1:
            who = " + ".join(sorted(owners)[:4])
            if len(owners) > 4:
                who += f" + {len(owners) - 4} more"
            findings.append(Finding(
                "stream-overlap", who,
                f"{len(owners)} streams share seed {sd:#010x} — "
                "correlated masks (all streams start at flat index 0)"))
    return findings


def _drop_cohort(tree):
    """One cohort's shapes, as meta tensors (nothing is read but shapes)."""
    return tu.tree_map(lambda t: None if t is None else torch.empty(
        tuple(t.shape[1:]), dtype=t.dtype, device="meta"), tree)


def state_stream_report(state, *, step=0, devs=(0,), cohorts=None,
                        run_seed=17, mask_mode: str = "sample",
                        tau: float = 0.5) -> dict:
    """The coverage gate over one federated state (from
    `launch.steps.init_fed_state`, real or on the meta device).

    Builds the forward tree once through `masked_forward_tree` (shard
    `devs[0]`, cohort `cohorts[0]`) and checks its tiling, then sweeps
    the whole (shard, cohort) grid through `mask_stream_seed` for seed
    collisions across distinct (leaf, shard, cohort) streams.

    Returns ``{"n_leaves", "n_intervals", "n_streams", "findings",
    "intervals"}``."""
    scores = state["scores"]
    C = next(int(t.shape[0]) for t in tu.leaves(scores) if t is not None)
    cohorts = [int(c) for c in (range(C) if cohorts is None else cohorts)]
    devs = [int(d) for d in devs]

    mp = masking.MaskedParams(state["weights"], _drop_cohort(scores),
                              _drop_cohort(state["floats"]))
    leaf_ids: list = []

    def seed_fn(i):
        leaf_ids.append(i)
        return masking.mask_stream_seed(step, devs[0], i, cohorts[0],
                                        run_seed=run_seed)

    tree = masking.masked_forward_tree(mp, seed_fn, mode=mask_mode, tau=tau)
    intervals = collect_intervals(tree)
    findings = check_intervals(intervals)

    # the whole (shard, cohort) grid: one seed matrix a leaf
    seeds_all = np.array(
        [[[masking.mask_stream_seed(step, d, i, c, run_seed=run_seed)
           for c in cohorts] for d in devs] for i in leaf_ids],
        dtype=np.uint32).reshape(len(leaf_ids), len(devs), len(cohorts))
    uniq, counts = np.unique(seeds_all.reshape(-1), return_counts=True)
    for sd in uniq[counts > 1].tolist():
        locs = np.argwhere(seeds_all == sd)
        who = ", ".join(
            f"leaf{leaf_ids[l]}/dev{devs[d]}/cohort{cohorts[c]}"
            for l, d, c in locs[:4].tolist())
        findings.append(Finding(
            "stream-overlap", who,
            f"{len(locs)} (leaf, shard, cohort) streams share seed "
            f"{sd:#010x}"))

    return {"n_leaves": len(leaf_ids),
            "n_intervals": len(intervals),
            "n_streams": int(seeds_all.size),
            "findings": findings,
            "intervals": intervals}


def _to_meta(tree):
    return tu.tree_map(lambda t: torch.empty(
        tuple(t.shape), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def meta_fed_state(cfg, C: int):
    """`(api, state)`: `init_fed_state` of the config with C cohorts on
    the meta device, the port's `jax.eval_shape`: the state is drawn
    under `FakeTensorMode` (nothing allocated) and each tensor becomes a
    meta tensor of its shape and type."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import steps as steplib
    from repro_torch.models import build_model

    api = build_model(cfg)
    with FakeTensorMode():
        state = steplib.init_fed_state(torch.Generator(), api,
                                       masking.MaskSpec(), C=C)
    return api, {k: _to_meta(v) for k, v in state.items()}


def meta_params(cfg):
    """The config's `init_params` tree on the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build_model

    api = build_model(cfg)
    with FakeTensorMode():
        params = api.init_params(torch.Generator())
    return _to_meta(params)


def arch_stream_report(arch: str, *, smoke: bool = True, C: int = 2,
                       devs=(0,), step=0, run_seed=17) -> dict:
    """`state_stream_report` for a registry config by name, its state on
    the meta device (`meta_fed_state`), so every arch is checked at full
    size without allocating."""
    from repro_torch.configs import get_config

    _, state = meta_fed_state(get_config(arch, smoke=smoke), C)
    return state_stream_report(state, step=step, devs=devs,
                               run_seed=run_seed)
