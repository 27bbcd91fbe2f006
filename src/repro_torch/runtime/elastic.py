"""Elastic scaling: resume a federated run with another cohort count
(`repro.runtime.elastic`).

The paper's global state is only (theta, seed, float leaves), with no
per-client optimizer floats, so re-entry after a resize is simple: new
cohorts re-derive their local scores from theta (eq. 4).  This module
places restored host arrays on one device, or as each rank's block on a
mesh (`launch.sharding.NamedSharding`), and re-plans the client ->
cohort assignment.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as _ckpt
from repro_torch.core import tree as tu

Pytree = Any


def reshard_server(host_tree: Pytree, target) -> Pytree:
    """Place host-global arrays (numpy or tensors; None kept) on a device,
    or as this rank's blocks on a mesh.  Works for any source layout
    because the source is global.

    `target` a device: every array placed there whole.  `target` a tree of
    `launch.sharding.NamedSharding` matching `host_tree` (the state's
    `steps.fed_state_shardings`): each array's block for this rank, on
    the mesh's device, as `jax.device_put` places a shard.  What is no
    array (the int step) is kept.  Either way each array lands in memory
    of its own, contiguous, so a source that is a broadcast view (one
    cohort's tensor expanded over the cohort axis) is materialized only
    as far as the block placed, and the source is never written."""
    def fresh(x, device):
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
        if x.ndim and x.shape[0] > 1 and x.stride(0) == 0:
            # a broadcast over the leading axis crosses once
            return out.copy_(x[:1].to(device).expand(x.shape))
        return out.copy_(x)

    def place(x, sh):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        if isinstance(x, np.ndarray):
            x = _ckpt._to_tensor(x, x.dtype.name == "bfloat16")
        if isinstance(target, (str, torch.device)):
            return fresh(x, target)
        return fresh(sh.local(x), sh.mesh.device)

    if isinstance(target, (str, torch.device)):
        return tu.tree_map(lambda x: place(x, None), host_tree)
    return tu.tree_map(place, host_tree, target)


def cohort_plan(n_clients: int, n_slices: int) -> list[np.ndarray]:
    """Assign K logical clients to cohorts.  On resize (n_slices changes)
    the plan is recomputed; no state migrates because clients are
    stateless between rounds."""
    return [np.arange(i, n_clients, n_slices) for i in range(n_slices)]


def _fit_cohort(arr, like) -> torch.Tensor:
    """Fit a checkpointed (C_old, ...) leaf onto a (C_new, ...) slot: the
    mean over the old cohort axis (in f32), broadcast to the new one, in
    the leaf's dtype.  Valid because theta and float leaves are
    cohort-replicated right after a round commit, and mid-round
    divergence is what the next round's mean would fold anyway."""
    arr = torch.as_tensor(arr)
    like_shape = tuple(like.shape)
    if tuple(arr.shape) == like_shape:
        return arr
    if arr.ndim >= 1 and tuple(arr.shape[1:]) == like_shape[1:]:
        m = arr.float().mean(dim=0, keepdim=True)
        return m.expand(like_shape).to(arr.dtype).contiguous()
    raise ValueError(
        f"cannot fit checkpoint leaf {tuple(arr.shape)} onto {like_shape}")


def restore_theta_only(ckpt_dir: str, state_like: Pytree,
                       step: Optional[int] = None) -> tuple[Pytree, int]:
    """Partial restore when the full structure no longer matches (cohort
    resize, optimizer switch, algorithm variant): carry over only the
    learned signal and rebuild the rest from `state_like`:

      * scores / floats  <- the checkpoint, cohort axis refit by
                            `_fit_cohort`, on the template leaf's device
      * opt_m / opt_v    <- zeros (the optimizer restarts cleanly)
      * weights          <- kept from `state_like` (seed-regenerated,
                            identical across restarts by construction)
      * step             <- the checkpoint manifest's step

    Returns (state, step) like `ckpt.restore_checkpoint`."""
    raw, manifest = _ckpt.load_raw(ckpt_dir, step)
    items = _ckpt._path_items(state_like)
    leaves = []
    for key, leaf in items:
        if leaf is None:
            leaves.append(None)
            continue
        top = key.split("/", 1)[0]
        if top in ("scores", "floats") and raw.get(key) is not None:
            leaves.append(_fit_cohort(raw[key], leaf).to(leaf.device))
        elif top in ("opt_m", "opt_v"):
            leaves.append(torch.zeros_like(leaf))
        elif key == "step":
            leaves.append(
                torch.tensor(int(manifest["step"]), dtype=leaf.dtype,
                             device=leaf.device)
                if isinstance(leaf, torch.Tensor) else int(manifest["step"]))
        else:
            leaves.append(leaf)
    _, treedef = tu.flatten(state_like)
    return tu.unflatten(treedef, leaves), int(manifest["step"])


def scale_event_log():
    """A resize-event recorder: (record(step, old, new, reason) -> the
    event list, the list)."""
    events = []

    def record(step: int, old: int, new: int, reason: str = ""):
        events.append({"step": int(step), "from": int(old),
                       "to": int(new), "reason": reason})
        return events
    return record, events
