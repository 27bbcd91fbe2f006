"""Elastic scaling: resume a federated run with another cohort count
(`repro.runtime.elastic`).

The paper's global state is only (theta, seed, float leaves), with no
per-client optimizer floats, so re-entry after a resize is simple: new
cohorts re-derive their local scores from theta (eq. 4).  This module
places restored host arrays on a device and re-plans the client ->
cohort assignment.  (The reference's mesh form of `reshard_server`
waits for the port's multi-device slice; here it places on one device.)
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as _ckpt
from repro_torch.core import tree as tu

Pytree = Any


def reshard_server(host_tree: Pytree, device) -> Pytree:
    """Place host arrays (numpy or CPU tensors; None kept) on `device`.
    Works for any source layout because the source is host-global."""
    def place(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = _ckpt._to_tensor(x, x.dtype.name == "bfloat16")
        return x.to(device)
    return tu.tree_map(place, host_tree)


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
