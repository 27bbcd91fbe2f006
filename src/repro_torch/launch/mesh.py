"""Device meshes over a `torch.distributed` process group (the
reference's `repro.launch.mesh`).

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model").

Federated mapping: client cohorts ride ("pod", "data"); tensor/expert
parallel rides "model".  A rank is one process on one device (a card
under NCCL, the CPU under gloo); its coordinates are the row-major
unravel of its rank over the mesh shape, the order `jax.make_mesh`
gives its devices.  Meshes are built by functions, after `init` has
started the process group, so importing this module touches no device.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init(device: str = "cuda", *, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None,
         timeout: Optional[timedelta] = None) -> torch.device:
    """Start the process group and return this rank's device.

    With no store the group starts from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); otherwise from the
    store given (a `torch.distributed.FileStore`, say), with `rank` and
    `world_size`.  "cuda" runs NCCL with this rank on card LOCAL_RANK
    (else its rank: one host); "cpu" runs gloo.  No backend gives way to
    another: "cuda" without a card or without NCCL raises."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh.init('cuda'): no CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("mesh.init('cuda'): this PyTorch has no NCCL")
        backend = "nccl"
    elif device == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("mesh.init('cpu'): this PyTorch has no gloo")
        backend = "gloo"
    else:
        raise ValueError(f"mesh.init: device must be 'cuda' or 'cpu', "
                         f"got {device!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dev = torch.device("cpu")
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    kw = {} if timeout is None else {"timeout": timeout}
    if store is not None:
        kw["store"] = store
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return dev


class Mesh:
    """A named grid of the process group's ranks.

    `shape` maps axis name -> size (the reference mesh's `.shape`),
    `ranks` is the rank grid, `coords` this rank's index on each axis and
    `device` its device.  A process group is made for each axis tuple a
    collective of the port uses ("pod": the round's exchange; the client
    axes: the mask means; every axis: the round's bit total), every rank
    making them in the same order at construction, as NCCL requires:
    `group(axes)` is the group of the ranks that share this rank's
    coordinates off those axes, its members ordered row-major over them
    (pod-major for ("pod", "data"))."""

    def __init__(self, shape, axis_names,
                 device: Optional[torch.device] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} holds "
                             f"{math.prod(shape)} ranks, the process group "
                             f"{world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = world
        self.rank = dist.get_rank()
        self.ranks = np.arange(world).reshape(shape)
        self.coords = {a: int(i) for a, i in zip(
            axis_names, np.unravel_index(self.rank, shape))}
        self.backend = dist.get_backend()
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if self.backend == "nccl" else torch.device("cpu"))
        self.device = device
        used = [("pod",) if "pod" in axis_names else (),
                client_axes(self), axis_names]
        self._groups = {}
        for axes in used:
            if axes and axes not in self._groups:
                self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes):
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        rows = self.ranks.transpose(rest + keep).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        mine = None
        for row in rows:
            g = dist.new_group(row.tolist())
            if self.rank in row:
                mine = g
        return mine

    def _axes(self, axis_names) -> tuple:
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axis_names):
        """The process group over `axis_names` (a name or a tuple)."""
        axes = self._axes(axis_names)
        if axes not in self._groups:
            raise ValueError(f"no process group over {axis_names} on the "
                             f"mesh {self.axis_names}: it has "
                             f"{sorted(self._groups)}")
        return self._groups[axes]

    def device_index(self) -> int:
        """The linear index of this rank's coordinates over every axis,
        row-major (the reference's per-shard `dev`)."""
        dev = 0
        for a in self.axis_names:
            dev = dev * self.shape[a] + self.coords[a]
        return dev


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """Small ("data", "model") mesh (tests)."""
    return Mesh((n_data, n_model), ("data", "model"))


def make_debug_pod_mesh(n_pod: int = 0, n_data: int = 0,
                        n_model: int = 0) -> Mesh:
    """Smallest mesh with all three production axes (the pod axis is what
    gives the round step its cross-cohort collectives).  With no
    arguments, the largest of (2,2,2) / (2,2,1) / (2,1,1) / (1,1,1) that
    the world size holds, as the reference picks from its device count;
    the mesh must then hold every rank (`Mesh` raises otherwise)."""
    if not (n_pod and n_data and n_model):
        n = dist.get_world_size()
        n_pod, n_data, n_model = ((2, 2, 2) if n >= 8 else
                                  (2, 2, 1) if n >= 4 else
                                  (2, 1, 1) if n >= 2 else (1, 1, 1))
    return Mesh((n_pod, n_data, n_model), ("pod", "data", "model"))


def client_axes(mesh) -> tuple:
    """Mesh axes that carry federated clients (the uplink axes)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")
