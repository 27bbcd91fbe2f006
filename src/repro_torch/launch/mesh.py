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


def init_dry(world_size: int, rank: int = 0) -> None:
    """Start torch's stand-in process group for the dry run
    (`launch.dryrun`): the "fake" backend over a `FakeStore`, this
    process joining as `rank` of `world_size`.  Every collective on it
    returns at once and moves no data (an all-reduce leaves its buffer as
    it was, an all-gather's output holds no peer's rows), so a round on it
    shows one rank's shapes, bytes, collective sites and memory, never an
    exchange.  `FakeStore` lives in `torch.testing._internal`, whose
    interface torch does not promise; it is imported here only.  Start it
    once per process world size (`dist.destroy_process_group()` ends it);
    `init` ("cuda", "cpu") never gives way to it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


class Mesh:
    """A named grid of the process group's ranks.

    `shape` maps axis name -> size (the reference mesh's `.shape`),
    `ranks` is the rank grid, `coords` this rank's index on each axis and
    `device` its device (the caller's when given; else the current card
    under NCCL and the CPU under any other backend, so a dry run over
    the stand-in group names its card here).  A process group is made
    for each axis tuple a collective of the port uses ("pod": the
    round's exchange; the client axes: the mask means and the train
    step's loss; every axis: the round's bit total; "data" and "model":
    the partitioned train step's gathers and reductions,
    `launch.partition`), every rank making them in the same order at
    construction, as NCCL requires:
    `group(axes)` is the group of the ranks that share this rank's
    coordinates off those axes, its members ordered row-major over them
    (pod-major for ("pod", "data")).  The data subgroups come last:
    for each k dividing d_data with 1 < k < d_data, the groups of k
    consecutive "data" coordinates (`data_group(k)`, keyed "data/k":
    the routing groups of a MoE layer that cover whole data ranks,
    `partition.ExpertLayout.moe`)."""

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
                client_axes(self), axis_names] + [
                    (a,) for a in ("data", "model") if a in axis_names]
        self._groups = {}
        for axes in used:
            if axes and axes not in self._groups:
                self._groups[axes] = self._make_group(axes)
        d = self.shape.get("data", 1)
        for k in range(2, d):
            if d % k == 0:
                self._groups[(f"data/{k}",)] = self._make_subgroup(k)

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

    def _make_subgroup(self, k):
        """Every rank makes every group of k consecutive "data"
        coordinates, row by row of the "data" groups, and keeps its own."""
        i = self.axis_names.index("data")
        rest = [a for a in range(len(self.axis_names)) if a != i]
        rows = self.ranks.transpose(rest + [i]).reshape(-1, k)
        mine = None
        for row in rows:
            g = dist.new_group(row.tolist())
            if self.rank in row:
                mine = g
        return mine

    def data_group(self, k: int):
        """The process group of the k consecutive "data" coordinates
        (k divides d_data) among which this rank's lies, ordered by
        coordinate: the "data" group itself at k = d_data."""
        d = self.shape["data"]
        if k == d:
            return self.group("data")
        if d % k or k < 2:
            raise ValueError(f"no data subgroup of {k} on {d} data ranks")
        return self._groups[(f"data/{k}",)]

    def axis_size(self, axis: str) -> int:
        """The ranks a group key of `group_axes` names spans: a mesh axis's
        size, or k for the data subgroup "data/k"."""
        if axis.startswith("data/"):
            return int(axis.split("/")[1])
        return self.shape[axis]

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

    def group_axes(self, group) -> tuple:
        """The axis tuple a process group of this mesh spans: the inverse
        of `group` and `data_group` (None, the default group, spans every
        axis; a data subgroup of k ranks is ("data/k",))."""
        if group is None or group is dist.group.WORLD:
            return self.axis_names
        for axes, g in self._groups.items():
            if g is group:
                return axes
        raise ValueError("the process group is not one of this mesh's")

    def device_index(self) -> int:
        """The linear index of this rank's coordinates over every axis,
        row-major (the reference's per-shard `dev`)."""
        dev = 0
        for a in self.axis_names:
            dev = dev * self.shape[a] + self.coords[a]
        return dev


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """Small ("data", "model") mesh (tests)."""
    return Mesh((n_data, n_model), ("data", "model"))


def make_debug_pod_mesh(n_pod: int = 0, n_data: int = 0,
                        n_model: int = 0,
                        device: Optional[torch.device] = None) -> Mesh:
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
    return Mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                device=device)


def client_axes(mesh) -> tuple:
    """Mesh axes that carry federated clients (the uplink axes)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")
