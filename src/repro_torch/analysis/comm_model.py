"""The static per-round communication model (the reference's
`repro.analysis.comm_model`).

The CommLedger meters what the codec says a round costs; nothing in that
number proves the collectives move the same amount.  This module closes
the gap from the wire's side: `record_collectives` records every
collective a round issues as a `CollectiveSite`, `classify_site` sorts
each against the state's per-shard shapes, and `round_comm_model` sums a
per-round wire cost: per collective, per mesh axis, per algorithm.

How the sites are recorded.  A `TorchDispatchMode` does see the c10d ops
(``c10d.allreduce_``, ``c10d._allgather_base_``) under gloo, but their
process group and reduce op arrive as TorchScript objects, and the
reduce op has no public way back to a `ReduceOp` in the PyTorch releases
the port runs on.  So `record_collectives` wraps every public tensor
collective of ``torch.distributed`` (`RECORDED`: the all-gathers,
all-reduces, reduce-scatters, all-to-alls, broadcast, reduce, gather,
scatter and the point-to-point calls) while it is open, on the CPU
(gloo) and on the card (NCCL) alike; the object collectives, which
pickle what they send, raise inside it (`UNRECORDABLE`).  A site's axes
come from the process group it ran on (`launch.mesh.Mesh.group_axes`);
its `prim` is the reference's primitive name where the reference has
one (``all_gather``, ``psum``, ``pmax``, ``pmin``, ``reduce_scatter``,
``all_to_all``, ``ppermute``), so the two packages' tables read alike.
A collective issued below the public functions (``distributed_c10d``
itself, a ``ProcessGroup`` method, the functional collectives) is not
wrapped: ``check=True`` counts the c10d ops the window dispatches with a
dispatch mode and raises on closing when one was not recorded.  The mode
sees every aten op, so a timed window leaves it off.

Two cost views a site:

  * accounting bits -- operand bits x the number of shards; for the
    packed word `all_gather`s this is the number the round meters under
    the bitpack codec (every shard's pooled word stream, counted once);
  * ring bytes -- what a ring implementation of the collective sends a
    device along its axis group (all_gather S*(A-1); psum 2*S*(A-1)/A;
    reduce_scatter / all_to_all S*(A-1)/A; ppermute S).

``bpp_wire`` = uplink accounting bits / (cohorts x global mask params):
the packed round's masks cross at 1 bit a parameter and cohort plus the
word padding (<= 32 bits a leaf, cohort and shard); the bf16 baseline at
16.

The port's words are int32 tensors holding uint32 bits, where the
reference keys its uplink on ``uint32``.  An integer 32-bit `all_gather`
is ``uplink`` only when its row length is ceil(n/32) for a mask leaf's
per-shard size n (`mask_word_rows`); an integer operand of a mask leaf's
size is ``mask-unpacked``.  So an int32 mask cannot pass for a word
stream and hide a 32x leak.

The aggregator tree's root hop has its static cost here too
(`tree_root_record_bits`, `tree_root_round_bits`): what one edge forwards
upstream a commit is one `runtime.agg_tree.PooledFoldRecord`: per weight
class the packed per-bit counts of every mask leaf plus a (size, version,
count) header, the pooled float, metric and entropy sums as a sidecar,
and a CRC32 header.  None of it depends on how many clients folded: the
O(params) root-traffic claim, which the tree engine's measured
`root_bits` meets exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.api.codecs import HEADER_BITS
from repro_torch.core import aggregation
from repro_torch.core import tree as tu

# every data-moving collective primitive of the reference's jaxprs, and
# the names of the torch collectives that have no primitive there
COLLECTIVE_PRIMS = frozenset({
    "all_gather", "all_gather_invariant",
    "psum", "psum_invariant", "psum2",
    "ppermute", "pbroadcast",
    "all_to_all", "reduce_scatter",
    "pmax", "pmin", "pgather",
    "all_reduce", "broadcast", "reduce", "gather", "scatter",
})


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One operand of one collective a round issued."""
    prim: str
    axes: tuple          # mesh axis names the collective runs over
    shape: tuple         # per-shard operand shape
    dtype: str           # "float32", "bfloat16", "int32", ...
    bits: int            # per-shard operand bits

    @property
    def elems(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def site_of(prim: str, axes, t: torch.Tensor) -> CollectiveSite:
    shape = tuple(int(d) for d in t.shape)
    return CollectiveSite(prim, tuple(axes), shape, dtype_name(t.dtype),
                          t.element_size() * 8 * int(math.prod(shape)))


_REDUCE_PRIMS = {"SUM": "psum", "MAX": "pmax", "MIN": "pmin"}


def _reduce_prim(op) -> str:
    for name, prim in _REDUCE_PRIMS.items():
        if op == getattr(dist.ReduceOp, name):
            return prim
    return "all_reduce"


# public torch.distributed collective -> (its prim, or None for the
# reduce op's; the argument holding what this rank sends, a tensor or a
# list of them).  gather's and scatter's operand is the one piece a rank
# sends or receives; recv's the tensor that arrives.
RECORDED = {
    "all_reduce": (None, "tensor"),
    "all_reduce_coalesced": (None, "tensors"),
    "all_gather_into_tensor": ("all_gather", "input_tensor"),
    "all_gather_single": ("all_gather", "input_tensor"),
    "all_gather": ("all_gather", "tensor"),
    "all_gather_coalesced": ("all_gather", "input_tensor_list"),
    "reduce_scatter_tensor": ("reduce_scatter", "input"),
    "reduce_scatter_single": ("reduce_scatter", "input"),
    "reduce_scatter": ("reduce_scatter", "input_list"),
    "all_to_all_single": ("all_to_all", "input"),
    "all_to_all": ("all_to_all", "input_tensor_list"),
    "broadcast": ("broadcast", "tensor"),
    "reduce": ("reduce", "tensor"),
    "gather": ("gather", "tensor"),
    "scatter": ("scatter", "tensor"),
    "send": ("ppermute", "tensor"),
    "isend": ("ppermute", "tensor"),
    "recv": ("ppermute", "tensor"),
    "irecv": ("ppermute", "tensor"),
    "batch_isend_irecv": ("ppermute", "p2p_op_list"),
}
# the object collectives pickle what they send: no operand to size
UNRECORDABLE = ("all_gather_object", "broadcast_object_list",
                "gather_object", "scatter_object_list", "send_object_list",
                "recv_object_list")
# c10d ops that move no payload
_NO_PAYLOAD_OPS = ("barrier", "monitored_barrier", "wait_tensor")


class _C10dOps(TorchDispatchMode):
    """Counts the collectives dispatched below torch.distributed."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func.namespace in ("c10d", "_c10d_functional",
                               "_c10d_functional_autograd")
                and not func.__name__.startswith(_NO_PAYLOAD_OPS)):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _wrap(name, fn, mesh, issue):
    prim, operand = RECORDED[name]
    sig = inspect.signature(fn)

    def call(*args, **kwargs):
        a = sig.bind(*args, **kwargs)
        a.apply_defaults()
        got = a.arguments[operand]
        if name == "batch_isend_irecv":     # one c10d op a P2POp
            new = [site_of(prim, mesh.group_axes(p.group), p.tensor)
                   for p in got]
            return issue(new, len(new), lambda: fn(*args, **kwargs))
        pr = prim or _reduce_prim(a.arguments["op"])
        axes = mesh.group_axes(a.arguments["group"])
        new = [site_of(pr, axes, t) for t in (
            got if isinstance(got, (list, tuple)) else [got])]
        return issue(new, 1, lambda: fn(*args, **kwargs))
    return call


def _refuse(name):
    def call(*args, **kwargs):
        raise RuntimeError(f"torch.distributed.{name} pickles what it "
                           f"sends: record_collectives cannot size it")
    return call


@contextlib.contextmanager
def record_collectives(mesh, run=None, *, check: bool = False):
    """Record every public tensor collective issued while open as
    `CollectiveSite`s, one an operand, appended to the list this yields;
    an object collective raises.  `run`, if given, is called as
    ``run(sites, call)`` with the call's new sites in place of ``call()``
    (a timer with CUDA events, say) and returns its result.  With
    `check`, closing raises when the window dispatched a collective that
    was not recorded."""
    sites: list = []
    issued = [0]

    def issue(new, n_ops, call):
        sites.extend(new)
        issued[0] += n_ops
        return call() if run is None else run(new, call)

    saved = {n: getattr(dist, n) for n in (*RECORDED, *UNRECORDABLE)
             if hasattr(dist, n)}
    for n, fn in saved.items():
        setattr(dist, n, _refuse(n) if n in UNRECORDABLE
                else _wrap(n, fn, mesh, issue))
    mode = _C10dOps() if check else contextlib.nullcontext()
    try:
        with mode:
            yield sites
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    if check and mode.n != issued[0]:
        raise RuntimeError(
            f"the window dispatched {mode.n} c10d collective op(s) but "
            f"recorded {issued[0]}: a collective issued below "
            f"torch.distributed's public functions went unrecorded")


# ---------------------------------------------------------------------------
# per-shard shape arithmetic (PartitionSpec -> local shapes)
# ---------------------------------------------------------------------------


def shard_shape(shape, spec, mesh) -> tuple:
    """Local (per-rank) shape of a global `shape` under `spec`."""
    out = list(int(s) for s in shape)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        k = 1
        for a in names:
            k *= int(mesh.shape[a])
        out[d] //= k
    return tuple(out)


def _leaves_with_specs(tree_shapes, tree_sh):
    return [(t, s.spec) for t, s in zip(tu.leaves(tree_shapes),
                                        tu.leaves(tree_sh))
            if t is not None and s is not None]


def float_shard_shapes(state_shapes, state_sh, mesh) -> frozenset:
    """Per-shard shapes of the float-sidecar leaves (cohort axis
    included): the only non-scalar float shapes allowed to cross a
    collective on the packed round (their mean over pods)."""
    return frozenset(shard_shape(t.shape, spec, mesh)
                     for t, spec in _leaves_with_specs(
                         state_shapes["floats"], state_sh["floats"]))


def _mask_bodies(state_shapes, state_sh, mesh) -> list:
    """(per-shard shape, one cohort's flat size) of every score leaf."""
    out = []
    for t, spec in _leaves_with_specs(state_shapes["scores"],
                                      state_sh["scores"]):
        sh = shard_shape(t.shape, spec, mesh)
        out.append((sh, int(math.prod(sh[1:])) if len(sh) > 1 else 1))
    return out


def mask_shard_sizes(state_shapes, state_sh, mesh) -> frozenset:
    """Per-shard flat mask-stream sizes (one cohort's, and all local
    cohorts' pooled) of every score leaf: the sizes an unpacked mask or
    raw score tree has if it crosses a collective."""
    sizes = set()
    for sh, body in _mask_bodies(state_shapes, state_sh, mesh):
        sizes.add(body)
        sizes.add(body * sh[0])
    return frozenset(sizes)


def mask_word_rows(state_shapes, state_sh, mesh) -> frozenset:
    """ceil(n/32) for each score leaf's per-shard, one-cohort size n: the
    row lengths of the packed word streams."""
    return frozenset(-(-body // 32) for _, body in
                     _mask_bodies(state_shapes, state_sh, mesh))


def mask_totals(state_shapes) -> tuple:
    """(cohorts, global mask params a cohort)."""
    C, n = 1, 0
    for s in tu.leaves(state_shapes["scores"]):
        if s is None:
            continue
        C = s.shape[0]
        n += int(math.prod(s.shape[1:]))
    return C, n


# ---------------------------------------------------------------------------
# the static cost model
# ---------------------------------------------------------------------------

def _ring_send_bytes(prim: str, S: float, A: int) -> float:
    """Bytes a ring implementation sends a device for a per-shard payload
    of S bytes over an axis group of size A."""
    if A <= 1:
        return 0.0
    if prim.startswith("all_gather"):
        return S * (A - 1)
    if prim.startswith("psum") or prim in ("pmax", "pmin", "all_reduce"):
        return 2.0 * S * (A - 1) / A
    if prim in ("reduce_scatter", "all_to_all"):
        return S * (A - 1) / A
    return float(S)


def _int32(dtype: str) -> bool:
    return dtype in ("int32", "uint32")


def classify_site(site: CollectiveSite, *, float_shapes=frozenset(),
                  mask_sizes=frozenset(), word_rows=frozenset()) -> str:
    """uplink | metric | sidecar | mask-unpacked | other."""
    if site.shape == ():
        return "metric"
    if (site.prim.startswith("all_gather") and _int32(site.dtype)
            and site.shape[-1] in word_rows):
        return "uplink"
    if site.dtype.startswith(("float", "bfloat")):
        if site.shape in float_shapes:
            return "sidecar"
        if site.elems in mask_sizes:
            return "mask-unpacked"   # the bf16 baseline's crossing
    elif site.elems in mask_sizes:
        return "mask-unpacked"       # an unpacked integer mask
    return "other"


def round_comm_model(sites: Sequence[CollectiveSite], state_shapes,
                     state_sh, mesh, scfg) -> dict:
    """Per-round cost table of one recorded round.

    ``uplink_bits`` counts every shard's uplink payload once (the
    accounting the round meters); for the unpacked baseline its bf16 mask
    all-reduces are the uplink.  The downlink is the round's analytic
    formula (theta's broadcast is not a collective: the state after the
    round carries it)."""
    fshapes = float_shard_shapes(state_shapes, state_sh, mesh)
    msizes = mask_shard_sizes(state_shapes, state_sh, mesh)
    rows_ = mask_word_rows(state_shapes, state_sh, mesh)
    n_dev = int(mesh.size)
    C, n_glob = mask_totals(state_shapes)

    rows, uplink_bits = [], 0
    per_axis: dict = {}
    per_kind: dict = {}
    for s in sites:
        A = 1
        for a in s.axes:
            if a in mesh.axis_names:
                A *= int(mesh.shape[a])
        role = classify_site(s, float_shapes=fshapes, mask_sizes=msizes,
                             word_rows=rows_)
        ring = _ring_send_bytes(s.prim, s.bits / 8.0, A)
        rows.append({
            "prim": s.prim, "axes": list(s.axes), "axis_size": A,
            "dtype": s.dtype, "shape": list(s.shape), "role": role,
            "payload_bits_per_shard": s.bits,
            "ring_send_bytes_per_device": round(ring, 1),
        })
        if role in ("uplink", "mask-unpacked"):
            uplink_bits += s.bits * n_dev
        ax = "x".join(s.axes) or "-"
        per_axis[ax] = per_axis.get(ax, 0.0) + ring * n_dev
        per_kind[s.prim] = per_kind.get(s.prim, 0.0) + ring * n_dev

    dl_bpp = float(scfg.downlink_bits) if scfg.downlink_bits else 32.0
    return {
        "mesh": {"shape": [int(mesh.shape[a]) for a in mesh.axis_names],
                 "axes": list(mesh.axis_names), "n_devices": n_dev},
        "cohorts": C,
        "mask_params": n_glob,
        "n_sites": len(rows),
        "sites": rows,
        "uplink_bits": int(uplink_bits),
        "bpp_wire": round(uplink_bits / float(C * n_glob), 4)
        if n_glob else 0.0,
        "downlink_bpp": dl_bpp,
        "downlink_bits": float(dl_bpp * n_glob * C),
        "ring_bytes_per_axis": {k: round(v, 1)
                                for k, v in sorted(per_axis.items())},
        "ring_bytes_per_prim": {k: round(v, 1)
                                for k, v in sorted(per_kind.items())},
    }


def arch_round_comm_model(arch: str, algo: str = "fedpm_reg", *, mesh,
                          C: Optional[int] = None, smoke: bool = True,
                          codec: str = "bitpack", packed: bool = True,
                          downlink_bits: int = 0, start=None) -> dict:
    """Cost model of one (arch, algorithm) cell: this rank places its
    block of the state (`start`, a `launch.mesh_round.global_state`
    pair, drawn here
    when not given), runs one round on `mesh` with its collectives
    recorded, and returns the `round_comm_model` dict plus the run's
    artifacts under "_run": (sites, state shapes, shardings, config,
    mesh, the round's metrics).  The round's collectives are checked
    complete (``record_collectives(check=True)``).  Every rank of the
    mesh must call it."""
    from repro_torch.launch import mesh_round, plans
    from repro_torch.launch import steps as steplib
    from repro_torch.runtime import elastic

    if algo not in plans.MASK_ALGOS:
        raise ValueError(f"algorithm {algo!r} has no mask round step "
                         f"(known: {sorted(plans.MASK_ALGOS)})")
    if C is None:
        C = max(steplib.n_cohorts(mesh), 1)
    api, host = start if start is not None else mesh_round.global_state(
        arch, C, smoke=smoke)
    sh = steplib.fed_state_shardings(host, mesh)
    scfg = steplib.StepConfig(packed_masks=packed,
                              downlink_bits=downlink_bits,
                              **plans.MASK_ALGOS[algo])
    fn = steplib.make_round_step(api, scfg, mesh=mesh, state_sh=sh,
                                 codec=codec)
    state = elastic.reshard_server(host, sh)
    with record_collectives(mesh, check=True) as sites:
        state, metrics = fn(state)
    del state
    model = round_comm_model(sites, host, sh, mesh, scfg)
    model.update(arch=arch, algo=algo, codec=codec, packed=packed)
    model["_run"] = (sites, host, sh, scfg, mesh,
                     {k: float(v) for k, v in metrics.items()})
    return model


# per weight class on the edge -> root wire: size (f32) + version + count
CLASS_HEADER_BITS = 96


def tree_root_record_bits(leaf_params: Sequence[int], *,
                          acc_bits: int = 16, n_classes: int = 1,
                          float_elems: int = 0,
                          n_metrics: int = 0) -> dict:
    """Wire cost of ONE edge's `PooledFoldRecord`.  `leaf_params` are the
    mask leaves' true parameter counts; each leaf's count accumulator
    covers the word-padded bit domain (32 * ceil(n/32) positions) at
    `acc_bits` a position (`aggregation.packed_count_bits`)."""
    wire = 0
    for n in leaf_params:
        padded = 32 * ((int(n) + 31) // 32)
        wire += aggregation.packed_count_bits(padded, acc_bits)
    wire = n_classes * (wire + CLASS_HEADER_BITS)
    sidecar = 32 * n_classes * (int(float_elems) + int(n_metrics) + 1)
    return {"wire_bits": int(wire), "sidecar_bits": int(sidecar),
            "header_bits": int(HEADER_BITS),
            "total_bits": int(wire + sidecar + HEADER_BITS)}


def tree_root_round_bits(leaf_params: Sequence[int], n_edges: int, *,
                         acc_bits: int = 16, n_classes: int = 1,
                         float_elems: int = 0,
                         n_metrics: int = 0) -> dict:
    """A commit's root traffic over the whole tree: one pooled record an
    edge, O(params) x n_edges, independent of the client count."""
    rec = tree_root_record_bits(leaf_params, acc_bits=acc_bits,
                                n_classes=n_classes,
                                float_elems=float_elems,
                                n_metrics=n_metrics)
    return {"n_edges": int(n_edges),
            "record_bits": rec,
            "root_bits": int(n_edges * (rec["wire_bits"]
                                        + rec["sidecar_bits"])),
            "root_header_bits": int(n_edges * rec["header_bits"]),
            "root_total_bits": int(n_edges * rec["total_bits"])}
