"""The partitioned train step: the twin of what GSPMD does to the
reference's train step when it is jitted with `in_shardings` =
(`steps.fed_state_shardings`, the batch's shardings), as its dry run
jits it, written out as collectives over the mesh's process groups.

A rank holds its block of every leaf (`elastic.reshard_server`): a
masked leaf's (K, N) layer blocks split by rows over "data" and by
columns over "model" where they divide (`sharding.param_spec`), a float
leaf's body likewise, the cohort axis on "pod".  Its batch is its block
too: its pod's cohorts, its "data" rows, the same rows on every "model"
rank.  The step is the global one, with the scheme applied where each
leaf is used, so no model code changes:

* A masked dense leaf (`BlockLayout.dense`, which
  `layers.masked_dense_apply` runs for a leaf that carries it), a layer
  block at a time: the block's w and s rows are all-gathered over "data"
  (the FSDP gather) into the rank's (K, N/d_model) column block, and
  kernel 1 runs on it at the leaf's stream offset moved by the block's
  first column c0, with n_logical = N, so the block draws the global
  leaf's masks bit for bit (the placed leaf carries the offset of its
  own block, r0 rows and c0 columns in, and n_logical = N).  Its output
  columns are all-gathered over "model", so every model rank holds the
  whole activation of its rows.
  Backward: the output gather's is a slice (what follows it is computed
  alike on every "model" rank); kernel 2's partial dx is all-reduced over
  "model"; kernel 3's ds of the column block is reduce-scattered over
  "data" back to the rank's rows and divided by the data size (a
  cohort's gradient is the mean of its data ranks').  A leaf whose K
  does not split over "data" is held whole on every data rank and its ds
  all-reduced there; one whose N does not split over "model" is computed
  whole on every model rank.
* A stacked (E, K, N) expert leaf (`ExpertLayout`, which
  `layers.moe_apply` hands a MoE layer's routed experts to).  The
  routing is the global step's: its unit, a routing group, is a
  microbatch chunk's tokens, or with `moe_block_dispatch` = G a block of
  T/G consecutive ones (where the chunk's global T splits so, into
  blocks of at least 8).  A group inside the rank's piece of the batch
  (below) is routed there, the piece's groups folded into one grouped
  launch a projection as `mesh=None` folds its blocks.  A group that
  covers k whole data ranks is routed on each of them over the k-rank
  data subgroup (`Mesh.data_group`; the "data" group itself where it is
  the cohort's whole batch): the router logits are all-gathered there
  in data-rank order (each data rank holds a contiguous run of the
  cohort's rows, so that is the global token order) and every rank of
  the subgroup routes all of them: the capacity, the queue positions,
  the keep mask, the gates and the aux loss of the group's tokens.
  Each rank scatters only its own tokens into the (E, cap, D) slots (a
  slot is filled by one token of the group, so the sum over the
  subgroup is exact), and the slots are reduce-scattered there along
  the slot axis (cap padded up to a multiple of k with zero rows, never
  combined).  Rank (data j, model i) runs kernels 5-6-7 on its slots
  and its experts, E/d_model of them from e0 = i*E/d_model on (the
  reference's `moe-expert` rule), their rows all-gathered over "data"
  at the global leaf's per-(layer, expert) offsets; an E that does not
  split over "model" falls to the generic rule, a column block of
  every expert, run as a dense block is (kernels 5-6 at the block's
  column offset, n_logical = N).  The experts' outputs are all-gathered
  over the subgroup (slots) and "model" (experts), and each rank
  combines its own tokens.  Backward: the slot gather's gradient is
  summed over the subgroup (what follows it differs per data rank), the
  expert gather's is sliced (the combine is computed alike on every
  "model" rank), the rank's partial dx over its experts is all-reduced
  over "model", and kernel 7's ds is reduce-scattered over "data" to
  the rank's rows and divided by the data size.  A group that neither
  lies inside one rank nor covers whole ranks does not run
  (`check_train`).
* A depthwise (W, C) conv leaf (`BlockLayout.conv`, which
  `layers.masked_conv1d_apply` runs for a leaf that carries a layout:
  mamba2's and recurrentgemma's `conv/w_conv`), a layer block at a time:
  its taps gathered over "data" where W splits there (the generic
  rule's rows; on the production meshes d_data = 16 leaves W = 4 whole),
  the rank's C/d_model channels from c0 on, the same scheme as a dense
  block's columns.  x (B, S, C), alike on every "model" rank, is sliced
  to the rank's channels; kernel 8 runs on them at the leaf's offset
  moved by c0 with n_logical = C; its f32 output channels are
  all-gathered over "model".  Backward: the output gather's is a slice;
  kernel 8's flipped dx of the channel block is all-gathered over
  "model" (a rank holds only its own channels' gradient, and what
  precedes the conv is computed alike on every "model" rank); kernel 9's
  ds goes back as a dense block's does (reduce-scattered over "data"
  where the taps split, else all-reduced there, divided by the data
  size).  A C that does not split over "model" is convolved whole on
  every model rank.
* A float leaf (`TrainPlan.gather_floats`: embedding tables, norm
  scales, biases) is gathered whole over its sharded axes before the
  forward.  Its gradient is sliced back to the block on "model" (not
  summed: that compute is replicated), summed over "data"
  (reduce-scattered where the block splits there, else all-reduced) and
  divided by the data size.

Microbatches (`StepConfig.microbatch` = M): the reference runs a
cohort's global batch of B rows as M chunks of B/M, chunk j's masks
drawn at stream tick step * M + j.  A data rank runs its B/d_data rows
as pieces of g = gcd(B/M, B/d_data) rows (`batch_pieces`), each inside
one chunk and drawn at that chunk's tick, every rank the same count of
pieces in lockstep, so every collective is issued alike on every rank;
each piece runs the forward and backward above, its gradients summed in
f32 over the pieces and divided by their count, a mean over the data
ranks' pieces: the global step's mean over the chunks.

Every collective is a public `torch.distributed` tensor collective over
a `Mesh.group`, inside an autograd Function, and none uses a float
atomic, so `analysis.comm_model.record_collectives` sees them all.  A
layer's gathered w and s are held by its kernel's autograd node until
that layer's backward has run (they are kept, not gathered again).
Collectives over an axis of size 1 still run (a copy), so one rank
runs the scheme as many do.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import masking
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers

# the families whose masked leaves are 2-D dense blocks (kernels 1-3),
# stacked (E, K, N) expert blocks (kernels 5-7) or depthwise (W, C) conv
# blocks (kernels 8-9)
FAMILIES = ("dense", "vlm", "encdec", "moe", "ssm", "hybrid")
_M32 = 0xFFFFFFFF


def check_train(api, cfg, data: int = 1, rows: int = 0,
                seq: int = 0) -> None:
    """Raise NotImplementedError for what the partitioned train step does
    not run: a family outside FAMILIES, and, given the mesh's data size
    and a cohort's global batch (`rows` rows of `seq` tokens), a MoE
    layer's routing group (a microbatch chunk, or its block under
    `moe_block_dispatch`) that neither lies inside one data rank's
    tokens nor covers whole data ranks."""
    if api.cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the partitioned train step runs the families {FAMILIES}; "
            f"{api.cfg.name} is {api.cfg.family!r}")
    if not (rows and api.cfg.n_experts):
        return
    M, G = cfg.microbatch, api.cfg.moe_block_dispatch
    T, R = rows // M * seq, rows // data * seq
    L = T // layers.dispatch_blocks(T, G)
    if R % L and L % R:
        raise NotImplementedError(
            f"microbatch {M} and moe_block_dispatch {G} make routing "
            f"groups of {L} tokens, which neither lie inside a data rank's "
            f"{R} tokens nor cover whole data ranks (rows {rows}, seq "
            f"{seq}, {data} data ranks): unaligned routing groups do not "
            f"run on a mesh")


def batch_pieces(rows: int, microbatch: int, data: int = 1,
                 coord: int = 0):
    """(g, chunks): a data rank's `rows` rows of a cohort's batch as
    pieces of g rows, and the microbatch chunk of each piece in turn.
    The cohort's rows * data rows run as `microbatch` chunks of B/M rows;
    g = gcd(B/M, rows), so a piece lies inside one chunk and one rank,
    and every rank runs rows // g pieces.  With data 1 (`mesh=None`) the
    pieces are the chunks."""
    B = rows * data
    if B % microbatch:
        raise ValueError(f"batch {B} does not split into {microbatch} "
                         f"microbatches")
    c = B // microbatch
    g = math.gcd(c, rows)
    return g, [(coord * rows + i * g) // c for i in range(rows // g)]


# ---------------------------------------------------------------------------
# collectives along a dim
# ---------------------------------------------------------------------------


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The blocks `t` of every rank of `group` joined along `dim` in
    group-rank order, contiguous: one `all_gather_into_tensor` along dim
    0 (the name both PyTorch releases the port runs on have), then the
    stack of blocks moved to `dim` (a copy unless `dim` is 0 or the group
    one rank)."""
    dim %= t.ndim
    k = dist.get_world_size(group)
    out = torch.empty((k * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*all_gather_into_tensor",
                                FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view((k,) + tuple(t.shape)).movedim(0, dim).flatten(
        dim, dim + 1).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of `t` over `group`, this rank keeping its block along
    `dim` (block j for group rank j): the blocks stacked along dim 0 (a
    copy unless `dim` is 0 or the group one rank), then one
    `reduce_scatter_tensor`."""
    dim %= t.ndim
    k = dist.get_world_size(group)
    src = t.unflatten(dim, (k, t.shape[dim] // k)).movedim(dim, 0)
    src = src.contiguous()
    out = torch.empty(tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*reduce_scatter_tensor",
                                FutureWarning)
        dist.reduce_scatter_tensor(out, src.flatten(0, 1), group=group)
    return out


# ---------------------------------------------------------------------------
# placements and their autograd Functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a rank's block of a leaf body becomes the tensor the global
    step uses: all-gathered along each (dim, axis) of `gathers` in turn.
    The gradient of that tensor comes back to the block (`reduce`)."""
    mesh: Any
    gathers: tuple

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        for dim, axis in self.gathers:
            t = all_gather(t, self.mesh.group(axis), dim)
        return t

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """The gathered tensor's gradient g, which every "model" rank holds
        alike and each "data" rank holds for its own rows of the batch:
        sliced to the block on "model" dims, summed over "data"
        (reduce-scattered on a "data" dim, else all-reduced) and divided by
        the data size; a fresh tensor."""
        mesh = self.mesh
        for dim, axis in self.gathers:
            if axis == "model":
                n = g.shape[dim] // mesh.shape["model"]
                g = g.narrow(dim, mesh.coords["model"] * n, n)
        data = [dim for dim, axis in self.gathers if axis == "data"]
        if data:
            g = reduce_scatter(g, mesh.group("data"), data[0])
        else:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=mesh.group("data"))
        return g.div_(mesh.shape["data"])


class _Gathered(torch.autograd.Function):
    """A block gathered by its `Placement`; backward: `Placement.reduce`."""

    @staticmethod
    def forward(ctx, t, placement):
        ctx.placement = placement
        out = placement.gather(t)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return ctx.placement.reduce(g), None


class _ToModel(torch.autograd.Function):
    """Forward: x as it is (every "model" rank holds it alike).  Backward:
    the partial gradients of the ranks' column blocks all-reduced over
    "model"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    """Forward: the ranks' output blocks along `dim` (columns, or a MoE
    layer's experts) all-gathered over "model".  Backward: this rank's
    block of the gradient (a slice: what follows is computed alike on
    every "model" rank)."""

    @staticmethod
    def forward(ctx, y, group, rank, dim):
        ctx.block = (dim, rank * y.shape[dim], y.shape[dim])
        return all_gather(y, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.block), None, None, None


class _ModelSlice(torch.autograd.Function):
    """Forward: this rank's block of x along `dim` (x alike on every
    "model" rank; a view).  Backward: the ranks' blocks of the gradient
    all-gathered over "model" (each holds only its own block's, and what
    precedes is computed alike on every "model" rank)."""

    @staticmethod
    def forward(ctx, x, group, rank, n, dim):
        ctx.group, ctx.dim = group, dim
        return x.narrow(dim, rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


class _GatherSum(torch.autograd.Function):
    """Forward: the ranks' blocks all-gathered over `group` along `dim`.
    Backward: the gradient summed over the group, this rank keeping its
    block (what follows the gather differs per rank)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    """Forward: the sum of the ranks' tensors over `group`, this rank
    keeping its block along `dim`.  Backward: the blocks' gradients
    all-gathered."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """A rank's placement of one masked dense or depthwise conv leaf: its
    layer blocks' rows (a conv's taps) gathered over "data" by `rows` (or
    held whole), its own columns (a conv's channels) the rank's N/d_model
    when `cols` (else all N)."""
    mesh: Any
    rows: Placement
    cols: bool

    def dense(self, x: torch.Tensor, p: MaskedLeaf) -> torch.Tensor:
        """y = x @ (m * w) of the global leaf's layer block on this rank's
        rows of the batch, every column, with the global masks: `p` is the
        rank's block as `TrainPlan.place` gives it (its w, s and the
        stream offset and row length that draw its own masks); the rows
        gathered over "data" start `r0` rows above it on the stream."""
        return self._product(x, p, False)

    def conv(self, x: torch.Tensor, p: MaskedLeaf) -> torch.Tensor:
        """The causal depthwise conv of the global (W, C) leaf's layer
        block on this rank's rows of the batch x (B, S, C), every
        channel, with the global masks, f32 (bias and cast stay with the
        caller): `p` is the rank's block as `TrainPlan.place` gives it,
        its taps gathered over "data", kernel 8 on its channels (module
        docstring)."""
        w = self.rows.gather(p.w)
        s = _Gathered.apply(p.s, self.rows)
        if self.cols:
            model, i = self.mesh.group("model"), self.mesh.coords["model"]
            x = _ModelSlice.apply(x, model, i, p.w.shape[-1], -1)
        if p.mode == "threshold":
            y = ops.masked_conv1d_threshold(x, w, s, p.tau)
        else:
            y = ops.masked_conv1d(x, w, s, int(p.seed),
                                  int(self._gathered_off(p)), p.n_logical)
        if self.cols:
            y = _FromModel.apply(y, model, i, -1)
        return y

    def _gathered_off(self, p: MaskedLeaf):
        """The stream offsets of the gathered rows: the block's, moved back
        by its first row r0 (its first column c0 stays in)."""
        r0 = (self.mesh.coords["data"] * p.w.shape[-2]
              if self.rows.gathers else 0)
        return (np.asarray(p.off, np.int64) - r0 * p.n_logical) & _M32

    def _product(self, x, p: MaskedLeaf, grouped: bool) -> torch.Tensor:
        w = self.rows.gather(p.w)
        s = _Gathered.apply(p.s, self.rows)
        if self.cols:
            model = self.mesh.group("model")
            x = _ToModel.apply(x, model)
        if p.mode == "threshold":
            y = (ops.masked_dense_grouped_threshold if grouped
                 else ops.masked_dense_threshold)(x, w, s, p.tau)
        else:
            off = self._gathered_off(p)
            y = (ops.masked_dense_grouped(x, w, s, p.seed, off, p.n_logical)
                 if grouped else
                 ops.masked_dense(x, w, s, int(p.seed), int(off),
                                  p.n_logical))
        if self.cols:
            y = _FromModel.apply(y, model, self.mesh.coords["model"], -1)
        return y


@dataclasses.dataclass(frozen=True)
class ExpertLayout(BlockLayout):
    """A rank's placement of one stacked (E, K, N) expert leaf: its layer
    blocks' rows gathered over "data" by `rows` (or held whole), and
    either the rank's own E/d_model experts (`experts`, the reference's
    `moe-expert` rule), or its N/d_model columns of every expert
    (`cols`: E does not split over "model"), or all of it."""
    experts: bool
    chunk_rows: int = 0        # rows of a microbatch chunk, global

    def grouped(self, x: torch.Tensor, p: MaskedLeaf) -> torch.Tensor:
        """y[e] = x[e] @ (m[e] * w[e]) of the rank's experts (x: (E_rank,
        slots, K)), every column, with the global masks."""
        return self._product(x, p, True)

    def moe(self, p: dict, x: torch.Tensor, n_experts: int, k: int,
            capacity_factor: float, block_dispatch: int = 0):
        """The routed experts of `layers.moe_apply` (a MoE layer's params
        `p`, its expert leaves placed, the float leaves gathered whole) on
        this rank's piece x (B, S, D) of a microbatch chunk of
        `chunk_rows` rows: (y (B, S, D), aux), the global step's
        semantics (module docstring).  The routing groups are the
        chunk's, or its blocks' where `block_dispatch` = G splits the
        chunk's global T tokens into blocks of at least 8; the piece holds
        whole groups, routed here, or one rank's share of a group that
        covers k whole data ranks, routed over their subgroup.

        aux is the mean of the piece's groups' aux terms (a group over k
        ranks: its own, added by each of them).  Over every piece of the
        step that is the global step's mean over the groups: each piece
        counts 1/P in the rank's mean and each rank 1/d_data in the
        cohort's, and a group over k ranks is added k times.  Its
        gradient reaches the router alike: the logits' gather over the
        subgroup sums the k copies of their gradient, and the router's
        float `Placement.reduce` divides by d_data, so the router gets the
        gradient of the mean loss plus the mean aux term, as in the
        global step.  A rank's tokens reach the other ranks' losses only
        through the aux term (a slot is combined into the one token that
        filled it), so the summed slot gradients give every rank the
        gradient of its own tokens."""
        mesh = self.mesh
        B, S, D = x.shape
        n, T = B * S, self.chunk_rows * S
        L = T // layers.dispatch_blocks(T, block_dispatch)
        if not self.chunk_rows or (n % L and L % n):
            raise NotImplementedError(
                f"a routing group of {L} tokens on a piece of {n}: neither "
                f"inside it nor spanning whole data ranks")
        groups, span = (n // L, 1) if n % L == 0 else (1, L // n)
        sub = mesh.data_group(span) if span > 1 else None
        xt = x.reshape(groups, n // groups, D)
        logits = xt.float() @ p["router_w"]
        if sub is not None:
            logits = _GatherSum.apply(logits, sub, 1)
        probs, gval, _, onehot, pos, keep, cap = layers.moe_route(
            logits, n_experts, k, capacity_factor)
        own = onehot
        if sub is not None:
            j = mesh.coords["data"] % span
            mine = slice(j * n, (j + 1) * n)
            own, pos, keep, gval = (onehot[:, mine], pos[:, mine],
                                    keep[:, mine], gval[:, mine])
        pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)
                  ).float() * keep[..., None]                 # (g, t, k, C)
        ne = n_experts // mesh.shape["model"] if self.experts else n_experts
        e0 = mesh.coords["model"] * ne if self.experts else 0
        if self.experts:
            model = mesh.group("model")
            xt = _ToModel.apply(xt, model)
        disp = torch.einsum("gtke,gtkc->gtec", own[..., e0:e0 + ne], pos_oh)
        xe = torch.einsum("gtec,gtd->egcd", disp, xt.float()).reshape(
            ne, groups * cap, D)
        if sub is not None:
            pad = -cap % span
            if pad:
                xe = torch.nn.functional.pad(xe, (0, 0, 0, pad))
            xe = _ScatterSum.apply(xe, sub, 1)       # (ne, slots / k, D)
        h = (torch.nn.functional.silu(p["w_gate"].layout.grouped(
            xe, p["w_gate"])) * p["w_up"].layout.grouped(xe, p["w_up"]))
        ye = p["w_down"].layout.grouped(h, p["w_down"])
        if sub is not None:
            ye = _GatherSum.apply(ye, sub, 1)
        if self.experts:
            ye = _FromModel.apply(ye, model, mesh.coords["model"], 0)
        ye = ye[:, :groups * cap].reshape(n_experts, groups, cap, D)
        comb = torch.einsum("gtke,gtkc,gtk->gtec", own, pos_oh, gval.float())
        y = torch.einsum("gtec,egcd->gtd", comb, ye.float())
        me = probs.mean(dim=-2)
        ce = onehot.sum(-2).mean(dim=-2)
        return (y.to(x.dtype).reshape(B, S, D),
                (n_experts * (me * ce).sum(-1)).mean())


# ---------------------------------------------------------------------------
# the plan of one step
# ---------------------------------------------------------------------------


def _parts(spec, ndim: int, what: str) -> list:
    """One mesh axis name or None a dim (an axis tuple is outside this
    scheme)."""
    parts = list(spec) + [None] * (ndim - len(spec))
    if any(p is not None and not isinstance(p, str) for p in parts):
        raise NotImplementedError(f"{what}: spec {spec} shards a dim over "
                                  f"several axes")
    return parts


class TrainPlan:
    """The partitioned train step's view of one rank's state: each masked
    leaf's `BlockLayout` (`ExpertLayout` for a stacked expert leaf), the
    stream offsets of the rank's layer blocks (of each of their experts)
    and the leaf's row length N, each float leaf's
    `Placement`, the global score count a cohort (the entropy proxy's n)
    and the rank's first global cohort.  Built from the rank's blocks and
    the state's shardings; raises NotImplementedError for a leaf this
    scheme does not place (a sharded stack axis)."""

    def __init__(self, mesh, state, state_sh):
        self.mesh = mesh
        self.layouts, self.n_scores = {}, 0
        for i, (s, sh, wsh) in enumerate(zip(
                tu.leaves(state["scores"]), tu.leaves(state_sh["scores"]),
                tu.leaves(state_sh["weights"]))):
            if s is None:
                continue
            g = sh.global_shape(tuple(s.shape))
            parts = _parts(sh.spec, len(g), f"scores leaf {i}")
            if parts[1:] != _parts(wsh.spec, len(g) - 1, f"weights leaf {i}"):
                raise NotImplementedError(
                    f"leaf {i}: scores {sh.spec} and weights {wsh.spec} are "
                    f"placed apart")
            # a stacked (C, L, E, K, N) expert leaf: a layer's (E, K, N)
            # block is one grouped launch, its E on "model" or whole; every
            # other leaf's layer block, a dense (K, N) or a conv's (W, C)
            # (mamba2's (C, L, W, C), recurrentgemma's (C, G, W, C)), is a
            # 2-D body
            body = 3 if len(g) == 5 else 2
            ep = body == 3 and parts[-3] == "model"
            if (any(parts[1:-body]) or parts[-2] not in (None, "data")
                    or parts[-1] not in (None, "model")
                    or (body == 3 and parts[-3] not in (None, "model"))
                    or (ep and parts[-1])):
                raise NotImplementedError(
                    f"leaf {i} of shape {g}: spec {sh.spec} is not a (K, N) "
                    f"block over (\"data\", \"model\") or an expert block "
                    f"with E on \"model\"")
            K, N = g[-2:]
            cols = parts[-1] == "model"
            # the rank's block starts at row r0, column c0 of each layer's
            # (of each of its experts')
            c0 = mesh.coords["model"] * s.shape[-1] if cols else 0
            r0 = mesh.coords["data"] * s.shape[-2] if parts[-2] else 0
            rows = Placement(mesh, ((body - 2, "data"),) if parts[-2] else ())
            off = masking.stream_offsets(g[1:-2], K, N)
            if ep:
                e0 = mesh.coords["model"] * s.shape[-3]
                off = off[..., e0:e0 + s.shape[-3]]
            off = ((off.astype(np.uint64) + np.uint64(r0 * N + c0))
                   & np.uint64(_M32))
            layout = (ExpertLayout(mesh, rows, cols, ep) if body == 3
                      else BlockLayout(mesh, rows, cols))
            self.layouts[i] = (layout, off.astype(np.uint32), N)
            self.n_scores += math.prod(g[1:])
        self.floats = []
        for i, (f, sh) in enumerate(zip(tu.leaves(state["floats"]),
                                        tu.leaves(state_sh["floats"]))):
            if f is None:
                self.floats.append(None)
                continue
            parts = _parts(sh.spec, f.ndim, f"floats leaf {i}")
            self.floats.append(Placement(mesh, tuple(
                (d - 1, a) for d, a in enumerate(parts) if d and a)))
        self.clients = mesh.group(meshlib.client_axes(mesh))
        self.n_clients = math.prod(mesh.shape[a]
                                   for a in meshlib.client_axes(mesh))

    def first_cohort(self, local: int) -> int:
        """The global index of this rank's first cohort (cohorts on
        "pod")."""
        return self.mesh.coords.get("pod", 0) * local

    def gather_floats(self, floats: Any) -> Any:
        """A cohort's float leaves (the rank's blocks) gathered whole,
        through autograd."""
        flat, tdef = tu.flatten(floats)
        return tu.unflatten(tdef, [
            None if f is None else _Gathered.apply(f, pl)
            for f, pl in zip(flat, self.floats)])

    def place(self, i: int, leaf: MaskedLeaf,
              chunk_rows: int = 0) -> MaskedLeaf:
        """Masked leaf `i` of a forward tree built on the rank's blocks,
        given this rank's layout and the offsets and row length at which
        its blocks draw the global leaf's masks (so `materialize_leaf` of
        it is the global leaf's block too); an expert leaf's layout also
        the rows of the microbatch chunk its piece of the batch lies in
        (the routing groups')."""
        layout, off, n = self.layouts[i]
        if isinstance(layout, ExpertLayout):
            layout = dataclasses.replace(layout, chunk_rows=chunk_rows)
        return dataclasses.replace(leaf, off=off, n_logical=n, layout=layout)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of every client rank's mean loss (all-reduced over the
        client axes): the global mean, alike on every rank."""
        loss = loss.clone()
        dist.all_reduce(loss, group=self.clients)
        return loss / self.n_clients
