"""Multi-pod dry run (the reference's `repro.launch.dryrun`): every
(arch x shape x production mesh) cell, seen from rank 0 of the
(16, 16) or (2, 16, 16) mesh.

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --mesh multi [--device cpu] [--unpacked] \\
        [--step train] [--patch '{"microbatch": 2}' ...]

The reference forces 512 host devices, lowers each cell's jitted step
under its shardings and reads the compiled program.  torch has no
compiler to ask; this module joins torch's stand-in process group
(`launch.mesh.init_dry`: the "fake" backend, whose collectives return at
once and move no data) as rank 0 of the mesh's world and reads rank 0's
side of each cell instead:

* train shapes: the state on the meta device (`stream_cover.
  meta_fed_state`), the mask-stream gate over every shard and cohort,
  the state's shardings; the train step's flops under
  `torch.utils.flop_counter.FlopCounterMode` on meta tensors at the
  global shapes (the kernels state theirs, `kernels.dispatch`), and the
  argument bytes of rank 0's block of state and batch.  For the
  families the partitioned step runs (`partition.FAMILIES`: every
  family's, the moe family's expert leaves with E on "model", the ssm
  and hybrid families' conv leaves with C on "model") the step runs
  partitioned (`steps.make_train_step(api, cfg, mesh, state_sh)`) on
  rank 0's block as meta tensors at the local shapes, its collectives
  recorded (microbatched and block-dispatched steps too, `--patch`:
  a data rank's rows as pieces of the global chunks, a MoE layer's
  routing groups over data subgroups or on the rank): the cell reports
  rank 0's flops, kernel work and collective bytes (by kind, and by
  kind and mesh axes;
  its calls by kind, axes, type and operand size), the global step's
  beside them under "global_step"; then the round
  step run once on rank 0's block of the state, drawn on `device` alone
  (the global state of deepseek-v2-236b is 4.2 TB), with its
  collectives recorded: wire purity, the static comm model, the
  collectives' operand bytes, argument bytes, the peak memory above
  them on a card, and declared-vs-held placement;
* prefill and decode shapes: argument bytes of rank 0's blocks of
  params and batch or cache, and the flops of `api.forward` or
  `steps.make_serve_step` on meta.

Only shapes, bytes, sites, memory and launch counts are read: under the
stand-in group an all-reduce leaves its buffer as it was and an
all-gather brings no peer's rows, so theta and the scores after the
round mean nothing.  Every result carries ``"peers": "fake"``.  Fields
with no twin here are None: `generated_code_size`, and the collective
bytes of the steps the port runs unpartitioned: prefill and decode.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import collective_lint, comm_model, shard_lint
from repro_torch.analysis import stream_cover
from repro_torch.configs import ARCH_NAMES, LONG_CONTEXT_OK, SHAPES
from repro_torch.configs import get_config
from repro_torch.core import tree as tu
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import partition
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model

P = shd.P
MESHES = {False: "pod16x16", True: "pod2x16x16"}
N_VIS = 256                   # vision rows of a VLM sequence (reference)
# state values of the round cell's block: scores at logit(0.5), the
# init's centre (every mask bit a fair coin of the hash stream), floats
# at 1, weights at 1 (the round never reads them), moments at 0
BLOCK_VALUES = {"scores": 0.0, "floats": 1.0, "weights": 1.0, "opt_m": 0.0,
                "opt_v": 0.0}
PLACEMENT_POSITIONS = 4096    # contents compared a leaf (`shard_lint`)
# the round's meter: the word-aligned size, exact, so the uplink the
# recorded sites carry can be held to it
ROUND_CODEC = "bitpack"


# ---------------------------------------------------------------------------
# input specs: meta tensors (no allocation) and their shardings
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _ns(mesh, *spec) -> shd.NamedSharding:
    return shd.NamedSharding(mesh, P(*spec))


def train_batch_specs(cfg, shape_cfg, mesh, C):
    """(batch on meta, its shardings) with a leading cohort axis C."""
    Bc = shape_cfg.global_batch // C
    S = shape_cfg.seq_len
    pod = "pod" if "pod" in mesh.axis_names else None
    shapes, sh = {}, {}
    if cfg.family == "vlm":
        shapes["tokens"] = _meta((C, Bc, S - N_VIS), torch.int32)
        shapes["vis_embeds"] = _meta((C, Bc, N_VIS, cfg.d_model),
                                     torch.bfloat16)
        sh["tokens"] = _ns(mesh, pod, "data", None)
        sh["vis_embeds"] = _ns(mesh, pod, "data", None, None)
    elif cfg.family == "encdec":
        shapes["tokens"] = _meta((C, Bc, S), torch.int32)
        shapes["frames"] = _meta((C, Bc, cfg.enc_seq, cfg.d_model),
                                 torch.bfloat16)
        sh["tokens"] = _ns(mesh, pod, "data", None)
        sh["frames"] = _ns(mesh, pod, "data", None, None)
    else:
        shapes["tokens"] = _meta((C, Bc, S), torch.int32)
        sh["tokens"] = _ns(mesh, pod, "data", None)
    return shapes, sh


def _client_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def serve_batch_specs(cfg, shape_cfg, mesh, api):
    """decode: (cache, token, pos) on meta, the cache's shardings, and
    the token's and position's."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    cache = api.init_cache(B, S, "meta")
    cache_sh = shd.cache_shardings(cache, mesh, B)
    client = _client_axes(mesh)
    csize = math.prod(mesh.shape[a] for a in client)
    tok_spec = P(client) if B % csize == 0 and csize > 1 else P()
    token = _meta((B,), torch.int32)
    pos = _meta((), torch.int32)
    sh = (shd.NamedSharding(mesh, tok_spec), shd.replicated(mesh))
    return cache, cache_sh, token, pos, sh


def prefill_batch_specs(cfg, shape_cfg, mesh):
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    client = _client_axes(mesh)
    shapes, sh = {}, {}
    if cfg.family == "vlm":
        shapes["tokens"] = _meta((B, S - N_VIS), torch.int32)
        shapes["vis_embeds"] = _meta((B, N_VIS, cfg.d_model),
                                     torch.bfloat16)
        sh["tokens"] = _ns(mesh, client, None)
        sh["vis_embeds"] = _ns(mesh, client, None, None)
    elif cfg.family == "encdec":
        shapes["tokens"] = _meta((B, S), torch.int32)
        shapes["frames"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                 torch.bfloat16)
        sh["tokens"] = _ns(mesh, client, None)
        sh["frames"] = _ns(mesh, client, None, None)
    else:
        shapes["tokens"] = _meta((B, S), torch.int32)
        sh["tokens"] = _ns(mesh, client, None)
    return shapes, sh


# ---------------------------------------------------------------------------
# collective and argument bytes
# ---------------------------------------------------------------------------

# the reference's HLO kind of each recorded primitive
HLO_KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
             "pmax": "all-reduce", "pmin": "all-reduce",
             "all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
             "all_to_all": "all-to-all", "ppermute": "collective-permute"}


def collective_bytes(sites) -> dict:
    """Per-kind operand bytes of recorded `comm_model.CollectiveSite`s
    (the twin of the reference's parser of compiled HLO), under the
    reference's kind names; an all-gather counts its operand, not its
    result.  Primitives with no HLO kind keep their own name.  `total`
    last."""
    out: dict = {}
    for s in sites:
        kind = HLO_KINDS.get(s.prim, s.prim)
        out[kind] = out.get(kind, 0) + s.bits // 8
    out["total"] = sum(out.values())
    return out


def collective_axes(sites) -> dict:
    """Operand bytes of recorded sites by "kind axis x axis" (the
    reference's kind names), sorted."""
    out: dict = {}
    for s in sites:
        key = f"{HLO_KINDS.get(s.prim, s.prim)} {'x'.join(s.axes)}"
        out[key] = out.get(key, 0) + s.bits // 8
    return dict(sorted(out.items()))


def collective_operands(sites) -> dict:
    """Calls of recorded sites by "kind axis x axis dtype" and operand
    elements: {key: {elements: calls}}, sorted."""
    out: dict = {}
    for s in sites:
        key = f"{HLO_KINDS.get(s.prim, s.prim)} {'x'.join(s.axes)} {s.dtype}"
        calls = out.setdefault(key, {})
        calls[str(s.elems)] = calls.get(str(s.elems), 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: int(kv[0])))
            for k, v in sorted(out.items())}


def local_meta(tree, shardings, mesh):
    """This rank's block of each tensor of `tree` as a meta tensor (non
    tensors as they are)."""
    return tu.tree_map(
        lambda t, sh: _meta(comm_model.shard_shape(tuple(t.shape), sh.spec,
                                                   mesh), t.dtype)
        if isinstance(t, torch.Tensor) else t, tree, shardings)


def block_bytes(tree, shardings, mesh) -> list:
    """Bytes of this rank's block of each array of `tree` (meta or real
    tensors read for their global shapes), flatten order, None leaves
    skipped; an int (the state's step) is the reference's int32
    scalar."""
    out = []
    for x, sh in zip(tu.leaves(tree), tu.leaves(shardings)):
        if x is None:
            continue
        if not isinstance(x, torch.Tensor):
            out.append(4)
            continue
        local = comm_model.shard_shape(tuple(x.shape), sh.spec, mesh)
        out.append(math.prod(local) * x.element_size())
    return out


def replica_share(state_shapes, state_sh, mesh) -> float:
    """The wire's share above 1 bit a parameter and cohort that replicated
    blocks put there: sum over the score leaves of (r - 1) n over the sum
    of n, n a cohort's elements of the leaf and r the ranks holding each
    of its blocks (the mesh axes its spec leaves out).  Each replica
    draws and sends its own masks, as the reference's shards do."""
    num = den = 0
    for t, sh in zip(tu.leaves(state_shapes["scores"]),
                     tu.leaves(state_sh["scores"])):
        if t is None:
            continue
        used = {a for part in sh.spec if part is not None
                for a in ((part,) if isinstance(part, str) else part)}
        r = math.prod(mesh.shape[a] for a in mesh.axis_names
                      if a not in used)
        n = t.numel() // t.shape[0]
        num += (r - 1) * n
        den += n
    return num / den if den else 0.0


# ---------------------------------------------------------------------------
# the round cell's block: rank 0's slice of a constant state on a device
# ---------------------------------------------------------------------------


def _host_leaf(t: torch.Tensor, value: float) -> torch.Tensor:
    """A global leaf of one value: a stride-0 CPU view, one element of
    storage whatever its shape."""
    return torch.full((), value, dtype=t.dtype).expand(tuple(t.shape))


def constant_state(state_shapes):
    """The host-global state of the round cell: every leaf of
    `state_shapes` one value (`BLOCK_VALUES`), as stride-0 views."""
    out = {}
    for key, tree in state_shapes.items():
        if key == "step":
            out[key] = 0
            continue
        v = BLOCK_VALUES[key]
        out[key] = tu.tree_map(
            lambda t, v=v: None if t is None else _host_leaf(t, v), tree)
    return out


def place_block(host, state_sh, device):
    """This rank's block of each leaf of the constant `host` state,
    filled on `device` (nothing of the global state is ever
    materialized)."""
    def one(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        value = x.reshape(-1)[0].item() if x.numel() else 0
        return torch.full(tuple(sh.local(x).shape), value, dtype=x.dtype,
                          device=device)
    return tu.tree_map(one, host, state_sh)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _step_config(shape_cfg, packed, cfg_patch):
    """(StepConfig, sharding mode tp_only, the arch's field patch)."""
    chunk_kv = 512 if shape_cfg.seq_len >= 32768 else None
    microbatch, tp_only = 1, False
    patch = dict(cfg_patch or {})
    chunk_kv = patch.pop("chunk_kv", chunk_kv)          # StepConfig
    microbatch = patch.pop("microbatch", microbatch)    # StepConfig
    tp_only = patch.pop("tp_only", tp_only)             # sharding mode
    scfg = steplib.StepConfig(chunk_kv=chunk_kv, packed_masks=packed,
                              microbatch=microbatch)
    return scfg, tp_only, patch


@contextlib.contextmanager
def _whole_pieces():
    """The score update runs each leaf block whole: on a card it runs in
    pieces of `steps.UPDATE_PIECE` elements to bound its temporaries,
    which meta tensors do not hold (the same ops, far fewer calls; no
    counted flop is elementwise)."""
    piece = steplib.UPDATE_PIECE
    steplib.UPDATE_PIECE = 1 << 62
    try:
        yield
    finally:
        steplib.UPDATE_PIECE = piece


@contextlib.contextmanager
def _counting():
    """(FlopCounterMode, the kernels' stated work) over a meta run."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, \
            dispatch.work_counter() as work:
        yield fc, work


def _meta_result(fc, work, arg_bytes, sites=None) -> dict:
    return {"flops": float(fc.get_total_flops()),
            "kernel_work": {k: dict(v) for k, v in sorted(work.items())},
            "bytes_accessed": None,
            "collective_bytes": (None if sites is None
                                 else collective_bytes(sites)),
            "memory": {"argument_size": int(sum(arg_bytes)),
                       "output_size": None, "temp_size": None,
                       "generated_code_size": None}}


def stream_gate(state_shapes, mesh, C, run_seed) -> dict:
    """The mask streams of every shard and cohort must tile the global
    hash stream: no overlap, gap or seed collision.  The one exception
    is the uint32 stream index wrapping inside a leaf past 2**32
    elements (ROADMAP Queue 3, both packages): reported, not raised."""
    n_dev = math.prod(mesh.shape[a] for a in mesh.axis_names)
    cover = stream_cover.state_stream_report(
        state_shapes, devs=range(n_dev), cohorts=range(C),
        run_seed=run_seed)
    big = {iv.owner for iv in cover["intervals"] if iv.flat_size > 2 ** 32}
    bad = [f for f in cover["findings"] if f.where not in big]
    if bad:
        raise AssertionError("mask-stream coverage violated: "
                             + "; ".join(str(f) for f in bad[:5]))
    return {"ok": True, "n_leaves": cover["n_leaves"],
            "n_streams": cover["n_streams"],
            "wrapped_findings": len(cover["findings"]),
            "wrapped_leaves": sorted(big)}


def round_cell(api, scfg, mesh, state_shapes, state_sh, device) -> dict:
    """One round step on this rank's block of the constant state, its
    collectives recorded (`check`: none may go past the recorder)."""
    host = constant_state(state_shapes)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state = place_block(host, state_sh, device)
    arg_bytes = block_bytes(state_shapes, state_sh, mesh)
    # declared vs held: every leaf the block its sharding names
    mism = []
    for key in sorted(k for k in state_sh if k != "step"):
        mism += shard_lint.placement_mismatches(
            state[key], state_sh[key], host[key], label=f"state/{key}/",
            positions=PLACEMENT_POSITIONS)
    if mism:
        raise AssertionError("declared-vs-held sharding drift: "
                             + "; ".join(str(f) for f in mism[:5]))
    fn = steplib.make_round_step(api, scfg, mesh=mesh, state_sh=state_sh,
                                 codec=ROUND_CODEC)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with comm_model.record_collectives(mesh, check=True) as sites:
        state, metrics = fn(state)
    if on_card:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in dispatch.LAUNCHES.items() if v}
    purity = collective_lint.round_purity_findings(sites, state_shapes,
                                                   state_sh, mesh)
    if scfg.packed_masks and purity:
        raise AssertionError("collective wire purity violated: "
                             + "; ".join(str(f) for f in purity[:5]))
    model = comm_model.round_comm_model(sites, state_shapes, state_sh, mesh,
                                        scfg)
    peak = (torch.cuda.max_memory_allocated(device) if on_card else None)
    args = int(sum(arg_bytes))
    out = {
        "flops": None, "bytes_accessed": None,
        "collective_bytes": collective_bytes(sites),
        "memory": {"argument_size": args, "output_size": None,
                   "temp_size": None if peak is None else int(peak - args),
                   "peak": peak, "generated_code_size": None},
        "comm_model": {k: model[k] for k in (
            "bpp_wire", "uplink_bits", "downlink_bits", "n_sites",
            "ring_bytes_per_axis")},
        "mask_params": model["mask_params"],
        "replica_share": replica_share(state_shapes, state_sh, mesh),
        "purity_findings": [str(f) for f in purity],
        "sites": sorted(f"{r['prim']} {r['dtype']} {r['role']}"
                        for r in model["sites"]),
        "codec": ROUND_CODEC,
        # the bits this rank's block meters (the all-reduce of the total
        # over every rank moved nothing)
        "block_metered_bits": float(metrics["bits_measured"]),
        "launches": launches,
        "round_s": seconds,
        "shard_lint": {"ok": True},
    }
    del state, metrics
    if on_card:
        torch.cuda.empty_cache()
    return out


def cell(arch: str, shape_name: str, multi_pod: bool, *,
         step_kind: str = "auto", packed: bool = True,
         cfg_patch: Optional[dict] = None, device="cuda",
         smoke: bool = False, mesh=None) -> dict:
    """One cell on rank 0 of the production mesh (the twin of the
    reference's `lower_cell`): a dict of per-step results.  The stand-in
    group must be up at the mesh's world size (`meshlib.init_dry`);
    `mesh` overrides the production mesh (tests use a (2, 2, 2) one) and
    `smoke` the config size."""
    cfg = get_config(arch, smoke=smoke)
    shape_cfg = SHAPES[shape_name]
    scfg, tp_only, patch = _step_config(shape_cfg, packed, cfg_patch)
    if patch:
        cfg = dataclasses.replace(cfg, **patch)
    device = torch.device(device)
    if mesh is None:
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                            device=device)
    C = steplib.n_cohorts(mesh)
    results: dict = {}
    t0 = time.perf_counter()
    if shape_cfg.kind == "train":
        api, state_shapes = stream_cover.meta_fed_state(cfg, C)
        results["stream_cover"] = stream_gate(state_shapes, mesh, C,
                                              scfg.seed)
        state_sh = steplib.fed_state_shardings(state_shapes, mesh)
        if step_kind in ("auto", "train"):
            t1 = time.perf_counter()
            batch, batch_sh = train_batch_specs(cfg, shape_cfg, mesh, C)
            arg = (block_bytes(state_shapes, state_sh, mesh)
                   + block_bytes(batch, batch_sh, mesh))
            meta_state = dict(state_shapes)
            fn = steplib.make_train_step(api, scfg)
            with _whole_pieces(), _counting() as (fc, work):
                fn(meta_state, batch)
            results["train_step"] = _meta_result(fc, work, arg)
            if cfg.family in partition.FAMILIES:
                glob = {k: results["train_step"][k]
                        for k in ("flops", "kernel_work")}
                fn = steplib.make_train_step(api, scfg, mesh, state_sh)
                with _whole_pieces(), _counting() as (fc, work), \
                        comm_model.record_collectives(mesh,
                                                      check=True) as sites:
                    fn(local_meta(state_shapes, state_sh, mesh),
                       local_meta(batch, batch_sh, mesh))
                results["train_step"] = dict(
                    _meta_result(fc, work, arg, sites), global_step=glob,
                    collective_axes=collective_axes(sites),
                    collective_operands=collective_operands(sites),
                    n_sites=len(sites))
            results["train_step"]["seconds"] = time.perf_counter() - t1
        if step_kind in ("auto", "round"):
            t1 = time.perf_counter()
            results["round_step"] = round_cell(api, scfg, mesh, state_shapes,
                                               state_sh, device)
            results["round_step"]["seconds"] = time.perf_counter() - t1
    elif shape_cfg.kind == "prefill":
        api = build_model(cfg)
        params = stream_cover.meta_params(cfg)
        params_sh = shd.tree_param_shardings(params, mesh, tp_only=tp_only)
        batch, batch_sh = prefill_batch_specs(cfg, shape_cfg, mesh)
        arg = (block_bytes(params, params_sh, mesh)
               + block_bytes(batch, batch_sh, mesh))
        with torch.no_grad(), _counting() as (fc, work):
            api.forward(params, batch, chunk_kv=scfg.chunk_kv)[0][:, -1]
        results["prefill_step"] = _meta_result(fc, work, arg)
        results["prefill_step"]["seconds"] = time.perf_counter() - t0
    else:                                     # decode
        api = build_model(cfg)
        params = stream_cover.meta_params(cfg)
        params_sh = shd.tree_param_shardings(params, mesh, tp_only=tp_only)
        cache, cache_sh, token, pos, (tok_sh, pos_sh) = serve_batch_specs(
            cfg, shape_cfg, mesh, api)
        arg = (block_bytes(params, params_sh, mesh)
               + block_bytes(cache, cache_sh, mesh)
               + block_bytes([token, pos], [tok_sh, pos_sh], mesh))
        with torch.no_grad(), _counting() as (fc, work):
            steplib.make_serve_step(api)(params, cache, token, pos)
        results["serve_step"] = _meta_result(fc, work, arg)
        results["serve_step"]["seconds"] = time.perf_counter() - t0
    total = time.perf_counter() - t0
    for r in results.values():
        r["peers"] = "fake"
        r["cell_s"] = total
    return results


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def iter_cells(archs, shapes):
    for a in archs:
        for s in shapes:
            if s == "long_500k" and a not in LONG_CONTEXT_OK:
                continue
            yield a, s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--unpacked", action="store_true",
                    help="bf16 all-reduce mask aggregation (baseline)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the round cells' blocks live")
    ap.add_argument("--step", default="auto",
                    choices=("auto", "train", "round"),
                    help="the steps a train shape's cell runs")
    ap.add_argument("--patch", action="append", default=[],
                    help="a JSON dict of fields replaced in the arch's "
                    "config or the step's (microbatch, chunk_kv, "
                    "tp_only): one cell each, keyed arch|shape|mesh|k=v")
    return ap.parse_args(argv)


def cell_key(arch: str, shape: str, mesh_name: str,
             patch: Optional[dict] = None) -> str:
    """A cell's key in the results: arch|shape|mesh, and |k=v,... for a
    patched cell."""
    key = f"{arch}|{shape}|{mesh_name}"
    if patch:
        key += "|" + ",".join(f"{k}={v}" for k, v in sorted(patch.items()))
    return key


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun --device cuda: no CUDA device")
    device = torch.device(args.device)
    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = (list(SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    patches = [json.loads(p) for p in args.patch] or [None]
    n_ok = n_fail = 0
    for mp in meshes:
        mesh_name = MESHES[mp]
        todo = [(a, s, p) for a, s in iter_cells(archs, shapes)
                for p in patches
                if not results.get(cell_key(a, s, mesh_name, p),
                                   {}).get("ok")]
        if not todo:
            continue
        meshlib.init_dry(512 if mp else 256)
        try:
            for arch, shape, patch in todo:
                key = cell_key(arch, shape, mesh_name, patch)
                t0 = time.time()
                try:
                    r = cell(arch, shape, mp, packed=not args.unpacked,
                             device=device, step_kind=args.step,
                             cfg_patch=patch)
                    results[key] = {"ok": True, **r}
                    n_ok += 1
                    print(f"[OK]   {key}  ({time.time() - t0:.0f}s)",
                          flush=True)
                except Exception as e:
                    results[key] = {"ok": False, "error": repr(e),
                                    "traceback": traceback.format_exc()}
                    n_fail += 1
                    print(f"[FAIL] {key}: {e}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
        finally:
            dist.destroy_process_group()
    print(f"done: {n_ok} ok, {n_fail} failed -> {args.out}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
