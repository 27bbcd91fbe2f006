"""Static-analysis gate: the `repro_torch.analysis` engines over the repo
(the reference's ``tools/repro_lint.py``).

  * source -- AST rules over ``src/repro_torch/``: bare
    ``manual_seed(<const>)`` under ``launch/``, kernel wrappers with
    their plain versions, launch counts, build entries and kernel
    boundaries, README env-knob rows, the materializing-call allowlist.
  * stream -- mask-stream coverage over the config zoo (SMOKE sizes, on
    the meta device): every `MaskedLeaf`'s intervals tile its flat hash
    stream (grouped (E, K, N) expert slices included) and no two (leaf,
    shard, cohort) streams share a seed.
  * ops -- the op walker over the fused dense forward and backward at
    one kernel shape and over the three aligned check configs' train
    steps, on ``--device``: no weight-shaped f32 value, no materialized
    mask, no f64 and (at the kernel shape) no weight-sized bf16 -> f32
    copy outside the kernels; every state leaf keeps its storage.
  * collective -- wire purity of every arch's fedpm_reg round and of
    internlm2-1.8b under every mask algorithm, recorded on a debug pod
    mesh of ranks; the unpacked bf16 baseline must fire (a rule that
    stops firing on the known-impure path is a dead gate).
  * shard -- silent replication over every arch's parameters on that
    mesh, and declared vs held on internlm2-1.8b's placed fed state.

The collective and shard engines spawn their ranks: 8 gloo ranks on the
CPU, one NCCL rank a card on the card.

    python -m repro_torch.tools.repro_lint [--engines source,stream,ops,
        collective,shard] [--archs all|a,b,...] [--device cuda|cpu]
        [--devices 8] [--cohorts 2] [--seed 17]

``--device`` defaults to ``cuda`` and raises without a card.  Prints
``FAIL ...`` lines, then ``# repro_lint: ok`` or ``# repro_lint: N
failure(s)``; exits 0 only when ok.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import pathlib
import sys
import tempfile
from datetime import timedelta

ENGINES = ("source", "stream", "ops", "collective", "shard")
REF_ARCH = "internlm2-1.8b"
RANK_TIMEOUT = 900                # seconds each rank's join may wait


def finish(tool: str, errors) -> int:
    """Print the FAIL lines and the summary line; return the exit code."""
    errors = list(errors)
    for e in errors:
        print(f"FAIL {e}")
    if errors:
        print(f"# {tool}: {len(errors)} failure(s)")
        return 1
    print(f"# {tool}: ok")
    return 0


def run_source(errors) -> None:
    from repro_torch.analysis import source_lint
    found = source_lint.run_all()
    errors.extend(f"source {f}" for f in found)
    print(f"# repro_lint[source]: {len(found)} finding(s)")


def run_stream(errors, archs, devices, cohorts, seed) -> None:
    from repro_torch.analysis import stream_cover
    for arch in archs:
        rep = stream_cover.arch_stream_report(
            arch, smoke=True, C=cohorts, devs=range(devices), run_seed=seed)
        errors.extend(f"stream[{arch}] {f}" for f in rep["findings"])
        print(f"# repro_lint[stream] {arch}: {rep['n_leaves']} leaves, "
              f"{rep['n_intervals']} intervals, {rep['n_streams']} "
              f"streams, {len(rep['findings'])} finding(s)")


def run_ops(errors, device) -> None:
    import torch
    from repro_torch.analysis import model_check, op_lint
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steplib

    # kernel level: the fused dense forward and backward under every rule
    M, K, N = 256, 512, 512
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=device).to(torch.bfloat16)
    s = torch.randn((K, N), generator=gen, device=device)
    rules = [op_lint.weight_f32_temporaries((K, N)),
             op_lint.mask_materialization((K, N)),
             op_lint.DtypePromotionRule([(K, N)])]

    def fwd_bwd(x, w, s):
        x, s = x.requires_grad_(), s.requires_grad_()
        ops.masked_dense(x, w, s, 0).float().sum().backward()

    found = op_lint.lint_ops(fwd_bwd, (x, w, s), rules)
    errors.extend(f"ops[kernel] {f}" for f in found)
    print(f"# repro_lint[ops] kernel fwd+bwd: {len(found)} finding(s)")

    # whole-model level: the fused train step of each aligned family; the
    # bf16 -> f32 shape check stays at the kernel level (an activation may
    # share a block shape at model scale)
    scfg = steplib.StepConfig(lam=0.1, lr=0.5)
    for fam, (cfg, S) in model_check.MODEL_CHECK_CFGS.items():
        api, state, batch = model_check.model_step_setup(cfg, S=S,
                                                         device=device)
        shapes = model_check.masked_block_shapes(state)
        rules = [op_lint.weight_f32_temporaries(sh) for sh in shapes]
        rules += [op_lint.mask_materialization(sh) for sh in shapes]
        rules.append(op_lint.DtypePromotionRule())
        keep = op_lint.InPlaceRule(state)
        found = op_lint.lint_ops(steplib.make_train_step(api, scfg),
                                 (state, batch), rules)
        found += keep.check(state)
        errors.extend(f"ops[{fam}] {f}" for f in found)
        print(f"# repro_lint[ops] {fam}: {len(shapes)} block shapes, "
              f"{len(found)} finding(s)")


def _rank_main(rank, world, store, device, engines, archs, cohorts, out):
    """One rank of the collective and shard engines: every rank runs every
    cell (the rounds' collectives need all of them); rank 0 writes what
    it found to `out` as JSON."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import collective_lint, shard_lint
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import mesh_round, plans

    torch.set_num_threads(1)
    dev = meshlib.init(device, store=dist.FileStore(store, world), rank=rank,
                       world_size=world, timeout=timedelta(seconds=600))
    res = {"errors": [], "lines": []}
    try:
        mesh = meshlib.make_debug_pod_mesh()
        if "collective" in engines:
            cells = [(a, "fedpm_reg", True) for a in archs]
            cells += [(REF_ARCH, algo, True) for algo in sorted(
                plans.MASK_ALGOS) if algo != "fedpm_reg" or REF_ARCH
                not in archs]
            # liveness: the bf16 baseline must fire
            cells.append((REF_ARCH, "fedpm_reg", False))
            for arch, algo, packed in cells:
                start = mesh_round.global_state(arch, cohorts, smoke=True,
                                                draw_device=dev)
                rep = collective_lint.arch_collective_report(
                    arch, algo, mesh=mesh, C=cohorts, packed=packed,
                    start=start)
                tag = f"{arch}|{algo}" + ("" if packed else "|unpacked")
                m = rep["model"]
                res["lines"].append(
                    f"# repro_lint[collective] {tag}: {rep['n_sites']} "
                    f"sites, bpp_wire={m['bpp_wire']}, "
                    f"{len(rep['findings'])} finding(s)")
                if packed:
                    res["errors"] += [f"collective[{tag}] {f}"
                                      for f in rep["findings"]]
                elif not rep["findings"]:
                    res["errors"].append(
                        "collective[liveness] the unpacked bf16 round gave "
                        "no purity finding (the rule went dead)")
        if "shard" in engines:
            for arch in archs:
                rep = shard_lint.arch_shard_report(arch, mesh=mesh)
                res["errors"] += [f"shard[{arch}] {f}"
                                  for f in rep["findings"]]
                res["lines"].append(
                    f"# repro_lint[shard] {arch}: "
                    f"{len(rep['explanations'])} leaves explained, "
                    f"{len(rep['findings'])} finding(s)")
            rep = shard_lint.arch_shard_report(REF_ARCH, mesh=mesh, C=cohorts,
                                               place_state=True)
            res["errors"] += [f"shard[round-state] {f}"
                              for f in rep["findings"]]
            res["lines"].append(
                f"# repro_lint[shard] round-state({REF_ARCH}): "
                f"{rep['n_leaves']} weights explained, declared vs held on "
                f"every state leaf, {len(rep['findings'])} finding(s)")
        res["mesh"] = mesh.shape
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_ranks(errors, engines, archs, device, cohorts) -> None:
    """Spawn the ranks of the collective and shard engines: 8 gloo ranks
    on the CPU, one NCCL rank a card."""
    import torch
    world = torch.cuda.device_count() if device == "cuda" else 8
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "rank0.json"
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, str(pathlib.Path(tmp) / "store"), device,
            sorted(engines), list(archs), cohorts, str(out)))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT)
                if p.is_alive() or p.exitcode != 0:
                    errors.append(f"ranks: a rank did not finish "
                                  f"(exit code {p.exitcode})")
                    return
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        res = json.loads(out.read_text())
    print(f"# repro_lint: {world} {device} rank(s), mesh {res['mesh']}")
    for line in res["lines"]:
        print(line)
    errors.extend(res["errors"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--engines", default=",".join(ENGINES),
                   help="comma-separated subset of " + ",".join(ENGINES))
    p.add_argument("--archs", default="all",
                   help="'all' (the config zoo) or comma-separated names")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--devices", type=int, default=8,
                   help="shard ids the stream engine sweeps "
                        "(mask_stream_seed is pure: no devices needed)")
    p.add_argument("--cohorts", type=int, default=2)
    p.add_argument("--seed", type=int, default=17)
    args = p.parse_args(argv)

    engines = {e.strip() for e in args.engines.split(",") if e.strip()}
    unknown = engines - set(ENGINES)
    if unknown:
        print(f"unknown engine(s): {sorted(unknown)}", file=sys.stderr)
        return 2
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_lint --device cuda: no CUDA device "
                           "(--device cpu runs the plain versions)")
    from repro_torch.configs import ARCH_NAMES
    archs = (list(ARCH_NAMES) if args.archs == "all" else
             [a.strip() for a in args.archs.split(",") if a.strip()])

    errors: list = []
    if "source" in engines:
        run_source(errors)
    if "stream" in engines:
        run_stream(errors, archs, args.devices, args.cohorts, args.seed)
    if "ops" in engines:
        run_ops(errors, args.device)
    if engines & {"collective", "shard"}:
        run_ranks(errors, engines & {"collective", "shard"}, archs,
                  args.device, args.cohorts)
    return finish("repro_lint", errors)


if __name__ == "__main__":
    sys.exit(main())
