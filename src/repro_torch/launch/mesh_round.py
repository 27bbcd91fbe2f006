"""Partitioned train steps and a federated round on a mesh of ranks, one
process a card: `steps.make_train_step(api, cfg, mesh, state_sh)` and
the paper's cross-pod mask exchange through `steps.make_round_step(api,
cfg, mesh, state_sh)`.

    torchrun --nproc_per_node=<cards> -m repro_torch.launch.mesh_round \\
        --arch internlm2-1.8b --cohorts 2 [--steps 4]

`--arch` takes any arch of the zoo: `--arch mamba2-370m --steps 4` runs
the ssm family's partitioned steps, its conv leaves on each rank's
channel block.

Each rank starts the process group from torchrun's environment
(`mesh.init`: NCCL with the rank on its card; `--device cpu`: gloo) and
builds `mesh.make_debug_pod_mesh()` from the world size.  It draws the
global fed state on the CPU from the launcher's seed (every rank the
same state; the cohort axis is a broadcast view, so the host holds one
cohort's tensors), places only its own block of it on its device
(`steps.fed_state_shardings` -> `elastic.reshard_server`), runs
`--steps` partitioned train steps on it (`launch.partition`; the
launcher's step configuration and batches: `BATCH` rows of `SEQ`
tokens a cohort from its token stream, keyed by (seed, step), each rank
taking its pod's cohorts and its "data" rows) and then one round with
the launcher's round configuration (the arithmetic codec, the 8-bit
downlink, seed 17); `--unpacked` runs the bf16 baseline.  Each rank
prints one line: its mesh coordinates, the steps' losses, the round's
metrics and seconds.  `--cohorts` must be a multiple of the mesh's pod
size.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import masking
from repro_torch.core import tree as tu
from repro_torch.data import synthetic
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import plans
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model
from repro_torch.runtime import elastic, fault

# the launcher's step and round configuration (`launch.train`'s defaults)
CODEC, DOWNLINK_BITS, SEED, LR = "arithmetic", 8, 17, 0.3
BATCH, SEQ = 2, 128           # rows a cohort, tokens a row
STREAM_TOKENS = 500_000       # the launcher's token stream


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cohorts", type=int, default=2)
    ap.add_argument("--unpacked", action="store_true",
                    help="the bf16 all-reduce baseline (16 bits a "
                         "parameter) instead of the packed all-gather")
    ap.add_argument("--steps", type=int, default=0,
                    help="partitioned train steps before the round")
    return ap.parse_args(argv)


def step_config(args) -> steplib.StepConfig:
    return steplib.StepConfig(lr=LR, downlink_bits=DOWNLINK_BITS, seed=SEED,
                              packed_masks=not args.unpacked)


def step_batch(args, api, step: int, device) -> dict:
    """The launcher's global batch of train step `step`: (cohorts, batch,
    seq) windows of its token stream at starts drawn from (seed, step)."""
    toks = synthetic.make_lm_stream(SEED, STREAM_TOKENS, api.cfg.vocab,
                                    device)
    gen = torch.Generator(device=device)
    gen.manual_seed(fault.counter_seed(SEED, step, fault.S_BATCH))
    return plans._cohort_batch(args.cohorts)(gen, toks, BATCH, SEQ)


def global_state(arch: str, cohorts: int, *, smoke: bool = False,
                 seed: int = SEED, draw_device="cpu", n_layers=None):
    """(model api, the host-global fed state of `cohorts` cohorts drawn
    from `seed`; `n_layers` cuts the arch's depth).  The draw runs on
    `draw_device` and its tensors then
    move to the host: a card draws far faster than the CPU's one
    generator stream, and holds one cohort's tensors only while it draws.
    Every cohort starts from the same tensors (`init_fed_state`), so the
    cohort axis of each leaf is a broadcast of one cohort's:
    `reshard_server` materializes only the block it places."""
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = build_model(cfg)
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    state = steplib.init_fed_state(gen, api, masking.MaskSpec(), C=1)
    for key in ("scores", "floats", "opt_m", "weights"):
        state[key] = tu.tree_map(lambda t: None if t is None else t.cpu(),
                                 state[key])
    for key in ("scores", "floats", "opt_m"):
        state[key] = tu.tree_map(
            lambda t: None if t is None else
            t.expand((cohorts,) + tuple(t.shape[1:])), state[key])
    return api, state


def run(args, mesh, start=None) -> dict:
    """`args.steps` partitioned train steps, then one mesh round, on this
    rank's block of the state: {"state": the rank's state after them,
    "losses": each step's global mean loss, "step_seconds": each step's
    wall seconds, "metrics": the round's {name: float}, "seconds": the
    round's wall seconds}, synchronized.  `start` is `global_state(...)`
    of the args' arch and cohorts (drawn here when not given); it is
    read, never written."""
    if args.cohorts % steplib.n_cohorts(mesh):
        raise ValueError(f"--cohorts {args.cohorts} does not split over "
                         f"the mesh's {steplib.n_cohorts(mesh)} pods")
    api, host = start if start is not None else global_state(
        args.arch, args.cohorts, smoke=args.smoke)
    sh = steplib.fed_state_shardings(host, mesh)
    state = elastic.reshard_server(host, sh)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)
    out = {"losses": [], "step_seconds": []}
    if args.steps:
        train = steplib.make_train_step(api, step_config(args), mesh=mesh,
                                        state_sh=sh)
        rows = shd.NamedSharding(mesh, shd.P("pod", "data"))
        for i in range(args.steps):
            batch = {k: rows.local(v) for k, v in step_batch(
                args, api, i, mesh.device).items()}
            sync()
            t0 = time.perf_counter()
            state, m = train(state, batch)
            sync()
            out["step_seconds"].append(time.perf_counter() - t0)
            out["losses"].append(float(m["loss"]))
    round_fn = steplib.make_round_step(api, step_config(args), mesh=mesh,
                                       state_sh=sh, codec=CODEC)
    sync()
    t0 = time.perf_counter()
    state, m = round_fn(state)
    sync()
    return dict(out, state=state, seconds=time.perf_counter() - t0,
                metrics={k: float(v) for k, v in m.items()})


def main(argv=None) -> None:
    args = parse_args(argv)
    meshlib.init(args.device)
    try:
        mesh = meshlib.make_debug_pod_mesh()
        out = run(args, mesh)
        print(f"rank {mesh.rank} {mesh.coords} {mesh.backend} "
              + (f"losses {[round(x, 6) for x in out['losses']]} "
                 if out["losses"] else "") + "round: "
              + " ".join(f"{k}={v:.6g}" for k, v in out["metrics"].items())
              + f" ({out['seconds']:.3f}s)", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
