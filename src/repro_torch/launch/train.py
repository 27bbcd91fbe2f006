"""Training launcher of the PyTorch port.

    python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 4 --round-every 2 --cohorts 2 --batch 2 --seq 128 \
        [--algo fedpm_reg|fedpm|fedmask|fedavg] [--ckpt-dir DIR]
        [--fail-prob P --pod-size N --pod-outage-prob P --quorum-frac F]
        [--tree-fanout N --agg-fault-prob P]

`--arch` takes every config of the zoo (`configs.ARCH_NAMES`): the dense
transformers, the MoE ones, qwen2-vl (text batches, as the reference's
plans make them), whisper (zero frames), mamba2 and recurrentgemma.

Runs on the CUDA card by default and raises if there is none; the CPU is
used only when asked for (`--device cpu`, with `--smoke` for the reduced
config), where the kernels' plain versions run.  Every
`--round-every` steps the round exchanges the cohorts' masks and prints

    step N: loss=… uplink=…Bpp (wire …Bpp <codec>) cum=…MB
        [alive=a/C] [edges=e/E root=…MB] (…s)

`--algo fedavg` trains the float params with no round and prints
`step N: loss=…` every 10 steps.

Checkpoint and restart (`--ckpt-dir`): after each round the state goes
to an `AsyncCheckpointer(keep=2)` and the CommLedger to a
`comm_ledger.json` sidecar (also into the checkpoint's manifest, so a
resume restores the ledger of the step it restores); a relaunch restores
the latest checkpoint and continues its step, or, when the structure no
longer matches (another --cohorts), carries theta over with
`runtime.elastic.restore_theta_only`.  Every step appends {step, loss[,
round metrics]} to `history.jsonl` there.  Every draw is keyed by
(seed, index), never by a generator carried through the run: a step's
batch by (seed, step) (`runtime.fault.counter_seed`), a round's
downlink by its step, its faults by (seed, round), so a resumed run
replays the uninterrupted one.

Faults (`--fail-prob`, `--pod-size`, `--pod-outage-prob`,
`--quorum-frac`): `runtime.fault.FaultSimulator` draws which cohorts'
uplinks arrive each round and the round renormalizes over them.  An
aggregator tree (`--tree-fanout`, `--agg-fault-prob`): the cohorts of a
crashed edge miss the round, and the edge -> root hop is metered from
the static cost model, one pooled record a surviving edge.

`main` parses the command line and calls `run(cfg, args)`, which a
scripted caller may call with any `ArchConfig` (e.g. a depth-cut one);
both return a summary (losses, round metrics, per-step and per-round
seconds measured after a device synchronize, the step it started at).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.analysis import comm_model
from repro_torch.api import codecs as codecs_lib
from repro_torch.api import registry
from repro_torch.ckpt import checkpoint as ckptlib
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import tree as tu
from repro_torch.data import synthetic
from repro_torch.launch import plans  # noqa: F401  (registers the plans)
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model
from repro_torch.runtime import agg_tree, elastic, fault


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu to run the plain "
                           "versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--algo", default="fedpm_reg",
                    choices=list(registry.launchable()))
    ap.add_argument("--codec", default="arithmetic",
                    choices=[c for c in codecs_lib.available()
                             if c != "float32"],
                    help="wire codec metering the mask uplink")
    ap.add_argument("--downlink-bits", type=int, default=8,
                    help="k-bit stochastic theta broadcast "
                         "(0 = raw float32 downlink)")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=17,
                    help="run seed for every mask stream, the init and "
                         "the data")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--round-every", type=int, default=10)
    ap.add_argument("--cohorts", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--score-opt", default="momentum",
                    choices=["momentum", "adam"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--fail-prob", type=float, default=0.0,
                    help="per-round iid cohort failure probability; the "
                         "round aggregation renormalizes over survivors")
    ap.add_argument("--pod-size", type=int, default=0,
                    help="cohorts per failure domain (0 = independent "
                         "failures); whole pods drop together")
    ap.add_argument("--pod-outage-prob", type=float, default=0.0,
                    help="per-round correlated pod outage probability")
    ap.add_argument("--quorum-frac", type=float, default=1.0,
                    help="straggler cut: keep the fastest fraction of "
                         "surviving cohorts each round (1.0 = wait for "
                         "everyone)")
    ap.add_argument("--tree-fanout", type=int, default=0,
                    help="cohorts per edge aggregator (0 = flat "
                         "aggregation); with a tree, each round's root "
                         "traffic is one O(params) pooled fold record per "
                         "surviving edge (runtime/agg_tree.py)")
    ap.add_argument("--agg-fault-prob", type=float, default=0.0,
                    help="per-round edge-aggregator crash probability "
                         "(requires --tree-fanout); cohorts of a crashed "
                         "edge miss the barrier round")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.agg_fault_prob > 0 and args.tree_fanout <= 0:
        ap.error("--agg-fault-prob requires --tree-fanout > 0")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_config(args.arch, smoke=args.smoke), args)


def _ledger_fields(ledger: codecs_lib.CommLedger) -> dict:
    return {"uplink_bits": ledger.uplink_bits,
            "downlink_bits": ledger.downlink_bits,
            "root_bits": ledger.root_bits, "rounds": ledger.rounds}


def _append_json(path: str, obj) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(obj) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _tree_topology(args, state):
    """(TreeTopology, static root bits a surviving edge): one pooled
    record over the mask leaves and the float leaves (the cohort axis
    dropped)."""
    leaves = lambda t: [l for l in tu.leaves(t) if l is not None]
    leaf_params = [math.prod(l.shape[1:]) for l in leaves(state["scores"])]
    float_elems = sum(math.prod(l.shape[1:])
                      for l in leaves(state.get("floats")))
    topo = agg_tree.TreeTopology(args.cohorts, args.tree_fanout,
                                 agg_fault_prob=args.agg_fault_prob,
                                 seed=args.seed)
    rec = comm_model.tree_root_record_bits(
        leaf_params, acc_bits=topo.cfg.acc_bits, n_classes=1,
        float_elems=float_elems, n_metrics=0)
    return topo, rec["wire_bits"] + rec["sidecar_bits"]


def run(cfg: ArchConfig, args: argparse.Namespace) -> dict:
    """Train `cfg` as the parsed command line `args` asks (its --arch and
    --smoke are not read)."""
    dev = resolve_device(args.device)
    # the reference's attention, router and unembed products are full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    api = build_model(cfg)
    scfg = steplib.StepConfig(lam=args.lam, lr=args.lr,
                              optimizer=args.score_opt,
                              downlink_bits=args.downlink_bits,
                              seed=args.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    plan = registry.get_launch_plan(args.algo)(
        api, scfg, gen=gen, cohorts=args.cohorts, optimizer=args.score_opt,
        codec=args.codec)
    state = plan.state

    # hierarchical aggregator tree: the barrier round has no retransmit
    # window, so edge faults collapse to participation masking, and the
    # edge -> root hop is metered from the static cost model
    topo, tree_edge_bits = None, 0
    if args.tree_fanout > 0:
        if "scores" not in state:
            raise ValueError(f"--tree-fanout: algo '{args.algo}' carries no "
                             f"mask scores to pool at an edge")
        topo, tree_edge_bits = _tree_topology(args, state)
        print(f"tree: {topo.n_edges} edge(s) at fanout {args.tree_fanout}, "
              f"root record {tree_edge_bits}b/edge (static)")

    start, saver, manifest = 0, None, {}
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        saver = ckptlib.AsyncCheckpointer(args.ckpt_dir, keep=2)
        if ckptlib.latest_step(args.ckpt_dir) is not None:
            try:
                state, start = ckptlib.restore_checkpoint(args.ckpt_dir,
                                                          state)
                print(f"resumed at step {start}")
            except (KeyError, ValueError):
                # structure mismatch (elastic resize, optimizer switch):
                # carry theta and the floats over, rebuild the rest
                state, start = elastic.restore_theta_only(args.ckpt_dir,
                                                          state)
                print(f"structure mismatch: theta-only partial restore "
                      f"at step {start}")
            manifest = ckptlib.read_manifest(args.ckpt_dir, start)

    toks = synthetic.make_lm_stream(args.seed, 500_000, cfg.vocab, dev)
    faulty = (args.fail_prob > 0 or args.pod_outage_prob > 0
              or args.quorum_frac < 1.0)
    sim = (fault.FaultSimulator(args.cohorts, fail_prob=args.fail_prob,
                                pod_size=args.pod_size,
                                pod_outage_prob=args.pod_outage_prob,
                                seed=args.seed)
           if faulty else None)
    policy = (fault.StragglerPolicy(quorum_frac=args.quorum_frac)
              if args.quorum_frac < 1.0 else None)
    # the ledger must survive restarts or cumulative MB under-reports: the
    # restored checkpoint's manifest holds the ledger of its step (a
    # checkpoint without one falls back to the sidecar)
    ledger = codecs_lib.CommLedger()
    ledger_path = (os.path.join(args.ckpt_dir, "comm_ledger.json")
                   if args.ckpt_dir else None)
    history = (os.path.join(args.ckpt_dir, "history.jsonl")
               if args.ckpt_dir else None)
    if start > 0:
        saved = manifest.get("extra", {}).get("ledger")
        if saved is None and os.path.exists(ledger_path):
            with open(ledger_path) as f:
                saved = json.load(f)
        if saved is not None:
            ledger = codecs_lib.CommLedger(**saved)
            print(f"resumed ledger: {ledger.total_mb:.2f}MB over "
                  f"{ledger.rounds} rounds")
    out = {"losses": [], "rounds": [], "step_seconds": [],
           "round_seconds": [], "start": start}

    t0 = time.time()
    for step in range(start, args.steps):
        bgen = torch.Generator(device=dev)
        bgen.manual_seed(fault.counter_seed(args.seed, step, fault.S_BATCH))
        batch = plan.make_batch(bgen, toks, args.batch, args.seq)
        _sync(dev)
        ts = time.perf_counter()
        state, m = plan.step_fn(state, batch)
        _sync(dev)
        out["step_seconds"].append(time.perf_counter() - ts)
        loss = float(m["loss"])
        out["losses"].append(loss)
        record = {"step": step + 1, "loss": loss}
        if plan.round_fn is not None and (step + 1) % args.round_every == 0:
            # faults are keyed by (seed, round index), so a resumed run
            # replays the identical fault sequence
            round_idx = (step + 1) // args.round_every
            alive = (sim.sample_round(policy, round_idx=round_idx)
                     if sim is not None else None)
            if topo is not None:
                base = (np.asarray(alive, bool) if alive is not None
                        else np.ones(args.cohorts, bool))
                masked = topo.round_mask(base, round_idx)
                # a round never folds an empty cohort: if aggregator
                # faults orphan every surviving cohort, the root adopts
                # them directly this round
                alive = masked if masked.any() else base
            ts = time.perf_counter()
            state, rm = (plan.round_fn(state) if alive is None else
                         plan.round_fn(state, torch.as_tensor(alive,
                                                              device=dev)))
            _sync(dev)
            out["round_seconds"].append(time.perf_counter() - ts)
            rm = {k: float(v) for k, v in rm.items()}
            out["rounds"].append(rm)
            record["round"] = rm
            upd = {"uplink_bits_measured": rm["bits_measured"],
                   "downlink_bits": rm["downlink_bits"]}
            if topo is not None:
                upd["root_bits_measured"] = float(
                    topo.surviving_edges(round_idx) * tree_edge_bits)
            ledger.update(upd)
            msg = (f"step {step+1}: loss={loss:.3f} "
                   f"uplink={rm['bpp']:.3f}Bpp "
                   f"(wire {rm['bpp_measured']:.3f}Bpp {args.codec}) "
                   f"cum={ledger.total_mb:.2f}MB")
            if alive is not None:
                msg += f" alive={int(alive.sum())}/{args.cohorts}"
            if topo is not None:
                msg += (f" edges={topo.surviving_edges(round_idx)}"
                        f"/{topo.n_edges} root={ledger.root_mb:.3f}MB")
            print(msg + f" ({time.time()-t0:.0f}s)", flush=True)
            if saver:
                saver.save(step + 1, state,
                           extra={"ledger": _ledger_fields(ledger)})
                tmp = ledger_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(_ledger_fields(ledger), f)
                os.replace(tmp, ledger_path)
        elif (step + 1) % 10 == 0:
            print(f"step {step+1}: loss={loss:.3f}", flush=True)
        if history:
            _append_json(history, record)
    if saver:
        saver.close()
    if ledger.rounds:
        msg = (f"comm: {ledger.rounds} rounds, up={ledger.uplink_mb:.2f}MB "
               f"down={ledger.downlink_mb:.2f}MB "
               f"total={ledger.total_mb:.2f}MB")
        if ledger.root_bits:
            msg += f" root={ledger.root_mb:.3f}MB"
        print(msg)
    print("done")
    out["ledger"] = ledger.as_dict()
    return out


if __name__ == "__main__":
    main()
