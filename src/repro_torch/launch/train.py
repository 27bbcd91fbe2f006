"""Training launcher of the PyTorch port.

    python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 4 --round-every 2 --cohorts 2 --batch 2 --seq 128

Runs on the CUDA card by default and raises if there is none; the CPU is
used only when asked for (`--device cpu`, with `--smoke` for the reduced
config), where the kernels' plain versions run.  Every
`--round-every` steps the round exchanges the cohorts' masks and prints

    step N: loss=… uplink=…Bpp (wire …Bpp <codec>) cum=…MB (…s)

`main` parses the command line and calls `run(cfg, args)`, which a
scripted caller may call with any `ArchConfig` (e.g. a depth-cut one);
both return a summary (losses, round metrics, per-step and per-round
seconds measured after a device synchronize).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import codecs as codecs_lib
from repro_torch.api import registry
from repro_torch.configs import ArchConfig, get_config
from repro_torch.data import synthetic
from repro_torch.launch import plans  # noqa: F401  (registers the plans)
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model


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
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_config(args.arch, smoke=args.smoke), args)


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
    toks = synthetic.make_lm_stream(args.seed, 500_000, cfg.vocab, dev)
    ledger = codecs_lib.CommLedger()
    out = {"losses": [], "rounds": [], "step_seconds": [],
           "round_seconds": []}

    t0 = time.time()
    for step in range(args.steps):
        batch = plan.make_batch(gen, toks, args.batch, args.seq)
        _sync(dev)
        ts = time.perf_counter()
        state, m = plan.step_fn(state, batch)
        _sync(dev)
        out["step_seconds"].append(time.perf_counter() - ts)
        loss = float(m["loss"])
        out["losses"].append(loss)
        if plan.round_fn is not None and (step + 1) % args.round_every == 0:
            ts = time.perf_counter()
            state, rm = plan.round_fn(state)
            _sync(dev)
            out["round_seconds"].append(time.perf_counter() - ts)
            rm = {k: float(v) for k, v in rm.items()}
            out["rounds"].append(rm)
            ledger.update({"uplink_bits_measured": rm["bits_measured"],
                           "downlink_bits": rm["downlink_bits"]})
            print(f"step {step+1}: loss={loss:.3f} "
                  f"uplink={rm['bpp']:.3f}Bpp "
                  f"(wire {rm['bpp_measured']:.3f}Bpp {args.codec}) "
                  f"cum={ledger.total_mb:.2f}MB ({time.time()-t0:.0f}s)",
                  flush=True)
        elif (step + 1) % 10 == 0:
            print(f"step {step+1}: loss={loss:.3f}", flush=True)
    if ledger.rounds:
        print(f"comm: {ledger.rounds} rounds, up={ledger.uplink_mb:.2f}MB "
              f"down={ledger.downlink_mb:.2f}MB "
              f"total={ledger.total_mb:.2f}MB")
    print("done")
    out["ledger"] = ledger.as_dict()
    return out


if __name__ == "__main__":
    main()
