"""End to end: federated mask-training of a ~100M-param LM (the
internlm2 family, reduced) with checkpoint/restart, client dropout and
straggler cuts: the production loop at a small scale.

    python -m repro_torch.examples.train_lm_masked --steps 200 \\
        [--small] [--resume] [--device cpu]

Every step runs `steps.make_train_step` (kernels 1-3 on the card), every
round `steps.make_round_step` (kernels 4 and 11).  The batches are
windows of one synthetic token stream at starts drawn from a generator
seeded by (0, step) (`runtime.fault.counter_seed`), so a resumed run
reads the batches an uninterrupted one would.  `--smoke` runs a config
of the SMOKE size, for a CPU test of the loop.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import masking
from repro_torch.data import synthetic
from repro_torch.launch import plans
from repro_torch.launch import steps as steplib
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import fault

SEED = 0


def make_100m_cfg(small: bool = False) -> ArchConfig:
    if small:  # ~40M: a run of minutes on a CPU
        return ArchConfig(name="lm-40m", family="dense", n_layers=8,
                          d_model=512, n_heads=8, n_kv_heads=4,
                          d_ff=2048, vocab=8192, head_dim=64)
    # ~106M params: 10L x 640d, vocab 32000
    return ArchConfig(name="lm-100m", family="dense", n_layers=10,
                      d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                      vocab=32000, head_dim=64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--round-every", type=int, default=10)
    ap.add_argument("--cohorts", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lm_masked_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="~40M variant for short demos")
    ap.add_argument("--smoke", action="store_true",
                    help="internlm2-1.8b's SMOKE config (CPU tests)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_config("internlm2-1.8b", smoke=True) if args.smoke
           else make_100m_cfg(small=args.small))
    api = build_model(cfg)
    spec = masking.MaskSpec()
    gen = torch.Generator(dev).manual_seed(SEED)
    scfg = steplib.StepConfig(lam=args.lam, lr=0.5)

    n = cfg.param_count()
    print(f"arch {cfg.name}: ~{n/1e6:.0f}M params")

    state = steplib.init_fed_state(gen, api, spec, C=args.cohorts)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt.restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    train_step = steplib.make_train_step(api, scfg)
    round_step = steplib.make_round_step(api, scfg)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=2)

    toks = synthetic.make_lm_stream(SEED, 2_000_000, cfg.vocab, dev)
    make_batch = plans._cohort_batch(args.cohorts)
    sim = fault.FaultSimulator(n_clients=args.cohorts, fail_prob=0.1,
                               seed=1)
    pol = fault.StragglerPolicy(quorum_frac=1.0)

    out = {"start": start, "losses": [], "rounds": []}
    t0 = time.time()
    for step in range(start, args.steps):
        bgen = torch.Generator(dev).manual_seed(
            fault.counter_seed(SEED, step, fault.S_BATCH))
        batch = make_batch(bgen, toks, args.batch, args.seq)
        state, m = train_step(state, batch)
        out["losses"].append(float(m["loss"]))
        if (step + 1) % args.round_every == 0:
            alive = sim.sample_round(pol)
            # dropped cohorts simply skip this round's exchange: in the
            # sim their previous scores are reused (nothing to aggregate)
            state, rm = round_step(state)
            saver.save(step + 1, state)
            out["rounds"].append({k: float(v) for k, v in rm.items()})
            print(f"step {step+1}: loss={float(m['loss']):.3f} "
                  f"uplink={float(rm['bpp']):.3f} Bpp "
                  f"alive={alive.sum()}/{args.cohorts} "
                  f"({(time.time()-t0):.0f}s)", flush=True)
    saver.close()
    print("done; checkpoint in", args.ckpt_dir)
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
