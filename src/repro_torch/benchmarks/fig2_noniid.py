"""Paper Fig. 2 (`benchmarks/fig2_noniid.py` of the JAX package): the
non-IID (c classes a client) accuracy / Bpp trade-off over lambda, with
the Top-k and MV-SignSGD baselines, on the mnist-like and cifar10-like
tasks, with the CommLedger's cumulative traffic in each direction.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_noniid
        [--rounds R] [--k K] [--c C] [--device cuda|cpu]

Prints CSV: dataset,algo,round,acc,bpp,bpp_measured,cum_up_mb,cum_down_mb,
and a summary on stderr.  It runs on the card unless --device cpu is
given.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.benchmarks import common
from repro_torch.launch.train import resolve_device

DATASETS = ("mnist-like", "cifar10-like")
LAMS = (0.0, 0.1, 0.5, 1.0)
BASELINES = (("topk", dict(k_frac=0.3)), ("mv_signsgd", {}))
HEADER = "dataset,algo,round,acc,bpp,bpp_measured,cum_up_mb,cum_down_mb"


def main(rounds: int = 12, k: int = 10, c: int = 2, device="cuda",
         out=sys.stdout, err=sys.stderr) -> dict:
    """Runs the grid and returns {dataset: {algo: history}}."""
    device = resolve_device(str(device))   # no card: raise before output
    # the reference's convs and products are full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(HEADER, file=out)
    result = {}
    for ds in DATASETS:
        setup = common.make_setup(ds, k=k, c=c, device=device)
        runs = {}
        for lam in LAMS:
            runs[f"lam={lam}"], _ = common.run_fedpm_variant(setup, lam,
                                                             rounds)
        # the baselines resolve through the same registry and round engine
        for name, kw in BASELINES:
            runs[name], _ = common.run_algorithm(setup, name, rounds, **kw)
        for name, hist in runs.items():
            for r in range(rounds):
                print(f"{ds},{name},{r},{hist['acc'][r]:.4f},"
                      f"{hist['bpp'][r]:.4f},{hist['bpp_measured'][r]:.4f},"
                      f"{hist['cumulative_uplink_mb'][r]:.4f},"
                      f"{hist['cumulative_downlink_mb'][r]:.4f}", file=out)
        result[ds] = runs
        for name, hist in runs.items():
            led = hist["ledger"]
            print(f"# {ds:13s} {name:12s} final acc={hist['acc'][-1]:.3f}"
                  f" bpp={hist['bpp'][-1]:.3f}"
                  f" comm={led['cumulative_total_mb']:.3f}MB", file=err)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--k", type=int, default=10, help="clients")
    ap.add_argument("--c", type=int, default=2, help="classes a client")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.rounds, a.k, a.c, a.device)
