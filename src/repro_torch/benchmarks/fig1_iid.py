"""Paper Fig. 1 (`benchmarks/fig1_iid.py` of the JAX package): IID
validation accuracy and average Bpp against rounds, FedPM against
FedPM + regularization (lambda 1 and 4), on three datasets, with the
CommLedger's cumulative two-way traffic (accuracy against MB).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_iid [--rounds N]
        [--k K] [--device cuda|cpu] [--datasets mnist-like ...]

Prints CSV: dataset,algo,round,acc,bpp,bpp_measured,sparsity,cum_mb, and a
summary on stderr.  It runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.benchmarks import common
from repro_torch.launch.train import resolve_device

DATASETS = ("mnist-like", "cifar10-like", "cifar100-like")
VARIANTS = (("fedpm", "fedpm", {}),
            ("fedpm_reg", "fedpm+reg", dict(lam=1.0)),
            ("fedpm_reg", "fedpm+reg4", dict(lam=4.0)))


def main(rounds: int = 12, k: int = 10, datasets=None, device="cuda",
         out=sys.stdout, err=sys.stderr) -> dict:
    """Runs the grid and returns {dataset: {variant: final acc, bpp and
    ledger}}."""
    device = resolve_device(str(device))   # no card: raise before output
    # the reference's convs and products are full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    datasets = datasets or DATASETS
    print("dataset,algo,round,acc,bpp,bpp_measured,sparsity,cum_mb",
          file=out)
    summary = []
    for ds in datasets:
        setup = common.make_setup(ds, k=k, c=None, device=device)
        # both variants resolve through the registry: "fedpm" is the
        # lam = 0 reference, "fedpm_reg" the paper's method
        for algo, name, kw in VARIANTS:
            hist, _ = common.run_algorithm(setup, algo, rounds, lr=0.1,
                                           optimizer="adam",
                                           float_lr=1e-3, **kw)
            for r in range(rounds):
                cum = (hist["cumulative_uplink_mb"][r]
                       + hist["cumulative_downlink_mb"][r])
                print(f"{ds},{name},{r},{hist['acc'][r]:.4f},"
                      f"{hist['bpp'][r]:.4f},"
                      f"{hist['bpp_measured'][r]:.4f},"
                      f"{hist['sparsity'][r]:.4f},{cum:.4f}", file=out)
            summary.append((ds, name, hist["acc"][-1], hist["bpp"][-1],
                            hist["ledger"]))
    print("# summary: dataset algo final_acc final_bpp cum_mb", file=err)
    gains = {}
    for ds, name, acc, bpp, ledger in summary:
        print(f"# {ds:14s} {name:10s} acc={acc:.3f} bpp={bpp:.3f} "
              f"up={ledger['cumulative_uplink_mb']:.3f}MB "
              f"down={ledger['cumulative_downlink_mb']:.3f}MB", file=err)
        gains.setdefault(ds, {})[name] = dict(acc=acc, bpp=bpp, **ledger)
    for ds, g in gains.items():
        for variant in ("fedpm+reg", "fedpm+reg4"):
            if variant in g and "fedpm" in g:
                dbpp = g["fedpm"]["bpp"] - g[variant]["bpp"]
                dacc = g["fedpm"]["acc"] - g[variant]["acc"]
                print(f"# {ds} {variant}: Bpp saved={dbpp:+.3f}, "
                      f"acc delta={-dacc:+.3f} (paper trend: reg saves "
                      "Bpp at ~0 acc cost; grows with rounds/lambda)",
                      file=err)
    return gains


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--k", type=int, default=10, help="clients")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--datasets", nargs="+", choices=DATASETS,
                    default=list(DATASETS))
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.rounds, a.k, a.datasets, a.device)
