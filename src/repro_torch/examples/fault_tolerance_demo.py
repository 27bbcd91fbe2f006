"""Fault-tolerance demo: 30% of the clients fail every round, pods go
down together, stragglers are cut, and the coordinator crashes and
restores from a checkpoint mid-run; training goes on (the weighted mask
mean renormalizes over the survivors).

    python -m repro_torch.examples.fault_tolerance_demo [--device cpu]

The failures are the counter-hash draws of `runtime.fault` keyed by
(seed, round); every other draw comes from one generator seeded with 0
on the device.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.core import federated, masking
from repro_torch.core import tree as tu
from repro_torch.data import partition, synthetic
from repro_torch.launch.train import resolve_device
from repro_torch.models import cnn
from repro_torch.runtime import fault

CRASH_AFTER = 4               # the round whose end is checkpointed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ft_demo_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def _same(a, b) -> bool:
    la, lb = tu.leaves(a), tu.leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (
            isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and x.device == y.device and torch.equal(x, y))
        or (not isinstance(x, torch.Tensor) and x == y)
        for x, y in zip(la, lb))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(0)
    cfg = cnn.ConvConfig("ftdemo", (8, 8), (32,), n_classes=4, img_size=8)
    task = synthetic.make_image_task(gen, n=512, img=8, n_classes=4,
                                     noise=0.35)
    K = 8
    cidx = partition.partition_iid(np.random.default_rng(0),
                                   task.y.cpu().numpy(), K)
    params = cnn.init_params(gen, cfg)
    spec = masking.MaskSpec()
    server = federated.init_server(gen, params, spec)

    apply_fn = lambda p, b: cnn.forward(p, cfg, b["images"])  # noqa: E731
    fc = federated.FedConfig(lam=0.5, local_steps=2, lr=0.1,
                             optimizer="adam")
    round_fn = federated.make_round_fn(apply_fn, cnn.ce_loss, fc)
    eval_fn = federated.make_eval_fn(apply_fn, cnn.accuracy, n_samples=2)
    sizes = torch.tensor([len(c) for c in cidx], dtype=torch.float32,
                         device=dev)
    test = {"images": task.x[:256], "labels": task.y[:256]}

    sim = fault.FaultSimulator(K, fail_prob=0.3, pod_size=4,
                               pod_outage_prob=0.05, seed=7)
    pol = fault.StragglerPolicy(quorum_frac=0.75)

    out = {"accs": [], "alive": [], "restored_equal": None}
    for r in range(args.rounds):
        data = synthetic.federated_batches(gen, task, cidx, K, 2, 32)
        alive = fault.participation_vector(sim, K, pol, device=dev)
        server, m = round_fn(server, data, alive, sizes, gen)
        acc = eval_fn(server, test, gen)
        out["accs"].append(float(acc))
        out["alive"].append(int(alive.sum()))
        print(f"round {r}: alive={int(alive.sum())}/{K} "
              f"loss={float(m['loss']):.3f} acc={float(acc):.3f} "
              f"bpp={float(m['uplink_bpp']):.3f}")
        if r == CRASH_AFTER:
            ckpt.save_checkpoint(args.ckpt_dir, r, server._asdict())
            print("  -- checkpoint saved; simulating coordinator crash"
                  " + restore --")
            restored, step = ckpt.restore_checkpoint(args.ckpt_dir,
                                                     server._asdict())
            out["restored_equal"] = (step == r
                                     and _same(restored, server._asdict()))
            server = federated.ServerState(**{
                k: restored[k] for k in server._asdict()})
    print(f"survived {args.rounds} rounds with failures; final accuracy "
          f"above.")
    return out


if __name__ == "__main__":
    main()
