"""Quickstart: federated mask-training (the paper's method) on a tiny
CNN and a synthetic task, end to end in seconds.

Algorithms are resolved by name from the `repro_torch.api` registry;
swap "fedpm_reg" for any of `api.available()` (fedpm, fedmask, topk,
mv_signsgd, fedavg) and the same loop runs.  The round engine does all
the communication accounting: `uplink_bpp` is the eq. 13 entropy bound,
`uplink_bpp_measured` what the chosen wire codec (--codec) costs, and
the CommLedger adds up two-way MB across the run.  At the end the final
mask payload is serialized through the codec and decoded back, and the
run fails unless every bit comes back.

    python -m repro_torch.examples.quickstart --codec arithmetic \\
        [--rounds 8] [--device cpu]

Every draw (task, init, batches, masks) comes from one generator seeded
with 0 on the device; the partition from numpy's `default_rng(0)`.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import api, ckpt
from repro_torch.api import codecs
from repro_torch.core import federated, masking
from repro_torch.core import tree as tu
from repro_torch.data import partition, synthetic
from repro_torch.launch.train import resolve_device
from repro_torch.models import cnn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default=None,
                    choices=[c for c in codecs.available()
                             if c != "float32"],
                    help="wire codec for the mask uplink "
                         "(default: the payload's own, arithmetic)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "quickstart_artifact.npz"),
        help="where the artifact is written")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(0)
    cfg = cnn.ConvConfig("quick", (8, 8), (32,), n_classes=4, img_size=8)
    task = synthetic.make_image_task(gen, n=512, img=8, n_classes=4,
                                     noise=0.35)
    K = 4
    cidx = partition.partition_iid(np.random.default_rng(0),
                                   task.y.cpu().numpy(), K)

    params = cnn.init_params(gen, cfg)
    apply_fn = lambda p, b: cnn.forward(p, cfg, b["images"])  # noqa: E731

    algo = api.get_algorithm("fedpm_reg", apply_fn, cnn.ce_loss,
                             spec=masking.MaskSpec(), lam=1.0,
                             local_steps=2, lr=0.1, optimizer="adam",
                             codec=args.codec)
    print(f"{algo.name}: {algo.payload_spec.description} "
          f"[codec={algo.codec.name}]")
    server = algo.init(gen, params)

    sizes = torch.tensor([len(c) for c in cidx], dtype=torch.float32,
                         device=dev)
    part = torch.ones((K,), dtype=torch.bool, device=dev)
    test = {"images": task.x[:256], "labels": task.y[:256]}
    ledger = api.CommLedger()

    for r in range(args.rounds):
        data = synthetic.federated_batches(gen, task, cidx, K, 2, 32)
        server, m = algo.round(server, data, part, sizes, gen)
        ledger.update(m)
        acc = api.evaluate(algo, server, test, apply_fn, cnn.accuracy, gen,
                           n_samples=2)
        print(f"round {r}: loss={float(m['loss']):.3f} "
              f"uplink={float(m['uplink_bpp']):.3f} Bpp "
              f"(wire {float(m['uplink_bpp_measured']):.3f}) "
              f"downlink={float(m['downlink_bpp']):.2f} Bpp "
              f"sparsity={float(m['sparsity']):.2f} "
              f"acc={float(acc):.3f} cum={ledger.total_mb:.3f}MB")

    # the deployable artifact: a seed + bit-packed masks (~n/8 bytes)
    art = federated.final_artifact(server, gen)
    size = ckpt.save_artifact(args.out, art)
    n = sum(int(np.prod(sh)) for _, (w, sh) in art["masks"].items())
    print(f"artifact: {size} bytes for {n} masked params "
          f"({8 * size / n:.2f} bits/param incl. float leaves)")

    # real wire serialization: the final mask payload through the codec
    scores = masking.scores_from_theta(server.theta)
    mask = masking.final_mask(
        masking.MaskedParams(server.weights, scores, server.floats), gen)
    payload = api.BitpackedMasks.from_masks(mask)
    msg = algo.codec.encode(payload)
    back = algo.codec.decode(msg)
    # the decoded payload lies on the host
    exact = all(
        (a is None and b is None) or (
            a is not None and b is not None
            and torch.equal(a.cpu(), b.cpu()))
        for a, b in zip(tu.leaves(payload.to_masks()),
                        tu.leaves(back.to_masks())))
    print(f"wire[{algo.codec.name}]: {msg.wire_bits // 8} bytes "
          f"({msg.wire_bits / n:.3f} Bpp measured, "
          f"{float(payload.bpp()):.3f} entropy bound), "
          f"decode exact={exact}")
    if not exact:
        raise SystemExit("codec round-trip failed")
    return {"exact": exact, "artifact_bytes": size, "masked_params": n,
            "wire_bits": msg.wire_bits, "ledger_mb": ledger.total_mb}


if __name__ == "__main__":
    main()
