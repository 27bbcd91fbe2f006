"""Shared benchmark scaffolding (`benchmarks/common.py` of the JAX
package): the paper's experimental grid on the synthetic image tasks,
reduced in width and image size by default so a whole figure runs in
minutes.  Every setup lives on one device: the card by default, the CPU
when the caller passes device="cpu"."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import masking
from repro_torch.data import partition, synthetic
from repro_torch.launch.train import resolve_device
from repro_torch.models import cnn

SPEC = masking.MaskSpec()


def make_setup(dataset: str, k: int, c: int | None, seed: int = 0,
               n: int = 1024, device="cuda") -> dict:
    """dataset in {mnist-like, cifar10-like, cifar100-like}: the
    difficulty is emulated by the prototype scale and the noise, the
    model is the paper's ConvN (Sec. IV) at reduced widths.  The task and
    the template params are drawn from a generator seeded with `seed` on
    `device`; the partition from numpy's `default_rng(seed)`."""
    dev = resolve_device(str(device))
    gen = torch.Generator(dev).manual_seed(seed)
    if dataset == "mnist-like":
        cfg = cnn.ConvConfig("conv4", (16, 16, 32, 32), (64,),
                             n_classes=10, img_size=16, in_channels=1)
        task = synthetic.make_image_task(gen, n=n, img=16, channels=1,
                                         proto_scale=1.4, noise=0.45)
    elif dataset == "cifar10-like":
        cfg = cnn.ConvConfig("conv6", (16, 16, 32, 32, 64, 64), (64,),
                             n_classes=10, img_size=16)
        task = synthetic.make_image_task(gen, n=n, img=16,
                                         proto_scale=1.0, noise=0.7)
    elif dataset == "cifar100-like":
        cfg = cnn.ConvConfig("conv10",
                             (16, 16, 32, 32, 64, 64, 64, 64, 64, 64),
                             (64,), n_classes=20, img_size=16)
        task = synthetic.make_image_task(gen, n=n, img=16, n_classes=20,
                                         proto_scale=1.0, noise=0.7)
    else:
        raise ValueError(dataset)
    return setup_from(cfg, task, k, c, seed, gen)


def setup_from(cfg: cnn.ConvConfig, task: synthetic.ImageTask, k: int,
               c: int | None, seed: int, gen: torch.Generator) -> dict:
    """The setup dict of `make_setup` for a given model and task: the
    IID (c None) or by-class partition, the template params from `gen`,
    the model's functions and the test batch (the first 512 samples)."""
    rng = np.random.default_rng(seed)
    labels = task.y.cpu().numpy()
    if c is None:
        cidx = partition.partition_iid(rng, labels, k)
    else:
        cidx = partition.partition_by_class(rng, labels, k, c)
    params = cnn.init_params(gen, cfg)
    m = min(512, task.x.shape[0])
    return dict(cfg=cfg, task=task, cidx=cidx, params=params,
                apply_fn=lambda p, b: cnn.forward(p, cfg, b["images"]),
                loss_fn=cnn.ce_loss, metric_fn=cnn.accuracy,
                test={"images": task.x[:m], "labels": task.y[:m]}, k=k,
                device=task.x.device)


def run_algorithm(setup: dict, name: str, rounds: int, *, local_steps=3,
                  batch=32, seed=0, participation=None, eval_samples=2,
                  codec=None, **algo_kw):
    """Sweep a registered algorithm by name through the round engine.
    Returns (history, final state): per-round lists of `acc`, `bpp` (the
    eq. 13 entropy bound), `bpp_measured` (the codec's wire rate),
    `sparsity`, `loss` and the CommLedger's `cumulative_uplink_mb` /
    `cumulative_downlink_mb` (the paper's accuracy-against-communication
    axis), and the final ledger as `history["ledger"]`.  Every draw of
    the run (init, batches, masks, downlink) comes from one generator
    seeded with `seed` on the setup's device."""
    dev = setup["device"]
    gen = torch.Generator(dev).manual_seed(seed)
    algo = api.get_algorithm(name, setup["apply_fn"], setup["loss_fn"],
                             spec=SPEC, local_steps=local_steps,
                             codec=codec, **algo_kw)
    st = algo.init(gen, setup["params"])
    sizes = torch.tensor([len(ci) for ci in setup["cidx"]],
                         dtype=torch.float32, device=dev)
    ledger = api.CommLedger()
    hist = {"acc": [], "bpp": [], "bpp_measured": [], "sparsity": [],
            "loss": [], "cumulative_uplink_mb": [],
            "cumulative_downlink_mb": []}
    for r in range(rounds):
        data = synthetic.federated_batches(
            gen, setup["task"], setup["cidx"], setup["k"], local_steps,
            batch)
        part = (torch.ones(setup["k"], dtype=torch.bool, device=dev)
                if participation is None else participation(r))
        st, m = algo.round(st, data, part, sizes, gen)
        ledger.update(m)
        hist["bpp"].append(float(m["uplink_bpp"]))
        hist["bpp_measured"].append(float(m["uplink_bpp_measured"]))
        hist["sparsity"].append(float(m.get("sparsity", 0.0)))
        hist["loss"].append(float(m["loss"]))
        hist["cumulative_uplink_mb"].append(ledger.uplink_mb)
        hist["cumulative_downlink_mb"].append(ledger.downlink_mb)
        hist["acc"].append(float(api.evaluate(
            algo, st, setup["test"], setup["apply_fn"], setup["metric_fn"],
            gen, n_samples=eval_samples)))
    hist["ledger"] = ledger.as_dict()
    return hist, st


def run_fedpm_variant(setup: dict, lam: float, rounds: int, local_steps=3,
                      batch=32, lr=0.1, seed=0, participation=None):
    """The paper's method at one lambda (lam = 0 is the FedPM
    reference): adam on the scores at `lr`, 1e-3 on the floats."""
    return run_algorithm(setup, "fedpm_reg", rounds,
                         local_steps=local_steps, batch=batch, seed=seed,
                         participation=participation, lam=lam, lr=lr,
                         optimizer="adam", float_lr=1e-3)


def run_baseline(setup: dict, algo, rounds: int, local_steps=3, batch=32,
                 seed=0):
    """The legacy entry: sweep an already-built `FedAlgorithm` with every
    client in every round; per-round `acc` (of `eval_params` once),
    `bpp` and `loss`, and the final state.  The draws come from one
    generator seeded with `seed` on the setup's device."""
    dev = setup["device"]
    gen = torch.Generator(dev).manual_seed(seed)
    st = algo.init(gen, setup["params"])
    sizes = torch.tensor([len(ci) for ci in setup["cidx"]],
                         dtype=torch.float32, device=dev)
    part = torch.ones(setup["k"], dtype=torch.bool, device=dev)
    hist = {"acc": [], "bpp": [], "loss": []}
    for _ in range(rounds):
        data = synthetic.federated_batches(
            gen, setup["task"], setup["cidx"], setup["k"], local_steps,
            batch)
        st, m = algo.round(st, data, part, sizes, gen)
        hist["bpp"].append(float(m["uplink_bpp"]))
        hist["loss"].append(float(m["loss"]))
        with torch.no_grad():
            out = setup["apply_fn"](algo.eval_params(st, gen), setup["test"])
            hist["acc"].append(float(setup["metric_fn"](out, setup["test"])))
    return hist, st
