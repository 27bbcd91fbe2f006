"""Synthetic, learnable datasets (`repro.data.synthetic`); the paper's
MNIST/CIFAR are stood in for by class-prototype images.

* `make_image_task`: class prototypes are low-frequency random fields
  (8x8 normal fields upsampled bilinearly), a sample is its class's
  prototype plus per-sample noise; `proto_scale` and `noise` set the
  difficulty.  The draws come from a `torch.Generator`;
  `image_task_from_draws` builds the task from given draws (the
  reference's threefry draws cannot be reproduced, so its tests inject
  them).
* `federated_batches`: the (K, H, B, ...) round tensor of K clients' H
  local batches.
* `make_lm_stream`: a Zipf unigram stream mixed half-and-half with the
  deterministic bigram drift next = (prev*7 + 3) mod V, from a numpy
  seed; it matches the reference statistically, not token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ImageTask:
    x: torch.Tensor       # (N, H, W, C) float32
    y: torch.Tensor       # (N,) int64 labels
    n_classes: int


def image_task_from_draws(small: torch.Tensor, labels: torch.Tensor,
                          normals: torch.Tensor, noise: float = 0.6
                          ) -> ImageTask:
    """The task from its draws: `small` (n_classes, 8, 8, C) prototype
    fields (already times proto_scale), `labels` (N,), `normals`
    (N, img, img, C).  The fields are upsampled with half-pixel centres
    and clamped edges, which is what `jax.image.resize(..., "bilinear")`
    computes when it upsamples."""
    n_classes = small.shape[0]
    img = normals.shape[1]
    protos = F.interpolate(small.float().permute(0, 3, 1, 2), size=(img, img),
                           mode="bilinear", align_corners=False,
                           antialias=False).permute(0, 2, 3, 1)
    labels = labels.long()
    xs = protos[labels] + noise * normals.float()
    return ImageTask(xs.contiguous(), labels, n_classes)


def make_image_task(gen: torch.Generator, n: int = 4096, img: int = 32,
                    channels: int = 3, n_classes: int = 10,
                    proto_scale: float = 1.0, noise: float = 0.6
                    ) -> ImageTask:
    """N class-prototype images on `gen`'s device."""
    dev = gen.device
    small = torch.randn((n_classes, 8, 8, channels), generator=gen,
                        device=dev) * proto_scale
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    normals = torch.randn((n, img, img, channels), generator=gen, device=dev)
    return image_task_from_draws(small, labels, normals, noise)


def federated_batches(gen: Optional[torch.Generator], task: ImageTask,
                      client_idx: Sequence[np.ndarray], n_clients: int,
                      local_steps: int, batch_size: int,
                      picks: Optional[Sequence] = None) -> dict:
    """{"images": (K, H, B, ...), "labels": (K, H, B)}: client i's H*B
    samples are `client_idx[i][pick]`, the picks drawn from `gen`
    (without replacement, with it when the client holds fewer than H*B
    samples) or given as `picks` (one index vector per client)."""
    dev = task.x.device
    need = local_steps * batch_size
    xs, ys = [], []
    for i in range(n_clients):
        idx = torch.as_tensor(np.asarray(client_idx[i]), dtype=torch.int64,
                              device=dev)
        if picks is not None:
            pick = torch.as_tensor(np.array(picks[i]), dtype=torch.int64,
                                   device=dev)
        elif idx.shape[0] < need:
            pick = torch.randint(0, idx.shape[0], (need,), generator=gen,
                                 device=dev)
        else:
            pick = torch.randperm(idx.shape[0], generator=gen,
                                  device=dev)[:need]
        sel = idx[pick]
        xs.append(task.x[sel].reshape(local_steps, batch_size,
                                      *task.x.shape[1:]))
        ys.append(task.y[sel].reshape(local_steps, batch_size))
    return {"images": torch.stack(xs), "labels": torch.stack(ys)}


def make_lm_stream(seed: int, n_tokens: int, vocab: int, device,
                   alpha: float = 1.2) -> torch.Tensor:
    """(n_tokens,) int64 token ids on `device`."""
    rng = np.random.default_rng(seed)
    probs = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    z = rng.choice(vocab, size=n_tokens, p=probs / probs.sum())
    mix = rng.random(n_tokens) < 0.5
    out = np.empty(n_tokens, dtype=np.int64)
    prev = 0
    for i, (zi, mi) in enumerate(zip(z.tolist(), mix.tolist())):
        prev = (prev * 7 + 3) % vocab if mi else zi
        out[i] = prev
    return torch.from_numpy(out).to(device)
