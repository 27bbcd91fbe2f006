"""The paper's own experiment models (`repro.models.cnn`): the Conv4 /
Conv6 / Conv10 feed-forward CNNs of Zhou et al. and Ramanujan et al.,
on (B, H, W, C) images.  Every conv and dense kernel is maskable; the
biases stay float.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.models import layers as L

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    name: str
    conv_planes: Tuple[int, ...]   # channels per conv; pool after each pair
    dense_sizes: Tuple[int, ...]
    n_classes: int = 10
    in_channels: int = 3
    img_size: int = 32


CONV4 = ConvConfig("conv4", (64, 64, 128, 128), (256, 256))
CONV6 = ConvConfig("conv6", (64, 64, 128, 128, 256, 256), (256, 256))
CONV10 = ConvConfig("conv10",
                    (64, 64, 128, 128, 256, 256, 512, 512, 512, 512),
                    (256, 256))


def init_params(gen: torch.Generator, cfg: ConvConfig) -> Pytree:
    """{"convs": [{"w_conv" (3, 3, ci, co) bf16, "bias"}], "denses":
    [{"w_dense" (din, dout) bf16, "bias"}]} on `gen`'s device: normal
    weights of std 1/sqrt(fan_in) (3*3*ci for a conv), zero f32 biases."""
    dev = gen.device
    params = {"convs": [], "denses": []}
    cin = cfg.in_channels
    for cout in cfg.conv_planes:
        params["convs"].append({
            "w_conv": L.dense_init(gen, (3, 3, cin, cout), fan_in=9 * cin),
            "bias": torch.zeros((cout,), dtype=torch.float32, device=dev)})
        cin = cout
    side = cfg.img_size // (2 ** (len(cfg.conv_planes) // 2))
    din = side * side * cin
    for dout in cfg.dense_sizes + (cfg.n_classes,):
        params["denses"].append({
            "w_dense": L.dense_init(gen, (din, dout), fan_in=din),
            "bias": torch.zeros((dout,), dtype=torch.float32, device=dev)})
        din = dout
    return params


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID (an odd last row or column drops)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def forward(params: Pytree, cfg: ConvConfig, images: torch.Tensor
            ) -> torch.Tensor:
    """images (B, H, W, C) -> f32 logits (B, n_classes).  A conv kernel
    that is a `MaskedLeaf` runs one fused masked dense over its im2col
    (`layers.masked_conv2d_apply`), a plain one a conv."""
    x = images.float()
    for i, cp in enumerate(params["convs"]):
        x = torch.relu(L.masked_conv2d_apply(x, cp["w_conv"]) + cp["bias"])
        if i % 2 == 1:
            x = _max_pool2(x)
    x = x.reshape(x.shape[0], -1)
    n = len(params["denses"])
    for j, dp in enumerate(params["denses"]):
        x = L.masked_dense_apply(x, dp["w_dense"]) + dp["bias"]
        if j < n - 1:
            x = torch.relu(x)
    return x


def ce_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, batch["labels"].long()[:, None]).mean()


def accuracy(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    return (torch.argmax(logits, -1) == batch["labels"]).float().mean()
