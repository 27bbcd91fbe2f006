"""Model dispatcher: family -> (init, forward, loss).

`forward(params, batch)` takes a params tree whose maskable leaves are
plain tensors or `masking.MaskedLeaf` bundles (the fused path); the
`layers.masked_dense_apply` / `masked_grouped_apply` dispatch decides
per leaf.  The dense and MoE transformer families are ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable        # (generator) -> params on its device
    forward: Callable            # (params, batch) -> (logits, aux)
    loss: Callable               # (outputs, batch) -> scalar


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense and "
            f"moe only)")

    def fwd(params, batch):
        if "vis_embeds" in batch:
            raise NotImplementedError("VLM inputs are not ported yet")
        return transformer.forward(params, cfg, batch["tokens"])

    return ModelApi(cfg, lambda gen: transformer.init_params(gen, cfg), fwd,
                    transformer.lm_loss)
