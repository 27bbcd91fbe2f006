"""Model dispatcher: family -> (init, forward, loss).

`forward(params, batch)` takes a params tree whose maskable leaves are
plain tensors or `masking.MaskedLeaf` bundles (the fused path); the
`layers.masked_dense_apply` / `masked_grouped_apply` /
`masked_conv1d_apply` dispatch decides per leaf.  Ported so far: the
dense and MoE transformers, the ssm family (mamba2) and the hybrid
family (recurrentgemma), their training forwards; every family's loss
is `transformer.lm_loss`.  KV-cache decoding (`init_cache`,
`decode_step`) is ported for the dense and MoE transformers; the ssm and
hybrid decode steps raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, ssm, transformer


def _decode_not_ported(cfg: ArchConfig) -> Callable:
    def fail(*args, **kwargs):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's decode step is not "
            f"ported yet (ROADMAP Queue 1 item 1)")
    return fail


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable        # (generator) -> params on its device
    forward: Callable            # (params, batch) -> (logits, aux)
    loss: Callable               # (outputs, batch) -> scalar
    init_cache: Callable         # (batch, max_seq, device) -> cache
    decode_step: Callable        # (params, cache, token, pos) -> logits,
    #                              cache


_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm,
             "hybrid": hybrid}


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense, moe, "
            f"ssm and hybrid only)")
    mod = _FAMILIES[cfg.family]

    def fwd(params, batch):
        if "vis_embeds" in batch:
            raise NotImplementedError("VLM inputs are not ported yet")
        return mod.forward(params, cfg, batch["tokens"])

    if mod is transformer:
        init_cache = lambda b, s, device: transformer.init_cache(
            cfg, b, s, device)
        decode = lambda params, cache, token, pos: transformer.decode_step(
            params, cfg, cache, token, pos)
    else:
        init_cache = decode = _decode_not_ported(cfg)
    return ModelApi(cfg, lambda gen: mod.init_params(gen, cfg), fwd,
                    transformer.lm_loss, init_cache, decode)
