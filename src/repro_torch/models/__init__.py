"""Model dispatcher: family -> (init, forward, loss, cache, decode).

`forward(params, batch, chunk_kv=None)` takes a params tree whose
maskable leaves are plain tensors or `masking.MaskedLeaf` bundles (the
fused path), and runs attention over KV chunks of `chunk_kv` keys when
set (the ssm family has none and ignores it); the
`layers.masked_dense_apply` / `masked_grouped_apply` /
`masked_conv1d_apply` dispatch decides per leaf.  Every family of the
reference's LM zoo is ported, with its training forward and its decode
step: the dense and MoE transformers (gemma3's sliding windows, qwen2's
qkv bias), the VLM (qwen2-vl: a batch's "vis_embeds" prepended, M-RoPE),
the encoder-decoder (whisper: a batch's "frames", zeros when absent), the
ssm family (mamba2) and the hybrid family (recurrentgemma).  Every
family's loss is `transformer.lm_loss`, which scores the text tail.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, ssm, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """One family's entry points for `cfg`.

    The decode cache convention, the same for every family:
    `init_cache(batch, max_seq, device)` makes a dict of zeroed tensors
    (KV caches, ring caches with their key positions, recurrent states,
    conv buffers), and `decode_step(params, cache, token, pos)` writes
    this token's entries into those tensors in place and returns
    (logits f32 (B, V), the same cache).  token: (B,) int; pos: an int
    or a 0-d integer tensor (batched under `torch.func.vmap`, as the
    lockstep serve step runs it), never read back to the host."""
    cfg: ArchConfig
    init_params: Callable        # (generator) -> params on its device
    forward: Callable            # (params, batch, chunk_kv=None) ->
    #                              (logits, aux)
    loss: Callable               # (outputs, batch) -> scalar
    init_cache: Callable         # (batch, max_seq, device) -> cache
    decode_step: Callable        # (params, cache, token, pos) -> logits,
    #                              cache


_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": ssm, "hybrid": hybrid, "encdec": encdec}


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    mod = _FAMILIES[cfg.family]

    def fwd(params, batch, chunk_kv=None):
        if mod is transformer:
            return mod.forward(params, cfg, batch["tokens"],
                               vis_embeds=batch.get("vis_embeds"),
                               chunk_kv=chunk_kv)
        if mod is encdec:
            return mod.forward(params, cfg, batch["tokens"],
                               frames=batch.get("frames"), chunk_kv=chunk_kv)
        return mod.forward(params, cfg, batch["tokens"], chunk_kv=chunk_kv)

    init_cache, decode = mod.init_cache, mod.decode_step
    if mod is transformer and transformer.windowed(cfg):
        init_cache = transformer.init_cache_windowed
        decode = transformer.decode_step_windowed
    return ModelApi(
        cfg, lambda gen: mod.init_params(gen, cfg), fwd, transformer.lm_loss,
        lambda b, s, device: init_cache(cfg, b, s, device),
        lambda params, cache, token, pos: decode(params, cfg, cache, token,
                                                 pos))
