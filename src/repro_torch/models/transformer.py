"""Decoder-only transformer, dense family (the dense part of
`repro.models.transformer`).

Layers are stacked along a leading L axis, as in the reference; the
reference's `lax.scan` over the stack is a Python loop here, and layer l
runs on block l of every leaf (a `MaskedLeaf` block carries that
layer's seed and its flat-stream offset l*K*N).  MoE, MLA and VLM
branches are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf
from repro_torch.models import layers as L

Pytree = Any


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or cfg.kv_lora_rank \
            or cfg.sliding_window or cfg.attn_soft_cap or cfg.norm != "rms" \
            or cfg.act != "silu" or cfg.qkv_bias:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA transformer with a gated "
            f"SiLU MLP is ported (no MoE, MLA, VLM, sliding window, soft "
            f"cap or qkv bias yet)")


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device; layer leaves are (L, ...)."""
    _check_dense(cfg)
    Lyr, d = cfg.n_layers, cfg.d_model
    dev = gen.device
    params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, d))},
        "final_norm": L.rms_norm_init(d, dev),
        "layers": {
            "attn_norm": L.rms_norm_init(d, dev, (Lyr,)),
            "ffn_norm": L.rms_norm_init(d, dev, (Lyr,)),
            "attn": L.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               lead=(Lyr,)),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, lead=(Lyr,)),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": L.embed_init(gen, (cfg.vocab, d))}
    return params


def layer_slice(stacked: Pytree, l: int) -> Pytree:
    """Layer l of a stacked layer tree (plain tensors and MaskedLeafs)."""
    return tu.tree_map(
        lambda a: a.block(l) if isinstance(a, MaskedLeaf) else a[l], stacked)


def _block(cfg: ArchConfig, x, lp, positions, theta):
    h = L.rms_norm(lp["attn_norm"], x)
    attn_out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                              cfg.n_kv_heads, cfg.hd, rope_theta=theta)
    x = x + attn_out
    h = L.rms_norm(lp["ffn_norm"], x)
    return x + L.mlp_apply(lp["mlp"], h)


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits f32 (B, S, V), aux_loss)."""
    _check_dense(cfg)
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    theta = cfg.rope_theta_global or cfg.rope_theta
    n = tu.leaves(params["layers"])[0]
    n = n.w.shape[0] if isinstance(n, MaskedLeaf) else n.shape[0]
    for l in range(n):
        x = _block(cfg, x, layer_slice(params["layers"], l), positions,
                   theta)
    x = L.rms_norm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])["table"]
    return L.unembed(head, x), torch.zeros((), device=x.device)


def lm_loss(outputs, batch):
    """Next-token cross entropy. outputs = (logits, aux)."""
    logits, aux = outputs[0], outputs[1]
    tokens = batch["tokens"]
    logits = logits[:, -tokens.shape[1]:]
    lg = logits[:, :-1].float()
    tgt = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    at = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return torch.mean(lse - at) + 0.01 * aux
