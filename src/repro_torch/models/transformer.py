"""Decoder-only transformer, dense and MoE families (the dense and
MLA/MoE parts of `repro.models.transformer`).

Layers are stacked along a leading L axis, as in the reference: the
first `first_dense_layers` layers (all of them without experts) under
params["layers"], the MoE layers under params["moe_layers"].  The
reference's `lax.scan` over each stack is a Python loop here, and layer
l runs on block l of every leaf (a `MaskedLeaf` block carries that
layer's seeds and flat-stream offsets).  The VLM branch, sliding
windows, soft caps and block-local MoE dispatch are not ported yet and
raise.

`decode_step` is one token of KV-cache decoding over a frozen (plain)
or masked params tree; `init_cache` makes the bf16 cache, (L, B, S, ...)
per stack as in the reference, and `decode_step` writes each layer's new
keys and values into it in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf
from repro_torch.models import layers as L

Pytree = Any


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.sliding_window \
            or cfg.attn_soft_cap or cfg.norm != "rms" or cfg.act != "silu" \
            or cfg.qkv_bias or cfg.moe_block_dispatch:
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE transformers with GQA or "
            f"MLA attention and gated SiLU MLPs are ported (no VLM, "
            f"sliding window, soft cap, qkv bias or block dispatch yet)")


def _stack_init(gen: torch.Generator, cfg: ArchConfig, n: int, moe: bool):
    d, lead = cfg.d_model, (n,)
    p = {"attn_norm": L.rms_norm_init(d, gen.device, lead),
         "ffn_norm": L.rms_norm_init(d, gen.device, lead)}
    if cfg.kv_lora_rank:
        p["attn"] = L.mla_init(gen, d, cfg.n_heads, cfg.kv_lora_rank,
                               cfg.q_lora_rank, cfg.qk_nope_dim,
                               cfg.qk_rope_dim, cfg.v_head_dim, lead=lead)
    else:
        p["attn"] = L.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               lead=lead)
    if moe:
        p["moe"] = L.moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts,
                              cfg.n_shared_experts, lead=lead)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, lead=lead)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device; layer leaves are (L, ...)."""
    _check_ported(cfg)
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    n_dense = cfg.n_layers - n_moe
    params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, cfg.d_model))},
        "final_norm": L.rms_norm_init(cfg.d_model, gen.device),
    }
    if n_dense:
        params["layers"] = _stack_init(gen, cfg, n_dense, moe=False)
    if n_moe:
        params["moe_layers"] = _stack_init(gen, cfg, n_moe, moe=True)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": L.embed_init(gen, (cfg.vocab,
                                                          cfg.d_model))}
    return params


def layer_slice(stacked: Pytree, l: int) -> Pytree:
    """Layer l of a stacked layer tree (plain tensors and MaskedLeafs)."""
    return tu.tree_map(
        lambda a: a.block(l) if isinstance(a, MaskedLeaf) else a[l], stacked)


def depth(stacked: Pytree) -> int:
    a = tu.leaves(stacked)[0]
    return (a.w if isinstance(a, MaskedLeaf) else a).shape[0]


def _block(cfg: ArchConfig, moe: bool, x, lp, positions, theta):
    """One layer; returns (x, aux)."""
    h = L.rms_norm(lp["attn_norm"], x)
    if cfg.kv_lora_rank:
        attn_out, _ = L.mla_apply(lp["attn"], h, positions, cfg.n_heads,
                                  cfg.kv_lora_rank, cfg.qk_nope_dim,
                                  cfg.qk_rope_dim, cfg.v_head_dim,
                                  rope_theta=cfg.rope_theta)
    else:
        attn_out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd, rope_theta=theta)
    x = x + attn_out
    h = L.rms_norm(lp["ffn_norm"], x)
    if moe:
        ffn_out, aux = L.moe_apply(lp["moe"], h, cfg.n_experts, cfg.top_k,
                                   cfg.capacity_factor)
        return x + ffn_out, aux
    return x + L.mlp_apply(lp["mlp"], h), 0.0


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits f32 (B, S, V), summed MoE aux loss)."""
    _check_ported(cfg)
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    theta = cfg.rope_theta_global or cfg.rope_theta
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, moe in (("layers", False), ("moe_layers", True)):
        if key not in params:
            continue
        for l in range(depth(params[key])):
            x, aux = _block(cfg, moe, x, layer_slice(params[key], l),
                            positions, theta)
            aux_total = aux_total + aux
    x = L.rms_norm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])["table"]
    return L.unembed(head, x), aux_total


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


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def _check_decode(cfg: ArchConfig) -> None:
    if cfg.window_kv_cache and cfg.sliding_window and cfg.global_every:
        raise NotImplementedError(
            f"{cfg.name}: windowed decode over ring caches is not ported "
            f"yet (ROADMAP Queue 1 item 5)")
    _check_ported(cfg)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               dtype=torch.bfloat16) -> Pytree:
    """Zeroed KV cache: per stack ("dense", "moe") GQA "k"/"v" of shape
    (L, B, S, n_kv, hd), or MLA's compressed "c_kv" (L, B, S, kv_lora)
    and "k_rope" (L, B, S, 1, qk_rope)."""
    _check_decode(cfg)
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    n_dense = cfg.n_layers - n_moe
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if cfg.kv_lora_rank:
        mk = lambda n: {
            "c_kv": z(n, batch, max_seq, cfg.kv_lora_rank),
            "k_rope": z(n, batch, max_seq, 1, cfg.qk_rope_dim)}
    else:
        mk = lambda n: {
            "k": z(n, batch, max_seq, cfg.n_kv_heads, cfg.hd),
            "v": z(n, batch, max_seq, cfg.n_kv_heads, cfg.hd)}
    out = {}
    if n_dense:
        out["dense"] = mk(n_dense)
    if n_moe:
        out["moe"] = mk(n_moe)
    return out


def _attn_gqa(cfg, lp, h, lc, pos, positions, theta):
    """Project this token's k, v, write them at `pos` of the layer's
    cache views `lc`, attend over the whole cache (unwritten slots lie
    in the future and are masked by causality)."""
    B = h.shape[0]
    k_new = L.masked_dense_apply(h, lp["w_k"]).reshape(
        B, 1, cfg.n_kv_heads, cfg.hd)
    v_new = L.masked_dense_apply(h, lp["w_v"]).reshape(
        B, 1, cfg.n_kv_heads, cfg.hd)
    k_new = L.apply_rope(k_new, positions, theta)
    lc["k"][:, pos] = k_new[:, 0].to(lc["k"].dtype)
    lc["v"][:, pos] = v_new[:, 0].to(lc["v"].dtype)
    out, _ = L.gqa_apply(lp, h, positions, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, rope_theta=theta,
                         kv_override=(lc["k"], lc["v"]))
    return out


def _attn_mla(cfg, lp, h, lc, pos, positions):
    dkv = L.masked_dense_apply(h, lp["w_dkv"])
    c_kv_new = L.rms_norm({"scale": lp["kv_norm_scale"]},
                          dkv[..., :cfg.kv_lora_rank])
    k_rope_new = L.apply_rope(dkv[..., cfg.kv_lora_rank:][:, :, None, :],
                              positions, cfg.rope_theta)
    lc["c_kv"][:, pos] = c_kv_new[:, 0].to(lc["c_kv"].dtype)
    lc["k_rope"][:, pos] = k_rope_new[:, 0].to(lc["k_rope"].dtype)
    out, _ = L.mla_apply(lp, h, positions, cfg.n_heads, cfg.kv_lora_rank,
                         cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                         rope_theta=cfg.rope_theta,
                         cache_kv=(lc["c_kv"], lc["k_rope"]))
    return out


@torch.no_grad()
def decode_step(params: Pytree, cfg: ArchConfig, cache: Pytree,
                token: torch.Tensor, pos):
    """One-token decode.  token: (B,) int; pos: the token's position (an
    int or a 0-d tensor).  Writes the new keys and values into `cache` at
    `pos` in place and returns (logits f32 (B, V), cache)."""
    _check_decode(cfg)
    pos = int(pos)
    x = L.embed_lookup(params["embed"]["table"], token[:, None])
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    positions = torch.tensor([pos], device=x.device)
    theta = cfg.rope_theta_global or cfg.rope_theta
    for key, part, moe in (("layers", "dense", False),
                           ("moe_layers", "moe", True)):
        if key not in params:
            continue
        stack = cache[part]
        for l in range(depth(params[key])):
            lp = layer_slice(params[key], l)
            lc = {k: v[l] for k, v in stack.items()}
            h = L.rms_norm(lp["attn_norm"], x)
            if cfg.kv_lora_rank:
                attn_out = _attn_mla(cfg, lp["attn"], h, lc, pos, positions)
            else:
                attn_out = _attn_gqa(cfg, lp["attn"], h, lc, pos, positions,
                                     theta)
            x = x + attn_out
            h = L.rms_norm(lp["ffn_norm"], x)
            if moe:
                ffn_out, _ = L.moe_apply(lp["moe"], h, cfg.n_experts,
                                         cfg.top_k, cfg.capacity_factor)
            else:
                ffn_out = L.mlp_apply(lp["mlp"], h)
            x = x + ffn_out
    x = L.rms_norm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])["table"]
    return L.unembed(head, x)[:, 0], cache
