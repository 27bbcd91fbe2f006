"""Whisper-style encoder-decoder (`repro.models.encdec`, arXiv:2212.04356).

The conv and mel frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, enc_seq, D), zeros when a batch
carries none.  Layer norms, non-gated GELU MLPs and learned positions
(`pos_embed_float`, `enc_pos_embed_float`: float leaves under MaskSpec's
"embed_float" pattern); no rope.  The encoder attends without a causal
mask; each decoder layer runs causal self-attention, then cross
attention whose keys and values are the masked `cross.w_k` / `cross.w_v`
projections of the encoder's output.  The embedding is tied to the head.

Layers are stacked along a leading L axis (`enc_layers`, `dec_layers`)
and run as a Python loop over block l of each leaf.  `init_cache` makes
the decoder's self-attention cache "k"/"v" (L, B, S, n_kv, hd) and the
cross K/V "ck"/"cv" (L, B, enc_seq, n_kv, hd), all zeros: a caller
fills ck/cv from `encode` (`cross_kv`) or decodes against the zeros, as
the reference launcher does; `decode_step` writes this token's keys and
values in place and reads the cross K/V from the cache.  `chunk_kv`
chunks the encoder's and the decoder's self-attention over its keys
(cross attention stays whole, as in the reference); the reference has
no `remat` for this family.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import decode_pos, depth, layer_slice

Pytree = Any
POS_TABLE = 40960     # learned decoder positions, as in the reference


def _enc_stack_init(gen, cfg: ArchConfig, n: int):
    d, dev, lead = cfg.d_model, gen.device, (n,)
    return {
        "attn_norm": L.layer_norm_init(d, dev, lead),
        "attn": L.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           lead=lead),
        "ffn_norm": L.layer_norm_init(d, dev, lead),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, lead=lead, gated=False),
    }


def _dec_stack_init(gen, cfg: ArchConfig, n: int):
    d, dev, lead = cfg.d_model, gen.device, (n,)
    return {
        "attn_norm": L.layer_norm_init(d, dev, lead),
        "attn": L.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           lead=lead),
        "cross_norm": L.layer_norm_init(d, dev, lead),
        "cross": L.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            lead=lead),
        "ffn_norm": L.layer_norm_init(d, dev, lead),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, lead=lead, gated=False),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device; layer leaves are (L, ...)."""
    dev = gen.device
    return {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, cfg.d_model))},
        "pos_embed_float": L.embed_init(gen, (POS_TABLE, cfg.d_model)),
        "enc_pos_embed_float": L.embed_init(gen, (cfg.enc_seq, cfg.d_model)),
        "enc_layers": _enc_stack_init(gen, cfg, cfg.enc_layers),
        "dec_layers": _dec_stack_init(gen, cfg, cfg.n_layers),
        "enc_final_norm": L.layer_norm_init(cfg.d_model, dev),
        "final_norm": L.layer_norm_init(cfg.d_model, dev),
    }


def encode(params: Pytree, cfg: ArchConfig, frames: torch.Tensor,
           chunk_kv: int = None):
    """frames: (B, S, D) stub frontend embeddings -> (B, S, D) in their
    dtype: learned positions, then non-causal self-attention without
    rope (over KV chunks of `chunk_kv` keys if set) and a GELU MLP per
    layer, then the final layer norm."""
    S = frames.shape[1]
    x = frames + params["enc_pos_embed_float"][:S].to(frames.dtype)
    positions = torch.arange(S, device=frames.device)
    stack = params["enc_layers"]
    for l in range(depth(stack)):
        lp = layer_slice(stack, l)
        h = L.layer_norm(lp["attn_norm"], x)
        out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, causal=False,
                             use_rope=False, chunk_kv=chunk_kv)
        x = x + out
        h = L.layer_norm(lp["ffn_norm"], x)
        x = x + L.mlp_apply(lp["mlp"], h, "gelu")
    return L.layer_norm(params["enc_final_norm"], x)


def cross_kv(cfg: ArchConfig, lp, enc_out: torch.Tensor):
    """A decoder layer's cross-attention keys and values from the
    encoder's output: the masked `w_k` / `w_v` projections, no bias, no
    rope, (B, S_enc, n_kv, hd) each."""
    B, S_enc = enc_out.shape[:2]
    k = L.masked_dense_apply(enc_out, lp["cross"]["w_k"])
    v = L.masked_dense_apply(enc_out, lp["cross"]["w_v"])
    return (k.reshape(B, S_enc, cfg.n_kv_heads, cfg.hd),
            v.reshape(B, S_enc, cfg.n_kv_heads, cfg.hd))


def _cross_ffn(cfg: ArchConfig, lp, x, positions, ck, cv):
    """Cross attention over (ck, cv) and the MLP, each with its residual."""
    h = L.layer_norm(lp["cross_norm"], x)
    out, _ = L.gqa_apply(lp["cross"], h, positions, cfg.n_heads,
                         cfg.n_kv_heads, cfg.hd, causal=False, use_rope=False,
                         kv_override=(ck, cv))
    x = x + out
    h = L.layer_norm(lp["ffn_norm"], x)
    return x + L.mlp_apply(lp["mlp"], h, "gelu")


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
            frames: torch.Tensor = None, chunk_kv: int = None):
    """tokens: (B, S_dec); frames: (B, enc_seq, D), bf16 zeros when None.
    Returns (logits f32 (B, S_dec, V), aux 0)."""
    if frames is None:
        frames = torch.zeros((tokens.shape[0], cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=tokens.device)
    enc_out = encode(params, cfg, frames, chunk_kv)
    S = tokens.shape[1]
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x + params["pos_embed_float"][:S].to(x.dtype)
    positions = torch.arange(S, device=x.device)
    stack = params["dec_layers"]
    for l in range(depth(stack)):
        lp = layer_slice(stack, l)
        h = L.layer_norm(lp["attn_norm"], x)
        out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, use_rope=False,
                             chunk_kv=chunk_kv)
        x = _cross_ffn(cfg, lp, x + out, positions, *cross_kv(cfg, lp,
                                                              enc_out))
    x = L.layer_norm(params["final_norm"], x)
    return (L.unembed(params["embed"]["table"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               dtype=torch.bfloat16) -> Pytree:
    """Zeroed decoder caches: self-attention "k"/"v" (L, B, max_seq,
    n_kv, hd) and cross "ck"/"cv" (L, B, enc_seq, n_kv, hd)."""
    z = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads,
                               cfg.hd), dtype=dtype, device=device)
    return {"k": z(max_seq), "v": z(max_seq), "ck": z(cfg.enc_seq),
            "cv": z(cfg.enc_seq)}


@torch.no_grad()
def decode_step(params: Pytree, cfg: ArchConfig, cache: Pytree,
                token: torch.Tensor, pos):
    """One decoder token.  token: (B,) int; pos: an int or a 0-d tensor.
    Writes this token's self-attention keys and values into `cache` at
    `pos` in place, attends over them causally and over the cache's
    cross K/V; returns (logits f32 (B, V), cache)."""
    B = token.shape[0]
    x = L.embed_lookup(params["embed"]["table"], token[:, None])
    pos = decode_pos(pos, x.device)
    positions = pos.reshape(1)
    x = x + params["pos_embed_float"].index_select(0, positions).to(x.dtype)
    stack = params["dec_layers"]
    for l in range(depth(stack)):
        lp = layer_slice(stack, l)
        kc, vc = cache["k"][l], cache["v"][l]
        h = L.layer_norm(lp["attn_norm"], x)
        k_new = L.masked_dense_apply(h, lp["attn"]["w_k"]).reshape(
            B, 1, cfg.n_kv_heads, cfg.hd)
        v_new = L.masked_dense_apply(h, lp["attn"]["w_v"]).reshape(
            B, 1, cfg.n_kv_heads, cfg.hd)
        L.write_at(kc, 1, positions, k_new)
        L.write_at(vc, 1, positions, v_new)
        out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, use_rope=False,
                             kv_override=(kc, vc))
        x = _cross_ffn(cfg, lp, x + out, positions, cache["ck"][l],
                       cache["cv"][l])
    x = L.layer_norm(params["final_norm"], x)
    return L.unembed(params["embed"]["table"], x)[:, 0], cache
