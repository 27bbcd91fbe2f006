"""Dense-transformer layers (the dense subset of `repro.models.layers`).

Conventions follow the reference: activations x are (B, S, D), params
are nested dicts of tensors, maskable tensors are named "w_*" and norms
carry "scale".  Every maskable projection goes through
`masked_dense_apply`, which runs the fused kernels for a `MaskedLeaf`
and a plain matmul for a plain tensor (float baselines, materialized
effective params).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.masking import MaskedLeaf
from repro_torch.kernels import ops

DEFAULT_DTYPE = torch.bfloat16


def masked_dense_apply(x: torch.Tensor, p) -> torch.Tensor:
    """y = x @ w_eff for a plain weight or a `MaskedLeaf` block."""
    if isinstance(p, MaskedLeaf):
        if p.mode == "threshold":
            return ops.masked_dense_threshold(x, p.w, p.s, p.tau)
        return ops.masked_dense(x, p.w, p.s, int(p.seed), int(p.off))
    return x @ p


# ---------------------------------------------------------------------------
# Initializers (draws from a torch.Generator on the target device)
# ---------------------------------------------------------------------------


def dense_init(gen, shape, dtype=DEFAULT_DTYPE, fan_in=None):
    """Normal(0, 1/fan_in) weights; fan_in defaults to the second-to-last
    dimension (the reference's shape[0] of an unstacked (K, N) leaf)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def embed_init(gen, shape, dtype=DEFAULT_DTYPE):
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rms_norm_init(d, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def rms_norm(params, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE and attention
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta=10000.0, device=None):
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, Hd), positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_init(gen, d_model, n_heads, n_kv, head_dim, dtype=DEFAULT_DTYPE,
             lead=()):
    lead = tuple(lead)
    return {
        "w_q": dense_init(gen, lead + (d_model, n_heads * head_dim), dtype),
        "w_k": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype),
        "w_v": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype),
        "w_o": dense_init(gen, lead + (n_heads * head_dim, d_model), dtype),
    }


def _causal_mask(q_pos, k_pos):
    """(Sq, Sk) additive mask: 0 where attended, -1e30 elsewhere."""
    ok = (q_pos[:, None] - k_pos[None, :]) >= 0
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def attention_core(q, k, v, q_pos, k_pos):
    """Causal attention. q: (B, Sq, H, Hd); k: (B, Sk, Kv, Hd);
    v: (B, Sk, Kv, Dv).  GQA by head repetition, f32 scores and softmax,
    output in q.dtype: the reference's unchunked branch (its sliding
    window, soft cap and chunked online softmax are not ported yet)."""
    B, Sq, H, Hd = q.shape
    Kv = k.shape[2]
    Dv = v.shape[-1]
    rep = H // Kv
    scale = 1.0 / math.sqrt(Hd)
    qf = (q.float() * scale).reshape(B, Sq, Kv, rep, Hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float())
    s = s + _causal_mask(q_pos, k_pos)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgh->bqgrh", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def gqa_apply(p, x, positions, n_heads, n_kv, head_dim, rope_theta=10000.0):
    """Causal self-attention block (no norm); returns (out, (k, v))."""
    B, S, _ = x.shape
    q = masked_dense_apply(x, p["w_q"]).reshape(B, S, n_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = masked_dense_apply(x, p["w_k"]).reshape(B, S, n_kv, head_dim)
    v = masked_dense_apply(x, p["w_v"]).reshape(B, S, n_kv, head_dim)
    k = apply_rope(k, positions, rope_theta)
    o = attention_core(q, k, v, positions, positions)
    return masked_dense_apply(o.reshape(B, S, n_heads * head_dim),
                              p["w_o"]), (k, v)


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, dtype=DEFAULT_DTYPE, lead=()):
    lead = tuple(lead)
    return {"w_up": dense_init(gen, lead + (d_model, d_ff), dtype),
            "w_gate": dense_init(gen, lead + (d_model, d_ff), dtype),
            "w_down": dense_init(gen, lead + (d_ff, d_model), dtype)}


def mlp_apply(p, x):
    """Gated SiLU MLP (the ported configs' activation)."""
    up = masked_dense_apply(x, p["w_up"])
    up = F.silu(masked_dense_apply(x, p["w_gate"])) * up
    return masked_dense_apply(up, p["w_down"])


def embed_lookup(table, tokens):
    return F.embedding(tokens, table)


def unembed(table, x):
    return x.float() @ table.float().T
