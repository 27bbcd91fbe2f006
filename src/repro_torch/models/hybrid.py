"""RecurrentGemma (Griffin, arXiv:2402.19427), the training forward of
`repro.models.hybrid`: RG-LRU recurrent blocks interleaved with local
(sliding-window, MQA) attention at a 2:1 ratio.

Layout as in the reference: the layers are grouped as repeats of
cfg.block_pattern ("rec", "rec", "attn"), each block kind's leaves
stacked over the groups under params["groups"]["b{i}_{kind}"], and the
remaining n_layers mod 3 layers (the leading kinds of the pattern, all
"rec" for every config in the repo) stacked under params["tail"].  The
reference's scans over groups and tail are Python loops here.  The RG-LRU
recurrence is a log-depth (Hillis-Steele) scan over time in plain torch,
as the reference's `lax.associative_scan` is plain XLA.

Float (non-masked) params: the recurrence decay `a_param`, the conv and
gate biases and the norms.  Decode (the O(1) recurrent step and the ring
KV cache) belongs to the serving slice and is not ported yet; a tail of
mixed block kinds, which the reference keeps as a list, raises.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import depth, layer_slice

Pytree = Any

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)


def _lru_width(cfg):
    return cfg.lru_width or cfg.d_model


def _rec_block_init(gen: torch.Generator, cfg: ArchConfig, lead):
    """Recurrent blocks stacked over `lead`.  (The reference draws w_out
    and the MLP from one reused key; the tests carry weights across from
    the reference, so the port draws them independently.)"""
    d, w = cfg.d_model, _lru_width(cfg)
    dev = gen.device
    f32 = torch.float32
    # Lambda init so a^c lies in [0.9, 0.999] (Griffin): softplus^-1
    u = torch.empty(lead + (w,), dtype=f32, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    return {
        "norm": L.rms_norm_init(d, dev, lead),
        "w_x": L.dense_init(gen, lead + (d, w)),
        "w_y": L.dense_init(gen, lead + (d, w)),
        "conv": L.conv1d_init(gen, cfg.conv_width, w, lead=lead),
        "w_rg": L.dense_init(gen, lead + (w, w)),   # recurrence gate
        "w_ri": L.dense_init(gen, lead + (w, w)),   # input gate
        "bias_rg": torch.zeros(lead + (w,), dtype=f32, device=dev),
        "bias_ri": torch.zeros(lead + (w,), dtype=f32, device=dev),
        "a_param": torch.log(torch.expm1(-torch.log(u) / _C)),
        "w_out": L.dense_init(gen, lead + (w, d), fan_in=w),
        "mlp_norm": L.rms_norm_init(d, dev, lead),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, lead=lead),
    }


def _attn_block_init(gen: torch.Generator, cfg: ArchConfig, lead):
    dev = gen.device
    return {
        "norm": L.rms_norm_init(cfg.d_model, dev, lead),
        "attn": L.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, lead=lead),
        "mlp_norm": L.rms_norm_init(cfg.d_model, dev, lead),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, lead=lead),
    }


def _group_counts(cfg: ArchConfig):
    plen = len(cfg.block_pattern)
    n_groups = cfg.n_layers // plen
    n_tail = cfg.n_layers - n_groups * plen  # leading-pattern remainder
    return n_groups, n_tail


def _block_init(gen, cfg, kind, lead):
    return (_rec_block_init if kind == "rec" else _attn_block_init)(
        gen, cfg, tuple(lead))


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device: group leaves (n_groups, ...),
    tail leaves (n_tail, ...)."""
    n_groups, n_tail = _group_counts(cfg)
    params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, cfg.d_model))},
        "groups": {f"b{i}_{kind}": _block_init(gen, cfg, kind, (n_groups,))
                   for i, kind in enumerate(cfg.block_pattern)},
        "final_norm": L.rms_norm_init(cfg.d_model, gen.device),
    }
    if n_tail:
        kinds = set(cfg.block_pattern[:n_tail])
        if len(kinds) != 1:
            raise NotImplementedError(
                f"{cfg.name}: a tail of mixed block kinds {kinds} (a list "
                f"in the reference) is not ported")
        params["tail"] = _block_init(gen, cfg, kinds.pop(), (n_tail,))
    return params


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rg_lru_scan(u, r, i, a_param):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t), by a log-depth
    (Hillis-Steele) inclusive scan over time of the pairs (a, b) under
    (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2).

    u, r, i: (B, S, W) float32.  Returns h (B, S, W) and the final h."""
    log_a = -_C * L.softplus(a_param) * r                  # (B, S, W) <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)
    S = u.shape[1]
    d = 1
    while d < S:
        # element t combines with element t - d (the earlier one)
        a_new = a[:, d:] * a[:, :-d]
        b_new = b[:, :-d] * a[:, d:] + b[:, d:]
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return b, b[:, -1]


def _rec_mix(cfg, lp, x):
    """RG-LRU mixer on (B, S, D) -> (B, S, D)."""
    gate = L.ACTIVATIONS["gelu"](
        L.masked_dense_apply(x, lp["w_y"]).float())
    u = L.masked_dense_apply(x, lp["w_x"])
    u = L.conv1d_causal(lp["conv"], u).float()
    r = torch.sigmoid(L.masked_dense_apply(u, lp["w_rg"]).float()
                      + lp["bias_rg"])
    i = torch.sigmoid(L.masked_dense_apply(u, lp["w_ri"]).float()
                      + lp["bias_ri"])
    h, _ = rg_lru_scan(u, r, i, lp["a_param"])
    return L.masked_dense_apply((h * gate).to(x.dtype), lp["w_out"])


def _block_fwd(cfg, kind, lp, x, positions):
    h = L.rms_norm(lp["norm"], x)
    if kind == "rec":
        x = x + _rec_mix(cfg, lp, h)
    else:
        out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd,
                             rope_theta=cfg.rope_theta,
                             window=cfg.sliding_window)
        x = x + out
    h = L.rms_norm(lp["mlp_norm"], x)
    return x + L.mlp_apply(lp["mlp"], h, cfg.act)


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits f32 (B, S, V), aux 0)."""
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    positions = torch.arange(tokens.shape[1], device=x.device)
    groups = params["groups"]
    for g in range(depth(groups)):
        gp = layer_slice(groups, g)
        for i, kind in enumerate(cfg.block_pattern):
            x = _block_fwd(cfg, kind, gp[f"b{i}_{kind}"], x, positions)
    if "tail" in params:
        for l in range(depth(params["tail"])):
            x = _block_fwd(cfg, cfg.block_pattern[0],
                           layer_slice(params["tail"], l), x, positions)
    x = L.rms_norm(params["final_norm"], x)
    logits = L.unembed(params["embed"]["table"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
