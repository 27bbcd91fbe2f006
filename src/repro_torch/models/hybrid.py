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
as the reference's `lax.associative_scan` is plain XLA.  `chunk_kv`
chunks the local attention over its keys; with `cfg.remat` each group
of blocks is recomputed in the backward (`transformer.remat`).

Float (non-masked) params: the recurrence decay `a_param`, the conv and
gate biases and the norms.  A tail of mixed block kinds is built as the
reference builds it, a list of one block each; the reference's forward
scans the tail as one stack and cannot run such a list, so the port's
forward and `decode_step` raise on it.

Decode is O(1) in the sequence length: each rec block keeps its RG-LRU
state and conv buffer, each attention block a ring KV cache of
min(sliding_window, max_seq) slots (`transformer.attn_ring`, the ring
logic gemma3's windowed decode shares); `decode_step` advances them in
place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (NEG_BIG, attn_ring,
                                            decode_pos, depth, layer_slice,
                                            remat)

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
    tail leaves (n_tail, ...), or a tail of mixed kinds as a list of
    unstacked blocks (the reference's layout)."""
    n_groups, n_tail = _group_counts(cfg)
    params = {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, cfg.d_model))},
        "groups": {f"b{i}_{kind}": _block_init(gen, cfg, kind, (n_groups,))
                   for i, kind in enumerate(cfg.block_pattern)},
        "final_norm": L.rms_norm_init(cfg.d_model, gen.device),
    }
    if n_tail:
        kinds = cfg.block_pattern[:n_tail]
        if len(set(kinds)) == 1:
            params["tail"] = _block_init(gen, cfg, kinds[0], (n_tail,))
        else:
            params["tail"] = [_block_init(gen, cfg, kind, ())
                              for kind in kinds]
    return params


def _stacked_tail(params: Pytree, cfg: ArchConfig):
    """The tail stack, or None; a tail of mixed kinds (a list) raises, as
    the reference's scan over it fails."""
    tail = params.get("tail")
    if isinstance(tail, list):
        raise NotImplementedError(
            f"{cfg.name}: a tail of mixed block kinds "
            f"{cfg.block_pattern[:len(tail)]}: the reference builds it as a "
            f"list, which its forward and decode cannot scan")
    return tail


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


def _block_fwd(cfg, kind, lp, x, positions, chunk_kv=None):
    h = L.rms_norm(lp["norm"], x)
    if kind == "rec":
        x = x + _rec_mix(cfg, lp, h)
    else:
        out, _ = L.gqa_apply(lp["attn"], h, positions, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd,
                             rope_theta=cfg.rope_theta,
                             window=cfg.sliding_window, chunk_kv=chunk_kv)
        x = x + out
    h = L.rms_norm(lp["mlp_norm"], x)
    return x + L.mlp_apply(lp["mlp"], h, cfg.act)


def _group_fwd(cfg, gp, x, positions, chunk_kv):
    for i, kind in enumerate(cfg.block_pattern):
        x = _block_fwd(cfg, kind, gp[f"b{i}_{kind}"], x, positions, chunk_kv)
    return x


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
            chunk_kv: int = None):
    """tokens: (B, S) -> (logits f32 (B, S, V), aux 0).  chunk_kv: the
    local attention over KV chunks of that many keys.  With `cfg.remat`
    each group is recomputed in the backward (the tail is not, as in the
    reference)."""
    tail = _stacked_tail(params, cfg)
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    positions = torch.arange(tokens.shape[1], device=x.device)
    groups = params["groups"]
    for g in range(depth(groups)):
        args = (cfg, layer_slice(groups, g), x, positions, chunk_kv)
        x = remat(_group_fwd, *args) if cfg.remat else _group_fwd(*args)
    if tail is not None:
        for l in range(depth(tail)):
            x = _block_fwd(cfg, cfg.block_pattern[0], layer_slice(tail, l),
                           x, positions, chunk_kv)
    x = L.rms_norm(params["final_norm"], x)
    logits = L.unembed(params["embed"]["table"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent state and ring-buffer local-attention caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               dtype=torch.bfloat16) -> Pytree:
    """Zeroed decode state, laid out as the reference's: per group "h"
    (n_groups, n_rec, B, lru) f32 and "conv" (n_groups, n_rec, B, W-1,
    lru); the ring "k"/"v" (n_groups, n_attn, B, Wr, n_kv, hd) of Wr =
    min(sliding_window, max_seq) slots and their positions "k_pos"
    (n_groups, n_attn, Wr) int32 at -NEG_BIG; the rec tail's "tail_h"
    and "tail_conv"."""
    n_groups, n_tail = _group_counts(cfg)
    w = _lru_width(cfg)
    Wr = min(cfg.sliding_window or max_seq, max_seq)
    n_rec = cfg.block_pattern.count("rec")
    n_attn = len(cfg.block_pattern) - n_rec
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    cache = {
        "h": z(n_groups, n_rec, batch, w, dt=torch.float32),
        "conv": z(n_groups, n_rec, batch, cfg.conv_width - 1, w),
        "k": z(n_groups, n_attn, batch, Wr, cfg.n_kv_heads, cfg.hd),
        "v": z(n_groups, n_attn, batch, Wr, cfg.n_kv_heads, cfg.hd),
        "k_pos": torch.full((n_groups, n_attn, Wr), -NEG_BIG,
                            dtype=torch.int32, device=device),
    }
    if n_tail:
        cache["tail_h"] = z(n_tail, batch, w, dt=torch.float32)
        cache["tail_conv"] = z(n_tail, batch, cfg.conv_width - 1, w)
    return cache


def _rec_step(cfg, lp, x_t, h_prev, conv_buf):
    """One RG-LRU decode step.  x_t: (B, D); h_prev: (B, lru) f32 and
    conv_buf (B, W-1, lru), both advanced in place.  Returns (B, D)."""
    gate = L.ACTIVATIONS["gelu"](
        L.masked_dense_apply(x_t, lp["w_y"]).float())
    u = L.masked_dense_apply(x_t, lp["w_x"])
    u = L.conv1d_step(lp["conv"], conv_buf, u).float()
    r = torch.sigmoid(L.masked_dense_apply(u, lp["w_rg"]).float()
                      + lp["bias_rg"])
    i = torch.sigmoid(L.masked_dense_apply(u, lp["w_ri"]).float()
                      + lp["bias_ri"])
    log_a = -_C * L.softplus(lp["a_param"]) * r
    h = torch.exp(log_a) * h_prev + torch.sqrt(torch.clamp(
        1 - torch.exp(2 * log_a), min=1e-12)) * (i * u)
    h_prev.copy_(h)
    return L.masked_dense_apply((h * gate).to(x_t.dtype), lp["w_out"])


def _attn_step_ring(cfg, lp, x_t, kc, vc, kpos, pos):
    """Decode attention of an attn block over its ring cache.  x_t:
    (B, D); kc/vc: (B, Wr, n_kv, hd), kpos: (Wr,), written in place."""
    return attn_ring(cfg, lp["attn"], x_t[:, None], kc, vc, kpos, pos,
                     cfg.sliding_window, cfg.rope_theta)[:, 0]


def _block_step(cfg, kind, lp, x, pos, state):
    """One block of decode: the mixer over `state` (the rec block's (h,
    conv) or the attn block's (k, v, k_pos)), then the MLP."""
    hin = L.rms_norm(lp["norm"], x)
    if kind == "rec":
        x = x + _rec_step(cfg, lp, hin, *state)
    else:
        x = x + _attn_step_ring(cfg, lp, hin, *state, pos)
    return x + L.mlp_apply(lp["mlp"], L.rms_norm(lp["mlp_norm"], x),
                           cfg.act)


@torch.no_grad()
def decode_step(params: Pytree, cfg: ArchConfig, cache: Pytree,
                token: torch.Tensor, pos):
    """One-token decode.  token: (B,) int; pos: the token's position (an
    int or a 0-d tensor).  Advances `cache` in place; returns (logits f32
    (B, V), cache)."""
    x = L.embed_lookup(params["embed"]["table"], token)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    pos = decode_pos(pos, x.device)
    groups = params["groups"]
    for g in range(depth(groups)):
        gp = layer_slice(groups, g)
        ri = ai = 0
        for i, kind in enumerate(cfg.block_pattern):
            if kind == "rec":
                state = (cache["h"][g, ri], cache["conv"][g, ri])
                ri += 1
            else:
                state = (cache["k"][g, ai], cache["v"][g, ai],
                         cache["k_pos"][g, ai])
                ai += 1
            x = _block_step(cfg, kind, gp[f"b{i}_{kind}"], x, pos, state)
    tail = _stacked_tail(params, cfg)
    if tail is not None:
        for l in range(depth(tail)):
            x = _block_step(cfg, "rec", layer_slice(tail, l), x,
                            pos, (cache["tail_h"][l], cache["tail_conv"][l]))
    x = L.rms_norm(params["final_norm"], x)
    return L.unembed(params["embed"]["table"], x), cache
