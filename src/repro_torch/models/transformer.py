"""Decoder-only transformer: the dense (internlm2, gemma3, deepseek-7b,
qwen2 with qkv bias), MoE with MLA (deepseek-v2-*) and VLM (qwen2-vl)
families of `repro.models.transformer`.

Layers are stacked along a leading L axis, as in the reference: the
first `first_dense_layers` layers (all of them without experts) under
params["layers"], the MoE layers under params["moe_layers"].  The
reference's `lax.scan` over each stack is a Python loop here, and layer
l runs on block l of every leaf (a `MaskedLeaf` block carries that
layer's seeds and flat-stream offsets).  Per-layer attention patterns
(gemma3's 5 local : 1 global layers, each kind with its own rope theta)
come from `layer_windows`.  qkv biases are f32 float leaves added after
the masked projections.  The VLM forward prepends stub patch embeddings
`vis_embeds` to the scaled token embeddings and rotates q and k by
M-RoPE over (t, h, w) position streams; its masking stays causal over
the linear positions.  `forward(..., chunk_kv=n)` runs attention over KV
chunks of n keys (`layers.attention_core`); `cfg.moe_block_dispatch`
routes the MoE layers' tokens in blocks (`layers.moe_apply`); `cfg.remat`
recomputes each layer in the backward (`torch.utils.checkpoint`: the
recompute draws the same masks, which come from the counter hash).  As
in the reference, no model reads `cfg.attn_soft_cap`: attention is
uncapped whatever it holds.

`decode_step` is one token of KV-cache decoding over a frozen (plain)
or masked params tree, with 1-D rope for every family (the VLM's decode
is text-only, as in the reference); `init_cache` makes the bf16 cache,
(L, B, S, ...) per stack as in the reference, and `decode_step` writes
each layer's new keys and values into it in place.  With
`cfg.window_kv_cache`, a windowed config decodes through
`decode_step_windowed` over `init_cache_windowed`'s ring caches
(sliding-window layers keep only their last `sliding_window` keys).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf
from repro_torch.models import layers as L

Pytree = Any
NEG_BIG = 1 << 30   # a ring cache's unwritten key sits at position -NEG_BIG


def layer_windows(cfg: ArchConfig, n: int):
    """(windows, thetas) of layers 0..n-1: a layer is global when
    (i + 1) % (global_every + 1) == 0 (every layer when global_every is
    0) and attends with no window at `rope_theta_global or rope_theta`;
    a local one attends within `sliding_window` at `rope_theta`.  The
    reference writes a global layer's window as 1 << 30; None here."""
    wins, thetas = [], []
    for i in range(n):
        is_global = (cfg.global_every == 0
                     or (i + 1) % (cfg.global_every + 1) == 0)
        if cfg.sliding_window and not is_global:
            wins.append(cfg.sliding_window)
            thetas.append(cfg.rope_theta)
        else:
            wins.append(None)
            thetas.append(cfg.rope_theta_global or cfg.rope_theta)
    return wins, thetas


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
                               cfg.qkv_bias, lead=lead)
    if moe:
        p["moe"] = L.moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts,
                              cfg.n_shared_experts, lead=lead)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, lead=lead)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device; layer leaves are (L, ...)."""
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


def _stacks(params: Pytree):
    """(params key, cache key, moe, index of its first layer) of each
    stack present, in order."""
    out, off = [], 0
    for key, part, moe in (("layers", "dense", False),
                           ("moe_layers", "moe", True)):
        if key in params:
            out.append((key, part, moe, off))
            off += depth(params[key])
    return out


def _ffn(cfg, lp, x):
    h = L.rms_norm(lp["ffn_norm"], x)
    return x + L.mlp_apply(lp["mlp"], h, cfg.act)


def _block(cfg: ArchConfig, moe: bool, x, lp, positions, window, theta,
           mrope_positions=None, chunk_kv=None):
    """One layer; returns (x, aux)."""
    h = L.rms_norm(lp["attn_norm"], x)
    if cfg.kv_lora_rank:
        attn_out, _ = L.mla_apply(lp["attn"], h, positions, cfg.n_heads,
                                  cfg.kv_lora_rank, cfg.qk_nope_dim,
                                  cfg.qk_rope_dim, cfg.v_head_dim,
                                  rope_theta=cfg.rope_theta,
                                  chunk_kv=chunk_kv)
    else:
        attn_out, _ = L.gqa_apply(
            lp["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            rope_theta=theta, window=window, mrope_positions=mrope_positions,
            mrope_sections=cfg.mrope_sections, chunk_kv=chunk_kv)
    x = x + attn_out
    if moe:
        h = L.rms_norm(lp["ffn_norm"], x)
        ffn_out, aux = L.moe_apply(lp["moe"], h, cfg.n_experts, cfg.top_k,
                                   cfg.capacity_factor,
                                   block_dispatch=cfg.moe_block_dispatch)
        return x + ffn_out, aux
    return _ffn(cfg, lp, x), 0.0


def remat(fn, *args):
    """fn(*args), recomputed in the backward (`cfg.remat`): nothing of it
    is kept for the backward but its inputs, as the reference's
    `jax.checkpoint(..., policy=nothing_saveable)`; off autograd a plain
    call.  The recompute launches the same kernels on the same stream
    coordinates, so it draws the same masks."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def mrope_positions(S_vis: int, S: int, B: int, device) -> torch.Tensor:
    """(3, B, S) int64 (t, h, w) positions of S_vis patches on a grid of
    side max(int(S_vis ** 0.5), 1), then S - S_vis text tokens: a patch
    has t 0, h its row, w its column; text advances all three from
    `side`, as the reference's forward lays them out."""
    side = max(int(S_vis ** 0.5), 1)
    vis = torch.arange(S_vis, device=device)
    txt = side + torch.arange(S - S_vis, device=device)
    t = torch.cat([torch.zeros_like(vis), txt])
    h = torch.cat([vis // side, txt])
    w = torch.cat([vis % side, txt])
    return torch.stack([t, h, w])[:, None, :].expand(3, B, S)


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
            vis_embeds: torch.Tensor = None, chunk_kv: int = None):
    """tokens: (B, S_text) -> (logits f32 (B, S, V), summed MoE aux loss).
    vis_embeds: (B, S_vis, D) stub patch embeddings (the VLM), prepended
    to the scaled token embeddings, so S = S_vis + S_text; q and k then
    rotate by M-RoPE (`mrope_positions`) while the causal mask stays on
    the linear positions.  chunk_kv: attention over KV chunks of that
    many keys.  With `cfg.remat` each layer is recomputed in the
    backward."""
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    mrope = None
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(x.dtype), x], dim=1)
        mrope = mrope_positions(vis_embeds.shape[1], x.shape[1], x.shape[0],
                                x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    wins, thetas = layer_windows(cfg, cfg.n_layers)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, _, moe, off in _stacks(params):
        for l in range(depth(params[key])):
            blk = functools.partial(_block, cfg, moe, lp=layer_slice(
                params[key], l), positions=positions, window=wins[off + l],
                theta=thetas[off + l], mrope_positions=mrope,
                chunk_kv=chunk_kv)
            x, aux = remat(blk, x) if cfg.remat else blk(x)
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


def windowed(cfg: ArchConfig) -> bool:
    """True when `cfg` decodes over ring caches (`init_cache_windowed`,
    `decode_step_windowed`), as the reference's dispatch decides."""
    return bool(cfg.window_kv_cache and cfg.sliding_window
                and cfg.global_every > 0)


def decode_pos(pos, device) -> torch.Tensor:
    """A decode position (an int or a 0-d integer tensor, batched under
    `torch.func.vmap`) as an int64 tensor on `device`, never read back
    to the host."""
    return torch.as_tensor(pos, device=device).to(torch.int64)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               dtype=torch.bfloat16) -> Pytree:
    """Zeroed KV cache: per stack ("dense", "moe") GQA "k"/"v" of shape
    (L, B, S, n_kv, hd), or MLA's compressed "c_kv" (L, B, S, kv_lora)
    and "k_rope" (L, B, S, 1, qk_rope)."""
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


def _new_kv(cfg, lp, h, positions, theta):
    """This token's roped keys and its values, (B, 1, n_kv, hd) each (the
    qkv biases, if any, added before the rope)."""
    B = h.shape[0]
    k = L.masked_dense_apply(h, lp["w_k"]).reshape(
        B, 1, cfg.n_kv_heads, cfg.hd)
    v = L.masked_dense_apply(h, lp["w_v"]).reshape(
        B, 1, cfg.n_kv_heads, cfg.hd)
    k, v = L.add_bias(k, lp, "bias_k"), L.add_bias(v, lp, "bias_v")
    return L.apply_rope(k, positions, theta), v


def attn_ring(cfg, lp, h, kc, vc, kpos, pos, window, theta):
    """Decode attention over a ring cache of W slots: this token's keys
    and values go to slot pos % W, its position to `kpos` (W,), and the
    query attends within `window` to the positions the ring holds (an
    unwritten slot holds -NEG_BIG).  h: (B, 1, D); kc, vc: (B, W, n_kv,
    hd), written in place."""
    positions = pos.reshape(1)
    slot = pos % kc.shape[1]
    k_new, v_new = _new_kv(cfg, lp, h, positions, theta)
    L.write_at(kc, 1, slot, k_new)
    L.write_at(vc, 1, slot, v_new)
    L.write_at(kpos, 0, slot, positions)
    out, _ = L.gqa_apply(lp, h, positions, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, rope_theta=theta, window=window,
                         kv_override=(kc, vc), k_positions=kpos)
    return out


def _attn_gqa(cfg, lp, h, lc, pos, window, theta):
    """Project this token's k, v, write them at `pos` of the layer's
    cache views `lc`, attend over the whole cache (unwritten slots lie
    in the future and are masked by causality)."""
    positions = pos.reshape(1)
    k_new, v_new = _new_kv(cfg, lp, h, positions, theta)
    L.write_at(lc["k"], 1, positions, k_new)
    L.write_at(lc["v"], 1, positions, v_new)
    out, _ = L.gqa_apply(lp, h, positions, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, rope_theta=theta, window=window,
                         kv_override=(lc["k"], lc["v"]))
    return out


def _attn_mla(cfg, lp, h, lc, pos):
    positions = pos.reshape(1)
    dkv = L.masked_dense_apply(h, lp["w_dkv"])
    c_kv_new = L.rms_norm({"scale": lp["kv_norm_scale"]},
                          dkv[..., :cfg.kv_lora_rank])
    k_rope_new = L.apply_rope(dkv[..., cfg.kv_lora_rank:][:, :, None, :],
                              positions, cfg.rope_theta)
    L.write_at(lc["c_kv"], 1, positions, c_kv_new)
    L.write_at(lc["k_rope"], 1, positions, k_rope_new)
    out, _ = L.mla_apply(lp, h, positions, cfg.n_heads, cfg.kv_lora_rank,
                         cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                         rope_theta=cfg.rope_theta,
                         cache_kv=(lc["c_kv"], lc["k_rope"]))
    return out


def _embed_token(params, cfg, token):
    x = L.embed_lookup(params["embed"]["table"], token[:, None])
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def _head(params, x):
    x = L.rms_norm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])["table"]
    return L.unembed(head, x)[:, 0]


@torch.no_grad()
def decode_step(params: Pytree, cfg: ArchConfig, cache: Pytree,
                token: torch.Tensor, pos):
    """One-token decode.  token: (B,) int; pos: the token's position (an
    int or a 0-d tensor).  Writes the new keys and values into `cache` at
    `pos` in place and returns (logits f32 (B, V), cache).  Each layer
    attends with its own window and rope theta (`layer_windows`)."""
    x = _embed_token(params, cfg, token)
    pos = decode_pos(pos, x.device)
    wins, thetas = layer_windows(cfg, cfg.n_layers)
    for key, part, moe, off in _stacks(params):
        stack = cache[part]
        for l in range(depth(params[key])):
            lp = layer_slice(params[key], l)
            lc = {k: v[l] for k, v in stack.items()}
            h = L.rms_norm(lp["attn_norm"], x)
            if cfg.kv_lora_rank:
                attn_out = _attn_mla(cfg, lp["attn"], h, lc, pos)
            else:
                attn_out = _attn_gqa(cfg, lp["attn"], h, lc, pos,
                                     wins[off + l], thetas[off + l])
            x = x + attn_out
            if moe:
                h = L.rms_norm(lp["ffn_norm"], x)
                ffn_out, _ = L.moe_apply(lp["moe"], h, cfg.n_experts,
                                         cfg.top_k, cfg.capacity_factor)
                x = x + ffn_out
            else:
                x = _ffn(cfg, lp, x)
    return _head(params, x), cache


def _local_global_split(cfg: ArchConfig):
    """gemma3's pattern, one global layer per global_every + 1: returns
    (plen, n_groups, n_tail), groups of plen = global_every local layers
    and 1 global, then a tail of n_tail local layers."""
    plen = cfg.global_every + 1
    n_groups = cfg.n_layers // plen
    return plen, n_groups, cfg.n_layers - n_groups * plen


def init_cache_windowed(cfg: ArchConfig, batch: int, max_seq: int, device,
                        dtype=torch.bfloat16) -> Pytree:
    """Ring caches of W = min(sliding_window, max_seq) slots for the local
    layers, full caches for the global ones, as the reference lays them
    out: "loc_k"/"loc_v" (n_groups, global_every, B, W, n_kv, hd) with
    their positions "loc_pos" (n_groups, global_every, W) int32,
    "glob_k"/"glob_v" (n_groups, B, max_seq, n_kv, hd), and for a tail
    "tail_k"/"tail_v" (n_tail, B, W, n_kv, hd), "tail_pos" (n_tail, W).
    Unwritten slots sit at position -NEG_BIG."""
    W = min(cfg.sliding_window, max_seq)
    plen, n_groups, n_tail = _local_global_split(cfg)
    n_loc = plen - 1
    kv = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    neg = lambda *shape: torch.full(shape, -NEG_BIG, dtype=torch.int32,
                                    device=device)
    cache = {
        "loc_k": kv(n_groups, n_loc, batch, W, cfg.n_kv_heads, cfg.hd),
        "loc_v": kv(n_groups, n_loc, batch, W, cfg.n_kv_heads, cfg.hd),
        "loc_pos": neg(n_groups, n_loc, W),
        "glob_k": kv(n_groups, batch, max_seq, cfg.n_kv_heads, cfg.hd),
        "glob_v": kv(n_groups, batch, max_seq, cfg.n_kv_heads, cfg.hd),
    }
    if n_tail:
        cache["tail_k"] = kv(n_tail, batch, W, cfg.n_kv_heads, cfg.hd)
        cache["tail_v"] = kv(n_tail, batch, W, cfg.n_kv_heads, cfg.hd)
        cache["tail_pos"] = neg(n_tail, W)
    return cache


@torch.no_grad()
def decode_step_windowed(params: Pytree, cfg: ArchConfig, cache: Pytree,
                         token: torch.Tensor, pos):
    """One-token decode over `init_cache_windowed`'s caches: layer l of
    params["layers"] is local slot l % plen of group l // plen, or the
    group's global layer at l % plen = global_every, or tail layer
    l - n_groups * plen.  Local layers attend within `sliding_window` at
    `rope_theta` over their ring, global ones over the full cache at
    `rope_theta_global`.  Writes `cache` in place; returns (logits f32
    (B, V), cache)."""
    x = _embed_token(params, cfg, token)
    pos = decode_pos(pos, x.device)
    plen, n_groups, _ = _local_global_split(cfg)
    theta_l = cfg.rope_theta
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    stacked = params["layers"]
    for l in range(cfg.n_layers):
        lp = layer_slice(stacked, l)
        h = L.rms_norm(lp["attn_norm"], x)
        g, i = divmod(l, plen)
        if g < n_groups and i < plen - 1:
            out = attn_ring(cfg, lp["attn"], h, cache["loc_k"][g, i],
                            cache["loc_v"][g, i], cache["loc_pos"][g, i],
                            pos, cfg.sliding_window, theta_l)
        elif g < n_groups:
            out = _attn_gqa(cfg, lp["attn"], h,
                            {"k": cache["glob_k"][g],
                             "v": cache["glob_v"][g]}, pos, None, theta_g)
        else:
            t = l - n_groups * plen
            out = attn_ring(cfg, lp["attn"], h, cache["tail_k"][t],
                            cache["tail_v"][t], cache["tail_pos"][t], pos,
                            cfg.sliding_window, theta_l)
        x = _ffn(cfg, lp, x + out)
    return _head(params, x), cache
