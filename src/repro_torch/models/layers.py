"""Model layers (`repro.models.layers`): norms, RoPE and M-RoPE, GQA
attention with optional qkv bias, MLA, MLPs, MoE, the causal and 2-D
convs.

Conventions follow the reference: activations x are (B, S, D), params
are nested dicts of tensors, maskable tensors are named "w_*" and norms,
biases and the router carry "scale" / "bias" / "router" (float leaves
under `MaskSpec`).  Every maskable projection goes
through `masked_dense_apply` (2-D weights), `masked_grouped_apply`
(stacked (E, K, N) expert weights), `masked_conv1d_apply` (depthwise
(W, C) conv kernels) or `masked_conv2d_apply` (the CNNs' (kh, kw, ci, co)
kernels), which run the fused kernels for a `MaskedLeaf` and
a plain product or conv for a plain tensor (float baselines,
materialized effective params).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import masking
from repro_torch.core.masking import MaskedLeaf
from repro_torch.kernels import ops

DEFAULT_DTYPE = torch.bfloat16


def masked_dense_apply(x: torch.Tensor, p) -> torch.Tensor:
    """y = x @ w_eff for a plain weight or a `MaskedLeaf` block (a rank's
    block on a mesh: its layout's partitioned product)."""
    if isinstance(p, MaskedLeaf):
        if p.layout is not None:
            return p.layout.dense(x, p)
        if p.mode == "threshold":
            return ops.masked_dense_threshold(x, p.w, p.s, p.tau)
        return ops.masked_dense(x, p.w, p.s, int(p.seed), int(p.off),
                                p.n_logical)
    # JAX's promotion: an f32 activation times a bf16 weight is f32
    dt = torch.promote_types(x.dtype, p.dtype)
    return x.to(dt) @ p.to(dt)


def masked_grouped_apply(x: torch.Tensor, p) -> torch.Tensor:
    """y[e] = x[e] @ w_eff[e] for a stacked (E, K, N) weight; x: (E, ..., K).
    A `MaskedLeaf` runs one grouped kernel launch per pass for all E
    groups, each group's mask its slice of the leaf's stream."""
    if isinstance(p, MaskedLeaf):
        if p.mode == "threshold":
            return ops.masked_dense_grouped_threshold(x, p.w, p.s, p.tau)
        return ops.masked_dense_grouped(x, p.w, p.s, p.seed, p.off)
    shape = x.shape
    dt = torch.promote_types(x.dtype, p.dtype)
    y = torch.bmm(x.reshape(shape[0], -1, shape[-1]).to(dt), p.to(dt))
    return y.reshape(*shape[:-1], p.shape[-1])


def masked_conv1d_apply(x: torch.Tensor, p) -> torch.Tensor:
    """Depthwise causal conv y[b,s,c] = sum_t x[b,s+t-(W-1),c] w_eff[t,c]
    for a (W, C) kernel leaf, f32 output (bias and cast stay with the
    caller).  A `MaskedLeaf` runs the fused masked conv kernels (a rank's
    block on a mesh: its layout's partitioned conv), a plain tensor the
    same kernels mask-free."""
    if isinstance(p, MaskedLeaf):
        if p.layout is not None:
            return p.layout.conv(x, p)
        if p.mode == "threshold":
            return ops.masked_conv1d_threshold(x, p.w, p.s, p.tau)
        return ops.masked_conv1d(x, p.w, p.s, int(p.seed), int(p.off),
                                 p.n_logical)
    return ops.conv1d_plain(x, p)


def masked_conv2d_apply(x: torch.Tensor, p) -> torch.Tensor:
    """2-D SAME conv, stride 1, of x: (B, H, W, ci) with a (kh, kw, ci, co)
    kernel leaf -> (B, H, W, co), in the reference's NHWC/HWIO layout.

    A plain tensor runs one `F.conv2d` (cast to x's dtype) on NCHW views
    of the NHWC tensors, padded as XLA pads SAME (an even kernel one more
    at the end).  A `MaskedLeaf` is im2col'd once to (B*H*W, kh*kw*ci) and
    runs one fused
    `masked_dense` over the leaf's (kh*kw*ci, co) reshape: that reshape
    is row-major in the leaf's flat order, so at the leaf's base offset
    the launch samples the mask of the leaf's flat uplink stream, and
    m * w never exists in device memory."""
    if not isinstance(p, MaskedLeaf):
        kh, kw = p.shape[:2]
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        xn = F.pad(x.permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph))
        return F.conv2d(xn, p.to(x.dtype).permute(3, 2, 0, 1)).permute(
            0, 2, 3, 1)
    kh, kw, ci, co = p.w.shape
    B, H, Wd, _ = x.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + Wd, :]
                      for dy in range(kh) for dx in range(kw)],
                     dim=-1).reshape(-1, kh * kw * ci)
    blk = MaskedLeaf(p.w.reshape(kh * kw * ci, co),
                     p.s.reshape(kh * kw * ci, co), p.seed[0, 0],
                     p.off[0, 0], p.mode, p.tau)
    return masked_dense_apply(cols, blk).reshape(B, H, Wd, co)


def effective_weight(p) -> torch.Tensor:
    """m * w of a `MaskedLeaf` from the fused kernels' stream (one
    weight-sized temporary), a plain tensor as it is.  Only the per-token
    conv step (`conv1d_step`) uses it: a decode session that froze its
    tree (`masking.freeze_for_decode`) passes plain tensors through."""
    if isinstance(p, MaskedLeaf):
        return masking.materialize_leaf(p)
    return p


def write_at(buf: torch.Tensor, dim: int, idx: torch.Tensor,
             val: torch.Tensor) -> None:
    """buf[..., idx, ...] = val along `dim`, in place; `idx` is a
    1-element integer tensor and `val` has size 1 along `dim`.  Through
    `index_put_`, which has a batching rule under `torch.func.vmap` (the
    lockstep serve step), and with no host read of `idx`."""
    buf.movedim(dim, 0).index_put_((idx.reshape(1),),
                                   val.movedim(dim, 0).to(buf.dtype))


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


def layer_norm_init(d, device, lead=()):
    shape = tuple(lead) + (d,)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


def layer_norm(params, x, eps=1e-5):
    """LayerNorm with f32 statistics (the population variance), f32
    scale and bias, output in x.dtype."""
    xc = x.float()
    xc = xc - torch.mean(xc, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
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


def apply_mrope(x, positions3, sections=(16, 24, 24), theta=10000.0):
    """Qwen2-VL's M-RoPE: positions3 (3, B, S) holds the (t, h, w)
    position streams; the Hd/2 rotary frequencies are split into
    `sections` (t first), each section rotated by its own stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, x.shape[-1])
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                      # (half,)
    pos = positions3.index_select(0, sec_id)                   # (half, B, S)
    ang = pos.movedim(0, -1).float() * freqs                   # (B, S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_init(gen, d_model, n_heads, n_kv, head_dim, qkv_bias=False,
             dtype=DEFAULT_DTYPE, lead=()):
    """GQA projections; with `qkv_bias`, f32 zero biases "bias_q",
    "bias_k", "bias_v" (float leaves)."""
    lead = tuple(lead)
    p = {
        "w_q": dense_init(gen, lead + (d_model, n_heads * head_dim), dtype),
        "w_k": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype),
        "w_v": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype),
        "w_o": dense_init(gen, lead + (n_heads * head_dim, d_model), dtype),
    }
    if qkv_bias:
        z = lambda n: torch.zeros(lead + (n,), dtype=torch.float32,
                                  device=gen.device)
        p["bias_q"] = z(n_heads * head_dim)
        p["bias_k"] = z(n_kv * head_dim)
        p["bias_v"] = z(n_kv * head_dim)
    return p


def _causal_mask(q_pos, k_pos, window=None, causal=True):
    """(Sq, Sk) additive mask: 0 where attended (0 <= q - k when causal,
    and q - k < window for a sliding window), -1e30 elsewhere.  A ring
    cache's unwritten slot sits at k = -2**30, out of every window."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window is not None:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def attention_core(q, k, v, q_pos, k_pos, window=None, causal=True,
                   chunk_kv=None, soft_cap=None):
    """Attention, causal unless `causal=False` (an encoder, cross
    attention), optionally within a sliding window.
    q: (B, Sq, H, Hd); k: (B, Sk, Kv, Hd); v: (B, Sk, Kv, Dv).  GQA (and
    MQA) by head repetition, f32 scores and softmax, output in q.dtype.
    `soft_cap` bounds the scores by tanh(s / cap) * cap before the mask.

    `chunk_kv` runs the reference's online softmax over KV chunks of that
    many keys, so no (Sq, Sk) score matrix exists at once (the memory
    path of long prefills): keys are zero-padded to whole chunks at
    position -10**9, and each chunk rescales the running max, sum and
    output, as the reference's scan does.  (A padded key lies inside a
    causal mask without a window, as in the reference.)"""
    B, Sq, H, Hd = q.shape
    Kv = k.shape[2]
    Dv = v.shape[-1]
    rep = H // Kv
    scale = 1.0 / math.sqrt(Hd)
    qf = (q.float() * scale).reshape(B, Sq, Kv, rep, Hd)

    def scores(kc):
        s = torch.einsum("bqgrh,bkgh->bgrqk", qf, kc.float())
        return s if soft_cap is None else torch.tanh(s / soft_cap) * soft_cap

    if chunk_kv is None:
        s = scores(k) + _causal_mask(q_pos, k_pos, window, causal)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgh->bqgrh", p, v.float())
        return o.reshape(B, Sq, H, Dv).to(q.dtype)

    Sk = k.shape[1]
    n_chunks = -(-Sk // chunk_kv)
    pad = n_chunks * chunk_kv - Sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    kpos = F.pad(k_pos, (0, pad), value=-(10 ** 9))
    m = torch.full((B, Kv, rep, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kv, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, rep, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        keys = slice(c * chunk_kv, (c + 1) * chunk_kv)
        s = scores(kp[:, keys]) + _causal_mask(q_pos, kpos[keys], window,
                                               causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bkgh->bgrqh", p, vp[:, keys].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(-2, 1).reshape(B, Sq, H, Dv).to(q.dtype)


def add_bias(t, p, name):
    """t + p[name] (an f32 bias over the flattened heads), in t.dtype."""
    if name not in p:
        return t
    return t + p[name].reshape(t.shape[-2:]).to(t.dtype)


def gqa_apply(p, x, positions, n_heads, n_kv, head_dim, rope_theta=10000.0,
              window=None, kv_override=None, k_positions=None, causal=True,
              use_rope=True, mrope_positions=None, mrope_sections=None,
              chunk_kv=None):
    """Self-attention block (no norm), causal unless `causal=False`,
    attending to the last `window` positions if set, over KV chunks of
    `chunk_kv` keys if set (`attention_core`); returns (out, (k, v)).
    The qkv biases, when the params carry them, are added after the
    masked projections.  `mrope_positions` (3, B, S) rotates q and k
    by M-RoPE over `mrope_sections` instead of RoPE; `use_rope=False`
    rotates nothing.  `kv_override` = (k, v) attends over given keys and
    values instead (cached decode: the keys are already roped; cross
    attention) at `k_positions` (default arange)."""
    B, S, _ = x.shape

    def rotate(t):
        if mrope_positions is not None:
            return apply_mrope(t, mrope_positions, mrope_sections,
                               rope_theta)
        return apply_rope(t, positions, rope_theta) if use_rope else t

    q = masked_dense_apply(x, p["w_q"]).reshape(B, S, n_heads, head_dim)
    q = rotate(add_bias(q, p, "bias_q"))
    if kv_override is not None:
        k, v = kv_override
        k_pos = (k_positions if k_positions is not None
                 else torch.arange(k.shape[1], device=x.device))
    else:
        k = masked_dense_apply(x, p["w_k"]).reshape(B, S, n_kv, head_dim)
        v = masked_dense_apply(x, p["w_v"]).reshape(B, S, n_kv, head_dim)
        k = rotate(add_bias(k, p, "bias_k"))
        v = add_bias(v, p, "bias_v")
        k_pos = positions
    o = attention_core(q, k, v, positions, k_pos, window, causal, chunk_kv)
    return masked_dense_apply(o.reshape(B, S, n_heads * head_dim),
                              p["w_o"]), (k, v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen, d_model, n_heads, kv_lora, q_lora, qk_nope, qk_rope,
             v_head, dtype=DEFAULT_DTYPE, lead=()):
    lead = tuple(lead)
    dev = gen.device
    p = {
        "w_dkv": dense_init(gen, lead + (d_model, kv_lora + qk_rope), dtype),
        "kv_norm_scale": torch.ones(lead + (kv_lora,), dtype=torch.float32,
                                    device=dev),
        "w_uk": dense_init(gen, lead + (kv_lora, n_heads * qk_nope), dtype),
        "w_uv": dense_init(gen, lead + (kv_lora, n_heads * v_head), dtype),
        "w_o": dense_init(gen, lead + (n_heads * v_head, d_model), dtype),
    }
    if q_lora:
        p["w_dq"] = dense_init(gen, lead + (d_model, q_lora), dtype)
        p["q_norm_scale"] = torch.ones(lead + (q_lora,), dtype=torch.float32,
                                       device=dev)
        p["w_uq"] = dense_init(
            gen, lead + (q_lora, n_heads * (qk_nope + qk_rope)), dtype)
    else:
        p["w_q"] = dense_init(
            gen, lead + (d_model, n_heads * (qk_nope + qk_rope)), dtype)
    return p


def mla_apply(p, x, positions, n_heads, kv_lora, qk_nope, qk_rope, v_head,
              rope_theta=10000.0, chunk_kv=None, cache_kv=None):
    """MLA forward (training / prefill); returns (out, (c_kv, k_rope)).
    q and k carry nope + rope dims, so the softmax scale is
    1/sqrt(qk_nope + qk_rope); the decoupled rope key is shared by all
    heads and the compressed c_kv is RMS-normed with `kv_norm_scale`.
    `cache_kv` = (c_kv, k_rope) attends over a decode cache (already
    holding this step's entries) at key positions arange; `chunk_kv`
    chunks the keys as `attention_core` does."""
    B, S, _ = x.shape
    if "w_dq" in p:
        cq = rms_norm({"scale": p["q_norm_scale"]},
                      masked_dense_apply(x, p["w_dq"]))
        q = masked_dense_apply(cq, p["w_uq"])
    else:
        q = masked_dense_apply(x, p["w_q"])
    q = q.reshape(B, S, n_heads, qk_nope + qk_rope)
    q_rope = apply_rope(q[..., qk_nope:], positions, rope_theta)

    dkv = masked_dense_apply(x, p["w_dkv"])
    c_kv = rms_norm({"scale": p["kv_norm_scale"]}, dkv[..., :kv_lora])
    k_rope = apply_rope(dkv[..., kv_lora:][:, :, None, :], positions,
                        rope_theta)                      # (B, S, 1, rope)
    if cache_kv is not None:
        c_kv_all, k_rope_all = cache_kv
        k_pos = torch.arange(c_kv_all.shape[1], device=x.device)
    else:
        c_kv_all, k_rope_all, k_pos = c_kv, k_rope, positions
    Sk = c_kv_all.shape[1]
    k_nope = masked_dense_apply(c_kv_all, p["w_uk"]).reshape(
        B, Sk, n_heads, qk_nope)
    v = masked_dense_apply(c_kv_all, p["w_uv"]).reshape(B, Sk, n_heads,
                                                        v_head)
    k = torch.cat([k_nope, k_rope_all.expand(B, Sk, n_heads, qk_rope)],
                  dim=-1)
    q = torch.cat([q[..., :qk_nope], q_rope], dim=-1)
    o = attention_core(q, k, v, positions, k_pos, chunk_kv=chunk_kv)
    return masked_dense_apply(o.reshape(B, S, -1), p["w_o"]), (c_kv, k_rope)


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, dtype=DEFAULT_DTYPE, lead=(), gated=True):
    lead = tuple(lead)
    p = {"w_up": dense_init(gen, lead + (d_model, d_ff), dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, lead + (d_model, d_ff), dtype)
    p["w_down"] = dense_init(gen, lead + (d_ff, d_model), dtype)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0) (no linear cut-off as in torch's)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# the reference's table; its "gelu" is jax.nn.gelu, which defaults to the
# tanh approximation (torch's default is the erf form)
ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh,
               "relu": F.relu}


def mlp_apply(p, x, act="silu"):
    """MLP, gated when the params carry "w_gate"."""
    a = ACTIVATIONS[act]
    up = masked_dense_apply(x, p["w_up"])
    if "w_gate" in p:
        up = a(masked_dense_apply(x, p["w_gate"])) * up
    else:
        up = a(up)
    return masked_dense_apply(up, p["w_down"])


# ---------------------------------------------------------------------------
# MoE (capacity dispatch, global or block-local)
# ---------------------------------------------------------------------------


def moe_init(gen, d_model, moe_d_ff, n_experts, n_shared,
             dtype=DEFAULT_DTYPE, lead=()):
    lead = tuple(lead)
    p = {"router_w": dense_init(gen, lead + (d_model, n_experts),
                                torch.float32),
         "w_up": dense_init(gen, lead + (n_experts, d_model, moe_d_ff),
                            dtype),
         "w_gate": dense_init(gen, lead + (n_experts, d_model, moe_d_ff),
                              dtype),
         "w_down": dense_init(gen, lead + (n_experts, moe_d_ff, d_model),
                              dtype)}
    if n_shared:
        p["shared"] = mlp_init(gen, d_model, moe_d_ff * n_shared, dtype,
                               lead)
    return p


def top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(logits: torch.Tensor, n_experts: int, k: int,
              capacity_factor: float):
    """Top-k routing with capacity, as the reference's `moe_apply`, of
    (..., T, E) router logits (a leading axis: independent blocks of T
    tokens each): returns (probs (..., T, E), renormalised gates with
    dropped slots zeroed (..., T, k), expert ids gidx (..., T, k), their
    one-hot (..., T, k, E), queue positions pos (..., T, k) f32, keep =
    pos < cap (..., T, k), cap).  A queue position counts the earlier
    (token, slot) pairs of the block sent to the same expert,
    token-major."""
    T = logits.shape[-2]
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = top_k(probs, k)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(T * k * capacity_factor / n_experts), 4)
    onehot = F.one_hot(gidx, n_experts).float()         # (..., T, k, E)
    flat = onehot.reshape(*onehot.shape[:-3], T * k, n_experts)
    pos_in_e = (torch.cumsum(flat, dim=-2) - flat).reshape(onehot.shape)
    pos = (pos_in_e * onehot).sum(-1)                    # (..., T, k)
    keep = pos < cap
    return probs, gval * keep, gidx, onehot, pos, keep, cap


def dispatch_blocks(T: int, block_dispatch: int) -> int:
    """The blocks a MoE layer routes T tokens in: `block_dispatch` = G
    where T splits into G blocks of at least 8 tokens, else one."""
    G = block_dispatch
    return G if G and T % G == 0 and T // G >= 8 else 1


def moe_apply(p, x, n_experts, k, capacity_factor=1.25, block_dispatch=0):
    """Capacity-dispatch MoE. x: (B, S, D) -> ((B, S, D), aux).  Tokens
    over an expert's capacity fall through on the residual path (plus
    the shared experts); dispatch and combine are the reference's
    one-hot (T, E, C) einsums, and the expert chain stays in f32.

    `block_dispatch` = G > 0, where B*S splits into G blocks of at least
    8 tokens: each block of B*S / G consecutive tokens is routed on its
    own, with its own capacity max(int((B*S / G) * k * cf / E), 4), and
    the aux loss is the mean of the blocks' (the reference vmaps
    `moe_apply` over the blocks).  Every block sends its tokens through
    the same expert weights, so the blocks' expert rows are folded into
    one (E, G*C, D) operand: one grouped launch per projection whatever
    G, and kernel 7's score gradient sums over every block.

    Expert leaves that carry a mesh layout (`launch.partition.
    ExpertLayout`, a rank's block on a mesh) hand the routing, the
    dispatch, the expert chain and the combine to it, with
    `block_dispatch`: x is then the rank's piece of a microbatch chunk,
    and the blocks are the global chunk's (G decided on its T tokens),
    routed on the rank or over the data ranks a block covers."""
    if isinstance(p["w_up"], MaskedLeaf) and p["w_up"].layout is not None:
        y, aux = p["w_up"].layout.moe(p, x, n_experts, k, capacity_factor,
                                      block_dispatch)
        if "shared" in p:
            y = y + mlp_apply(p["shared"], x)
        return y, aux
    B, S, D = x.shape
    T = B * S
    G = dispatch_blocks(T, block_dispatch)
    xt = x.reshape(G, T // G, D)
    logits = xt.float() @ p["router_w"]
    probs, gval, _, onehot, pos, keep, cap = moe_route(
        logits, n_experts, k, capacity_factor)
    pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).float() \
        * keep[..., None]                                   # (G, t, k, C)
    disp = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)   # (G, t, E, C)
    xe = torch.einsum("gtec,gtd->egcd", disp, xt.float())    # (E, G, C, D)
    xe = xe.reshape(n_experts, G * cap, D)
    h = F.silu(masked_grouped_apply(xe, p["w_gate"])) \
        * masked_grouped_apply(xe, p["w_up"])
    ye = masked_grouped_apply(h, p["w_down"]).reshape(
        n_experts, G, cap, D)                                # (E, G, C, D)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, gval.float())
    y = torch.einsum("gtec,egcd->gtd", comb, ye.float())
    y = y.to(x.dtype).reshape(B, S, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    # Switch-style load-balancing loss, a block's each, their mean
    me = probs.mean(dim=-2)
    ce = onehot.sum(-2).mean(dim=-2)
    return y, (n_experts * (me * ce).sum(-1)).mean()


# ---------------------------------------------------------------------------
# Causal temporal conv (mamba2 / recurrentgemma frontends)
# ---------------------------------------------------------------------------


def conv1d_init(gen, width, channels, dtype=DEFAULT_DTYPE, lead=()):
    lead = tuple(lead)
    return {"w_conv": dense_init(gen, lead + (width, channels), dtype,
                                 fan_in=width),
            "bias_conv": torch.zeros(lead + (channels,), dtype=torch.float32,
                                     device=gen.device)}


def conv1d_causal(p, x):
    """Depthwise causal conv with bias: x (B, S, C) -> (B, S, C) in
    x.dtype (f32 sum plus f32 bias, then the cast)."""
    out = masked_conv1d_apply(x, p["w_conv"])
    return (out + p["bias_conv"]).to(x.dtype)


def conv1d_step(p, buf, x_t):
    """One decode step of the causal conv.  buf: (B, W-1, C), the last
    W-1 inputs, shifted by one and `x_t` appended in place; x_t: (B, C)
    -> (B, C) in x_t.dtype (an f32 sum over the W taps plus the f32 bias,
    then the cast).  A `MaskedLeaf` kernel is materialized every step
    (`effective_weight`), as in the reference.  The taps are summed in
    order, each a fused multiply-add (`addcmul`), as the reference's f32
    contraction sums them on the CPU, so f32 steps agree bit for bit."""
    w = effective_weight(p["w_conv"]).float()
    dt = torch.promote_types(buf.dtype, x_t.dtype)
    full = torch.cat([buf.to(dt), x_t[:, None].to(dt)], dim=1)  # (B, W, C)
    taps = full.float().transpose(0, 1).contiguous()            # (W, B, C)
    acc = taps[0] * w[0]
    for t in range(1, w.shape[0]):
        acc = torch.addcmul(acc, taps[t], w[t])
    buf.copy_(full[:, 1:])
    return (acc + p["bias_conv"]).to(x_t.dtype)


def embed_lookup(table, tokens):
    return F.embedding(tokens, table)


def unembed(table, x):
    return x.float() @ table.float().T
