"""Mamba-2 (SSD, state-space duality; arXiv:2405.21060), the training
forward of `repro.models.ssm`.

Chunked SSD: quadratic within a chunk, a linear recurrence across
chunks.  Layers are stacked along a leading L axis as in the reference;
its `lax.scan` over them is a Python loop, layer l running on block l of
every leaf.  The maskable tensors are `w_in`, the depthwise conv kernel
`conv/w_conv` (through the masked conv kernels) and `w_out`; the
dynamical-system params (A_log, dt_bias, D) and the norms stay float.

`forward` takes and ignores `chunk_kv` (no attention), as the
reference's does; with `cfg.remat` each layer is recomputed in the
backward (`transformer.remat`).

Decode is the recurrent form: `init_cache` holds each layer's SSM state
(f32) and the conv's last W-1 inputs, and `decode_step` advances both
in place by one token, constant memory in the sequence length.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import depth, layer_slice, remat

Pytree = Any


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_headdim
    return d_in, n_heads


def _layer_init(gen: torch.Generator, cfg: ArchConfig, n: int):
    """n stacked layers, every leaf (n, ...)."""
    d, N, G = cfg.d_model, cfg.ssm_state, cfg.ssm_ngroups
    d_in, nh = _dims(cfg)
    dev, lead = gen.device, (n,)
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev))
    return {
        "norm": L.rms_norm_init(d, dev, lead),
        # fused input projection: [z, x, B, C, dt]
        "w_in": L.dense_init(gen, lead + (d, 2 * d_in + 2 * G * N + nh)),
        "conv": L.conv1d_init(gen, cfg.conv_width, d_in + 2 * G * N,
                              lead=lead),
        "A_log": a_log.expand(n, nh).clone(),
        "dt_bias": torch.zeros(lead + (nh,), dtype=f32, device=dev),
        "D": torch.ones(lead + (nh,), dtype=f32, device=dev),
        "gate_norm_scale": torch.ones(lead + (d_in,), dtype=f32, device=dev),
        "w_out": L.dense_init(gen, lead + (d_in, d), fan_in=d_in),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Pytree:
    """Random params on `gen`'s device; layer leaves are (L, ...)."""
    return {
        "embed": {"table": L.embed_init(gen, (cfg.vocab, cfg.d_model))},
        "layers": _layer_init(gen, cfg, cfg.n_layers),
        "final_norm": L.rms_norm_init(cfg.d_model, gen.device),
    }


# ---------------------------------------------------------------------------
# SSD chunked scan (training)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256):
    """SSD: y_t = C_t^T sum_{s<=t} (prod_{r=s+1..t} exp(A dt_r)) dt_s B_s x_s

    x: (B, S, H, P); dt: (B, S, H) f32; A: (H,) (negative);
    Bm, Cm: (B, S, G, N).  Heads map to groups by H // G repetition.
    Returns y: (B, S, H, P) f32, final_state: (B, H, P, N) f32.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N)

    dA = dtc * A                                   # (B, nc, c, H) negative
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk: L[b,n,i,j,h] = exp(dA_cs_i - dA_cs_j) for i >= j
    diff = dA_cs[..., :, None, :] - dA_cs[..., None, :, :]  # (B,nc,c,c,H)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=x.device)
    # zero the off-mask diffs BEFORE the exp: exp(+big) * 0 is NaN in the
    # backward of where
    diff = torch.where(mask, diff, zero)
    Ldec = torch.where(mask, torch.exp(diff), zero)
    CB = torch.einsum("bucgs,bukgs->buckg", Cc.to(f32), Bc.to(f32))
    CB = torch.repeat_interleave(CB, rep, dim=-1)           # (B,nc,c,c,H)
    W = CB * Ldec
    xdt = xc.to(f32) * dtc[..., None]
    y_intra = torch.einsum("buckh,bukhp->buchp", W, xdt)

    # chunk-final states: sum_j exp(dA_cs_last - dA_cs_j) dt_j B_j x_j
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (B,nc,c,H)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)            # (B,nc,c,H,N)
    states = torch.einsum("buch,buchs,buchp->buhps", decay_to_end,
                          Bh.to(f32), xdt)

    # inter-chunk recurrence over nc (sequential, cheap)
    chunk_decay = torch.exp(torch.sum(dA, dim=2))           # (B, nc, H)
    st = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    init_states = []
    for n in range(nc):
        init_states.append(st)
        st = st * chunk_decay[:, n, :, None, None] + states[:, n]
    init_states = torch.stack(init_states, dim=1)           # (B,nc,H,P,N)

    # contribution of the carried-in state: y += C_i exp(dA_cs_i) state_in
    Ch = torch.repeat_interleave(Cc, rep, dim=3)            # (B,nc,c,H,N)
    y_inter = torch.einsum("buchs,buch,buhps->buchp", Ch.to(f32),
                           torch.exp(dA_cs), init_states)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, st


def _mix(cfg: ArchConfig, lp, x, chunk=256):
    """One mamba2 mixer on (B, S, D)."""
    d_in, nh = _dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    B_, S, _ = x.shape
    zxbcdt = L.masked_dense_apply(x, lp["w_in"])
    z, xs, Bm, Cm, dt = torch.split(
        zxbcdt, [d_in, d_in, G * N, G * N, nh], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(L.conv1d_causal(lp["conv"], conv_in))
    xs = conv_out[..., :d_in].reshape(B_, S, nh, P)
    Bm = conv_out[..., d_in:d_in + G * N].reshape(B_, S, G, N)
    Cm = conv_out[..., d_in + G * N:].reshape(B_, S, G, N)
    dt = L.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    y, _ = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(chunk, S))
    y = y + xs.float() * lp["D"][..., None]
    y = y.reshape(B_, S, d_in)
    y = L.rms_norm({"scale": lp["gate_norm_scale"]},
                   y.to(x.dtype) * F.silu(z))
    return L.masked_dense_apply(y, lp["w_out"])


def _layer(cfg: ArchConfig, lp, x):
    return x + _mix(cfg, lp, L.rms_norm(lp["norm"], x))


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
            chunk_kv: int = None):
    """tokens: (B, S) -> (logits f32 (B, S, V), aux 0); chunk_kv is
    unused (no attention)."""
    x = L.embed_lookup(params["embed"]["table"], tokens)
    for l in range(depth(params["layers"])):
        lp = layer_slice(params["layers"], l)
        x = remat(_layer, cfg, lp, x) if cfg.remat else _layer(cfg, lp, x)
    x = L.rms_norm(params["final_norm"], x)
    logits = L.unembed(params["embed"]["table"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Recurrent decode (constant memory in the sequence length)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               dtype=torch.bfloat16) -> Pytree:
    """Zeroed decode state: "ssm_state" (L, B, nh, P, N) f32 and
    "conv_buf" (L, B, W-1, conv channels) in `dtype`; `max_seq` does not
    size it."""
    d_in, nh = _dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    return {
        "ssm_state": torch.zeros((cfg.n_layers, batch, nh, P, N),
                                 dtype=torch.float32, device=device),
        "conv_buf": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                                 d_in + 2 * G * N), dtype=dtype,
                                device=device),
    }


@torch.no_grad()
def decode_step(params: Pytree, cfg: ArchConfig, cache: Pytree,
                token: torch.Tensor, pos):
    """One-token decode.  token: (B,) int; `pos` is not read (the state
    carries the past).  Advances `cache` in place; returns (logits f32
    (B, V), cache)."""
    d_in, nh = _dims(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    B_ = token.shape[0]
    rep = nh // G
    x = L.embed_lookup(params["embed"]["table"], token)         # (B, D)
    for l in range(depth(params["layers"])):
        lp = layer_slice(params["layers"], l)
        st = cache["ssm_state"][l]
        h = L.rms_norm(lp["norm"], x)
        zxbcdt = L.masked_dense_apply(h, lp["w_in"])
        z, xin, Bm, Cm, dt = torch.split(
            zxbcdt, [d_in, d_in, G * N, G * N, nh], dim=-1)
        conv_out = F.silu(L.conv1d_step(lp["conv"], cache["conv_buf"][l],
                                        torch.cat([xin, Bm, Cm], dim=-1)))
        xin = conv_out[..., :d_in].reshape(B_, nh, P).float()
        Bm = conv_out[..., d_in:d_in + G * N].reshape(B_, G, N)
        Cm = conv_out[..., d_in + G * N:].reshape(B_, G, N)
        dt = L.softplus(dt.float() + lp["dt_bias"])             # (B, nh)
        dA = torch.exp(dt * -torch.exp(lp["A_log"]))
        # heads map to groups in blocks of rep (jnp.repeat's order)
        Bh = torch.repeat_interleave(Bm, rep, dim=1).float()    # (B, nh, N)
        Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
        st.copy_(st * dA[..., None, None]
                 + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xin))
        y = torch.einsum("bhpn,bhn->bhp", st, Ch) + xin * lp["D"][..., None]
        y = L.rms_norm({"scale": lp["gate_norm_scale"]},
                       y.reshape(B_, d_in).to(x.dtype) * F.silu(z))
        x = x + L.masked_dense_apply(y, lp["w_out"])
    x = L.rms_norm(params["final_norm"], x)
    return L.unembed(params["embed"]["table"], x), cache
