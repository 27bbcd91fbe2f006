"""Plain PyTorch versions of the hand-written kernels (the oracles).

Each function computes exactly what its CUDA kernel computes, with
ordinary tensor ops, on any device.  The wrappers in
`repro_torch.kernels.masked_matmul` run these for CPU tensors; the tests
and `chip_smoke.py` hold the kernels against them.

uint32 arithmetic: torch has no uint32 arithmetic on the CPU, so the
hash runs in int64 with ``& 0xFFFFFFFF`` after every op.  Products of
two values below 2**32 wrap mod 2**64 in int64 and keep their low 32
bits, so the emulation is bit-exact against a true uint32 pipeline.
Packed words are stored as int32 tensors holding the uint32 bit
pattern (torch has no general uint32 tensor ops either).
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _U32


def hash_uniform(idx: torch.Tensor, seed) -> torch.Tensor:
    """Counter-based uniform in [0, 1) of a uint32 index (int64 tensor
    holding values in [0, 2**32)) under a uint32 `seed` (int or int64
    tensor broadcastable against `idx`).  Bit-identical to the CUDA
    device function `hash_uniform` in csrc/hash.cuh."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=idx.device)
    s = _u32(s + 1)
    s = _u32((s ^ (s >> 16)) * 0x45D9F3B5)
    s = s ^ (s >> 11)
    x = _u32(_u32(idx) + _u32(0x9E3779B9 * s))
    x = _u32((x ^ (x >> 16)) * 0x85EBCA6B)
    x = _u32((x ^ s ^ (x >> 13)) * 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def flat_index(K: int, N: int, off, n_logical: int, device) -> torch.Tensor:
    """uint32 hash index off + row*n_logical + col of a (K, N) block."""
    rows = torch.arange(K, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(N, dtype=torch.int64, device=device)[None, :]
    off = torch.as_tensor(off, dtype=torch.int64, device=device)
    return _u32(_u32(off) + _u32(rows * n_logical) + cols)


def sample_mask(s: torch.Tensor, seed, off=0, n_logical=None) -> torch.Tensor:
    """uint8 Bernoulli mask 1[hash_u(seed, off + row*N + col) < sigmoid(s)]
    of a (K, N) score block; `off` shifts the flat index (layer-stacked
    leaves), `n_logical` overrides the row stride of the index."""
    K, N = s.shape
    idx = flat_index(K, N, off, N if n_logical is None else n_logical,
                     s.device)
    u = hash_uniform(idx, seed)
    return (u < torch.sigmoid(s.float())).to(torch.uint8)


def threshold_mask(s: torch.Tensor, tau=0.5) -> torch.Tensor:
    """The deterministic FedMask mask m = 1[sigmoid(s) > tau]."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=s.device)
    return (torch.sigmoid(s.float()) > tau).to(torch.uint8)


def _block_mask(s, seed, off, n_logical, mode, tau):
    if mode == "threshold":
        return threshold_mask(s, tau)
    return sample_mask(s, seed, off, n_logical)


def masked_matmul(x, w, s, seed, off=0, n_logical=None, mode="sample",
                  tau=0.5):
    """y = x @ (m * w), f32 accumulation, cast to x.dtype."""
    m = _block_mask(s, seed, off, n_logical, mode, tau)
    wm = m.float() * w.float()
    return (x.float() @ wm).to(x.dtype)


def masked_matmul_dx(g, w, s, seed, off=0, n_logical=None, mode="sample",
                     tau=0.5):
    """dx = g @ (m * w)^T with the forward's mask, cast to g.dtype."""
    m = _block_mask(s, seed, off, n_logical, mode, tau)
    wm = m.float() * w.float()
    return (g.float() @ wm.T).to(g.dtype)


def masked_matmul_ds(x, g, w, s):
    """STE score gradient ds = (x^T @ g) * w * sigmoid(s)(1 - sigmoid(s)),
    cast to s.dtype."""
    xg = x.float().T @ g.float()
    sig = torch.sigmoid(s.float())
    return (xg * w.float() * sig * (1.0 - sig)).to(s.dtype)


def grouped_mask(s, seeds, offs, n_logical=None, mode="sample", tau=0.5):
    """(E, K, N) uint8 masks of stacked score blocks; group e samples at
    flat index offs[e] + row*n_logical + col of seeds[e]'s stream
    (offs[e] = e*K*N makes the E masks one stacked-leaf stream)."""
    if mode == "threshold":
        return threshold_mask(s, tau)
    return torch.stack([sample_mask(s[e], int(seeds[e]), int(offs[e]),
                                    n_logical) for e in range(s.shape[0])])


def masked_matmul_grouped(x, w, s, seeds, offs, n_logical=None,
                          mode="sample", tau=0.5):
    """y[e] = x[e] @ (m[e] * w[e]), f32 accumulation, cast to x.dtype.
    x: (E, M, K); w, s: (E, K, N); seeds, offs: E uint32 ints."""
    m = grouped_mask(s, seeds, offs, n_logical, mode, tau)
    wm = m.float() * w.float()
    return torch.bmm(x.float(), wm).to(x.dtype)


def masked_matmul_grouped_dx(g, w, s, seeds, offs, n_logical=None,
                             mode="sample", tau=0.5):
    """dx[e] = g[e] @ (m[e] * w[e])^T with the forward's masks, cast to
    g.dtype."""
    m = grouped_mask(s, seeds, offs, n_logical, mode, tau)
    wm = m.float() * w.float()
    return torch.bmm(g.float(), wm.transpose(1, 2)).to(g.dtype)


def masked_matmul_grouped_ds(x, g, w, s):
    """ds[e] = (x[e]^T @ g[e]) * w[e] * sigmoid(s[e])(1 - sigmoid(s[e])),
    cast to s.dtype."""
    xg = torch.bmm(x.float().transpose(1, 2), g.float())
    sig = torch.sigmoid(s.float())
    return (xg * w.float() * sig * (1.0 - sig)).to(s.dtype)


def masked_dense_grouped_bwd(x, w, s, seeds, offs, g, mode="sample",
                             tau=0.5):
    """The grouped STE backward (dx, ds) from the plain versions, with
    the stacked mask, m*w and x^T g materialized at (E, K, N)."""
    dx = masked_matmul_grouped_dx(g, w, s, seeds, offs, None, mode, tau)
    return dx, masked_matmul_grouped_ds(x, g, w, s)


def conv_weight(w, s, seed=0, off=0, n_logical=None, mode="sample",
                tau=0.5) -> torch.Tensor:
    """The f32 (W, C) taps m * w of a depthwise conv kernel leaf; the
    mask is drawn at flat index off + t*n_logical + c (the leaf's uplink
    stream).  mode "plain" takes w as it is (pre-materialized weights)."""
    if mode == "plain":
        return w.float()
    m = _block_mask(s, seed, off, n_logical, mode, tau)
    return m.float() * w.float()


def _shifted(x, W: int, flip: bool):
    """x (B, S, C) zero-padded on the time axis to S + W - 1: W - 1
    leading zeros (the causal forward) or trailing ones (`flip`, dL/dx)."""
    pad = (0, 0, 0, W - 1) if flip else (0, 0, W - 1, 0)
    return torch.nn.functional.pad(x, pad)


def masked_conv1d(x, w, s, seed=0, off=0, mode="sample", tau=0.5,
                  n_logical=None, flip=False):
    """Depthwise causal conv y[b,s,c] = sum_t x_pad[b,s+t,c] * wm[t,c]
    with wm = conv_weight(...), accumulated tap by tap in t order (the
    reference's order), f32 output.  `flip` reverses the taps (wm[W-1-t]
    at shift t) over trailing padding: the dL/dx correlation of the
    causal conv with the same mask.  x: (B, S, C) unpadded."""
    wm = conv_weight(w, s, seed, off, n_logical, mode, tau)
    W = wm.shape[0]
    S = x.shape[1]
    xp = _shifted(x, W, flip)
    row = (lambda t: W - 1 - t) if flip else (lambda t: t)
    out = xp[:, 0:S].float() * wm[row(0)]
    for t in range(1, W):
        out = out + xp[:, t:t + S].float() * wm[row(t)]
    return out


def masked_conv1d_ds(x, g, w, s, epilogue="ste"):
    """ds[t,c] = (sum_{b,s} x_pad[b,s+t,c] g[b,s,c]) * w * sigmoid'(s)
    (the STE score gradient, computed in f32 and cast to s.dtype), or
    with epilogue "dw" the raw f32 correlation, the plain conv's weight
    gradient.  x: (B, S, C) unpadded; g: (B, S, C); w, s: (W, C)."""
    W = w.shape[0]
    S = x.shape[1]
    xp = _shifted(x, W, False).float()
    gf = g.float()
    xg = torch.stack([torch.sum(xp[:, t:t + S] * gf, dim=(0, 1))
                      for t in range(W)])
    if epilogue == "dw":
        return xg
    sig = torch.sigmoid(s.float())
    return (xg * w.float() * sig * (1.0 - sig)).to(s.dtype)


def masked_conv1d_bwd(x, w, s, seed, g, off=0, mode="sample", tau=0.5):
    """The masked conv's STE backward (dx in x.dtype, ds in s.dtype)
    from the plain versions."""
    dx = masked_conv1d(g, w, s, seed, off, mode, tau, flip=True)
    return dx.to(x.dtype), masked_conv1d_ds(x, g, w, s)


def conv1d_plain(x, w):
    """Depthwise causal conv with a plain (W, C) kernel, f32 output."""
    return masked_conv1d(x, w, None, mode="plain")


def conv1d_plain_dw(x, g, w):
    """Weight gradient of `conv1d_plain` with (W, C) kernel w (f32)."""
    return masked_conv1d_ds(x, g, w, None, epilogue="dw")


def sample_rows(s2: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """(C, n) score rows + (C,) uint32 seeds -> (C, n) uint8 masks; row c
    draws flat indices 0..n-1 of seeds[c]'s stream."""
    _, n = s2.shape
    idx = torch.arange(n, dtype=torch.int64, device=s2.device)[None, :]
    seeds = torch.as_tensor(seeds, dtype=torch.int64,
                            device=s2.device)[:, None]
    u = hash_uniform(idx, seeds)
    return (u < torch.sigmoid(s2.float())).to(torch.uint8)


def threshold_rows(s2: torch.Tensor, tau=0.5) -> torch.Tensor:
    return threshold_mask(s2, tau)


def pack_bits(mask_flat: torch.Tensor) -> torch.Tensor:
    """(..., 32k) {0,1} -> (..., k) little-endian words (int32 bit
    pattern of the uint32 word)."""
    lead = mask_flat.shape[:-1]
    bits = mask_flat.to(torch.int64).reshape(*lead, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mask_flat.device)
    words = (bits << shifts).sum(dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_bits` over the last axis -> (..., n) uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].to(torch.uint8)


def sample_and_pack(s2, seeds, mode="sample", tau=0.5) -> torch.Tensor:
    """The sample-then-pack two-pass the fused kernel replaces:
    (C, n) scores -> (C, ceil(n/32)) words, bits past n zero."""
    m = threshold_rows(s2, tau) if mode == "threshold" else \
        sample_rows(s2, seeds)
    pad = (-m.shape[1]) % 32
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    return pack_bits(m)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32-stored uint32 words (int64)."""
    x = words.to(torch.int64) & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24
