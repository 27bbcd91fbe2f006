"""Autograd wrappers around the masked-matmul and masked-conv kernels
(the dense, grouped and conv parts of `repro.kernels.ops`).

`masked_dense` is the mask-training forward of a dense layer with the
straight-through backward; all three passes run the fused kernels:

    y     = x @ (m*w)                        [masked_matmul]
    dL/dx = g @ (m*w)^T                      [masked_matmul_dx]
    dL/ds = (x^T @ g) * w * sigmoid'(s)      [masked_matmul_ds]

The backward regenerates the forward's mask from the same hash stream,
so the mask never exists in device memory.  Gradients flow to x and s
only: w is frozen and seed/off/tau are stream coordinates.  `off`
shifts the flat hash index, so the L per-layer launches over a stacked
(L, K, N) leaf (off = l*K*N) draw exactly the stream `sample_and_pack`
packs for the flattened leaf.  The JAX reference pads operands to 128
for its matrix unit; the CUDA kernels mask their ragged edges instead,
so no padding happens here and the hash keeps the logical column count.

`masked_dense_grouped` is the same for stacked (E, K, N) weights (the
MoE experts): one grouped launch per pass covers all E groups, group e
sampling at offs[e] of seeds[e]'s stream, so under the `MaskedLeaf`
convention (offs[e] = (l*E + e)*K*N) layer l's E masks are its slice of
the leaf's uplink stream.

`masked_conv1d` is the depthwise causal conv through a masked (W, C)
kernel leaf, f32 output:

    y     = sum_t x_pad[s+t] * (m*w)[t]           [masked_conv1d]
    dL/dx = the same taps flipped over g          [masked_conv1d, flip]
    dL/ds = (x^T * g) * w * sigmoid'(s)           [masked_conv1d_ds]

with the mask drawn at off + t*C + c (C the logical channel count; the
reference pads C to 128 for its vector unit, which the CUDA kernels do
not need).  `conv1d_plain` runs the same kernels mask-free for a
pre-materialized kernel, its weight gradient the raw correlation.

`pack_bits` / `unpack_bits` are the mask artifact's and the round mean's
bit packing (`kernels.bitpack`), with the reference's zero-pad to 32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bitpack
from repro_torch.kernels import masked_matmul as mm


class _MaskedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, seed, off, mode, tau, n_logical):
        K, N = w.shape
        x2 = x.reshape(-1, K).contiguous()
        y = mm.masked_matmul(x2, w, s, seed, off, n_logical=n_logical,
                             mode=mode, tau=tau)
        ctx.save_for_backward(x2, w, s)
        ctx.coords = (seed, off, mode, tau, n_logical, x.shape)
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, g):
        x2, w, s = ctx.saved_tensors
        seed, off, mode, tau, n_logical, shape = ctx.coords
        g2 = g.reshape(-1, w.shape[1]).contiguous()
        dx = ds = None
        if ctx.needs_input_grad[0]:
            dx = mm.masked_matmul_dx(g2, w, s, seed, off, n_logical=n_logical,
                                     mode=mode,
                                     tau=tau).reshape(shape).to(x2.dtype)
        if ctx.needs_input_grad[2]:
            ds = mm.masked_matmul_ds(x2, g2, w, s).to(s.dtype)
        return dx, None, ds, None, None, None, None, None


def masked_dense(x, w, s, seed, off=0, n_logical=None):
    """y = x @ (bern(sigmoid(s); seed, off) * w), STE backward.
    x: (..., K); w, s: (K, N); seed/off: uint32 ints; mask (k, n) drawn
    at off + k*n_logical + n (n_logical None: N), so a column block of a
    wider leaf draws that leaf's masks."""
    return _MaskedDense.apply(x, w, s, int(seed), int(off), "sample", 0.5,
                              n_logical)


def masked_dense_threshold(x, w, s, tau=0.5):
    """y = x @ (1[sigmoid(s) > tau] * w), STE backward (FedMask)."""
    return _MaskedDense.apply(x, w, s, 0, 0, "threshold", float(tau), None)


class _MaskedDenseGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, seeds, offs, mode, tau, n_logical):
        E = x.shape[0]
        K, N = w.shape[-2:]
        x3 = x.reshape(E, -1, K).contiguous()
        y = mm.masked_matmul_grouped(x3, w, s, seeds, offs,
                                     n_logical=n_logical, mode=mode, tau=tau)
        ctx.save_for_backward(x3, w, s)
        ctx.coords = (seeds, offs, mode, tau, n_logical, x.shape)
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, g):
        x3, w, s = ctx.saved_tensors
        seeds, offs, mode, tau, n_logical, shape = ctx.coords
        g3 = g.reshape(x3.shape[0], -1, w.shape[-1]).contiguous()
        dx = ds = None
        if ctx.needs_input_grad[0]:
            dx = mm.masked_matmul_grouped_dx(
                g3, w, s, seeds, offs, n_logical=n_logical, mode=mode,
                tau=tau).reshape(shape).to(x3.dtype)
        if ctx.needs_input_grad[2]:
            ds = mm.masked_matmul_grouped_ds(x3, g3, w, s).to(s.dtype)
        return dx, None, ds, None, None, None, None, None


def masked_dense_grouped(x, w, s, seeds, offs=None, n_logical=None):
    """y[e] = x[e] @ (bern(sigmoid(s[e]); seeds[e], offs[e]) * w[e]) for
    stacked (E, K, N) weights, STE backward.  x: (E, ..., K); seeds, offs:
    one uint32 or E of them (offs default e*K*N).  `n_logical`: the row
    length of the stream each group's block is cut from (None: N), so a
    column block of wider experts, its offsets moved by its first
    column, draws their masks."""
    if offs is None:
        K, N = w.shape[-2:]
        offs = np.arange(x.shape[0], dtype=np.int64) * (K * N)
    return _MaskedDenseGrouped.apply(x, w, s, seeds, offs, "sample", 0.5,
                                     n_logical)


def masked_dense_grouped_threshold(x, w, s, tau=0.5):
    """y[e] = x[e] @ (1[sigmoid(s[e]) > tau] * w[e]), STE backward
    (FedMask; no hash stream)."""
    return _MaskedDenseGrouped.apply(x, w, s, 0, 0, "threshold",
                                     float(tau), None)


class _MaskedConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, seed, off, mode, tau, n_logical):
        x = x.contiguous()
        y = mm.masked_conv1d(x, w, s, seed, off, n_logical=n_logical,
                             mode=mode, tau=tau)
        ctx.save_for_backward(x, w, s)
        ctx.coords = (seed, off, mode, tau, n_logical)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, s = ctx.saved_tensors
        seed, off, mode, tau, n_logical = ctx.coords
        g = g.contiguous()
        dx = ds = None
        if ctx.needs_input_grad[0]:
            dx = mm.masked_conv1d(g, w, s, seed, off, n_logical=n_logical,
                                  mode=mode, tau=tau, flip=True).to(x.dtype)
        if ctx.needs_input_grad[2]:
            ds = mm.masked_conv1d_ds(x, g, w, s)
        return dx, None, ds, None, None, None, None, None


def masked_conv1d(x, w, s, seed, off=0, n_logical=None):
    """Depthwise causal conv through the masked (W, C) kernel leaf,
    y[b,s,c] = sum_t x[b, s+t-(W-1), c] * (m*w)[t,c] with m ~
    bern(sigmoid(s); seed, off), STE backward.  x: (B, S, C); returns f32
    (B, S, C) (bias and cast stay with the caller).  Mask (t, c) is drawn
    at off + t*n_logical + c (n_logical None: C), so a channel block of a
    wider leaf, its offset moved by its first channel, draws that leaf's
    masks."""
    return _MaskedConv1d.apply(x, w, s, int(seed), int(off), "sample", 0.5,
                               n_logical)


def masked_conv1d_threshold(x, w, s, tau=0.5):
    """The same with m = 1[sigmoid(s) > tau] (FedMask; no hash stream)."""
    return _MaskedConv1d.apply(x, w, s, 0, 0, "threshold", float(tau), None)


class _Conv1dPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return mm.masked_conv1d(x, w, None, mode="plain")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm.masked_conv1d(g, w, None, mode="plain",
                                  flip=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = mm.masked_conv1d_ds(x, g, w, None,
                                     epilogue="dw").to(w.dtype)
        return dx, dw


def conv1d_plain(x, w):
    """Depthwise causal conv with a plain (pre-materialized) (W, C)
    kernel through the same kernels, f32 output; the weight gradient is
    the raw correlation."""
    return _Conv1dPlain.apply(x, w)


def sample_and_pack(scores, seeds, mode="sample", tau=0.5):
    """Fused uplink sampler: (C, n) score rows + C uint32 seeds ->
    (C, ceil(n/32)) int32-stored uint32 words of the row masks."""
    return mm.sample_and_pack(scores, seeds, mode=mode, tau=tau)


def pack_bits(mask_flat: torch.Tensor) -> torch.Tensor:
    """(n,) or (R, n) {0,1} values of any dtype -> (ceil(n/32),) or
    (R, ceil(n/32)) int32-stored uint32 words, zero-padded to 32 bits as
    `repro.kernels.ops.pack_bits` pads (the kernel pads by index)."""
    if mask_flat.dtype not in (torch.uint8, torch.bool):
        mask_flat = mask_flat.to(torch.uint8)
    return bitpack.pack_bits(mask_flat.contiguous())


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(W,) or (R, W) words -> (n,) or (R, n) uint8."""
    return bitpack.unpack_bits(words.contiguous(), n)
