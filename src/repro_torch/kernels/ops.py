"""Autograd wrappers around the masked-matmul kernels (the dense half of
`repro.kernels.ops`).

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import masked_matmul as mm


class _MaskedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, seed, off, mode, tau):
        K, N = w.shape
        x2 = x.reshape(-1, K).contiguous()
        y = mm.masked_matmul(x2, w, s, seed, off, mode=mode, tau=tau)
        ctx.save_for_backward(x2, w, s)
        ctx.coords = (seed, off, mode, tau, x.shape)
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, g):
        x2, w, s = ctx.saved_tensors
        seed, off, mode, tau, shape = ctx.coords
        g2 = g.reshape(-1, w.shape[1]).contiguous()
        dx = ds = None
        if ctx.needs_input_grad[0]:
            dx = mm.masked_matmul_dx(g2, w, s, seed, off, mode=mode,
                                     tau=tau).reshape(shape).to(x2.dtype)
        if ctx.needs_input_grad[2]:
            ds = mm.masked_matmul_ds(x2, g2, w, s).to(s.dtype)
        return dx, None, ds, None, None, None, None


def masked_dense(x, w, s, seed, off=0):
    """y = x @ (bern(sigmoid(s); seed, off) * w), STE backward.
    x: (..., K); w, s: (K, N); seed/off: uint32 ints."""
    return _MaskedDense.apply(x, w, s, int(seed), int(off), "sample", 0.5)


def masked_dense_threshold(x, w, s, tau=0.5):
    """y = x @ (1[sigmoid(s) > tau] * w), STE backward (FedMask)."""
    return _MaskedDense.apply(x, w, s, 0, 0, "threshold", float(tau))


def sample_and_pack(scores, seeds, mode="sample", tau=0.5):
    """Fused uplink sampler: (C, n) score rows + C uint32 seeds ->
    (C, ceil(n/32)) int32-stored uint32 words of the row masks."""
    return mm.sample_and_pack(scores, seeds, mode=mode, tau=tau)
