"""The launch counts and device dispatch every kernel wrapper shares
(`kernels.masked_matmul` for kernels 1-9, `kernels.bitpack` for 10-11).

A wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on one CUDA device; anything else
raises.  Each launch adds one to `LAUNCHES[name]`, so a run can show
that it went through the kernels.

Every wrapper runs its body inside `kernel_boundary`: while an op walker
(`analysis.op_lint.OpWalker`) is open, the ops of the body are hidden
from it and the call is shown to it as one opaque op, on the CPU (whose
plain version computes m * w, which the card never holds) and on the
card alike; the twin of the reference's jaxpr walker never entering a
``pallas_call``.
"""
from __future__ import annotations

import functools

import torch

KERNELS = ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds",
           "sample_and_pack", "masked_matmul_grouped",
           "masked_matmul_grouped_dx", "masked_matmul_grouped_ds",
           "masked_conv1d", "masked_conv1d_ds", "pack_bits", "unpack_bits")
LAUNCHES = {name: 0 for name in KERNELS}


# the op walkers open now, and how deep the calls are inside wrappers (a
# count, not a flag: a wrapper's body may call another wrapper)
WALKERS: list = []
_DEPTH = [0]


def kernel_boundary(name: str):
    """Decorator of a kernel wrapper: with a walker open, the wrapper's
    body runs hidden from it and the walker's `kernel(name, outputs)` is
    called once the outermost wrapper returns.  With none open it only
    calls the wrapper."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not WALKERS:
                return fn(*args, **kwargs)
            _DEPTH[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
            if not _DEPTH[0]:
                for w in list(WALKERS):
                    w.kernel(name, out)
            return out
        return call
    return wrap


def inside_kernel() -> bool:
    """True while a wrapper's body runs under an open walker."""
    return _DEPTH[0] > 0


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands must all lie on the CPU or on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return False


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
