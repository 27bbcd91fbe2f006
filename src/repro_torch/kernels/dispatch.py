"""The launch counts and device dispatch every kernel wrapper shares
(`kernels.masked_matmul` for kernels 1-9, `kernels.bitpack` for 10-11).

A wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on one CUDA device; anything else
raises.  Each launch adds one to `LAUNCHES[name]`, so a run can show
that it went through the kernels.
"""
from __future__ import annotations

import torch

KERNELS = ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds",
           "sample_and_pack", "masked_matmul_grouped",
           "masked_matmul_grouped_dx", "masked_matmul_grouped_ds",
           "masked_conv1d", "masked_conv1d_ds", "pack_bits", "unpack_bits")
LAUNCHES = {name: 0 for name in KERNELS}


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
