"""The launch counts and device dispatch every kernel wrapper shares
(`kernels.masked_matmul` for kernels 1-9, `kernels.bitpack` for 10-11).

A wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on one CUDA device.  On the meta
device (the twin of `jax.eval_shape` through a ``pallas_call``) it
checks its operands as the launch path does and returns empty meta
tensors of the kernel's output shapes and types, launching nothing: meta
tensors hold no numbers, so this is no fallback.  Mixed devices raise.
Each launch adds one to `LAUNCHES[name]`, so a run can show that it went
through the kernels; a meta call adds nothing there.

On the card and on meta every wrapper states the work of its call from
the shapes (`count_work`: the function's flops, and its bytes with each
input read once and each output written once): an open
`torch.utils.flop_counter.FlopCounterMode` then counts the kernels'
flops under their names beside the aten ops' (it cannot see a ctypes
launch), and an open `work_counter()` sums both.  On the CPU the plain
version's aten ops count themselves.

Every wrapper runs its body inside `kernel_boundary`: while an op walker
(`analysis.op_lint.OpWalker`) is open, the ops of the body are hidden
from it and the call is shown to it as one opaque op, on the CPU (whose
plain version computes m * w, which the card never holds) and on the
card alike; the twin of the reference's jaxpr walker never entering a
``pallas_call``.
"""
from __future__ import annotations

import contextlib
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


def placement(*tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "meta" when every one is a
    meta tensor, "cuda" when all lie on one CUDA device; raises
    otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}):
        return kinds.pop()
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands must all lie on the CPU, all on the "
                         f"meta device or all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return "cuda"


# the work counters open now (`work_counter`)
_WORK: list = []


@contextlib.contextmanager
def work_counter():
    """Sum the work the kernel wrappers state while open: yields
    {name: {"calls", "flops", "bytes"}}, filled as they run."""
    tally: dict = {}
    _WORK.append(tally)
    try:
        yield tally
    finally:
        _WORK.remove(tally)


def _flop_counters() -> list:
    """The `FlopCounterMode`s open on this thread (their dispatch modes
    sit on the mode stack and point back at them)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch.utils.flop_counter import FlopCounterMode
    out = []
    for mode in _get_current_dispatch_mode_stack():
        counter = getattr(mode, "counter", None)
        if isinstance(counter, FlopCounterMode) and counter not in out:
            out.append(counter)
    return out


def count_work(name: str, flops: int, nbytes: int) -> None:
    """State one call's work: its flops go to every open
    `FlopCounterMode` (under the kernel's name, at every module level it
    tracks), flops and bytes to every open `work_counter`."""
    for tally in _WORK:
        t = tally.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        t["calls"] += 1
        t["flops"] += int(flops)
        t["bytes"] += int(nbytes)
    if not flops:
        return
    for counter in _flop_counters():
        for par in set(counter.mod_tracker.parents):
            counter.flop_counts[par][name] += int(flops)


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped): each read or written
    once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
