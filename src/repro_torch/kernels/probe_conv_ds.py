"""Kernel 9's time under other launch plans: a sweep of (cluster, lanes).

    PYTHONPATH=src python -m repro_torch.kernels.probe_conv_ds

runs on one CUDA card.  At mamba2-370m's and recurrentgemma-9b's conv
shapes (B 2, S 128, C 2304 and 4096, W 4 taps, bf16 x, the "ste"
epilogue) it launches the package's `masked_conv1d_ds` under each plan:
the cluster size P that splits the time rows and the row lanes of a
block (`kernels.masked_matmul.conv_ds_plan` gives (8, 8) there).  Each is
checked against the plain version, then timed by CUDA events around
replays of a CUDA graph of 50 launches (the microsecond kernel's time
without the host's), twice, beside an empty kernel's replay time.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import masked_matmul as mm

PLANS = ((8, 8), (4, 8), (2, 8), (1, 8), (8, 4), (8, 2), (4, 4))
B, S, W = 2, 128, 4


def replay_us(fn, reps: int = 50) -> float:
    """Mean microseconds of one call of `fn` in a replayed CUDA graph of
    `reps` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / (5 * reps)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_conv_ds: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    empty = replay_us(lambda: torch.cuda._sleep(0))
    print(f"an empty kernel: {empty:.2f} us")
    for C in (2304, 4096):
        x = torch.randn(B, S, C, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(B, S, C, generator=gen, device=dev)
        w = torch.randn(W, C, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.randn(W, C, generator=gen, device=dev)
        ds = torch.empty(W, C, device=dev)
        want = ref.masked_conv1d_ds(x, g, w, s)
        row = []
        for cluster, lanes in PLANS:
            def launch():
                build.launch("masked_conv1d_ds", x.data_ptr(), g.data_ptr(),
                             w.data_ptr(), s.data_ptr(), ds.data_ptr(), B, S,
                             C, W, 0, 0, 0, cluster, lanes, 1,
                             torch.cuda.current_stream().cuda_stream)
            launch()
            torch.cuda.synchronize()
            if not torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max())):
                raise RuntimeError(f"plan ({cluster}, {lanes}) differs from "
                                   f"the plain version")
            t = [replay_us(launch) for _ in range(2)]
            row.append(f"({cluster},{lanes}) {t[0]:.2f}/{t[1]:.2f}")
        plan = mm.conv_ds_plan(B, S, C)
        print(f"C={C} (plan ({plan['cluster']},{plan['lanes']})), us: "
              + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
