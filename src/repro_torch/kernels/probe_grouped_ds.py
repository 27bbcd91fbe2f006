"""What binds kernel 7 on kernel 3's tensor-core body: time variants of it.

    PYTHONPATH=src python -m repro_torch.kernels.probe_grouped_ds

runs on one CUDA card; it loads no library of the package, only the
variants'.  Each variant is kernel 7 (csrc/masked_matmul_grouped_ds.cu
on csrc/masked_matmul_ds_wgmma.cuh) with a part taken out: a textual
patch of copies of the headers, built with the library's nvcc flags into
`build/repro_torch_probe_ds/<variant>/` (`probe_grouped.build_all`).
Every variant is then timed in a process of its own, in turns, for two
rounds: one deepseek-v2-lite MoE layer (E = 64 experts, M = 30 rows, the
three expert projections), 20 launches of the layer between CUDA
events, six times.  A variant that takes a part out computes something
else, so only "base" and "contiguous" (another order of the same
tiles) are checked against the plain version.

    --time VARIANT [--plan BN,STAGES,CHUNKS,GRID]   one variant, here,
                                                    with another plan
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import build, probe_grouped, ref
from repro_torch.kernels import masked_matmul as mm

OUT = build.BUILD_DIR.parent / "repro_torch_probe_ds"
DS = "masked_matmul_ds_wgmma.cuh"
SOURCE = "masked_matmul_grouped_ds.cu"
# (header, text, replacement) patches of each part
_NO_SIGMOID = [(DS, "const float sig0 = sigmoid(sv.x), sig1 = sigmoid(sv.y);",
                "const float sig0 = sv.x, sig1 = sv.y;")]
_NO_PRODUCTS = [(DS, "mma(2, 0); mma(1, 1); mma(0, 2); mma(1, 0); mma(0, 1); "
                 "mma(0, 0);", "")]
_NO_SPLIT = [(DS, "  using F = F32Stage<BN>;\n  const float* xe",
              "  if (tid >= 0) return;\n  using F = F32Stage<BN>;\n"
              "  const float* xe"),
             (DS, "  using F = F32Stage<BN>;\n  using L = Layout",
              "  if (tid >= 0) return;\n  using F = F32Stage<BN>;\n"
              "  using L = Layout")]
_NO_WS = [(DS, "const bool in_k = r0 < p.K;", "const bool in_k = false;")]
_NO_STORE = [(DS, """if (gk < p.K && tl.n0 + gn < p.N)
            *reinterpret_cast<float4*>""", """if (gk < -1)
            *reinterpret_cast<float4*>""")]
VARIANTS = {
    "base": [],
    # block b takes the contiguous range of tiles [T b / G, T (b + 1) / G)
    # instead of b, b + G, ...: the blocks running together then read
    # 256-byte pieces of w's rows far apart instead of whole rows
    "contiguous": [
        (DS, "  const int tiles = p.E * per_group;\n",
         "  const int tiles = p.E * per_group;\n"
         "  const int t_lo = (int)((int64_t)tiles * blockIdx.x / gridDim.x);\n"
         "  const int t_hi =\n"
         "      (int)((int64_t)tiles * (blockIdx.x + 1) / gridDim.x);\n"),
        (DS, "for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {",
         "for (int tile = t_lo; tile < t_hi; ++tile) {"),
        (DS, "(int)blockIdx.x < tiles", "t_lo < t_hi"),
        (DS, "tile_at<BN>(blockIdx.x, tiles_n, per_group)",
         "tile_at<BN>(t_lo, tiles_n, per_group)"),
        (DS, "tile + (int)gridDim.x < tiles", "tile + 1 < t_hi"),
        (DS, "tile_at<BN>(tile + gridDim.x, tiles_n, per_group)",
         "tile_at<BN>(tile + 1, tiles_n, per_group)")],
    "no_sigmoid": _NO_SIGMOID,
    "no_products": _NO_PRODUCTS,
    "no_split": _NO_SPLIT,
    "no_ws_loads": _NO_WS,
    "no_store": _NO_STORE,
    "no_memory": _NO_SPLIT + _NO_WS + _NO_STORE,
    "stream_only": _NO_SIGMOID + _NO_PRODUCTS + _NO_SPLIT,
    "skeleton": _NO_SPLIT + _NO_WS + _NO_STORE + _NO_SIGMOID + _NO_PRODUCTS,
}
# (variant, plan override "bn,stages,chunks,grid") in the order of a
# round: the plan (width 64, one stage, 12 (w, s) chunks, two blocks an
# SM), then one block an SM at width 64, and at width 128 with two
# stages (the plan of M > 32)
RUNS = [(v, None) for v in VARIANTS] + [
    ("base", "64,1,12,132"), ("base", "128,2,10,132")]
E, M = 64, 30
SHAPES = ((2048, 1408), (2048, 1408), (1408, 2048))   # w_gate, w_up, w_down


def time_variant(name: str, plan: str | None) -> list:
    """Per-layer ms of variant `name`, six times, after a check against
    the plain version for the variants that keep the arithmetic."""
    fn = getattr(ctypes.CDLL(str(probe_grouped._lib(name, OUT))), SOURCE[:-3])
    fn.argtypes = build.ARGTYPES[SOURCE[:-3]]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops = []
    for K, N in SHAPES:
        x = torch.randn(E, M, K, generator=gen, device=dev)
        g = torch.randn(E, M, N, generator=gen, device=dev)
        w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.randn(E, K, N, generator=gen, device=dev)
        ds = torch.empty(E, K, N, device=dev)
        p = mm.ds_plan(M, K, N, torch.float32, sms, E)
        if plan:
            bn, stages, chunks, grid = map(int, plan.split(","))
            p = dict(p, bn=bn, stages=stages, chunks=chunks, grid=grid,
                     smem=mm.ds_smem(bn, stages, chunks, True))
        tma = mm._grid_flags((x, 4 * K), (g, 4 * N), (w, 2 * N), (s, 4 * N),
                             (ds, 4 * N))
        ops.append((x, g, w, s, ds, K, N, (0, p["bn"], p["stages"],
                                           p["chunks"], p["smem"], p["grid"],
                                           tma)))
    stream = torch.cuda.current_stream().cuda_stream

    def layer():
        for x, g, w, s, ds, K, N, args in ops:
            err = fn(x.data_ptr(), g.data_ptr(), w.data_ptr(), s.data_ptr(),
                     ds.data_ptr(), E, M, K, N, *args, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, cudaError {err}")

    layer()
    torch.cuda.synchronize()
    if name in ("base", "contiguous"):
        for x, g, w, s, ds, *_ in ops:
            want = ref.masked_matmul_grouped_ds(x, g, w, s)
            if not torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max())):
                raise RuntimeError(f"{name}: differs from the plain version")
    times = []
    for _ in range(6):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        for _ in range(20):
            layer()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 20)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", choices=sorted(VARIANTS))
    ap.add_argument("--plan", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_grouped_ds: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        t = time_variant(args.time, args.plan)
        print(f"{args.time} {args.plan or 'plan'}: per layer ms min "
              f"{min(t):.4f} max {max(t):.4f} {[round(v, 4) for v in t]}")
        return 0
    probe_grouped.build_all(VARIANTS, SOURCE, OUT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for _ in range(2):
        for name, plan in RUNS:
            cmd = [sys.executable, "-m",
                   "repro_torch.kernels.probe_grouped_ds", "--time", name]
            cmd += ["--plan", plan] if plan else []
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
