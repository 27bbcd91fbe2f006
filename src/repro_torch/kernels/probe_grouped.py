"""What binds kernels 5-6's tensor-core body: time variants of it.

    PYTHONPATH=src python -m repro_torch.kernels.probe_grouped

runs on one CUDA card; it loads no library of the package, only the
variants'.  Each variant is the body of kernel 5
(csrc/masked_matmul_grouped.cu) with a part taken out: a textual patch
of copies of its headers, built with the library's nvcc flags into
`build/repro_torch_probe/<variant>/`.  Every variant is then timed in a
process of its own (two libraries holding the same kernel template in
one process did not launch), in turns, for two rounds: one
deepseek-v2-lite MoE layer (E = 64 experts, M = 30 rows, the three
expert projections, mode "sample"), 20 launches of the layer between
CUDA events, six times.  A variant that takes a part out computes
something else, so only "base" and the ones that keep the arithmetic
are checked against the plain version.

    --time VARIANT [--plan BC,SPLIT,W_STAGES,A_BUFS]   one variant, here
    --sass PATH    also write `cuobjdump -sass` of the base library
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import masked_matmul as mm

OUT = build.BUILD_DIR.parent / "repro_torch_probe"
WG, GW = "masked_matmul_wgmma.cuh", "masked_matmul_grouped_wgmma.cuh"
_MASK0 = "mask_bit(sv[2 * t], idx + (2 * t) * step, smix, MODE, p.tau)"
_MASK1 = """mask_bit(sv[2 * t + 1], idx + (2 * t + 1) * step,
                                   smix, MODE, p.tau)"""
_GATE_ORDER = ("""    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t lo =
          mask_bit(sv[2 * t], idx + (2 * t) * step, smix, MODE, p.tau)
              ? wv[2 * t] : 0u;
      const uint32_t hi = mask_bit(sv[2 * t + 1], idx + (2 * t + 1) * step,
                                   smix, MODE, p.tau)
                              ? wv[2 * t + 1] : 0u;
      v[t] = lo | (hi << 16);
    }""", """    float theta[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) theta[t] = sigmoid(sv[t]);
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool m0 = MODE == 1 ? theta[2 * t] > p.tau
          : hash_uniform(idx + (2 * t) * step, smix) < theta[2 * t];
      const bool m1 = MODE == 1 ? theta[2 * t + 1] > p.tau
          : hash_uniform(idx + (2 * t + 1) * step, smix) < theta[2 * t + 1];
      v[t] = (m0 ? wv[2 * t] : 0u) | ((m1 ? wv[2 * t + 1] : 0u) << 16);
    }""")
# (header, text, replacement) patches of each part
_NO_MEMORY = [(GW, "    if (tid != 0 || i >= n) return;",
               "    if (tid >= 0) return;"),
              (GW, "    mbar_wait(L.full_w(st), (i / p.w_stages) & 1);\n", "")]
_NO_GATE = [(GW, """    if (p.mode == 1)
      wg::gate_tile<BC, DX, 1>""", """    if (p.mode == 7)
      wg::gate_tile<BC, DX, 1>"""),
            (GW, """    else
      wg::gate_tile<BC, DX, 0>(gen(L.b(i & 1)), wr, sr, (j0 + i) * BR, c0,
                               smix, gp, tid);""", "")]
_NO_SPLIT = [(GW, "    for (int t = stid; t < tasks; t += THREADS) {",
              "    for (int t = stid; t < 0; t += THREADS) {"),
             (GW, "if (stid < tasks) fetch(stid, 0, pre);", ""),
             (GW, "if (stid < tasks) fetch(stid, i + 1, pre);", "")]
_NO_PRODUCTS = [(GW, "wg::wgmma_bf16<BC>(acc, da + 2 * kk, db + 2 * kk);",
                 "(void)da;")]
VARIANTS = {
    "base": [],
    "no_gate": _NO_GATE,
    "mask_by_sign": [(WG, _MASK0, "(sv[2 * t] > 0.0f)"),
                     (WG, _MASK1, "(sv[2 * t + 1] > 0.0f)")],
    "hash_only": [(WG, _MASK0,
                   "(hash_uniform(idx + (2 * t) * step, smix) < 0.5f)"),
                  (WG, _MASK1,
                   "(hash_uniform(idx + (2 * t + 1) * step, smix) < 0.5f)")],
    "sigmoid_only": [(WG, _MASK0, "(0.5f < sigmoid(sv[2 * t]))"),
                     (WG, _MASK1, "(0.5f < sigmoid(sv[2 * t + 1]))")],
    "no_products": _NO_PRODUCTS,
    "no_memory": _NO_MEMORY,
    "no_memory_gate": _NO_MEMORY + _NO_GATE,
    "no_memory_gate_split": _NO_MEMORY + _NO_GATE + _NO_SPLIT,
    "skeleton": _NO_MEMORY + _NO_GATE + _NO_SPLIT + _NO_PRODUCTS,
    "one_fence": [(GW, """                               smix, gp, tid);
    fence_async_smem();
  };""", """                               smix, gp, tid);
  };""")],
    "sigmoids_first": [(WG,) + _GATE_ORDER],
}
# variants whose arithmetic is the body's: checked against the plain one
EXACT = ("base", "one_fence", "sigmoids_first")
# (variant, plan override) in the order of a round
RUNS = [(v, None) for v in VARIANTS] + [("base", "64,1,6,2"),
                                        ("base", "128,1,3,2")]
E, M = 64, 30
SHAPES = ((2048, 1408), (2048, 1408), (1408, 2048))   # w_gate, w_up, w_down


def _lib(name: str, out: Path = OUT) -> Path:
    return out / name / "lib.so"


def build_all(variants: dict = VARIANTS,
              source: str = "masked_matmul_grouped.cu",
              out: Path = OUT) -> None:
    """Patch copies of the headers and `source` and build every variant
    at once, each into `out/<variant>/lib.so`."""
    procs = {}
    for name, patches in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in build.HEADERS + (source,):
            text = (build.CSRC / f).read_text()
            for header, old, new in patches:
                if header == f:
                    if old not in text:
                        raise RuntimeError(f"{name}: patch not found in {f}")
                    text = text.replace(old, new)
            (d / f).write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(_lib(name, out)),
               str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {regs[:2]}")


def time_variant(name: str, plan: str | None) -> list:
    """Per-layer ms of variant `name`, six times, after a check against
    the plain version where the variant keeps the arithmetic."""
    fn = getattr(ctypes.CDLL(str(_lib(name))), "masked_matmul_grouped")
    fn.argtypes = build.ARGTYPES["masked_matmul_grouped"]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    seeds = [7] * E
    ops = []
    for K, N in SHAPES:
        x = torch.randn(E, M, K, generator=gen, device=dev)
        w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.randn(E, K, N, generator=gen, device=dev)
        y = torch.empty(E, M, N, device=dev)
        offs = [e * K * N for e in range(E)]
        # the plan without the card's occupancy query, which would load
        # the package's own library beside the variant's: at these
        # shapes it picks clusters of 1 or 2, which fill all 132 SMs
        p = mm.grouped_plan(E, M, K, N)
        args = (p["bc"], p["split"], p["w_stages"], p["a_bufs"], p["smem"])
        if plan:
            bc, split, ws, ab = map(int, plan.split(","))
            args = (bc, split, ws, ab, mm.grouped_smem(bc, 64, ab, ws))
        args += (mm._grid_flags((x, 4 * K), (w, 2 * N), (s, 4 * N),
                                (y, 4 * N)),)
        ops.append((x, w, s, y, mm._group_coords(seeds, offs, dev), K, N,
                    offs, args))
    stream = torch.cuda.current_stream().cuda_stream

    def layer():
        for x, w, s, y, c, K, N, _, args in ops:
            err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                     c[0].data_ptr(), c[1].data_ptr(), y.data_ptr(), E, M, K,
                     N, N, 0, 0.5, 0, *args, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, cudaError {err}")

    layer()
    torch.cuda.synchronize()
    if name in EXACT:
        for x, w, s, y, _, _, _, offs, _ in ops:
            want = ref.masked_matmul_grouped(x, w, s, seeds, offs)
            if not torch.allclose(y, want, rtol=1e-5,
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
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_grouped: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        t = time_variant(args.time, args.plan)
        print(f"{args.time} {args.plan or 'plan'}: per layer ms min "
              f"{min(t):.4f} max {max(t):.4f} {[round(v, 4) for v in t]}")
        return 0
    build_all()
    if args.sass:
        with open(args.sass, "w") as f:
            subprocess.run(["cuobjdump", "-sass", str(_lib("base"))],
                           stdout=f, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for _ in range(2):
        for name, plan in RUNS:
            cmd = [sys.executable, "-m", "repro_torch.kernels.probe_grouped",
                   "--time", name] + (["--plan", plan] if plan else [])
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
