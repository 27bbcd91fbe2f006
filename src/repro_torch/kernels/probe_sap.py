"""What binds kernel 4 (sample_and_pack): the stream or the gating.

    PYTHONPATH=src python -m repro_torch.kernels.probe_sap

runs on one CUDA card; it loads no library of the package, only the
variants'.  Each variant is csrc/sample_and_pack.cu with a part taken
out, a textual patch of a copy built with the library's nvcc flags into
`build/repro_torch_probe_sap/<variant>/` (`probe_grouped.build_all`):

    kernel        as it is
    exact         without the filter: every bit by the exact mask_bit
                  (the gating of kernel 4 before the filter)
    stream        the loads and the stores, no gating (m = 1[s > tau])
    gating        the gating, no score loads (scores made from the
                  address)
    exact_gating  the exact gating, no score loads
    skeleton      neither: the loop, the word formation and the stores

Every variant is timed in a process of its own, in turns, for two
rounds: one internlm2-1.8b round's uplink, the 7 layer-stacked leaves
(24 layers each, up to 402,653,184 scores a row) at C = 2 cohorts,
mode "sample", CUDA events around each round of 7 launches, five
times, under the launch plan (`kernels.masked_matmul.sap_plan`) and
under others: 1, 2 and 8 vector loads a lane in flight instead of 4,
2, 5, 6 and 8 blocks an SM instead of 4, and the scalar path (one lane an
element, 8 words a warp).  "kernel" and "exact" are first checked
against the plain version under every plan, in both modes, on two rows
of 2**20 and of 100,003 (the scalar path).  The share of a round's
elements that the filter sends to the exact path (|sigmoid(s) - u| or
|sigmoid(s) - tau| within the source's EPS) is estimated on the first
2**24 elements of each leaf's first row.

    --time VARIANT     one variant, here
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build, probe_grouped, ref
from repro_torch.kernels import masked_matmul as mm

OUT = build.BUILD_DIR.parent / "repro_torch_probe_sap"
SOURCE = "sample_and_pack.cu"
_SIG = "  const float sig = __fdividef(1.0f, 1.0f + __expf(-s));"
_NO_GATE = [(SOURCE, _SIG, "  return tau - s;\n" + _SIG)]
_NO_FILTER = [(SOURCE, _SIG, "  return repro::mask_bit(s, idx, smix, MODE, "
               "tau) ? -1.0f : 1.0f;\n" + _SIG)]
_SYNTH = """const uint32_t a = (uint32_t)(size_t)q >> 2;
  return make_float4(__uint_as_float(0x3F000000u | (a & 0x7FFFFu)),
                     __uint_as_float(0xBF000000u | ((a + 1u) & 0x7FFFFu)),
                     __uint_as_float(0x3F800000u | ((a + 2u) & 0x7FFFFu)),
                     __uint_as_float(0xBF800000u | ((a + 3u) & 0x7FFFFu)));"""
_NO_LOADS = [
    (SOURCE, "return __ldcs(reinterpret_cast<const float4*>(q));", _SYNTH),
    (SOURCE, "return __ldcs(q);",
     "return __uint_as_float(0x3F000000u | "
     "(((uint32_t)(size_t)q >> 2) & 0x7FFFFu));")]
VARIANTS = {"kernel": [], "exact": _NO_FILTER, "stream": _NO_GATE,
            "gating": _NO_LOADS, "exact_gating": _NO_FILTER + _NO_LOADS,
            "skeleton": _NO_GATE + _NO_LOADS}
EXACT = ("kernel", "exact")   # the variants checked against the plain one
# (label, unroll, blocks an SM, vector path) after the plan
PLANS = (("plan", None, None, True), ("unroll 1", 1, None, True),
         ("unroll 2", 2, None, True), ("unroll 8", 8, None, True),
         ("2 blocks/SM", None, 2, True), ("5 blocks/SM", None, 5, True),
         ("6 blocks/SM", None, 6, True), ("8 blocks/SM", None, 8, True),
         ("scalar", None, None, False))
LAYER_SHAPES = ((2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
                (2048, 8192), (2048, 8192), (8192, 2048))   # internlm2
N_LAYERS, COHORTS, SEEDS, TAU = 24, 2, (11, 12), 0.5


def exact_share(s: torch.Tensor, seed: int) -> tuple:
    """Shares of the elements of score row `s` whose margin lies within
    the source's EPS, which the filter sends to the exact path, in mode
    "sample" and "threshold" (at TAU), by the exact sigmoid (within 9e-7
    of the filter's)."""
    src = (build.CSRC / SOURCE).read_text()
    eps = float(re.search(r"constexpr float EPS = ([0-9.e+-]+)f;",
                          src).group(1))
    idx = torch.arange(s.numel(), dtype=torch.int64, device=s.device)
    sig = torch.sigmoid(s)
    u = ref.hash_uniform(idx, seed)
    return (float(((sig - u).abs() <= eps).float().mean()),
            float(((sig - TAU).abs() <= eps).float().mean()))


def _plan(C: int, n: int, sms: int, unroll, per_sm, vec: bool) -> dict:
    plan = mm.sap_plan(C, n, sms, aligned=vec, unroll=unroll)
    if per_sm:
        plan["grid"] = max(1, min(plan["grid"] * per_sm // mm.SAP_PER_SM,
                                  -(-plan["items"] // 8)))
    return plan


def time_variant(name: str) -> list:
    """[(label, [ms a round, five times])] of variant `name` under each
    plan, after a check against the plain version for the variants of
    EXACT."""
    fn = getattr(ctypes.CDLL(str(probe_grouped._lib(name, OUT))),
                 "sample_and_pack")
    fn.argtypes = build.ARGTYPES["sample_and_pack"]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    seeds = torch.tensor(SEEDS, dtype=torch.int32, device=dev)

    def launch(s, words, plan, mode=0):
        C, n = s.shape
        err = fn(s.data_ptr(), seeds.data_ptr(), words.data_ptr(), C, n,
                 mode, TAU, 0, int(plan["vec"]), plan["unroll"], plan["grid"],
                 stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, cudaError {err}")

    gen = torch.Generator(device=dev).manual_seed(4)
    if name in EXACT:
        for n in (1 << 20, 100_003):
            s = 2 * torch.randn(COHORTS, n, generator=gen, device=dev)
            for mode, mname in enumerate(("sample", "threshold")):
                want = ref.sample_and_pack(s, seeds.long(), mname, TAU)
                for label, unroll, per_sm, vec in PLANS:
                    words = torch.empty_like(want)
                    launch(s, words,
                           _plan(COHORTS, n, sms, unroll, per_sm, vec), mode)
                    torch.cuda.synchronize()
                    if not torch.equal(words, want):
                        raise RuntimeError(
                            f"{name} {label} n={n} {mname}: words differ "
                            f"from the plain version")
    leaves = []
    for K, N in LAYER_SHAPES:
        n = N_LAYERS * K * N
        s = torch.randn(COHORTS, n, generator=gen, device=dev)
        leaves.append((s, torch.empty(COHORTS, (n + 31) // 32,
                                      dtype=torch.int32, device=dev)))
    if name == "kernel":
        shares = [exact_share(s[0, :1 << 24], SEEDS[0]) for s, _ in leaves]
        print(f"share of the elements on the exact path, sample / "
              f"threshold: {max(a for a, _ in shares):.3g} / "
              f"{max(b for _, b in shares):.3g} (the largest of the 7 "
              f"leaves' first 2**24 scores)")
    out = []
    for label, unroll, per_sm, vec in PLANS:
        plans = [_plan(COHORTS, s.shape[1], sms, unroll, per_sm, vec)
                 for s, _ in leaves]

        def round_():
            for (s, words), plan in zip(leaves, plans):
                launch(s, words, plan)

        round_()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            round_()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        p = plans[-1]
        out.append((f"{label} (unroll {p['unroll']}, grid {p['grid']}, "
                    f"vec {int(p['vec'])})", times))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_sap: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        for label, t in time_variant(args.time):
            print(f"{args.time} {label}: ms a round min {min(t):.3f} max "
                  f"{max(t):.3f} {[round(v, 3) for v in t]}")
        return 0
    probe_grouped.build_all(VARIANTS, SOURCE, OUT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    nbytes = sum(COHORTS * (4 * N_LAYERS * K * N + 4 * ((N_LAYERS * K * N
                                                          + 31) // 32))
                 for K, N in LAYER_SHAPES)
    print(f"bound: {nbytes / 3.35e12 * 1e3:.3f} ms a round ({nbytes} bytes "
          f"at 3.35 TB/s)")
    for _ in range(2):
        for name in VARIANTS:
            cmd = [sys.executable, "-m", "repro_torch.kernels.probe_sap",
                   "--time", name]
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr)
                return out.returncode
            print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
