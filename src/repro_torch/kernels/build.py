"""Build the CUDA kernels with nvcc and load them through ctypes.

Each source in `csrc/` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

The libraries go to `build/repro_torch/` at the repository root (listed
in .gitignore), named by a digest of their sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  `build()`
starts one nvcc per source, all at once, and raises if any fails; the
first wrapper call builds whatever is missing.  Nothing here runs at
import time.  The tensor-core bodies of kernels 1-3 and 5-7 fetch the
driver's cuTensorMapEncodeTiled through the runtime, so no library links
-lcuda.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
HEADERS = ("hash.cuh", "masked_matmul_tiles.cuh",
           "masked_matmul_wgmma.cuh", "masked_matmul_ds_wgmma.cuh",
           "masked_matmul_grouped_wgmma.cuh")
SOURCES = ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds",
           "sample_and_pack", "masked_matmul_grouped",
           "masked_matmul_grouped_dx", "masked_matmul_grouped_ds",
           "masked_conv1d", "masked_conv1d_ds", "pack_bits",
           "unpack_bits")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _U32, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_uint32, ctypes.c_float)
# argtypes of each C entry point: a library's kernel entry is named as
# its source and returns cudaGetLastError() as an int; the entries of
# ENTRY_LIBRARY live in another entry's library and return a value
ARGTYPES = {
    "masked_matmul_fwd": [_P, _P, _P, _P, _I, _I, _I, _U32, _U32, _U32, _I,
                          _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "masked_matmul_dx": [_P, _P, _P, _P, _I, _I, _I, _U32, _U32, _U32, _I,
                         _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "masked_matmul_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "sample_and_pack": [_P, _P, _P, _I, _I64, _I, _F, _I, _I, _I, _I, _P],
    "masked_matmul_grouped": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U32,
                              _I, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "masked_matmul_grouped_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _U32, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    "masked_matmul_grouped_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P],
    "masked_conv1d": [_P, _P, _P, _P, _I, _I, _I, _I, _U32, _U32, _U32, _I,
                      _F, _I, _I, _I, _I, _I, _P],
    "masked_conv1d_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    "pack_bits": [_P, _P, _I64, _I64, _I, _P],
    "unpack_bits": [_P, _P, _I64, _I64, _I64, _I, _P],
    "masked_matmul_fwd_capacity": [_I, _I, _I, _I],
    "masked_matmul_dx_capacity": [_I, _I, _I, _I],
    "masked_matmul_grouped_capacity": [_I, _I, _I, _I],
    "masked_matmul_grouped_dx_capacity": [_I, _I, _I, _I],
}
ENTRY_LIBRARY = {"masked_matmul_fwd_capacity": "masked_matmul_fwd",
                 "masked_matmul_dx_capacity": "masked_matmul_dx",
                 "masked_matmul_grouped_capacity": "masked_matmul_grouped",
                 "masked_matmul_grouped_dx_capacity":
                     "masked_matmul_grouped_dx"}

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together.  Returns {name: ptxas report}
    (the compiler's `-Xptxas -v` output; kept beside the library so a
    reused build reports it too).  Raises on any failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name).with_suffix(".log").read_text()
            for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use, with the
    argtypes of every entry point it holds set."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for entry in ARGTYPES:
            if ENTRY_LIBRARY.get(entry, entry) == name:
                fn = getattr(lib, entry)
                fn.argtypes = ARGTYPES[entry]
                fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def call(entry: str, *args) -> int:
    """Call C entry point `entry` and return its int."""
    return getattr(library(ENTRY_LIBRARY.get(entry, entry)), entry)(*args)


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point; raise on a CUDA error."""
    err = call(name, *args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
