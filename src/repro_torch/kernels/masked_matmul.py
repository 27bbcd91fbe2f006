"""Wrappers of the nine hand-written CUDA kernels of mask training, each
beside its plain PyTorch version (the bit-packing kernels 10-11 have
theirs in `kernels.bitpack`).

    masked_matmul             y  = x @ (m * w)          csrc/masked_matmul_fwd.cu
    masked_matmul_dx          dx = g @ (m * w)^T        csrc/masked_matmul_dx.cu
    masked_matmul_ds          ds = (x^T g) * w * s'(s)  csrc/masked_matmul_ds.cu
    sample_and_pack           (C, n) scores -> (C, n/32) words
                                                        csrc/sample_and_pack.cu
                              (a persistent grid of 16-byte loads)
    masked_matmul_grouped     y[e]  = x[e] @ (m[e] * w[e])
                                                  csrc/masked_matmul_grouped.cu
    masked_matmul_grouped_dx  dx[e] = g[e] @ (m[e] * w[e])^T
                                               csrc/masked_matmul_grouped_dx.cu
    masked_matmul_grouped_ds  ds[e] = (x[e]^T g[e]) * w[e] * s'(s[e])
                                               csrc/masked_matmul_grouped_ds.cu
                              (on kernel 3's body: masked_matmul_ds_wgmma.cuh)
    masked_conv1d             y[b,s,c] = sum_t x_pad[b,s+t,c] (m * w)[t,c]
                                                  csrc/masked_conv1d.cu
                              (time rows over the whole launch)
    masked_conv1d_ds          ds[t,c] = (sum_{b,s} x_pad[b,s+t,c] g[b,s,c])
                                        * w * s'(s)  csrc/masked_conv1d_ds.cu
                              (split over a thread-block cluster)

m = 1[hash_u(seed, off + row*n_logical + col) < sigmoid(s)] in "sample"
mode, 1[sigmoid(s) > tau] in "threshold" mode; the hash index is uint32
and wraps, as in the JAX reference.  The grouped kernels take E stacked
(K, N) problems with per-group stream coordinates seeds[e], offs[e].  The
conv kernels take a depthwise (W, C) kernel leaf, its mask drawn at
off + t*n_logical + c; `masked_conv1d` also runs mask-free ("plain", for
pre-materialized weights) and with the taps flipped (dL/dx).

Dispatch is by the tensors' device: a CPU tensor runs the plain version
(`*_plain`, from `kernels.ref`), a CUDA tensor launches the kernel or
raises, a meta tensor gets an empty meta result of the kernel's output
shape and type (the dry run's shape-only path).  Nothing falls back.
Each launch adds one to `dispatch.LAUNCHES[name]`, so a run can show
that it went through the kernels; on the card and on meta each call
states its flops and bytes (`dispatch.count_work`): 2 M K N for kernels
1-2 and 5-6 (times E), the same plus EPILOGUE_FLOPS a score for 3 and 7,
2 W B S C for 8 and 9 (plus the epilogue), none for 4.  Each wrapper runs inside `dispatch.kernel_boundary`, so the op
walker (`analysis.op_lint`) sees a call as one opaque op.

The dense kernels take bf16 x/g, or f32 x/g where the reference feeds an
f32 activation (recurrentgemma's gate projections).  Kernels 1-2 run a
tensor-core body for bf16 x/g (csrc/masked_matmul_wgmma.cuh) whose
launch plan `wgmma_plan` computes here, from the card's occupancy query
(`card_capacity`), and a tiled SIMT body for f32 x/g.  Kernel 3 runs a
persistent tensor-core body for both (csrc/masked_matmul_ds_wgmma.cuh;
f32 x/g split into three bf16 parts) under the launch plan `ds_plan`.
The grouped kernels take f32 x/g (the MoE expert chain stays in f32, as
in the reference): kernels 5-6 run a tensor-core body
(csrc/masked_matmul_grouped_wgmma.cuh; x/g split into three bf16 parts,
m*w exact in bf16) under the launch plan `grouped_plan`, kernel 7 kernel
3's body on E groups under `ds_plan(..., E=E)`.  The conv kernels take
bf16 or f32 x and f32 g, with an f32 output; kernel 8 gives each thread
4 channels of 4 time rows, all of its loads in flight before the block
gates its taps once, under the launch plan `conv_plan`, and kernel 9
splits its time rows over a thread-block cluster under `conv_ds_plan`.
Kernel 4 runs a persistent grid whose warps issue several 16-byte score
loads each before they gate, and decides each bit from a cheap sigmoid
with an error band (the exact gating inside it), under the launch plan
`sap_plan`.
All take bf16 w and contiguous operands.  Kernels 1-9 take f32 or bf16
scores (kernels 3, 7 and 9's ds in the scores' type, kernel 9's "dw"
correlation f32): the device code reads a bf16 score block as it lies
and widens each score to f32 exactly before the gating, so no f32 copy
of it is made.  The wrappers raise on anything else rather than copy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build, dispatch, ref


masked_matmul_plain = ref.masked_matmul
masked_matmul_dx_plain = ref.masked_matmul_dx
masked_matmul_ds_plain = ref.masked_matmul_ds
sample_and_pack_plain = ref.sample_and_pack
masked_matmul_grouped_plain = ref.masked_matmul_grouped
masked_matmul_grouped_dx_plain = ref.masked_matmul_grouped_dx
masked_matmul_grouped_ds_plain = ref.masked_matmul_grouped_ds
masked_conv1d_plain = ref.masked_conv1d
masked_conv1d_ds_plain = ref.masked_conv1d_ds

# The bf16 body of kernels 1-2 (csrc/masked_matmul_wgmma.cuh): a block
# owns ROWS rows and BC output columns, walks its share of the reduction
# axis in stages of BR, and the blocks of a cluster (<= MAX_CLUSTER) split
# that axis.  Its shared memory: A_STAGES A tiles (ROWS x BR bf16), two
# gated B tiles (BC x BR bf16), w_stages raw (w bf16, s f32) tiles
# (BR x BC), 16 bytes of mbarriers a stage, and 1024 bytes of alignment.
WG_ROWS, WG_BR, WG_A_STAGES = 256, 64, 2
WG_WIDTHS = (32, 48, 64, 80, 96, 112, 128)   # as REPRO_WG_WIDTHS
WG_MAX_W_STAGES, MAX_CLUSTER = 8, 8
SMEM_LIMIT = 232_448            # bytes of shared memory a block can use
SM_SMEM = 233_472               # bytes of shared memory an SM holds
BLOCK_RESERVED = 1024           # of them the system keeps for each block
SMS = 132                       # streaming multiprocessors of an H100 SXM

_MODES = {"sample": 0, "threshold": 1, "plain": 2}
_EPILOGUES = {"ste": 0, "dw": 1}
_ACTS = (torch.bfloat16, torch.float32)   # activation types built for
_SCORES = (torch.float32, torch.bfloat16)  # score types of kernels 1-9


# flops an element of the ds epilogue (kernels 3, 7, 9): sigmoid'(s) =
# sigma * (1 - sigma) from the sigmoid (exp, add, divide), and the
# products with w and with the correlation
EPILOGUE_FLOPS = 7


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    """`dtype`: the type the kernel takes, or a tuple of types it takes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous {dtype} "
                         f"{tuple(shape)} tensor, got {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def _f32(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float32)


def _sbf16(s: torch.Tensor) -> int:
    return int(s.dtype == torch.bfloat16)


def _mask_mode(mode: str) -> str:
    """The mask modes of the matmul kernels (the conv takes "plain" too)."""
    if mode not in ("sample", "threshold"):
        raise ValueError(f"mask mode {mode!r}: sample or threshold")
    return mode


def _u32(v) -> int:
    return int(v) & 0xFFFFFFFF


def _i32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 holding their bit patterns."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def _group_u32(vals, E: int, name: str) -> list:
    """E per-group uint32 stream coordinates as Python ints, from one
    value (broadcast) or E of them (ints, a numpy array or a CPU
    tensor)."""
    a = np.asarray(vals, dtype=np.int64).reshape(-1)
    if a.size not in (1, E):
        raise ValueError(f"{name}: expected 1 or {E} per-group values, "
                         f"got {a.size}")
    return (np.broadcast_to(a, (E,)) & 0xFFFFFFFF).tolist()


def _group_coords(seeds: list, offs: list, dev) -> torch.Tensor:
    """(2, E) int32 device tensor of the seeds' and offsets' uint32 bit
    patterns, copied from pinned memory without a host synchronize."""
    t = _i32_bits(torch.tensor([seeds, offs], dtype=torch.int64))
    return t.pin_memory().to(dev, non_blocking=True)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_smem(bc: int, w_stages: int, s_bytes: int = 4) -> int:
    """Dynamic shared-memory bytes of the bf16 body at width `bc`, for
    scores of `s_bytes` bytes (4 f32, 2 bf16)."""
    return (1024 + WG_A_STAGES * WG_ROWS * WG_BR * 2 + 2 * bc * WG_BR * 2
            + w_stages * WG_BR * bc * (2 + s_bytes)
            + 16 * (WG_A_STAGES + w_stages))


def ideal_capacity(bc: int, split: int, smem: int) -> int:
    """Blocks the card would hold at once if clusters of `split` could
    take any SMs: one per SM (the shared memory allows no second)."""
    return SMS // split * split


def wgmma_plan(M: int, R: int, C: int, capacity=ideal_capacity,
               s_bytes: int = 4) -> dict:
    """Launch plan of kernels 1-2's bf16 body for out (M, C) = A (M, R) @
    B (R, C) (forward: R = K, C = N; dx: R = N, C = K): the width `bc`,
    the cluster size `split` over the reduction axis, the raw stages
    `w_stages`, the shared-memory bytes `smem` and the `grid`.  Block q
    of a cluster sums the stages [steps*q // split, steps*(q+1) // split)
    of WG_BR.

    Each stage moves BR x ((2 + s_bytes) bc) bytes of w and s from device
    memory and a (256 x BR) tile of A from L2; a block's time is its
    stages plus one for set-up and the cluster reduction, and the blocks
    beyond what the card holds at once, `capacity(bc, split, smem)` (on
    the card: the occupancy query of the kernel's library), run in
    further waves.  The plan minimizes waves x that time, then the block
    count: one full wave of short blocks beats a second, partly empty
    wave."""
    steps, mblocks = _cdiv(R, WG_BR), _cdiv(M, WG_ROWS)
    best = None
    for bc in WG_WIDTHS:
        w_stages = WG_MAX_W_STAGES
        while wgmma_smem(bc, w_stages, s_bytes) > SMEM_LIMIT:
            w_stages -= 1
        smem = wgmma_smem(bc, w_stages, s_bytes)
        tiles = _cdiv(C, bc) * mblocks
        for split in range(1, min(MAX_CLUSTER, max(steps, 1)) + 1):
            blocks = tiles * split
            per_block = ((_cdiv(steps, split) + 1) * WG_BR
                         * ((2 + s_bytes) * bc + 2 * WG_ROWS))
            waves = _cdiv(blocks, capacity(bc, split, smem))
            key = (waves * per_block, blocks, split)
            if best is None or key < best[0]:
                best = (key, dict(bc=bc, split=split, w_stages=w_stages,
                                  smem=smem,
                                  grid=(split, _cdiv(C, bc), mblocks)))
    return best[1]


def _grid_flags(*pairs) -> int:
    """Bit i: tensor i of the (tensor, row pitch in bytes) pairs lies on
    the 16-byte grid (its base and its pitch), so the kernel may move it
    by TMA (or by 16-byte vectors); element by element otherwise."""
    return sum(1 << i for i, (t, pitch) in enumerate(pairs)
               if pitch % 16 == 0 and t.data_ptr() % 16 == 0)


def _tma_flags(a, w, s, R: int, N: int) -> int:
    """Bit 0, 1, 2: A, w, s go by TMA (a row pitch and a base on the
    16-byte grid); the kernel loads the others element by element."""
    return (_grid_flags((a, 2 * R), (w, 2 * N), (s, s.element_size() * N))
            if R else 0)


def card_capacity(kernel: str, s_bf16: int = 0):
    """`capacity` for `wgmma_plan` or `grouped_plan` from kernel
    `kernel`'s occupancy query on the current card, of the build for the
    score type `s_bf16`."""
    def capacity(bc: int, split: int, smem: int) -> int:
        n = build.call(f"{kernel}_capacity", bc, split, smem, s_bf16)
        if n <= 0:
            raise RuntimeError(f"{kernel}: occupancy query for bc={bc} "
                               f"split={split} failed: {n}")
        return n
    return capacity


@functools.lru_cache(maxsize=None)
def card_plan(kernel: str, device: int, M: int, R: int, C: int,
              s_bytes: int = 4) -> dict:
    """`wgmma_plan` on card `device`, computed once per shape and score
    type."""
    with torch.cuda.device(device):
        return wgmma_plan(M, R, C, card_capacity(kernel, int(s_bytes == 2)),
                          s_bytes)


def _plan_args(kernel: str, a, w, s, M: int, R: int, C: int,
               N: int) -> tuple:
    """(bc, split, w_stages, smem, tma) for the C entry point; the plan
    only steers bf16 activations (f32 ones run the SIMT body)."""
    if a.dtype != torch.bfloat16:
        return (0, 1, 1, 0, 0)
    plan = card_plan(kernel, a.device.index, M, R, C, s.element_size())
    return (plan["bc"], plan["split"], plan["w_stages"], plan["smem"],
            _tma_flags(a, w, s, R, N))


# Kernel 3's tensor-core body (csrc/masked_matmul_ds_wgmma.cuh): a block
# owns a DS_BK x bn tile of ds and all of M; bf16 x/g come in a ring of
# `stages` stages of DS_BMS rows (x: DS_BK, g: bn columns), f32 x/g are
# split into 3 bf16 parts in `stages` stages of DS_BMF rows (2, or 1
# where M <= DS_BMF); w and s come in a
# ring of `chunks` chunks of DS_WR rows x bn (6 bytes an element), one
# for each of the DS_BK / DS_WR consumer warps a tile; 16 bytes of
# mbarriers a stage and a chunk, and 1024 bytes of alignment.
DS_BK, DS_BMS, DS_BMF, DS_WR = 128, 64, 32, 16
DS_LONG_ROWS = 512            # f32 rows of M past which the LONG build runs
DS_WIDTHS = (64, 128)                         # as REPRO_DS_WIDTHS
DS_MAX_STAGES = 4
DS_RING_BYTES = 96 * 1024     # of (w, s) chunks: a tile at bn = 128


def ds_smem(bn: int, stages: int, chunks: int, f32: bool,
            s_bytes: int = 4) -> int:
    """Dynamic shared-memory bytes of kernel 3's body, for scores of
    `s_bytes` bytes (4 f32, 2 bf16)."""
    rows = stages * 3 * DS_BMF if f32 else stages * DS_BMS
    return (1024 + rows * (DS_BK + bn) * 2
            + chunks * DS_WR * bn * (2 + s_bytes) + 16 * (stages + chunks))


def ds_plan(M: int, K: int, N: int, act=torch.bfloat16,
            sms: int = SMS, E: int = 1, s_bytes: int = 4) -> dict:
    """Launch plan of kernel 3's body for ds (K, N) from x (M, K) and
    g (M, N) of type `act`, or of kernel 7's for E stacked such problems:
    the tile (`bk`, `bn`), the x/g `stages`, the (w, s) `chunks`, the
    shared-memory bytes `smem`, the blocks an SM holds (`per_sm`) and
    the persistent `grid`, at most per_sm blocks an SM.  The blocks take
    the E * (K / bk) * (N / bn) tiles in turn.

    The wider tile reads fewer bytes of x and g from L2 per byte of w, s
    and ds (2*M*(bk + bn) against 10*bk*bn), so bn = 128 unless its
    tiles would leave SMs without one; then bn = 64, one block an SM.
    bf16: the (w, s) ring holds DS_RING_BYTES, a tile's chunks at
    bn = 128, two tiles' at 64, and as many x/g stages as fit beside it,
    at most DS_MAX_STAGES (256 rows, the main path's M).  f32: two
    stages, which the consumers fill while the other is multiplied, and
    as many chunks as fit beside them, at most two tiles': the deeper
    ring lets the (w, s) loads of the next tile run while this one's
    epilogue holds its chunks.  f32 at M <= DS_BMF (the MoE capacity):
    a tile's only stage in one buffer, and two blocks an SM at bn = 64
    (the kernel's 96-register build), so that 16 consumer warps hide the
    latency of the sigmoid epilogue, each block in half the SM's shared
    memory.  bf16 scores (`s_bytes` 2) make a chunk 4 bytes an element,
    so the bf16 ring's DS_RING_BYTES hold more chunks.  f32 at M >
    DS_LONG_ROWS runs the body's LONG build at width 64, one block an SM,
    which folds the tensor cores' partial sum into f32 registers every
    128 rows."""
    f32 = act == torch.float32
    tiles = {bn: E * _cdiv(K, DS_BK) * _cdiv(N, bn) for bn in DS_WIDTHS}
    bn, per_sm, budget = (128 if tiles[128] >= sms else 64), 1, SMEM_LIMIT
    if f32 and M <= DS_BMF:
        bn, per_sm, budget = 64, 2, SM_SMEM // 2 - BLOCK_RESERVED
    if f32 and M > DS_LONG_ROWS:
        bn = 64
    if f32:
        stages, chunks = (1 if M <= DS_BMF else 2), 2 * DS_BK // DS_WR
        while ds_smem(bn, stages, chunks, f32, s_bytes) > budget:
            chunks -= 1
    else:
        stages = DS_MAX_STAGES
        chunks = DS_RING_BYTES // (DS_WR * bn * (2 + s_bytes))
        while ds_smem(bn, stages, chunks, f32, s_bytes) > budget:
            stages -= 1
    return dict(bk=DS_BK, bn=bn, stages=stages, chunks=chunks,
                smem=ds_smem(bn, stages, chunks, f32, s_bytes),
                per_sm=per_sm,
                grid=max(1, min(tiles[bn], per_sm * sms)))


# Kernels 5-6's body (csrc/masked_matmul_grouped_wgmma.cuh): a block owns
# `rows` = 64*ceil(min(M, GW_MAX_ROWS)/64) rows of one group's M block and
# BC output columns, walks its share of the reduction axis in stages of
# WG_BR, and the blocks of a cluster (<= MAX_CLUSTER) split that axis.
# Its shared memory: a_bufs A buffers (3 bf16 parts of rows x WG_BR), two
# gated B tiles (BC x WG_BR bf16), w_stages raw (w bf16, s f32 or bf16)
# tiles (WG_BR x BC), an 8-byte mbarrier a stage, and 1024 bytes of
# alignment.
GW_WIDTHS = (64, 128)                    # as REPRO_GW_WIDTHS
GW_MAX_ROWS, GW_PARTS, GW_MAX_W_STAGES = 256, 3, 8


def grouped_rows(M: int) -> int:
    """Rows of A a block of kernels 5-6 holds: whole 64-row wgmma tiles
    of the M block, at most GW_MAX_ROWS."""
    return 64 * _cdiv(min(M, GW_MAX_ROWS), 64)


def grouped_smem(bc: int, rows: int, a_bufs: int, w_stages: int,
                 s_bytes: int = 4) -> int:
    """Dynamic shared-memory bytes of kernels 5-6's body, for scores of
    `s_bytes` bytes (4 f32, 2 bf16)."""
    return (1024 + a_bufs * GW_PARTS * rows * WG_BR * 2 + 2 * bc * WG_BR * 2
            + w_stages * WG_BR * bc * (2 + s_bytes) + 8 * w_stages)


def grouped_plan(E: int, M: int, R: int, C: int,
                 capacity=ideal_capacity, s_bytes: int = 4) -> dict:
    """Launch plan of kernels 5-6's body for out[e] (M, C) = A[e] (M, R) @
    B[e] (R, C), e < E (forward: R = K, C = N; dx: R = N, C = K): the
    width `bc`, the cluster size `split` over the reduction axis, the
    block's `rows`, the A buffers `a_bufs`, the raw stages `w_stages`,
    the shared-memory bytes `smem` and the `grid` (split, column tiles,
    E x M blocks).  Block q of a cluster sums the stages
    [steps*q // split, steps*(q+1) // split) of WG_BR.

    Two A buffers (the split of stage i+1 beside the products of stage i)
    where two raw stages still fit beside them, else one; then as many
    raw stages as fit, at most GW_MAX_W_STAGES (scores of `s_bytes` 2,
    bf16, make a stage 4 bytes a weight instead of 6, so more fit beside
    256 rows of A).  Each stage moves BR x ((2 + s_bytes) bc) bytes of w
    and s from device memory and rows x BR f32 of A from L2; a block's
    time is its stages plus one for set-up and the cluster reduction,
    and the blocks beyond what the card holds at once
    (`capacity(bc, split, smem)`, on the card the occupancy query) run in
    further waves.  The plan minimizes waves x that time, then the block
    count: the E x column-tile blocks of the deepseek-v2-lite shapes (704
    or 1024 at E = 64) do not divide into whole waves of 132, and a
    cluster split of 2 makes 704 into 10.7 waves of shorter blocks."""
    steps, mblocks = _cdiv(R, WG_BR), _cdiv(M, GW_MAX_ROWS)
    rows = grouped_rows(M)
    best = None
    for bc in GW_WIDTHS:
        a_bufs = (2 if grouped_smem(bc, rows, 2, 2, s_bytes) <= SMEM_LIMIT
                  else 1)
        w_stages = GW_MAX_W_STAGES
        while grouped_smem(bc, rows, a_bufs, w_stages, s_bytes) > SMEM_LIMIT:
            w_stages -= 1
        smem = grouped_smem(bc, rows, a_bufs, w_stages, s_bytes)
        tiles = E * _cdiv(C, bc) * mblocks
        for split in range(1, min(MAX_CLUSTER, max(steps, 1)) + 1):
            blocks = tiles * split
            per_block = ((_cdiv(steps, split) + 1) * WG_BR
                         * ((2 + s_bytes) * bc + 4 * rows))
            waves = _cdiv(blocks, capacity(bc, split, smem))
            key = (waves * per_block, blocks, split)
            if best is None or key < best[0]:
                best = (key, dict(bc=bc, split=split, rows=rows,
                                  a_bufs=a_bufs, w_stages=w_stages,
                                  smem=smem,
                                  grid=(split, _cdiv(C, bc), E * mblocks)))
    return best[1]


@functools.lru_cache(maxsize=None)
def card_grouped_plan(kernel: str, device: int, E: int, M: int, R: int,
                      C: int, s_bytes: int = 4) -> dict:
    """`grouped_plan` on card `device`, computed once per shape and
    score type."""
    with torch.cuda.device(device):
        return grouped_plan(E, M, R, C,
                            card_capacity(kernel, int(s_bytes == 2)), s_bytes)


def _grouped_args(kernel: str, a, w, s, out, E: int, M: int, R: int,
                  C: int, N: int) -> tuple:
    """(bc, split, w_stages, a_bufs, smem, tma) for kernels 5-6's C entry
    point (for the score type of s).  tma bit 0: A (a row pitch of 4 R
    bytes) by 16-byte vectors; 1, 2: w (2 N bytes a row), s (4 N, or 2 N
    for bf16 scores) by TMA; 3: out by 16-byte vectors; no w or s rows to
    map when R is 0."""
    es = s.element_size()
    plan = card_grouped_plan(kernel, a.device.index, E, M, R, C, es)
    tma = _grid_flags((a, 4 * R), (w, 2 * N), (s, es * N), (out, 4 * C))
    return (plan["bc"], plan["split"], plan["w_stages"], plan["a_bufs"],
            plan["smem"], tma if R else tma & 9)


@functools.lru_cache(maxsize=None)
def card_sms(device: int) -> int:
    """Streaming multiprocessors of card `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def card_ds_plan(device: int, M: int, K: int, N: int, f32: bool,
                 E: int = 1, s_bytes: int = 4) -> dict:
    """`ds_plan` on card `device` (its SM count), computed once per
    shape and score type."""
    act = torch.float32 if f32 else torch.bfloat16
    return ds_plan(M, K, N, act, card_sms(device), E, s_bytes)


def _ds_args(x, g, w, s, ds, E: int, M: int, K: int, N: int) -> tuple:
    """(bn, stages, chunks, smem, grid, tma) for kernel 3's or 7's C entry
    point (for the score type of s).  tma bit 0, 1: x, g; 2, 3: w, s; 4:
    ds, each on the 16-byte grid (its base and its row pitch, and so
    every group's rows); no x, g rows to map at M = 0."""
    es = s.element_size()
    plan = card_ds_plan(x.device.index, M, K, N, bool(_f32(x)), E, es)
    e = x.element_size()
    tma = _grid_flags((x, e * K), (g, e * N), (w, 2 * N), (s, es * N),
                      (ds, es * N)) & (31 if M else 28)
    return (plan["bn"], plan["stages"], plan["chunks"], plan["smem"],
            plan["grid"], tma)


# Kernel 9 (csrc/masked_conv1d_ds.cu): the B*S time rows in chunks of
# CONV_RT rows of one batch row, split over a cluster of at most
# CONV_MAX_CLUSTER blocks; a block owns CONV_CB channels in quads of
# CONV_QUAD (one a thread) and at most CONV_MAX_LANES row lanes.
CONV_QUAD, CONV_CB, CONV_RT = 4, 64, 4
CONV_MAX_LANES, CONV_MAX_CLUSTER, CONV_MAX_W = 8, 8, 8


def conv_ds_plan(B: int, S: int, C: int) -> dict:
    """Launch plan of kernel 9 for ds (W, C) from x, g (B, S, C): the
    `chunks` of CONV_RT time rows, the `cluster` size P that splits them
    (rank q takes chunks [q*chunks // P, (q+1)*chunks // P)), the row
    `lanes` of a block (lane r takes every lanes-th chunk of its rank's
    range), its `threads` and the `grid` (cluster ranks, channel
    tiles).  As many ranks and lanes as there are chunks, up to the
    largest cluster and block: at the main paths' (2, 128) every thread
    takes one chunk, so that all of a launch's loads are in flight at
    once (the bytes take about as long as one round trip)."""
    chunks = B * _cdiv(S, CONV_RT)
    cluster = max(1, min(CONV_MAX_CLUSTER, chunks))
    lanes = max(1, min(CONV_MAX_LANES, _cdiv(chunks, cluster)))
    return dict(chunks=chunks, cluster=cluster, lanes=lanes,
                threads=lanes * CONV_CB // CONV_QUAD,
                grid=(cluster, _cdiv(C, CONV_CB)))


# Kernel 8 (csrc/masked_conv1d.cu): the B*S time rows in chunks of
# CONV_RT rows of one batch row; a block owns CONV_FWD_CB channels in
# quads of CONV_QUAD (one a thread) and at most CONV_FWD_LANES chunks,
# one a row lane.
CONV_FWD_CB, CONV_FWD_LANES = 128, 8


def conv_plan(B: int, S: int, C: int) -> dict:
    """Launch plan of kernel 8 for y (B, S, C): the `chunks` of CONV_RT
    time rows, the row `lanes` of a block (block i takes chunks [i*lanes,
    (i+1)*lanes), one a lane), its `threads` and the `grid` (row blocks,
    channel tiles).  As many lanes as there are chunks, up to the
    largest block: every thread takes one chunk, so that all of a
    launch's loads are in flight at once; at the main paths' (2, 128)
    the 64 chunks make 8 row blocks, x 18 (mamba2) or 32 (recurrentgemma)
    channel tiles."""
    chunks = B * _cdiv(S, CONV_RT)
    lanes = max(1, min(CONV_FWD_LANES, chunks))
    return dict(chunks=chunks, lanes=lanes,
                threads=lanes * CONV_FWD_CB // CONV_QUAD,
                grid=(_cdiv(chunks, lanes), _cdiv(C, CONV_FWD_CB)))


# Kernel 4 (csrc/sample_and_pack.cu): a persistent grid of blocks of
# SAP_THREADS threads, at most SAP_PER_SM an SM, whose warps stride over
# the (row, piece) space; a piece is `unroll` chunks of 128 elements (16
# bytes a lane, vector path) or `unroll` words of 32 (4 bytes a lane,
# scalar path).
SAP_THREADS, SAP_PER_SM = 256, 4
SAP_UNROLLS = (1, 2, 4, 8)                    # as the C entry's builds
SAP_UNROLL_VEC, SAP_UNROLL_SCALAR = 4, 8


def sap_plan(C: int, n: int, sms: int = SMS, aligned: bool = True,
             unroll: int | None = None, s_bytes: int = 4) -> dict:
    """Launch plan of kernel 4 for (C, n) scores of `s_bytes` bytes (4
    f32, 2 bf16): the vector flag `vec` (n a multiple of the V = 16 /
    s_bytes scores of a 16-byte vector, so that every row starts on the
    16-byte grid, and the base `aligned` on it), the `unroll` (vector or
    word loads a warp issues before it gates: 4 x 16 bytes a lane, or 8
    x one score; a bf16 vector's 8 bits allow at most 4), the elements a
    thread loads at once (`per_thread`), the `piece` of a row a warp
    takes (elements), the pieces of a row (`per_row`) and in all
    (`items`), and the persistent `grid`: as many blocks as have pieces,
    at most SAP_PER_SM an SM, so that every block is resident at once."""
    v = 16 // s_bytes
    vec = n % v == 0 and aligned
    if unroll is None:
        unroll = SAP_UNROLL_VEC if vec else SAP_UNROLL_SCALAR
    if unroll not in SAP_UNROLLS or (vec and unroll * v > 32):
        raise ValueError(f"unroll {unroll}: one of {SAP_UNROLLS}, at most "
                         f"{32 // v} on the vector path")
    piece = (32 * v if vec else 32) * unroll
    per_row = _cdiv(n, piece)
    items = C * per_row
    warps = SAP_THREADS // 32
    return dict(vec=vec, unroll=unroll, per_thread=(v if vec else 1) * unroll,
                piece=piece, per_row=per_row, items=items,
                threads=SAP_THREADS,
                grid=max(1, min(_cdiv(items, warps), sms * SAP_PER_SM)))


@dispatch.kernel_boundary("masked_matmul_fwd")
def masked_matmul(x, w, s, seed, off=0, *, n_logical=None, mode="sample",
                  tau=0.5):
    """x: (M, K); w, s: (K, N) -> (M, N) in x.dtype."""
    mode = _mask_mode(mode)
    where = dispatch.placement(x, w, s)
    if where == "cpu":
        return masked_matmul_plain(x, w, s, seed, off, n_logical, mode, tau)
    M, K = x.shape
    N = w.shape[1]
    _require(x, "x", _ACTS, (M, K))
    _require(w, "w", torch.bfloat16, (K, N))
    _require(s, "s", _SCORES, (K, N))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    dispatch.count_work("masked_matmul_fwd", 2 * M * K * N,
                        dispatch.nbytes(x, w, s, y))
    if where == "cuda" and M and N:
        build.launch("masked_matmul_fwd", x.data_ptr(), w.data_ptr(),
                     s.data_ptr(), y.data_ptr(), M, K, N, _u32(seed),
                     _u32(off), _u32(N if n_logical is None else n_logical),
                     _MODES[mode], float(tau), _f32(x), _sbf16(s),
                     *_plan_args("masked_matmul_fwd", x, w, s, M, K, N, N),
                     dispatch.stream(x))
        dispatch.LAUNCHES["masked_matmul_fwd"] += 1
    return y


@dispatch.kernel_boundary("masked_matmul_dx")
def masked_matmul_dx(g, w, s, seed, off=0, *, n_logical=None,
                     mode="sample", tau=0.5):
    """g: (M, N); w, s: (K, N) -> dx = g @ (m * w)^T : (M, K) in g.dtype."""
    mode = _mask_mode(mode)
    where = dispatch.placement(g, w, s)
    if where == "cpu":
        return masked_matmul_dx_plain(g, w, s, seed, off, n_logical, mode,
                                      tau)
    M, N = g.shape
    K = w.shape[0]
    _require(g, "g", _ACTS, (M, N))
    _require(w, "w", torch.bfloat16, (K, N))
    _require(s, "s", _SCORES, (K, N))
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    dispatch.count_work("masked_matmul_dx", 2 * M * K * N,
                        dispatch.nbytes(g, w, s, dx))
    if where == "cuda" and M and K:
        build.launch("masked_matmul_dx", g.data_ptr(), w.data_ptr(),
                     s.data_ptr(), dx.data_ptr(), M, K, N, _u32(seed),
                     _u32(off), _u32(N if n_logical is None else n_logical),
                     _MODES[mode], float(tau), _f32(g), _sbf16(s),
                     *_plan_args("masked_matmul_dx", g, w, s, M, N, K, N),
                     dispatch.stream(g))
        dispatch.LAUNCHES["masked_matmul_dx"] += 1
    return dx


@dispatch.kernel_boundary("masked_matmul_ds")
def masked_matmul_ds(x, g, w, s):
    """x: (M, K); g: (M, N); w, s: (K, N) -> ds : (K, N) in s.dtype."""
    where = dispatch.placement(x, g, w, s)
    if where == "cpu":
        return masked_matmul_ds_plain(x, g, w, s)
    M, K = x.shape
    N = g.shape[1]
    _require(x, "x", _ACTS, (M, K))
    _require(g, "g", x.dtype, (M, N))
    _require(w, "w", torch.bfloat16, (K, N))
    _require(s, "s", _SCORES, (K, N))
    ds = torch.empty((K, N), dtype=s.dtype, device=s.device)
    dispatch.count_work("masked_matmul_ds",
                        2 * M * K * N + EPILOGUE_FLOPS * K * N,
                        dispatch.nbytes(x, g, w, s, ds))
    if where == "cuda" and K and N:
        build.launch("masked_matmul_ds", x.data_ptr(), g.data_ptr(),
                     w.data_ptr(), s.data_ptr(), ds.data_ptr(), M, K, N,
                     _f32(x), _sbf16(s),
                     *_ds_args(x, g, w, s, ds, 1, M, K, N),
                     dispatch.stream(x))
        dispatch.LAUNCHES["masked_matmul_ds"] += 1
    return ds


@dispatch.kernel_boundary("sample_and_pack")
def sample_and_pack(s, seeds, mode="sample", tau=0.5):
    """s: (C, n) score rows; seeds: C uint32 row seeds (ints or a
    tensor) -> (C, ceil(n/32)) int32 words holding the uint32 bit
    patterns; bits past n are zero."""
    mode = _mask_mode(mode)
    where = dispatch.placement(s)
    seeds = torch.as_tensor([_u32(v) for v in seeds], dtype=torch.int64,
                            device="cpu" if where == "meta" else s.device)
    if where == "cpu":
        return sample_and_pack_plain(s, seeds, mode, tau)
    C, n = s.shape
    _require(s, "s", _SCORES, (C, n))
    words = torch.empty((C, (n + 31) // 32), dtype=torch.int32,
                        device=s.device)
    dispatch.count_work("sample_and_pack", 0, dispatch.nbytes(s, words))
    if where == "cuda" and C and n:
        seeds32 = _i32_bits(seeds)
        plan = sap_plan(C, n, card_sms(s.device.index),
                        aligned=s.data_ptr() % 16 == 0,
                        s_bytes=s.element_size())
        build.launch("sample_and_pack", s.data_ptr(), seeds32.data_ptr(),
                     words.data_ptr(), C, n, _MODES[mode], float(tau),
                     _sbf16(s), int(plan["vec"]), plan["unroll"],
                     plan["grid"],
                     dispatch.stream(s))
        dispatch.LAUNCHES["sample_and_pack"] += 1
    return words


@dispatch.kernel_boundary("masked_matmul_grouped")
def masked_matmul_grouped(x, w, s, seeds, offs, *, n_logical=None,
                          mode="sample", tau=0.5):
    """x: (E, M, K); w, s: (E, K, N); seeds, offs: per-group uint32
    stream coordinates (E of them, or one for all) -> y[e] = x[e] @
    (m[e] * w[e]) : (E, M, N) in x.dtype."""
    mode = _mask_mode(mode)
    E = x.shape[0]
    seeds = _group_u32(seeds, E, "seeds")
    offs = _group_u32(offs, E, "offs")
    where = dispatch.placement(x, w, s)
    if where == "cpu":
        return masked_matmul_grouped_plain(x, w, s, seeds, offs, n_logical,
                                           mode, tau)
    _, M, K = x.shape
    N = w.shape[2]
    _require(x, "x", torch.float32, (E, M, K))
    _require(w, "w", torch.bfloat16, (E, K, N))
    _require(s, "s", _SCORES, (E, K, N))
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    dispatch.count_work("masked_matmul_grouped", 2 * E * M * K * N,
                        dispatch.nbytes(x, w, s, y))
    if where == "cuda" and E and M and N:
        coords = _group_coords(seeds, offs, x.device)
        build.launch("masked_matmul_grouped", x.data_ptr(), w.data_ptr(),
                     s.data_ptr(), coords[0].data_ptr(),
                     coords[1].data_ptr(), y.data_ptr(), E, M, K, N,
                     _u32(N if n_logical is None else n_logical),
                     _MODES[mode], float(tau), _sbf16(s),
                     *_grouped_args("masked_matmul_grouped", x, w, s, y, E,
                                    M, K, N, N),
                     dispatch.stream(x))
        dispatch.LAUNCHES["masked_matmul_grouped"] += 1
    return y


@dispatch.kernel_boundary("masked_matmul_grouped_dx")
def masked_matmul_grouped_dx(g, w, s, seeds, offs, *, n_logical=None,
                             mode="sample", tau=0.5):
    """g: (E, M, N); w, s: (E, K, N) -> dx[e] = g[e] @ (m[e] * w[e])^T :
    (E, M, K) in g.dtype, the grouped forward's masks."""
    mode = _mask_mode(mode)
    E = g.shape[0]
    seeds = _group_u32(seeds, E, "seeds")
    offs = _group_u32(offs, E, "offs")
    where = dispatch.placement(g, w, s)
    if where == "cpu":
        return masked_matmul_grouped_dx_plain(g, w, s, seeds, offs,
                                              n_logical, mode, tau)
    _, M, N = g.shape
    K = w.shape[1]
    _require(g, "g", torch.float32, (E, M, N))
    _require(w, "w", torch.bfloat16, (E, K, N))
    _require(s, "s", _SCORES, (E, K, N))
    dx = torch.empty((E, M, K), dtype=g.dtype, device=g.device)
    dispatch.count_work("masked_matmul_grouped_dx", 2 * E * M * K * N,
                        dispatch.nbytes(g, w, s, dx))
    if where == "cuda" and E and M and K:
        coords = _group_coords(seeds, offs, g.device)
        build.launch("masked_matmul_grouped_dx", g.data_ptr(), w.data_ptr(),
                     s.data_ptr(), coords[0].data_ptr(),
                     coords[1].data_ptr(), dx.data_ptr(), E, M, K, N,
                     _u32(N if n_logical is None else n_logical),
                     _MODES[mode], float(tau), _sbf16(s),
                     *_grouped_args("masked_matmul_grouped_dx", g, w, s, dx,
                                    E, M, N, K, N),
                     dispatch.stream(g))
        dispatch.LAUNCHES["masked_matmul_grouped_dx"] += 1
    return dx


@dispatch.kernel_boundary("masked_matmul_grouped_ds")
def masked_matmul_grouped_ds(x, g, w, s):
    """x: (E, M, K); g: (E, M, N); w, s: (E, K, N) -> ds : (E, K, N) in
    s.dtype."""
    where = dispatch.placement(x, g, w, s)
    if where == "cpu":
        return masked_matmul_grouped_ds_plain(x, g, w, s)
    E, M, K = x.shape
    N = g.shape[2]
    _require(x, "x", torch.float32, (E, M, K))
    _require(g, "g", torch.float32, (E, M, N))
    _require(w, "w", torch.bfloat16, (E, K, N))
    _require(s, "s", _SCORES, (E, K, N))
    ds = torch.empty((E, K, N), dtype=s.dtype, device=s.device)
    dispatch.count_work("masked_matmul_grouped_ds",
                        2 * E * M * K * N + EPILOGUE_FLOPS * E * K * N,
                        dispatch.nbytes(x, g, w, s, ds))
    if where == "cuda" and E and K and N:
        build.launch("masked_matmul_grouped_ds", x.data_ptr(), g.data_ptr(),
                     w.data_ptr(), s.data_ptr(), ds.data_ptr(), E, M, K, N,
                     _sbf16(s), *_ds_args(x, g, w, s, ds, E, M, K, N),
                     dispatch.stream(x))
        dispatch.LAUNCHES["masked_matmul_grouped_ds"] += 1
    return ds


@dispatch.kernel_boundary("masked_conv1d")
def masked_conv1d(x, w, s, seed=0, off=0, *, n_logical=None, mode="sample",
                  tau=0.5, flip=False):
    """x: (B, S, C) bf16 or f32, unpadded; w, s: (W, C) (s unread and may
    be None in mode "plain") -> (B, S, C) f32: y[b,s,c] = sum_t
    x_pad[b,s+t,c] * (m * w)[t,c] with W - 1 leading zeros, or with
    `flip` the reversed taps over W - 1 trailing zeros (dL/dx).  The mask
    is drawn at off + t*n_logical + c (n_logical defaults to C)."""
    if mode not in _MODES:
        raise ValueError(f"conv mode {mode!r}: sample, threshold or plain")
    plain = mode == "plain"
    where = dispatch.placement(x, w, *(() if plain else (s,)))
    if where == "cpu":
        return masked_conv1d_plain(x, w, s, seed, off, mode, tau, n_logical,
                                   flip)
    B, S, C = x.shape
    W = w.shape[0]
    _require(x, "x", _ACTS, (B, S, C))
    _require(w, "w", torch.bfloat16, (W, C))
    if not plain:
        _require(s, "s", _SCORES, (W, C))
    y = torch.empty((B, S, C), dtype=torch.float32, device=x.device)
    dispatch.count_work("masked_conv1d", 2 * W * B * S * C,
                        dispatch.nbytes(x, w, None if plain else s, y))
    if where == "cuda" and B and S and C:
        vec = int(C % CONV_QUAD == 0 and _grid_flags((x, 0), (y, 0)) == 3)
        build.launch("masked_conv1d", x.data_ptr(), w.data_ptr(),
                     0 if plain else s.data_ptr(), y.data_ptr(), B, S, C, W,
                     _u32(seed), _u32(off),
                     _u32(C if n_logical is None else n_logical),
                     _MODES[mode], float(tau), int(flip), _f32(x),
                     0 if plain else _sbf16(s),
                     conv_plan(B, S, C)["lanes"], vec, dispatch.stream(x))
        dispatch.LAUNCHES["masked_conv1d"] += 1
    return y


@dispatch.kernel_boundary("masked_conv1d_ds")
def masked_conv1d_ds(x, g, w, s, *, epilogue="ste"):
    """x: (B, S, C) bf16 or f32, unpadded; g: (B, S, C) f32; w, s: (W, C)
    -> (W, C): the correlation sum_{b,s} x_pad[b,s+t,c] g[b,s,c] times
    w * sigmoid'(s) in s.dtype (epilogue "ste"), or raw in f32 (epilogue
    "dw": the plain conv's weight gradient; s unread and may be None)."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r}: ste or dw")
    dw = epilogue == "dw"
    where = dispatch.placement(x, g, w, *(() if dw else (s,)))
    if where == "cpu":
        return masked_conv1d_ds_plain(x, g, w, s, epilogue)
    B, S, C = x.shape
    W = w.shape[0]
    _require(x, "x", _ACTS, (B, S, C))
    _require(g, "g", torch.float32, (B, S, C))
    _require(w, "w", torch.bfloat16, (W, C))
    if not dw:
        _require(s, "s", _SCORES, (W, C))
    ds = torch.empty((W, C), dtype=torch.float32 if dw else s.dtype,
                     device=x.device)
    dispatch.count_work("masked_conv1d_ds", 2 * W * B * S * C
                        + (0 if dw else EPILOGUE_FLOPS * W * C),
                        dispatch.nbytes(x, g, w, None if dw else s, ds))
    if where == "cuda" and C:
        plan = conv_ds_plan(B, S, C)
        vec = int(C % CONV_QUAD == 0 and _grid_flags((x, 0), (g, 0)) == 3)
        build.launch("masked_conv1d_ds", x.data_ptr(), g.data_ptr(),
                     w.data_ptr(), 0 if dw else s.data_ptr(), ds.data_ptr(),
                     B, S, C, W, _EPILOGUES[epilogue], _f32(x),
                     0 if dw else _sbf16(s), plan["cluster"], plan["lanes"],
                     vec, dispatch.stream(x))
        dispatch.LAUNCHES["masked_conv1d_ds"] += 1
    return ds
