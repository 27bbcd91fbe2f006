"""The launch plan of kernels 3 and 7's tensor-core body, on the CPU.

`masked_matmul_ds` and `masked_matmul_grouped_ds` (kernel 3's body on E
groups; csrc/masked_matmul_ds_wgmma.cuh) take their launch plan from the
Python wrapper (`kernels.masked_matmul.ds_plan`): the tile (bk, bn) of
ds a block owns, the x/g stages, the (w, s) chunks of the epilogue, the
shared-memory bytes and the persistent grid.  These tests hold the plan,
for every masked dense projection of the four configs at the main path's
M = 256 and for ragged shapes, on bf16 and f32 activations, to what the
kernel needs: the persistent blocks' tiles cover ds exactly once, the
shared memory fits a block, the grid is at least 1 and at most one block
an SM (two at width 64 for f32 at M <= 32, where the shared memory holds
no third), and internlm2-1.8b's shapes give every SM a tile.  For kernel 7,
at deepseek-v2-lite's expert shapes, the row counts where the stages
change and ragged cells: the tiles cover every group once, numbered N
fastest, each reading only its own group's rows, and one group is
kernel 3's plan; on bf16 scores (2 bytes a score, `s_bytes` 2) the
plan fits the same budget with a ring at least as deep, at
deepseek-v2-lite's and deepseek-v2-236b's expert shapes.  They also hold
the plan's constants to the kernel's.
"""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm

from test_torch_wgmma_plan import ARCHS, M, RAGGED, _dense_shapes
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ACTS = {"bf16": torch.bfloat16, "f32": torch.float32}
SHAPES = sorted({(M, K, N) for arch in ARCHS
                 for K, N in _dense_shapes(arch)} | set(RAGGED))
HEADER = (build.CSRC / "masked_matmul_ds_wgmma.cuh").read_text()


def _tile_walk(plan, K, N):
    """The (k0, n0) corners of the tiles each persistent block takes, as
    the kernel walks them: block b takes tiles b, b + grid, ..., numbered
    with the N tiles fastest."""
    bk, bn = plan["bk"], plan["bn"]
    tiles_n = -(-N // bn)
    tiles = -(-K // bk) * tiles_n
    return [[(t // tiles_n * bk, t % tiles_n * bn)
             for t in range(b, tiles, plan["grid"])]
            for b in range(plan["grid"])]


def _covered_once(starts, size, extent):
    """Intervals [s, s + size) clipped to [0, extent) tile it exactly."""
    edges = sorted(starts)
    return (edges == list(range(0, extent, size)) if extent
            else edges == [])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_cover_ds_exactly_once(shape, act):
    Mx, K, N = shape
    plan = mm.ds_plan(Mx, K, N, ACTS[act])
    walk = _tile_walk(plan, K, N)
    corners = [c for block in walk for c in block]
    if not K or not N:   # the wrapper launches nothing
        assert corners == []
        return
    assert len(corners) == len(set(corners))
    assert _covered_once({k for k, _ in corners}, plan["bk"], K)
    assert _covered_once({n for _, n in corners}, plan["bn"], N)
    assert len(corners) == len({k for k, _ in corners}) * len(
        {n for _, n in corners})
    # the epilogue's chunks: one for each consumer warp's rows
    assert plan["bn"] in mm.DS_WIDTHS and plan["bk"] == mm.DS_BK
    assert plan["bk"] % mm.DS_WR == 0


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_a_block_and_the_card(shape, act):
    Mx, K, N = shape
    f32 = act == "f32"
    plan = mm.ds_plan(Mx, K, N, ACTS[act])
    assert plan["smem"] == mm.ds_smem(plan["bn"], plan["stages"],
                                      plan["chunks"], f32)
    _holds_per_sm(plan)
    # every block has a tile
    assert all(_tile_walk(plan, K, N)) or K == 0 or N == 0
    # the ring holds at least a tile's chunks; a bf16 stage of x and g is
    # handed back only once the next is multiplied, so two at least; f32
    # stages are split by the consumers: two (one split while the other
    # is multiplied), or one where it is a tile's only stage
    assert plan["chunks"] >= plan["bk"] // mm.DS_WR
    if f32:
        assert plan["stages"] == (1 if Mx <= mm.DS_BMF else 2)
        assert plan["chunks"] <= 2 * plan["bk"] // mm.DS_WR
    else:
        assert 2 <= plan["stages"] <= mm.DS_MAX_STAGES


def _holds_per_sm(plan):
    """`per_sm` blocks of the plan fit an SM's shared memory and a third
    (a second, at one) does not; two only at width 64, whose build keeps
    to the registers of two blocks; the grid at most per_sm an SM."""
    per_sm, used = plan["per_sm"], plan["smem"] + mm.BLOCK_RESERVED
    assert plan["smem"] <= mm.SMEM_LIMIT
    assert per_sm * used <= mm.SM_SMEM < (per_sm + 1) * used
    # one block an SM: the shared memory holds no second
    assert per_sm == 2 or 2 * plan["smem"] > mm.SMEM_LIMIT
    assert per_sm == 1 or (per_sm == 2 and plan["bn"] == 64)
    assert 1 <= plan["grid"] <= per_sm * mm.SMS


@pytest.mark.parametrize("act", ACTS)
def test_internlm2_shapes_give_every_sm_work(act):
    for K, N in _dense_shapes("internlm2-1.8b"):
        plan = mm.ds_plan(M, K, N, ACTS[act])
        walk = _tile_walk(plan, K, N)
        assert plan["grid"] == mm.SMS and all(walk), (K, N, plan)
        # no block takes more than one tile beyond the mean
        sizes = [len(b) for b in walk]
        assert max(sizes) - min(sizes) <= 1


def test_plan_constants_are_the_kernels():
    """DS_BK, DS_BMS, DS_BMF, DS_WR and the widths are the kernel's
    constants (csrc/masked_matmul_ds_wgmma.cuh)."""
    for py, c in (("DS_BK", "BK"), ("DS_BMS", "BMS"), ("DS_BMF", "BMF"),
                  ("DS_WR", "WR"), ("DS_LONG_ROWS", "LONG_ROWS")):
        got = re.search(rf"constexpr int {c} = (\d+);", HEADER)
        assert int(got.group(1)) == getattr(mm, py), py
    macro = re.search(r"#define REPRO_DS_WIDTHS\(X\)(.*)", HEADER).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", macro)) == \
        mm.DS_WIDTHS
    for bn in mm.DS_WIDTHS:
        assert f"wgmma_mn<{bn}>" in HEADER


def test_grid_flags():
    """Bit i is set only where tensor i's base and row pitch lie on the
    16-byte grid."""
    buf = torch.zeros(64, dtype=torch.float32)
    aligned, off = buf[:32], buf[1:33]
    assert aligned.data_ptr() % 16 == 0
    assert mm._grid_flags((aligned, 16), (aligned, 12), (off, 16),
                          (aligned, 32)) == 0b1001


# Kernel 7 (masked_matmul_grouped_ds) runs this body on E stacked
# problems under `ds_plan(..., E=E)`: deepseek-v2-lite's expert
# projections at E = 64 for the capacity M = 30 and the row counts where
# the stages change, and the ragged cell (K = 1000: w's rows off the
# 16-byte grid, a last K tile that ends inside the group).
EXPERT_SHAPES = [(2048, 1408), (1408, 2048)]
GROUPED = [(64, m, K, N) for m in (30, 64, 65, 240, 300)
           for K, N in EXPERT_SHAPES] + [(5, 29, 1000, 1500),
                                         (3, 33, 70, 45), (8, 1, 64, 64)]


def _grouped_walk(plan, E, K, N):
    """The (e, k0, n0) of the tiles each persistent block takes, as the
    kernel numbers them (`tile_at`): group, then K tile, then N tile,
    N fastest; block b takes tiles b, b + grid, ..."""
    bk, bn = plan["bk"], plan["bn"]
    tiles_n = -(-N // bn)
    per_group = -(-K // bk) * tiles_n
    return [[(t // per_group, t % per_group // tiles_n * bk,
              t % tiles_n * bn)
             for t in range(b, E * per_group, plan["grid"])]
            for b in range(plan["grid"])]


@pytest.mark.parametrize("E,m,K,N", GROUPED)
def test_grouped_tiles_cover_every_group_once(E, m, K, N):
    plan = mm.ds_plan(m, K, N, torch.float32, E=E)
    walk = _grouped_walk(plan, E, K, N)
    tiles = [t for block in walk for t in block]
    assert len(tiles) == len(set(tiles))
    # every (e, k, n) of ds lies in exactly one tile
    cover = {}
    for e, k0, n0 in tiles:
        for k in range(k0, min(k0 + plan["bk"], K)):
            cover[(e, k)] = cover.get((e, k), set()) | {n0}
    assert set(cover) == {(e, k) for e in range(E) for k in range(K)}
    for n0s in cover.values():
        assert _covered_once(n0s, plan["bn"], N)
    # every block has a tile, and none more than one beyond the mean
    sizes = [len(b) for b in walk]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("E,m,K,N", GROUPED)
def test_grouped_numbering_is_n_fastest(E, m, K, N):
    """Consecutive tile numbers walk the N tiles of one (group, K tile)
    before the next K tile, and the K tiles of a group before the next
    group: the blocks running together read whole rows of w and s."""
    plan = mm.ds_plan(m, K, N, torch.float32, E=E)
    order = sorted(t for block in _grouped_walk(plan, E, K, N)
                   for t in block)
    tiles_n = -(-N // plan["bn"])
    numbered = sorted(order, key=lambda t: (t[0], t[1], t[2]))
    assert order == numbered
    for i in range(0, len(order), tiles_n):
        row = order[i:i + tiles_n]
        assert len({(e, k0) for e, k0, _ in row}) == 1
        assert [n0 for *_, n0 in row] == list(
            range(0, tiles_n * plan["bn"], plan["bn"]))


@pytest.mark.parametrize("E,m,K,N", GROUPED)
def test_grouped_tiles_read_their_own_group(E, m, K, N):
    """The rows a tile's (w, s) chunks and ds stores touch lie inside
    its group: each consumer warp's WR rows from k0 + v*WR are loaded and
    stored only below K (the kernel's bound; TMA's 3-d maps fill zeros
    past it), so no flat offset reaches the next group's K*N block."""
    plan = mm.ds_plan(m, K, N, torch.float32, E=E)
    for block in _grouped_walk(plan, E, K, N):
        for e, k0, n0 in block:
            rows = [r for v in range(plan["bk"] // mm.DS_WR)
                    for r in range(k0 + v * mm.DS_WR,
                                   k0 + (v + 1) * mm.DS_WR) if r < K]
            cols = [c for c in range(n0, n0 + plan["bn"]) if c < N]
            assert rows and cols
            lo = (e * K + rows[0]) * N + cols[0]
            hi = (e * K + rows[-1]) * N + cols[-1]
            assert e * K * N <= lo <= hi < (e + 1) * K * N


@pytest.mark.parametrize("E,m,K,N", GROUPED)
def test_grouped_plan_fits_a_block(E, m, K, N):
    plan = mm.ds_plan(m, K, N, torch.float32, E=E)
    assert plan["smem"] == mm.ds_smem(plan["bn"], plan["stages"],
                                      plan["chunks"], True)
    _holds_per_sm(plan)
    # at the MoE capacity one stage a tile and two blocks an SM, whose 16
    # consumer warps hide the sigmoid epilogue's latency
    one = m <= mm.DS_BMF
    assert plan["stages"] == (1 if one else 2)
    assert plan["per_sm"] == (2 if one else 1)
    assert plan["bk"] // mm.DS_WR <= plan["chunks"] <= \
        2 * plan["bk"] // mm.DS_WR
    # no deeper ring would fit, short of two tiles'
    budget = (mm.SM_SMEM // plan["per_sm"] - mm.BLOCK_RESERVED if one
              else mm.SMEM_LIMIT)
    assert plan["chunks"] == 2 * plan["bk"] // mm.DS_WR or mm.ds_smem(
        plan["bn"], plan["stages"], plan["chunks"] + 1, True) > budget


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES + [(30, 2048, 1408)])
def test_one_group_is_kernel_3s_plan(shape, act):
    """E = 1 is kernel 3's plan, and E groups plan as kernel 3 would for
    the groups' K tiles stacked: E enters only through the tile count."""
    Mx, K, N = shape
    plan = mm.ds_plan(Mx, K, N, ACTS[act])
    assert mm.ds_plan(Mx, K, N, ACTS[act], mm.SMS, 1) == plan
    for E in (2, 64):
        stacked = mm.ds_plan(Mx, E * -(-K // mm.DS_BK) * mm.DS_BK, N,
                             ACTS[act])
        assert mm.ds_plan(Mx, K, N, ACTS[act], mm.SMS, E) == stacked


def test_deepseek_shapes_fill_the_card():
    """At the main path's E = 64, M = 30 every expert projection gives
    each of two blocks an SM 85 or 86 tiles of width 64, with a (w, s)
    ring of 12 chunks (a tile and a half) beside its one stage."""
    for K, N in EXPERT_SHAPES:
        plan = mm.ds_plan(30, K, N, torch.float32, E=64)
        assert plan["bn"] == 64 and plan["per_sm"] == 2
        assert plan["grid"] == 2 * mm.SMS
        assert plan["stages"] == 1 and plan["chunks"] == 12
        sizes = [len(b) for b in _grouped_walk(plan, 64, K, N)]
        assert (min(sizes), max(sizes)) == (85, 86)


def test_grouped_flags_follow_the_row_pitch(monkeypatch):
    """Kernel 7's tma bits, as kernel 3's: x, g, w, s, ds each on the
    16-byte grid (base and row pitch, so every group's rows too).  In the
    ragged cell w's 3000-byte pitch is off it; at M = 0 there are no x, g
    rows to map."""
    monkeypatch.setattr(
        mm, "card_ds_plan",
        lambda device, M, K, N, f32, E=1, s_bytes=4: mm.ds_plan(
            M, K, N, torch.float32 if f32 else torch.bfloat16, mm.SMS, E,
            s_bytes))
    E, M, K, N = 5, 29, 1000, 1500
    x, g = torch.zeros(E, M, K), torch.zeros(E, M, N)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16)
    s, ds = torch.zeros(E, K, N), torch.zeros(E, K, N)
    args = mm._ds_args(x, g, w, s, ds, E, M, K, N)
    plan = mm.ds_plan(M, K, N, torch.float32, mm.SMS, E)
    assert args == (plan["bn"], plan["stages"], plan["chunks"],
                    plan["smem"], plan["grid"], 0b11011)
    w8 = torch.zeros(E, K, 1408, dtype=torch.bfloat16)
    s8, g8, ds8 = (torch.zeros(E, K, 1408), torch.zeros(E, M, 1408),
                   torch.zeros(E, K, 1408))
    assert mm._ds_args(x, g8, w8, s8, ds8, E, M, K, 1408)[-1] == 0b11111
    assert mm._ds_args(x[:, :0], g8[:, :0], w8, s8, ds8, E, 0, K,
                       1408)[-1] == 0b11100
    x_odd = torch.zeros(E, M, 1001)
    assert mm._ds_args(x_odd, g8, w8, s8, ds8, E, M, 1001,
                       1408)[-1] == 0b11110


# The paper's CNNs: Conv6 at img 32, batch 32, each conv's im2col (M, K,
# N) and the denses, f32 activations (models/cnn.py); past DS_LONG_ROWS
# rows the body folds its partial sums (the LONG build, width 64 only).
CNN_SHAPES = [(32768, 27, 64), (32768, 576, 64), (8192, 576, 128),
              (8192, 1152, 128), (2048, 1152, 256), (2048, 2304, 256),
              (32, 4096, 256), (32, 256, 256), (32, 256, 10)]


@pytest.mark.parametrize("shape", CNN_SHAPES)
def test_cnn_shapes_plan(shape):
    """Tiles cover ds once, a block fits, and an f32 launch past
    DS_LONG_ROWS rows takes width 64, the only LONG build."""
    Mx, K, N = shape
    plan = mm.ds_plan(Mx, K, N, torch.float32)
    corners = [c for b in _tile_walk(plan, K, N) for c in b]
    assert len(corners) == len(set(corners))
    assert _covered_once({k for k, _ in corners}, plan["bk"], K)
    assert _covered_once({n for _, n in corners}, plan["bn"], N)
    _holds_per_sm(plan)
    if Mx > mm.DS_LONG_ROWS:
        assert plan["bn"] == 64 and plan["per_sm"] == 1
    assert "launch_bn<64, true, true, SB>" in HEADER
    assert "launch_bn<W, true, true>" not in HEADER


# Kernel 7 on bf16 scores: `ds_plan(..., E=E, s_bytes=2)` at the expert
# shapes of deepseek-v2-lite (E = 64, M = 30) and deepseek-v2-236b (E =
# 160 experts at the capacity M = 12), and the grouped cells above
GROUPED_BF16 = GROUPED + [(160, 12, 5120, 1536), (160, 12, 1536, 5120)]


@pytest.mark.parametrize("E,m,K,N", GROUPED_BF16)
def test_grouped_bf16_score_plan_fits_a_block(E, m, K, N):
    """At 2 bytes a score a (w, s) chunk is 4 bytes an element: the plan
    fits the block's budget (half the SM at M <= DS_BMF), keeps a ring of
    at least one chunk per consumer warp (the C entry refuses fewer) and
    at most two tiles', as deep as fits and at least as deep as the f32
    scores' ring; the tiles and grid are the f32 plan's."""
    plan = mm.ds_plan(m, K, N, torch.float32, E=E, s_bytes=2)
    f32 = mm.ds_plan(m, K, N, torch.float32, E=E)
    assert plan["smem"] == mm.ds_smem(plan["bn"], plan["stages"],
                                      plan["chunks"], True, 2)
    _holds_per_sm(plan)
    one = m <= mm.DS_BMF
    budget = (mm.SM_SMEM // plan["per_sm"] - mm.BLOCK_RESERVED if one
              else mm.SMEM_LIMIT)
    assert plan["smem"] <= budget <= mm.SMEM_LIMIT
    assert plan["bk"] // mm.DS_WR <= plan["chunks"] <= \
        2 * plan["bk"] // mm.DS_WR
    assert plan["chunks"] == 2 * plan["bk"] // mm.DS_WR or mm.ds_smem(
        plan["bn"], plan["stages"], plan["chunks"] + 1, True, 2) > budget
    assert plan["chunks"] >= f32["chunks"]
    for key in ("bk", "bn", "stages", "per_sm", "grid"):
        assert plan[key] == f32[key], key
    walk = _grouped_walk(plan, E, K, N)
    assert sorted(t for b in walk for t in b) == sorted(
        t for b in _grouped_walk(f32, E, K, N) for t in b)


def test_deepseek_shapes_on_bf16_scores_hold_two_tiles():
    """At E = 64, M = 30 the bf16-score ring holds two tiles' chunks (16)
    where the f32 one holds 12, beside the one stage, two blocks an SM."""
    for K, N in EXPERT_SHAPES:
        plan = mm.ds_plan(30, K, N, torch.float32, E=64, s_bytes=2)
        assert plan["bn"] == 64 and plan["per_sm"] == 2
        assert plan["stages"] == 1 and plan["chunks"] == 16
        assert plan["grid"] == 2 * mm.SMS


def test_grouped_bf16_score_flags(monkeypatch):
    """With bf16 scores kernel 7's s and ds rows are 2 N bytes: at N =
    1004 off the 16-byte grid (bits 3, 4 clear) where f32 rows (4016
    bytes) lie on it, as g's do (w's 2008 do not); the plan asked for is
    the 2-byte one."""
    asked = []

    def plan(device, M, K, N, f32, E=1, s_bytes=4):
        asked.append(s_bytes)
        return mm.ds_plan(M, K, N, torch.float32, mm.SMS, E, s_bytes)
    monkeypatch.setattr(mm, "card_ds_plan", plan)
    E, M, K, N = 4, 30, 256, 1004
    x, g = torch.zeros(E, M, K), torch.zeros(E, M, N)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16)
    bf = torch.bfloat16
    s32, ds32 = torch.zeros(E, K, N), torch.zeros(E, K, N)
    s16, ds16 = torch.zeros(E, K, N, dtype=bf), torch.zeros(E, K, N,
                                                           dtype=bf)
    f = mm._ds_args(x, g, w, s32, ds32, E, M, K, N)
    b = mm._ds_args(x, g, w, s16, ds16, E, M, K, N)
    assert asked == [4, 2]
    assert f[-1] == 0b11011 and b[-1] == 0b00011
    p2 = mm.ds_plan(M, K, N, torch.float32, mm.SMS, E, 2)
    assert b[:-1] == (p2["bn"], p2["stages"], p2["chunks"], p2["smem"],
                      p2["grid"])
