"""The launch plan of kernels 5-6's tensor-core body, on the CPU.

`masked_matmul_grouped` / `masked_matmul_grouped_dx`
(csrc/masked_matmul_grouped_wgmma.cuh) take their launch plan from the
Python wrapper (`kernels.masked_matmul.grouped_plan`): the width of a
block's output tile, the cluster size that splits the reduction axis, the
rows of A a block holds, the A buffers, the raw stages and the
shared-memory bytes.  These tests hold the plan, for deepseek-v2-lite's
expert projections in both orientations at the row counts where a
block's shape changes and for ragged shapes, to what the kernel needs:
the grid covers every (group, M block, column tile) once, the cluster's
ranges cover the reduction axis once, the shared memory fits a block,
and the deepseek-v2-lite shapes fill the card, for f32 scores and for
bf16 ones (2 bytes a score: a raw stage of 4 bytes a weight, more of
them where they fit).  They also hold the plan's constants to the
kernel's and the wrapper's flags to the operands' row pitches.
"""
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm

from test_torch_wgmma_plan import CAPACITIES, _gpc_capacity, _split_ranges
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

HEADER = (build.CSRC / "masked_matmul_grouped_wgmma.cuh").read_text()
CFG = get_config("deepseek-v2-lite-16b")


def _capacity(tokens):
    """Rows a routed expert takes from a cohort of `tokens` tokens, as
    the MoE layer sizes them (capacity factor 1.25, at least 4)."""
    return max(int(tokens * CFG.top_k * CFG.capacity_factor
                   / CFG.n_experts), 4)


CAP = _capacity(256)            # the main path's 256 tokens a cohort: 30
EXPERT_SHAPES = [(CFG.d_model, CFG.moe_d_ff), (CFG.moe_d_ff, CFG.d_model)]
ROWS = (1, 29, 30, 64, 65, 240, 300)


def _problems():
    """(tag, E, M, R, C): both orientations (forward R = K, C = N; dx
    R = N, C = K) of the expert shapes at E = 64 for every row count,
    and ragged shapes."""
    out = []
    for m in ROWS:
        for K, N in EXPERT_SHAPES:
            out.append((f"fwd M={m} {K}x{N}", CFG.n_experts, m, K, N))
            out.append((f"dx M={m} {K}x{N}", CFG.n_experts, m, N, K))
    for E, m, K, N in [(5, 29, 1000, 1500), (3, 33, 70, 45), (2, 1, 64, 64),
                       (8, 300, 256, 384), (1, 7, 0, 5), (4, 513, 1, 1)]:
        out.append((f"ragged fwd E={E} M={m} {K}x{N}", E, m, K, N))
        out.append((f"ragged dx E={E} M={m} {K}x{N}", E, m, N, K))
    return out


PROBLEMS = _problems()


def test_capacity_is_the_main_paths():
    assert CAP == 30 and _capacity(2048) == 240


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,E,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_plan_fits_a_block(tag, E, m, R, C, capacity):
    plan = mm.grouped_plan(E, m, R, C, CAPACITIES[capacity])
    bc, rows = plan["bc"], plan["rows"]
    assert bc in mm.GW_WIDTHS and 1 <= plan["split"] <= mm.MAX_CLUSTER
    assert rows == 64 * -(-min(m, mm.GW_MAX_ROWS) // 64)
    assert plan["smem"] == mm.grouped_smem(bc, rows, plan["a_bufs"],
                                           plan["w_stages"])
    assert plan["smem"] <= mm.SMEM_LIMIT
    # the parked partials of the cluster reduction fit under the ring
    assert rows * (bc + 8) * 4 <= plan["smem"] - 1024 - 8 * plan["w_stages"]
    # two raw stages at least, so that one is in flight while one is gated;
    # two A buffers wherever they fit beside two raw stages
    assert 2 <= plan["w_stages"] <= mm.GW_MAX_W_STAGES
    assert plan["a_bufs"] == (
        2 if mm.grouped_smem(bc, rows, 2, 2) <= mm.SMEM_LIMIT else 1)
    # every block of the cluster has stages to sum (none idles)
    assert plan["split"] <= max(1, -(-R // mm.WG_BR))


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,E,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_grid_covers_every_block_once(tag, E, m, R, C, capacity):
    """Block (x, y, z) of the grid: cluster rank x, column tile y, group
    z // M blocks and M block z % M blocks, as the kernel reads them.
    Every (group, M block, column tile) gets one cluster, every row of
    every group lies in one M block, every column in one tile."""
    plan = mm.grouped_plan(E, m, R, C, CAPACITIES[capacity])
    split, tiles, zs = plan["grid"]
    assert split == plan["split"]
    if C == 0:   # no output columns: the wrapper launches nothing
        assert tiles == 0
        return
    mblocks = -(-m // mm.GW_MAX_ROWS)
    assert zs == E * mblocks
    seen = [(z // mblocks, z % mblocks, y) for y in range(tiles)
            for z in range(zs)]
    assert sorted(seen) == sorted({(e, b, y) for e in range(E)
                                   for b in range(mblocks)
                                   for y in range(tiles)})
    # the rows a block holds, min(rows, M - m0), cover M once
    rows = [min(plan["rows"], m - b * mm.GW_MAX_ROWS)
            for b in range(mblocks)]
    assert all(0 < r <= plan["rows"] for r in rows) and sum(rows) == m
    # the column tiles cover C once, the last one ragged at most
    assert (tiles - 1) * plan["bc"] < C <= tiles * plan["bc"]


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,E,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_split_covers_the_reduction_once(tag, E, m, R, C, capacity):
    split = mm.grouped_plan(E, m, R, C, CAPACITIES[capacity])["split"]
    ranges = _split_ranges(R, split)
    assert len(ranges) == split
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(R))
    assert all(lo % mm.WG_BR == 0 for lo, _ in ranges)


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("orient", ["fwd", "dx"])
@pytest.mark.parametrize("K,N", EXPERT_SHAPES)
def test_deepseek_shapes_fill_the_card(K, N, orient, capacity):
    """At the main path's E = 64, M = 30 each expert projection keeps the
    card at least 95% busy over its waves (the blocks over waves x the
    blocks the card holds at once), with every block gating one of the
    widths that hand all 512 threads the same work."""
    R, C = (K, N) if orient == "fwd" else (N, K)
    cap = CAPACITIES[capacity]
    plan = mm.grouped_plan(CFG.n_experts, CAP, R, C, cap)
    blocks = plan["split"] * plan["grid"][1] * plan["grid"][2]
    held = cap(plan["bc"], plan["split"], plan["smem"])
    waves = -(-blocks // held)
    assert blocks / (waves * held) >= 0.95, plan
    assert plan["rows"] == 64 and plan["a_bufs"] == 2


def test_plan_constants_are_the_kernels():
    """GW_WIDTHS, GW_MAX_ROWS and GW_PARTS are the kernel's, and the
    rows and widths it launches agree with the plan's."""
    macro = re.search(r"#define REPRO_GW_WIDTHS\(X\)(.*)", HEADER).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", macro)) == \
        mm.GW_WIDTHS
    for py, c in (("GW_MAX_ROWS", "MAX_ROWS"), ("GW_PARTS", "PARTS")):
        got = re.search(rf"constexpr int {c} = (\d+);", HEADER)
        assert int(got.group(1)) == getattr(mm, py), py
    assert "64 * ((min(M, MAX_ROWS) + 63) / 64)" in HEADER
    assert all(bc % 64 == 0 for bc in mm.GW_WIDTHS)


def test_grouped_flags_follow_the_row_pitch(monkeypatch):
    """Bit 0: A by 16-byte vectors, 1: w by TMA, 2: s by TMA, 3: out by
    16-byte vectors, each only where its row pitch lies on the 16-byte
    grid: in the ragged cell (K 1000, N 1500) w's 3000-byte pitch does
    not.  No w or s rows to map for an empty reduction axis."""
    monkeypatch.setattr(
        mm, "card_grouped_plan",
        lambda kernel, device, E, M, R, C, s_bytes=4: mm.grouped_plan(
            E, M, R, C, s_bytes=s_bytes))
    E, M, K, N = 5, 29, 1000, 1500
    x = torch.zeros(E, M, K)
    g = torch.zeros(E, M, N)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16)
    s = torch.zeros(E, K, N)
    fwd = mm._grouped_args("masked_matmul_grouped", x, w, s, g, E, M, K, N,
                           N)
    dx = mm._grouped_args("masked_matmul_grouped_dx", g, w, s, x, E, M, N,
                          K, N)
    assert fwd[-1] == 0b1101 and dx[-1] == 0b1101
    plan = mm.grouped_plan(E, M, K, N)
    assert fwd[:-1] == (plan["bc"], plan["split"], plan["w_stages"],
                        plan["a_bufs"], plan["smem"])
    w8 = torch.zeros(E, K, 1408, dtype=torch.bfloat16)
    s8 = torch.zeros(E, K, 1408)
    y8 = torch.zeros(E, M, 1408)
    assert mm._grouped_args("masked_matmul_grouped", x, w8, s8, y8, E, M, K,
                            1408, 1408)[-1] == 0b1111
    x_odd = torch.zeros(E, M, 1001)
    assert mm._grouped_args("masked_matmul_grouped", x_odd, w8, s8, y8, E,
                            M, 1001, 1408, 1408)[-1] == 0b1110
    assert mm._grouped_args("masked_matmul_grouped", x[..., :0], w8[:, :0],
                            s8[:, :0], y8, E, M, 0, 1408, 1408)[-1] == 0b1001


def test_gpc_capacity_fills_the_card_too():
    """Where clusters must fit whole in a GPC, the main path's plans
    keep to clusters the GPCs hold whole (1 or 2: 132 blocks)."""
    for K, N in EXPERT_SHAPES:
        for R, C in ((K, N), (N, K)):
            plan = mm.grouped_plan(CFG.n_experts, CAP, R, C, _gpc_capacity)
            assert plan["split"] in (1, 2), plan


# bf16 scores (`s_bytes` 2): a raw (w, s) stage is 4 bytes a weight
S_BYTES = (4, 2)


def test_raw_stage_is_four_bytes_a_weight_on_bf16_scores():
    """A raw stage holds BR x BC weights of bf16 w and of the scores as
    they lie: 6 bytes a weight for f32 scores, 4 for bf16, and an 8-byte
    mbarrier; the A buffers and B tiles do not depend on the scores."""
    for bc in mm.GW_WIDTHS:
        for rows in (64, 128, 256):
            for s_bytes in S_BYTES:
                one = (mm.grouped_smem(bc, rows, 1, 2, s_bytes)
                       - mm.grouped_smem(bc, rows, 1, 1, s_bytes))
                assert one == mm.WG_BR * bc * (2 + s_bytes) + 8
            assert mm.grouped_smem(bc, rows, 2, 0, 2) == \
                mm.grouped_smem(bc, rows, 2, 0, 4)
            assert mm.grouped_smem(bc, rows, 1, 3) == \
                mm.grouped_smem(bc, rows, 1, 3, 4)


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,E,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_bf16_score_plan_fits_a_block(tag, E, m, R, C, capacity):
    """The bf16-score plan holds what the f32 one holds (a block fits, the
    partials fit under the ring, two raw stages at least, the A-buffer
    rule) at 4 bytes a raw weight, with as many raw stages as fit (up to
    GW_MAX_W_STAGES), and its grid covers the same blocks."""
    plan = mm.grouped_plan(E, m, R, C, CAPACITIES[capacity], s_bytes=2)
    bc, rows, ab, ws = (plan["bc"], plan["rows"], plan["a_bufs"],
                        plan["w_stages"])
    assert plan["smem"] == mm.grouped_smem(bc, rows, ab, ws, 2)
    assert plan["smem"] <= mm.SMEM_LIMIT
    assert rows * (bc + 8) * 4 <= plan["smem"] - 1024 - 8 * ws
    assert 2 <= ws <= mm.GW_MAX_W_STAGES
    assert ws == mm.GW_MAX_W_STAGES or \
        mm.grouped_smem(bc, rows, ab, ws + 1, 2) > mm.SMEM_LIMIT
    assert ab == (2 if mm.grouped_smem(bc, rows, 2, 2, 2) <= mm.SMEM_LIMIT
                  else 1)
    f32 = mm.grouped_plan(E, m, R, C, CAPACITIES[capacity])
    assert plan["grid"][2] == f32["grid"][2] and plan["rows"] == f32["rows"]
    if plan["bc"] == f32["bc"] and plan["a_bufs"] == f32["a_bufs"]:
        assert plan["w_stages"] >= f32["w_stages"]


@pytest.mark.parametrize("bc", mm.GW_WIDTHS)
@pytest.mark.parametrize("rows", [64, 128, 256])
def test_bf16_scores_leave_room_for_more_raw_stages(bc, rows):
    """At every width and row count the 2-byte scores fit more raw stages
    beside the same A buffers than the 4-byte ones, where those fit some
    but stop short of GW_MAX_W_STAGES (at 256 rows and width 128, one A
    buffer: 3 against 2)."""
    def most(a_bufs, s_bytes):
        ws = mm.GW_MAX_W_STAGES
        while mm.grouped_smem(bc, rows, a_bufs, ws, s_bytes) > mm.SMEM_LIMIT:
            ws -= 1
        return ws
    for a_bufs in (1, 2):
        f32, bf = most(a_bufs, 4), most(a_bufs, 2)
        assert bf >= f32
        if 0 < f32 < mm.GW_MAX_W_STAGES:
            assert bf > f32, (a_bufs, f32, bf)
    if (bc, rows) == (128, 256):
        assert (most(1, 4), most(1, 2)) == (2, 3)


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("orient", ["fwd", "dx"])
@pytest.mark.parametrize("K,N", EXPERT_SHAPES)
def test_deepseek_shapes_fill_the_card_on_bf16_scores(K, N, orient,
                                                      capacity):
    """The main path's E = 64, M = 30 on bf16 scores also keeps the card
    at least 95% busy over its waves."""
    R, C = (K, N) if orient == "fwd" else (N, K)
    cap = CAPACITIES[capacity]
    plan = mm.grouped_plan(CFG.n_experts, CAP, R, C, cap, s_bytes=2)
    blocks = plan["split"] * plan["grid"][1] * plan["grid"][2]
    held = cap(plan["bc"], plan["split"], plan["smem"])
    assert blocks / (-(-blocks // held) * held) >= 0.95, plan
    assert plan["rows"] == 64 and plan["a_bufs"] == 2


def test_bf16_score_flags_and_plan(monkeypatch):
    """With bf16 scores the wrapper asks for the 2-byte plan (and the
    occupancy query of the bf16-score build) and reckons s's row pitch
    as 2 N bytes: at N = 1004 an f32 score row (4016 bytes) lies on the
    16-byte grid and a bf16 one (2008) does not, nor does w's; x and y
    (4 K and 4 N bytes) do."""
    asked = []

    def plan(kernel, device, E, M, R, C, s_bytes=4):
        asked.append(s_bytes)
        return mm.grouped_plan(E, M, R, C, s_bytes=s_bytes)
    monkeypatch.setattr(mm, "card_grouped_plan", plan)
    E, M, K, N = 4, 30, 256, 1004
    x = torch.zeros(E, M, K)
    y = torch.zeros(E, M, N)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16)
    s32, s16 = torch.zeros(E, K, N), torch.zeros(E, K, N,
                                                 dtype=torch.bfloat16)
    f = mm._grouped_args("masked_matmul_grouped", x, w, s32, y, E, M, K, N,
                         N)
    b = mm._grouped_args("masked_matmul_grouped", x, w, s16, y, E, M, K, N,
                         N)
    assert asked == [4, 2]
    assert f[-1] == 0b1101 and b[-1] == 0b1001
    p2 = mm.grouped_plan(E, M, K, N, s_bytes=2)
    assert b[:-1] == (p2["bc"], p2["split"], p2["w_stages"], p2["a_bufs"],
                      p2["smem"])
    w8 = torch.zeros(E, K, 1408, dtype=torch.bfloat16)
    s8 = torch.zeros(E, K, 1408, dtype=torch.bfloat16)
    y8 = torch.zeros(E, M, 1408)
    assert mm._grouped_args("masked_matmul_grouped", x, w8, s8, y8, E, M, K,
                            1408, 1408)[-1] == 0b1111


def test_capacity_query_names_the_score_type(monkeypatch):
    """`card_capacity` hands the occupancy query of kernels 1-2 and 5-6
    the score type's build flag (the C entries take it last)."""
    calls = []
    monkeypatch.setattr(mm.build, "call",
                        lambda entry, *a: calls.append((entry, a)) or 132)
    for kernel in ("masked_matmul_fwd", "masked_matmul_grouped",
                   "masked_matmul_grouped_dx"):
        for s_bf16 in (0, 1):
            assert mm.card_capacity(kernel, s_bf16)(64, 2, 1000) == 132
    assert calls == [(f"{k}_capacity", (64, 2, 1000, b))
                     for k in ("masked_matmul_fwd", "masked_matmul_grouped",
                               "masked_matmul_grouped_dx") for b in (0, 1)]
