"""The launch plan of kernel 3's tensor-core body, on the CPU.

`masked_matmul_ds` (csrc/masked_matmul_ds_wgmma.cuh) takes its launch
plan from the Python wrapper (`kernels.masked_matmul.ds_plan`): the tile
(bk, bn) of ds a block owns, the x/g stages, the (w, s) chunks of the
epilogue, the shared-memory bytes and the persistent grid.  These tests
hold the plan, for every masked dense projection of the four configs at
the main path's M = 256 and for ragged shapes, on bf16 and f32
activations, to what the kernel needs: the persistent blocks' tiles
cover ds exactly once, the shared memory fits a block, the grid is at
least 1 and at most one block an SM, and internlm2-1.8b's shapes give
every SM a tile.  They also hold the plan's constants to the kernel's.
"""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm

from test_torch_wgmma_plan import ARCHS, M, RAGGED, _dense_shapes

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
    assert plan["smem"] <= mm.SMEM_LIMIT
    # one block an SM: the shared memory holds no second
    assert 2 * plan["smem"] > mm.SMEM_LIMIT
    assert 1 <= plan["grid"] <= mm.SMS
    # every block has a tile
    assert all(_tile_walk(plan, K, N)) or K == 0 or N == 0
    # the ring holds at least a tile's chunks; a stage of x and g is
    # handed back only once the next is multiplied, so two at least
    assert plan["chunks"] >= plan["bk"] // mm.DS_WR
    assert plan["stages"] == 2 if f32 else \
        2 <= plan["stages"] <= mm.DS_MAX_STAGES


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
                  ("DS_WR", "WR")):
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
