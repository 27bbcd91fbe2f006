"""The launch plan of kernel 9 (masked_conv1d_ds), on the CPU.

`masked_conv1d_ds` (csrc/masked_conv1d_ds.cu) takes its launch plan from
the Python wrapper (`kernels.masked_matmul.conv_ds_plan`): the chunks of
CONV_RT time rows, the cluster that splits them, the row lanes of a
block and the grid.  These tests walk the chunks as the kernel does, at
mamba2-370m's and recurrentgemma-9b's conv shapes, the ragged cell and
small ones, for every tap count the kernel takes, and hold the plan to
what the kernel needs: the cluster ranks' row slices, with the W - 1
rows of halo each chunk reads before it, cover every (b, s) term of
every tap exactly once and read no other batch row; the grid, the
cluster and the block fit the card's limits; the plan's constants are
the kernel's.
"""
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

SOURCE = (build.CSRC / "masked_conv1d_ds.cu").read_text()
# (B, S, C): mamba2-370m's conv and recurrentgemma-9b's at the main
# path's batch 2 x seq 128, the ragged cell, and small ones
SHAPES = [(2, 128, 2304), (2, 128, 4096), (3, 37, 1000), (1, 1, 5),
          (1, 3, 8), (2, 5, 9), (4, 1000, 64), (1, 4, 4), (0, 7, 64)]
TAPS = (1, 2, 4, 8)


def _walk(plan, B, S, W):
    """The (b, s, t, x row) terms each thread of a column of channels
    adds, as the kernel walks them: rank q takes chunks [n*q // P,
    n*(q+1) // P), lane r every lanes-th from lo + r; chunk k is rows
    s0 = (k % per_row) * RT .. of batch row b = k // per_row, and tap t
    of row s reads x row s + t - (W - 1) when that is >= 0."""
    rt, P, lanes = mm.CONV_RT, plan["cluster"], plan["lanes"]
    per_row = -(-S // rt)
    n = B * per_row
    terms = []
    for q in range(P):
        lo, hi = n * q // P, n * (q + 1) // P
        for r in range(lanes):
            for k in range(lo + r, hi, lanes):
                b, s0 = k // per_row, k % per_row * rt
                halo = range(s0 - (W - 1), s0 + rt)   # the x slots loaded
                for s in range(s0, min(s0 + rt, S)):
                    for t in range(W):
                        sx = s + t - (W - 1)
                        assert sx in halo
                        if sx >= 0:
                            terms.append((b, s, t, sx))
    return terms


@pytest.mark.parametrize("W", TAPS)
@pytest.mark.parametrize("B,S,C", SHAPES)
def test_slices_cover_every_term_once(B, S, C, W):
    plan = mm.conv_ds_plan(B, S, C)
    terms = _walk(plan, B, S, W)
    want = [(b, s, t, s + t - (W - 1)) for b in range(B) for s in range(S)
            for t in range(W) if s + t - (W - 1) >= 0]
    assert sorted(terms) == sorted(want)
    assert all(0 <= sx < S for *_, sx in terms)


@pytest.mark.parametrize("B,S,C", SHAPES)
def test_plan_fits_the_card(B, S, C):
    plan = mm.conv_ds_plan(B, S, C)
    P, lanes = plan["cluster"], plan["lanes"]
    assert plan["chunks"] == B * -(-S // mm.CONV_RT)
    assert 1 <= P <= mm.CONV_MAX_CLUSTER and 1 <= lanes <= mm.CONV_MAX_LANES
    # every rank and lane has a chunk wherever there are chunks enough
    assert P == max(1, min(mm.CONV_MAX_CLUSTER, plan["chunks"]))
    assert P * lanes >= min(plan["chunks"],
                            mm.CONV_MAX_CLUSTER * mm.CONV_MAX_LANES)
    assert plan["threads"] == lanes * mm.CONV_CB // mm.CONV_QUAD <= 1024
    assert plan["threads"] % 16 == 0
    # the cluster is the grid's x extent; the channel tiles cover C
    gx, gy = plan["grid"]
    assert gx == P and gy <= 65535
    assert (gy - 1) * mm.CONV_CB < C <= gy * mm.CONV_CB
    # the lanes' and the block's partials: static shared memory <= 48 KB
    quads = mm.CONV_CB // mm.CONV_QUAD
    smem = 16 * quads * mm.CONV_MAX_W * (mm.CONV_MAX_LANES + 1)
    assert smem <= 48 * 1024


def test_main_path_shapes_put_every_load_in_flight():
    """At (B 2, S 128) every thread of the launch takes one chunk: the 8
    ranks of a cluster x 8 lanes are the 64 chunks, and 36 (mamba2) or
    64 (recurrentgemma) channel tiles give 288 or 512 blocks."""
    for C, tiles in ((2304, 36), (4096, 64)):
        plan = mm.conv_ds_plan(2, 128, C)
        assert plan["chunks"] == 64 == plan["cluster"] * plan["lanes"]
        assert plan["grid"] == (8, tiles)


def test_plan_constants_are_the_kernels():
    for py, c in (("CONV_QUAD", "QUAD"), ("CONV_CB", "CB"),
                  ("CONV_RT", "RT"), ("CONV_MAX_LANES", "MAX_LANES"),
                  ("CONV_MAX_CLUSTER", "MAX_CLUSTER"),
                  ("CONV_MAX_W", "MAX_W")):
        got = re.search(rf"constexpr int {c} = (\d+);", SOURCE)
        assert got and int(got.group(1)) == getattr(mm, py), py
    assert "constexpr int QB = CB / QUAD;" in SOURCE
    assert "__launch_bounds__(QB * MAX_LANES" in SOURCE
    assert "cfg.blockDim = dim3(QB * lanes);" in SOURCE
    assert "cfg.gridDim = dim3(cluster, (C + CB - 1) / CB);" in SOURCE
