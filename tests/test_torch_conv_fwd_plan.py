"""The launch plan of kernel 8 (masked_conv1d), on the CPU.

`masked_conv1d` (csrc/masked_conv1d.cu) takes its launch plan from the
Python wrapper (`kernels.masked_matmul.conv_plan`): the chunks of
CONV_RT time rows, the row lanes of a block (one chunk a lane) and the
grid of row blocks and channel tiles.  These tests walk the grid as the
kernel does, at mamba2-370m's and recurrentgemma-9b's conv shapes, the
ragged cell, one of C % 4 != 0 and small ones, for tap counts 1, 2, 4
and 8, in both directions, and hold the plan to what the kernel needs:
every output (b, s, c) is written exactly once, from the W taps' x_pad
rows in t order, all of which lie in the thread's loaded slots and in
its own batch row; vector loads only where C % 4 == 0; the grid and the
block fit the card's limits; the plan's constants are the kernel's.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

SOURCE = (build.CSRC / "masked_conv1d.cu").read_text()
# (B, S, C): mamba2-370m's conv and recurrentgemma-9b's at the main
# path's batch 2 x seq 128, the ragged cell, C % 4 != 0, and small ones
SHAPES = [(2, 128, 2304), (2, 128, 4096), (3, 37, 1000), (2, 21, 1001),
          (1, 1, 5), (1, 3, 8), (2, 5, 9), (4, 1000, 64), (1, 4, 4),
          (1, 8, 130)]
TAPS = (1, 2, 4, 8)


def _walk(plan, B, S, C, W, flip):
    """(b, s, c) -> ([x_pad rows added, in order], [flat x rows loaded])
    as the kernel's threads compute them: block (i, j), lane r takes
    chunk k = i*lanes + r (live while k < chunks), quad q channels
    j*CB + 4q .. +3; chunk k is rows s0 = (k % per_row) * RT .. of batch
    row b = k // per_row; slot u holds x row base + u (base s0 - (W - 1)
    causally, s0 flipped), loaded from flat row b*S + base + u where
    that lies in [0, S) and a zero otherwise, and output row s0 + i,
    tap t reads slot i + t."""
    rt, cb, quad = mm.CONV_RT, mm.CONV_FWD_CB, mm.CONV_QUAD
    lanes, (gx, gy) = plan["lanes"], plan["grid"]
    per_row = -(-S // rt)
    out = {}
    for i in range(gx):
        for r in range(lanes):
            k = i * lanes + r
            if k >= B * per_row:
                continue
            b, s0 = k // per_row, k % per_row * rt
            base = s0 if flip else s0 - (W - 1)
            slots = range(base, base + rt + W - 1)
            loaded = [b * S + sx for sx in slots if 0 <= sx < S]
            for j in range(gy):
                for q in range(cb // quad):
                    for c in range(j * cb + q * quad, j * cb + (q + 1) * quad):
                        if c >= C:
                            continue
                        for di in range(rt):
                            s = s0 + di
                            if s >= S:
                                break
                            rows = [slots[di + t] for t in range(W)]
                            assert (b, s, c) not in out
                            out[(b, s, c)] = rows, loaded
    return out


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("W", TAPS)
@pytest.mark.parametrize("B,S,C", SHAPES)
def test_every_output_written_once_from_its_taps_in_order(B, S, C, W, flip):
    if B * S * C > 300_000:   # the walk is per element: a channel slice
        C = min(C, 2 * mm.CONV_FWD_CB + 3)
    plan = mm.conv_plan(B, S, C)
    out = _walk(plan, B, S, C, W, flip)
    assert len(out) == B * S * C
    for (b, s, c), (rows, loaded) in out.items():
        # x_pad[s + t]: x row s + t - (W - 1) causally, s + t flipped
        want = [s + t if flip else s + t - (W - 1) for t in range(W)]
        assert rows == want
        # what lies outside [0, S) is a zero by index, never another
        # batch row's x
        assert all(b * S <= r < (b + 1) * S for r in loaded)
        assert {b * S + r for r in rows if 0 <= r < S} <= set(loaded)


@pytest.mark.parametrize("B,S,C", SHAPES)
def test_plan_fits_the_card(B, S, C):
    plan = mm.conv_plan(B, S, C)
    lanes, (gx, gy) = plan["lanes"], plan["grid"]
    assert plan["chunks"] == B * -(-S // mm.CONV_RT)
    assert 1 <= lanes <= mm.CONV_FWD_LANES
    assert lanes == max(1, min(mm.CONV_FWD_LANES, plan["chunks"]))
    assert plan["threads"] == lanes * mm.CONV_FWD_CB // mm.CONV_QUAD <= 1024
    assert plan["threads"] % 32 == 0
    # the row blocks cover the chunks, the channel tiles C
    assert (gx - 1) * lanes < plan["chunks"] <= gx * lanes
    assert gx <= 2 ** 31 - 1 and gy <= 65535
    assert (gy - 1) * mm.CONV_FWD_CB < C <= gy * mm.CONV_FWD_CB
    # the taps in static shared memory: W x CB f32 <= 48 KB
    assert 4 * mm.CONV_MAX_W * mm.CONV_FWD_CB <= 48 * 1024


def test_main_path_shapes_put_every_load_in_flight():
    """At (B 2, S 128) every thread of a launch takes one chunk: 64
    chunks in 8 row blocks of 8 lanes, x 18 (mamba2) or 32
    (recurrentgemma) channel tiles, all resident at once on 132 SMs."""
    for C, tiles in ((2304, 18), (4096, 32)):
        plan = mm.conv_plan(2, 128, C)
        assert plan["chunks"] == 64 and plan["lanes"] == 8
        assert plan["grid"] == (8, tiles)
        assert plan["threads"] == 256
        assert 8 * tiles * 256 <= mm.SMS * 2048


def _flag(C, x, y):
    """The wrapper's vector flag (kernels.masked_matmul.masked_conv1d)."""
    return int(C % mm.CONV_QUAD == 0
               and mm._grid_flags((x, 0), (y, 0)) == 3)


@pytest.mark.parametrize("C", [2304, 4096, 1000, 1001, 1002, 1003, 5])
def test_vector_loads_only_where_c_is_a_multiple_of_4(C):
    y = torch.empty(2, 3, C)
    x = torch.empty(2, 3, C + 8)[..., :C]   # any base; C alone decides
    for xx in (torch.empty(2, 3, C), x):
        want = C % 4 == 0 and xx.data_ptr() % 16 == 0 \
            and y.data_ptr() % 16 == 0
        assert _flag(C, xx, y) == int(want)
    # a base off the 16-byte grid takes the element path
    off = torch.empty(2 * 3 * C + 1)[1:]
    assert _flag(C, off, y) == 0


def test_plan_constants_are_the_kernels():
    for py, c in (("CONV_QUAD", "QUAD"), ("CONV_FWD_CB", "CB"),
                  ("CONV_RT", "RT"), ("CONV_FWD_LANES", "MAX_LANES"),
                  ("CONV_MAX_W", "MAX_W")):
        got = re.search(rf"constexpr int {c} = (\d+);", SOURCE)
        assert got and int(got.group(1)) == getattr(mm, py), py
    assert "constexpr int QB = CB / QUAD;" in SOURCE
    assert "__launch_bounds__(QB * MAX_LANES)" in SOURCE
    assert "const dim3 block(QB * lanes);" in SOURCE
    assert ("const dim3 grid((chunks + lanes - 1) / lanes, (C + CB - 1) "
            "/ CB);") in SOURCE
    assert "(vec && C % QUAD)" in SOURCE
    # products and sums rounded separately, in t order: the plain
    # version's bits
    assert "__fmul_rn" in SOURCE and "__fadd_rn" in SOURCE
    assert np.all([f"REPRO_CONV_W({w})" in SOURCE for w in range(1, 9)])
