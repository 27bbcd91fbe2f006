"""The launch plan of kernel 4 (sample_and_pack), on the CPU.

`sample_and_pack` (csrc/sample_and_pack.cu) takes its launch plan from
the Python wrapper (`kernels.masked_matmul.sap_plan`): the vector flag,
the unroll (loads a lane issues before it gates), the pieces a warp
takes and the persistent grid.  These tests walk the plan as the kernel
does, at every internlm2-1.8b leaf's row length (24 layers stacked, up
to 402,653,184 scores), at 100,003, 100,004, 1, 31 and 33, for C = 1, 2
and 4 rows: the warps' strides take every piece once; every word of
every row is stored exactly once, and every element below n lands at
its bit (word e // 32, bit e % 32) while the bits at or past n stay
zero; vector loads only where n % 4 == 0 and the base lies on the
16-byte grid; int64 offsets; and the grid fits the card.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

SOURCE = (build.CSRC / "sample_and_pack.cu").read_text()
# internlm2-1.8b's masked leaves, 24 layers stacked: w_k / w_v, w_q /
# w_o, w_gate / w_up / w_down
LEAVES = (24 * 2048 * 1024, 24 * 2048 * 2048, 24 * 2048 * 8192)
SMALL = (100_003, 100_004, 1, 31, 33)
ROWS = (1, 2, 4)


def _cdiv(a, b):
    return -(-a // b)


def _kernel_map(plan, n, qs):
    """What the warps that take pieces `qs` do, as numpy arrays of one
    shape (piece, load, lane[, element of the lane's vector]): the row
    c, the element e, the word k it lands in and its bit, whether it is
    gated (`live`: below n) and whether its lane stores word k."""
    U, per_row, piece = plan["unroll"], plan["per_row"], plan["piece"]
    q = np.asarray(qs, dtype=np.int64)
    if plan["vec"]:
        q = q[:, None, None, None]
        j = np.arange(U)[None, :, None, None]
        lane = np.arange(32)[None, None, :, None]
        i = np.arange(4)[None, None, None, :]
        c, local = q // per_row, q % per_row
        first = local * piece + 128 * j + 4 * lane   # the vector's base
        e = first + i
        k = (local * piece + 128 * j) // 32 + lane // 8
        bit = 4 * (lane % 8) + i
        live = first < n                # n % 4 == 0: a vector is whole
        stores = (lane % 8 == 0) & (i == 0)
    else:
        q = q[:, None, None]
        j = np.arange(U)[None, :, None]
        lane = np.arange(32)[None, None, :]
        c, local = q // per_row, q % per_row
        k = local * U + j
        e = k * 32 + lane
        bit = lane
        live = e < n
        stores = lane == 0
    shape = np.broadcast_shapes(c.shape, e.shape, k.shape, bit.shape,
                                live.shape, stores.shape)
    stores = np.broadcast_to(stores, shape) & (np.broadcast_to(k, shape)
                                               < _cdiv(n, 32))
    return [np.broadcast_to(a, shape).ravel()
            for a in (c, e, k, bit, live, stores)]


def _check_pieces(plan, C, n, qs, whole):
    c, e, k, bit, live, stores = _kernel_map(plan, n, qs)
    nw = _cdiv(n, 32)
    assert (c < C).all()
    # a gated element is below n and lands at its bit; the rest are at
    # or past n and contribute no bit
    assert (e[live] < n).all() and (e[~live] >= n).all()
    assert (k[live] == e[live] // 32).all()
    assert (bit[live] == e[live] % 32).all()
    # each stored word is one (row, word) and no other lane stores it
    keys = c[stores] * nw + k[stores]
    assert len(np.unique(keys)) == len(keys)
    # each gated element once
    ekeys = c[live] * n + e[live]
    assert len(np.unique(ekeys)) == len(ekeys)
    if whole:
        assert len(keys) == C * nw and len(ekeys) == C * n


def _stride_cover(plan):
    """The pieces the warps' grid-stride loops take, in all: warp g takes
    g, g + warps, ... below items."""
    warps = plan["grid"] * plan["threads"] // 32
    return np.concatenate([np.arange(g, plan["items"], warps)
                           for g in range(min(warps, plan["items"]))])


def _walk(plan, C, g):
    """The pieces warp g takes as the kernel's `Walk` steps them: row and
    piece from one division, then by (warps // per_row, warps % per_row)
    with a carry, while the row is below C."""
    warps = plan["grid"] * plan["threads"] // 32
    per_row = plan["per_row"]
    c, piece = divmod(g, per_row)
    step_c, step_piece = divmod(warps, per_row)
    out = []
    while c < C:
        out.append(c * per_row + piece)
        c, piece = c + step_c, piece + step_piece
        if piece >= per_row:
            c, piece = c + 1, piece - per_row
    return out


@pytest.mark.parametrize("C", ROWS)
@pytest.mark.parametrize("n", SMALL + (100_000, 4096))
def test_the_walk_without_division_is_the_grid_stride(C, n):
    for sms in (mm.SMS, 3, 1):
        plan = mm.sap_plan(C, n, sms)
        warps = plan["grid"] * plan["threads"] // 32
        for g in range(warps):
            assert _walk(plan, C, g) == list(range(g, plan["items"], warps))


@pytest.mark.parametrize("C", ROWS)
@pytest.mark.parametrize("n", SMALL)
def test_small_rows_every_word_once(C, n):
    plan = mm.sap_plan(C, n)
    qs = _stride_cover(plan)
    assert np.array_equal(np.sort(qs), np.arange(plan["items"]))
    _check_pieces(plan, C, n, qs, whole=True)


@pytest.mark.parametrize("C", ROWS)
@pytest.mark.parametrize("n", LEAVES)
def test_leaf_rows_every_word_once(C, n):
    """The full leaves: every piece taken once by the warps' strides,
    the pieces tile each row (the last one partial or whole), and the
    first, middle and last pieces of every row map their elements and
    words as above (the walk of all 1.6 G elements is left out)."""
    plan = mm.sap_plan(C, n)
    assert plan["vec"]
    qs = _stride_cover(plan)
    assert len(qs) == plan["items"] == C * plan["per_row"]
    assert np.array_equal(np.sort(qs), np.arange(plan["items"]))
    per_row, piece = plan["per_row"], plan["piece"]
    assert (per_row - 1) * piece < n <= per_row * piece
    sample = sorted({r * per_row + p for r in range(C)
                     for p in (0, 1, per_row // 2, per_row - 2,
                               per_row - 1)})
    _check_pieces(plan, C, n, sample, whole=False)


@pytest.mark.parametrize("n", LEAVES + SMALL + (100_000, 128, 4, 8))
def test_vector_loads_only_where_legal(n):
    for C in ROWS:
        assert mm.sap_plan(C, n)["vec"] == (n % 4 == 0)
        assert not mm.sap_plan(C, n, aligned=False)["vec"]
    # the wrapper's alignment test: a base off the 16-byte grid takes
    # the scalar path even where n % 4 == 0
    s = torch.empty(2 * 100_004 + 1)[1:].view(2, 100_004)
    assert s.data_ptr() % 16 != 0
    assert not mm.sap_plan(2, 100_004, aligned=s.data_ptr() % 16 == 0)["vec"]


def test_offsets_are_int64():
    """A row of the largest leaf is 1.6 GB: the byte offsets of a second
    row pass 2**31, its element offsets c * n + e at C = 6, so the kernel
    computes them in int64."""
    n = max(LEAVES)
    assert 2 * n * 4 > 2 ** 31 and 4 * n < 2 ** 31 < 8 * n
    assert "int64_t n, nw;" in SOURCE
    for decl in ("int64_t per_row, c, piece, step_c, step_piece;",
                 "const int64_t q = blockIdx.x",
                 "const int64_t c = w.c;", "const int64_t e0 =",
                 "const int64_t i =", "const int64_t k = e / 32;",
                 "const int64_t k0 = w.piece * U;"):
        assert decl in SOURCE, decl
    assert build.ARGTYPES["sample_and_pack"][4] is build._I64


@pytest.mark.parametrize("n", LEAVES + SMALL)
@pytest.mark.parametrize("C", ROWS)
def test_grid_fits_the_card(C, n):
    for sms in (mm.SMS, 114):
        plan = mm.sap_plan(C, n, sms)
        assert 1 <= plan["grid"] <= sms * mm.SAP_PER_SM
        # no block without a piece, where there are pieces enough
        assert plan["grid"] <= max(1, _cdiv(plan["items"], 8))
        assert plan["threads"] == mm.SAP_THREADS
        assert plan["unroll"] in mm.SAP_UNROLLS
        assert plan["per_thread"] == plan["unroll"] * (4 if plan["vec"]
                                                       else 1)
        assert plan["piece"] == plan["unroll"] * (128 if plan["vec"]
                                                  else 32)
        assert plan["items"] == C * _cdiv(n, plan["piece"])
    # the leaves fill every SM with SAP_PER_SM blocks
    if n in LEAVES:
        assert mm.sap_plan(C, n)["grid"] == mm.SMS * mm.SAP_PER_SM


@pytest.mark.parametrize("unroll", [3, 0, 16])
def test_plan_refuses_an_unroll_the_kernel_lacks(unroll):
    with pytest.raises(ValueError):
        mm.sap_plan(2, 4096, unroll=unroll)


def test_plan_constants_are_the_kernels():
    for py, c in (("SAP_THREADS", "THREADS"), ("SAP_PER_SM", "PER_SM")):
        got = re.search(rf"constexpr int {c} = (\d+);", SOURCE)
        assert got and int(got.group(1)) == getattr(mm, py), py
    assert SOURCE.count("__launch_bounds__(THREADS, PER_SM)") == 2
    built = [int(u) for u in re.findall(r"REPRO_SAP_U\((\d)\)", SOURCE)]
    assert tuple(built) == mm.SAP_UNROLLS
    assert "(vec && n % 4)" in SOURCE
