"""What surrounds the tensor-core body of kernels 1-2, on the CPU.

The bf16 body of `masked_matmul_fwd` / `masked_matmul_dx`
(csrc/masked_matmul_wgmma.cuh) takes its launch plan from the Python
wrapper (`kernels.masked_matmul.wgmma_plan`): the width of a block's
output tile, the cluster size that splits the reduction axis, the raw
stages and the shared-memory bytes.  These tests hold the plan, for every
masked dense projection of the four configs at the main path's M = 256
and for ragged shapes, to what the kernel needs: the cluster's ranges
cover the reduction axis exactly once, a cluster has at most 8 blocks,
the shared memory fits a block, and internlm2-1.8b's shapes fill the
card.  They also hold the build's bookkeeping to the sources: every
header is in the digest of the libraries, and every entry point's
argtypes match its C signature.
"""
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.kernels import build
from repro_torch.kernels import masked_matmul as mm
from repro_torch.models import build_model, layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

M = 256                 # tokens per cohort on the main path
ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
         "recurrentgemma-9b")
RAGGED = [(200, 1000, 1500), (33, 70, 45), (1, 2048, 2048),
          (600, 512, 384), (5, 0, 7), (3, 1, 1)]
# blocks an H100 SXM held at once in clusters of 1..8 (the occupancy
# query on the card): clusters must fit whole in a GPC
H100_BLOCKS = {1: 132, 2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105,
               8: 120}


def _split_ranges(R, split):
    """The reduction ranges [lo, hi) of a cluster's blocks in rank order,
    as the kernel computes them: block q takes the stages of WG_BR
    [steps*q // split, steps*(q+1) // split)."""
    steps = -(-R // mm.WG_BR)
    return [(min(R, steps * q // split * mm.WG_BR),
             min(R, steps * (q + 1) // split * mm.WG_BR))
            for q in range(split)]


def _gpc_capacity(bc, split, smem):
    return H100_BLOCKS[split]


CAPACITIES = {"ideal": mm.ideal_capacity, "h100": _gpc_capacity}


def _meta_init(gen, shape, *args, **kwargs):
    return torch.empty(tuple(shape), device="meta")


def _dense_shapes(arch):
    """(K, N) of every masked dense projection of the full-width `arch`
    (the param tree built on the meta device: no memory)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "dense_init", _meta_init)
    mp.setattr(layers, "embed_init", _meta_init)
    try:
        params = build_model(get_config(arch)).init_params(
            torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    shapes = set()
    for path, leaf in tree.flatten_with_paths(params):
        name = path.split("/")[-1]
        experts = "moe/" in path and "moe/shared/" not in path
        if leaf is None or not name.startswith("w_") or name == "w_conv" \
                or experts:
            continue
        shapes.add(tuple(leaf.shape[-2:]))
    return sorted(shapes)


SHAPES = {arch: _dense_shapes(arch) for arch in ARCHS}


def test_dense_shapes_are_the_configs():
    assert SHAPES["internlm2-1.8b"] == [(2048, 1024), (2048, 2048),
                                        (2048, 8192), (8192, 2048)]
    assert (1024, 4384) in SHAPES["mamba2-370m"]      # w_in, N ragged
    assert (512, 2048) in SHAPES["deepseek-v2-lite-16b"]   # MLA w_uk
    assert (4096, 256) in SHAPES["recurrentgemma-9b"]      # MQA w_k


def _problems():
    """(tag, M, R, C): both orientations of every dense shape at M = 256
    (forward R = K, C = N; dx R = N, C = K) and of the ragged shapes."""
    out = []
    for arch, shapes in SHAPES.items():
        for K, N in shapes:
            out.append((f"{arch} fwd {K}x{N}", M, K, N))
            out.append((f"{arch} dx {K}x{N}", M, N, K))
    for m, K, N in RAGGED:
        out.append((f"ragged fwd {m}x{K}x{N}", m, K, N))
        out.append((f"ragged dx {m}x{K}x{N}", m, N, K))
    return out


PROBLEMS = _problems()


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_plan_fits_a_block_and_a_cluster(tag, m, R, C, capacity):
    plan = mm.wgmma_plan(m, R, C, CAPACITIES[capacity])
    bc, split = plan["bc"], plan["split"]
    assert bc in mm.WG_WIDTHS and 1 <= split <= mm.MAX_CLUSTER
    assert plan["smem"] == mm.wgmma_smem(bc, plan["w_stages"])
    assert plan["smem"] <= mm.SMEM_LIMIT
    # the parked partials of the cluster reduction fit under the ring
    barriers = 16 * (mm.WG_A_STAGES + plan["w_stages"])
    assert mm.WG_ROWS * (bc + 8) * 4 <= plan["smem"] - 1024 - barriers
    assert plan["grid"] == (split, -(-C // bc), -(-m // mm.WG_ROWS))
    # every block of the cluster has stages to sum (none idles)
    assert split <= max(1, -(-R // mm.WG_BR))


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("tag,m,R,C", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_plan_splits_cover_the_reduction_once(tag, m, R, C, capacity):
    split = mm.wgmma_plan(m, R, C, CAPACITIES[capacity])["split"]
    ranges = _split_ranges(R, split)
    assert len(ranges) == split
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(R))
    # ranges start on stage boundaries, as the kernel's TMA boxes do
    assert all(lo % mm.WG_BR == 0 for lo, _ in ranges)


@pytest.mark.parametrize("orient", ["fwd", "dx"])
@pytest.mark.parametrize("K,N", SHAPES["internlm2-1.8b"])
def test_internlm2_plans_fill_the_card(K, N, orient):
    """Each internlm2-1.8b projection at M = 256, where clusters can take
    any SMs, runs in one wave on at least 128 of the 132 SMs: a second,
    partly empty wave would cost more than the 4 idle SMs."""
    R, C = (K, N) if orient == "fwd" else (N, K)
    plan = mm.wgmma_plan(M, R, C)
    blocks = plan["split"] * plan["grid"][1] * plan["grid"][2]
    assert 128 <= blocks <= mm.SMS


@pytest.mark.parametrize("orient", ["fwd", "dx"])
@pytest.mark.parametrize("K,N", SHAPES["internlm2-1.8b"])
def test_internlm2_plans_take_one_wave_on_gpcs(K, N, orient):
    """Where clusters must fit whole in a GPC (the H100's occupancy
    query: 102 blocks in clusters of 6, 120 in clusters of 8), each plan
    still runs in one wave, on at least 96 SMs."""
    R, C = (K, N) if orient == "fwd" else (N, K)
    plan = mm.wgmma_plan(M, R, C, _gpc_capacity)
    blocks = plan["split"] * plan["grid"][1] * plan["grid"][2]
    assert 96 <= blocks <= _gpc_capacity(plan["bc"], plan["split"],
                                         plan["smem"])


def test_tma_flags_follow_the_row_pitch():
    """A, w and s go by TMA only where the row pitch is a multiple of 16
    bytes (RAGGED: x's 2000-byte pitch and s's 6000 do, w's 3000 does
    not), never for an empty reduction axis."""
    x = torch.zeros(4, 1000, dtype=torch.bfloat16)
    w = torch.zeros(1000, 1500, dtype=torch.bfloat16)
    s = torch.zeros(1000, 1500)
    assert mm._tma_flags(x, w, s, 1000, 1500) == 0b101
    g = torch.zeros(4, 1500, dtype=torch.bfloat16)
    assert mm._tma_flags(g, w, s, 1500, 1500) == 0b100
    w8 = torch.zeros(64, 4384, dtype=torch.bfloat16)
    s8 = torch.zeros(64, 4384)
    x8 = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert mm._tma_flags(x8, w8, s8, 64, 4384) == 0b111
    assert mm._tma_flags(x8, w8, s8, 0, 4384) == 0


def test_plan_widths_are_the_kernels():
    """The widths the plan may pick are the ones the kernel instantiates
    (REPRO_WG_WIDTHS in csrc/masked_matmul_wgmma.cuh)."""
    text = (build.CSRC / "masked_matmul_wgmma.cuh").read_text()
    macro = re.search(r"#define REPRO_WG_WIDTHS\(X\)(.*)", text).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", macro)) == \
        mm.WG_WIDTHS
    for bc in mm.WG_WIDTHS:
        assert f"wgmma_bf16<{bc}>" in text


def test_every_header_is_in_the_library_digest():
    """`build._lib_path` hashes only the sources named in HEADERS: a
    header missing there would not rebuild the libraries that include
    it when it changes."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert sorted(build.HEADERS) == headers
    for src in build.CSRC.glob("*.cu"):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert inc in build.HEADERS, (src.name, inc)


def _c_signatures():
    """{entry: argument count} of every extern "C" function in csrc/."""
    sigs = {}
    for src in build.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, args in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            sigs[name] = len([a for a in args.split(",") if a.strip()])
    return sigs


@pytest.mark.parametrize("entry", sorted(build.ARGTYPES))
def test_argtypes_match_the_c_signature(entry):
    sigs = _c_signatures()
    assert entry in sigs, f"no extern \"C\" {entry} in csrc/"
    assert len(build.ARGTYPES[entry]) == sigs[entry]
    lib = build.ENTRY_LIBRARY.get(entry, entry)
    assert lib in build.SOURCES
    assert entry in (build.CSRC / f"{lib}.cu").read_text()


def test_every_c_entry_has_argtypes():
    assert set(_c_signatures()) == set(build.ARGTYPES)


def _c_args(entry):
    """Argument names of extern "C" entry point `entry` in csrc/."""
    for src in build.CSRC.glob("*.cu"):
        got = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src.read_text())
        if got:
            return [a.split()[-1].lstrip("*") for a in got.group(1).split(",")]
    raise AssertionError(f"no extern \"C\" {entry} in csrc/")


@pytest.mark.parametrize("entry,header", [
    ("masked_matmul_ds", "masked_matmul_ds_wgmma.cuh"),
    ("masked_matmul_grouped_ds", "masked_matmul_ds_wgmma.cuh"),
    ("masked_matmul_fwd", "masked_matmul_tiles.cuh"),
    ("masked_matmul_dx", "masked_matmul_tiles.cuh")])
def test_each_body_has_its_entry_points(entry, header):
    """Kernels 3 and 7 run the tensor-core body of
    masked_matmul_ds_wgmma.cuh; the SIMT tiles of masked_matmul_tiles.cuh
    serve only kernels 1-2 on f32 activations (no score-gradient tile is
    left in it)."""
    text = (build.CSRC / f"{entry}.cu").read_text()
    assert f'#include "{header}"' in text
    users = sorted(src.stem for src in build.CSRC.glob("*.cu")
                   if f'#include "{header}"' in src.read_text())
    assert entry in users
    if header == "masked_matmul_tiles.cuh":
        assert users == ["masked_matmul_dx", "masked_matmul_fwd"]
        assert "ds_tile" not in (build.CSRC / header).read_text()


def test_score_gradient_signatures_carry_the_plan():
    """Kernel 7's entry takes kernel 3's launch plan in kernel 3's order,
    with the group count E before the shapes and no activation flag (its
    x, g are f32); kernel 9's takes its cluster plan and the vector flag
    before the stream."""
    k3, k7 = _c_args("masked_matmul_ds"), _c_args("masked_matmul_grouped_ds")
    assert k7 == k3[:5] + ["E"] + [a for a in k3[5:] if a != "x_f32"]
    assert k3[-7:] == ["bn", "stages", "chunks", "smem", "grid", "tma",
                       "stream"]
    assert _c_args("masked_conv1d_ds")[-4:] == ["cluster", "lanes", "vec",
                                                "stream"]
