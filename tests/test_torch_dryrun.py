"""The port's multi-pod dry run (`repro_torch.launch.dryrun`) against the
JAX package's (`repro.launch.dryrun`).

One reference subprocess forces 512 XLA host devices (as
`tests/test_analysis.py`'s forced-mesh script does) and writes: the
shape table and the cell list; the three batch-spec functions' shapes,
types and partition specs for every arch on both production meshes; its
HLO parser's numbers on the canned HLO of `tests/test_perf_features.py`;
the static comm model of internlm2-1.8b's SMOKE round on the (2, 16, 16)
production mesh (its round jaxpr traced there, with
`jaxpr_lint.jcore = jax.extend.core` set in that process: jax 0.9.0
moved `ClosedJaxpr` / `Jaxpr`); and, on a (2, 2, 2) mesh of 8 of those
devices, the compiled argument sizes of the SMOKE train and round steps
(the round's with the indices of the arguments its executable kept).

One port subprocess joins the stand-in process group (the "fake"
backend, once per world size) and runs the same cells as rank 0, plus
the negative cases: an f32 operand injected into the packed round's
all-gathers, shard 1's mask streams aliased onto shard 0's, a `--out`
whose cell is already `ok`, and a cell that fails.  Both subprocesses
run side by side."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

from repro_torch.analysis import comm_model
from repro_torch.analysis.shard_lint import AxisSizes
from repro_torch.configs import (ARCH_NAMES, LONG_CONTEXT_OK, SHAPES,
                                 get_config)
from repro_torch.launch import dryrun
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600
# the canned HLO of tests/test_perf_features.py's parser test
HLO = """
  %ag = bf16[4,128]{1,0} all-gather(%x), replica_groups=[2,16]<=[32], dimensions={0}
  %ar-start = f32[256]{0} all-reduce-start(%y), replica_groups=[1,32]<=[32]
  %ar-done = f32[256]{0} all-reduce-done(%ar-start)
  %rs = u32[8]{0} reduce-scatter(%z), replica_groups=[4,8]<=[32]
"""
# the same collectives as recorded sites: per-shard operands (the
# all-gather's operand a 16th of its result, the reduce-scatter's eight
# times its result)
HLO_SITES = [
    comm_model.CollectiveSite("all_gather", ("data",), (4, 8), "bfloat16",
                              4 * 8 * 16),
    comm_model.CollectiveSite("psum", ("data",), (256,), "float32",
                              256 * 32),
    comm_model.CollectiveSite("reduce_scatter", ("data",), (64,), "uint32",
                              64 * 32),
]

REFERENCE = r'''
import json, sys
import numpy as np
from repro.launch import dryrun        # sets its XLA_FLAGS before jax
import jax
import jax.extend.core
from repro.analysis import comm_model, jaxpr_lint
from repro.configs import ARCH_NAMES, LONG_CONTEXT_OK, SHAPES, get_config
from repro.core import masking
from repro.launch import mesh as meshlib
from repro.launch import sharding as shd
from repro.launch import steps as steplib
from repro.models import build_model
jaxpr_lint.jcore = jax.extend.core

def spec(s):
    return [None if p is None else p if isinstance(p, str) else
            (p[0] if len(p) == 1 else list(p)) for p in tuple(s)]

def specs(shapes, shardings):
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    shf = jax.tree_util.tree_leaves(shardings)
    for (path, x), sh in zip(flat, shf):
        out[jax.tree_util.keystr(path)] = [list(x.shape), str(x.dtype),
                                           spec(sh.spec)]
    return out

out = {"shapes": {k: [v.name, v.seq_len, v.global_batch, v.kind]
                  for k, v in SHAPES.items()},
       "long": sorted(LONG_CONTEXT_OK),
       "cells": [list(c) for c in dryrun.iter_cells(ARCH_NAMES,
                                                    list(SHAPES))],
       "specs": {}}
for mp in (False, True):
    mesh = meshlib.make_production_mesh(multi_pod=mp)
    C = steplib.n_cohorts(mesh)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        api = build_model(cfg)
        b, bsh = dryrun.train_batch_specs(cfg, SHAPES["train_4k"], mesh, C)
        p, psh = dryrun.prefill_batch_specs(cfg, SHAPES["prefill_32k"],
                                            mesh)
        cache, csh, tok, pos, (tsh, qsh) = dryrun.serve_batch_specs(
            cfg, SHAPES["decode_32k"], mesh, api)
        out["specs"][f"{arch}|{mp}"] = {
            "train": specs(b, bsh), "prefill": specs(p, psh),
            "cache": specs(cache, csh),
            "token": specs([tok, pos], [tsh, qsh])}
out["hlo"] = dryrun.collective_bytes(sys.argv[2])
m = comm_model.arch_round_comm_model(
    "internlm2-1.8b", mesh=meshlib.make_production_mesh(multi_pod=True))
out["comm"] = {k: m[k] for k in (
    "bpp_wire", "uplink_bits", "downlink_bits", "n_sites",
    "ring_bytes_per_axis")}

mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                         ("pod", "data", "model"))
cfg = get_config("internlm2-1.8b", smoke=True)
api = build_model(cfg)
scfg = steplib.StepConfig()
with jax.set_mesh(mesh):
    st = jax.eval_shape(lambda k: steplib.init_fed_state(
        k, api, masking.MaskSpec(), 2), jax.random.PRNGKey(0))
    sh = steplib.fed_state_shardings(st, mesh)
    b, bsh = dryrun.train_batch_specs(cfg, SHAPES["train_4k"], mesh, 2)
    c = jax.jit(steplib.make_train_step(api, scfg),
                in_shardings=(sh, bsh),
                out_shardings=(sh, shd.replicated(mesh))).lower(
                    st, b).compile()
    out["train_arg"] = c.memory_analysis().argument_size_in_bytes
    c = jax.jit(steplib.make_round_step(api, scfg, mesh=mesh, state_sh=sh),
                in_shardings=(sh,),
                out_shardings=(sh, shd.replicated(mesh))).lower(st).compile()
    out["round_arg"] = c.memory_analysis().argument_size_in_bytes
    out["round_kept"] = sorted(c._executable._kept_var_idx)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''

PORT = r'''
import json, sys
import torch
import torch.distributed as dist
from repro_torch.analysis import stream_cover
from repro_torch.configs import get_config
from repro_torch.core import aggregation, masking
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steplib

out = {}
cpu = torch.device("cpu")
meshlib.init_dry(512)
out["cell"] = dryrun.cell("internlm2-1.8b", "train_4k", True, device=cpu,
                          smoke=True)
out["unpacked"] = dryrun.cell("internlm2-1.8b", "train_4k", True,
                              device=cpu, smoke=True, packed=False,
                              step_kind="round")

gather = aggregation.all_gather_rows
def leaky(words, group):
    # the words' f32 copy crosses beside them: 32x what is metered
    f = words.float()
    buf = f.new_empty((2 * f.shape[0],) + tuple(f.shape[1:]))
    dist.all_gather_into_tensor(buf, f, group=group)
    return gather(words, group)
aggregation.all_gather_rows = leaky
try:
    dryrun.cell("internlm2-1.8b", "train_4k", True, device=cpu, smoke=True,
                step_kind="round")
    out["f32"] = None
except AssertionError as e:
    out["f32"] = str(e)
aggregation.all_gather_rows = gather

seed = masking.mask_stream_seed
def aliased(step, dev, leaf, cohort, run_seed=0):
    # shard 1's streams are shard 0's
    return seed(step, 0 if dev == 1 else dev, leaf, cohort,
                run_seed=run_seed)
masking.mask_stream_seed = aliased
try:
    dryrun.cell("internlm2-1.8b", "train_4k", True, device=cpu, smoke=True,
                step_kind="round")
    out["overlap"] = None
except AssertionError as e:
    out["overlap"] = str(e)
masking.mask_stream_seed = seed
dist.destroy_process_group()

meshlib.init_dry(8)
mesh = meshlib.make_debug_pod_mesh(2, 2, 2, device=cpu)
r = dryrun.cell("internlm2-1.8b", "train_4k", True, device=cpu, smoke=True,
                mesh=mesh)
out["train_arg"] = r["train_step"]["memory"]["argument_size"]
out["round_arg"] = r["round_step"]["memory"]["argument_size"]
_, st = stream_cover.meta_fed_state(get_config("internlm2-1.8b",
                                               smoke=True), 2)
out["round_leaf_bytes"] = dryrun.block_bytes(
    st, steplib.fed_state_shardings(st, mesh), mesh)
dist.destroy_process_group()

path = sys.argv[2]
with open(path, "w") as f:
    json.dump({"internlm2-1.8b|train_4k|pod2x16x16": {"ok": True,
                                                      "mark": 7}}, f)
out["skip_rc"] = dryrun.main(["--arch", "internlm2-1.8b", "--shape",
                              "train_4k", "--mesh", "multi", "--out", path,
                              "--device", "cpu"])
with open(path) as f:
    out["skip_file"] = json.load(f)
out["fail_rc"] = dryrun.main(["--arch", "no-such-arch", "--shape",
                              "train_4k", "--mesh", "multi", "--out",
                              path + ".fail", "--device", "cpu"])
with open(path + ".fail") as f:
    out["fail_file"] = json.load(f)
with open(sys.argv[1], "w") as f:
    json.dump(out, f, default=str)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port) results, the two subprocesses run side by
    side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    base = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref_env = dict(base, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=512")
    port_env = dict(base, PYTHONPATH=str(ROOT / "src"))
    procs = [
        subprocess.Popen([sys.executable, "-c", REFERENCE,
                          str(tmp / "ref.json"), HLO], env=ref_env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True),
        subprocess.Popen([sys.executable, "-c", PORT, str(tmp / "port.json"),
                          str(tmp / "out.json")], env=port_env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)]
    logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, o[-3000:] + e[-3000:]
    return (json.loads((tmp / "ref.json").read_text()),
            json.loads((tmp / "port.json").read_text()), logs[1][0])


def test_shapes_and_cells_equal_the_reference(runs):
    ref, _, _ = runs
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind]
            for k, v in SHAPES.items()} == ref["shapes"]
    assert sorted(LONG_CONTEXT_OK) == ref["long"]
    assert [list(c) for c in dryrun.iter_cells(ARCH_NAMES, list(SHAPES))] \
        == ref["cells"]


def _spec(s):
    return [None if p is None else p if isinstance(p, str) else
            (p[0] if len(p) == 1 else list(p)) for p in tuple(s)]


def _specs(shapes, shardings):
    from repro_torch.core import tree as tu
    out = {}
    for (path, x), sh in zip(tu.flatten_with_paths(shapes),
                             tu.leaves(shardings)):
        out[path] = [list(x.shape), str(x.dtype).removeprefix("torch."),
                     _spec(sh.spec)]
    return out


def _ref_paths(d):
    """The reference's keystr paths (['a']['b'], [0]) as the port's a/b."""
    return {k.replace("']['", "/").strip("[]'").replace("][", "/"): v
            for k, v in d.items()}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_batch_specs_equal_the_reference(runs, multi_pod):
    ref, _, _ = runs
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AxisSizes.of(shape, axes)
    C = steplib.n_cohorts(mesh)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        api = build_model(cfg)
        want = ref["specs"][f"{arch}|{multi_pod}"]
        b, bsh = dryrun.train_batch_specs(cfg, SHAPES["train_4k"], mesh, C)
        assert _specs(b, bsh) == _ref_paths(want["train"]), arch
        p, psh = dryrun.prefill_batch_specs(cfg, SHAPES["prefill_32k"],
                                            mesh)
        assert _specs(p, psh) == _ref_paths(want["prefill"]), arch
        cache, csh, tok, pos, (tsh, qsh) = dryrun.serve_batch_specs(
            cfg, SHAPES["decode_32k"], mesh, api)
        assert _specs(cache, csh) == _ref_paths(want["cache"]), arch
        assert _specs([tok, pos], [tsh, qsh]) == _ref_paths(
            want["token"]), arch


def test_collective_bytes_equal_the_reference_parser(runs):
    ref, _, _ = runs
    got = dryrun.collective_bytes(HLO_SITES)
    assert got == ref["hlo"]
    assert list(got)[-1] == "total"


def test_round_cell_comm_model_equals_the_reference(runs):
    """internlm2-1.8b's SMOKE round on the (2, 16, 16) production mesh,
    seen from rank 0 of the stand-in group: the reference's static comm
    model of its jaxpr traced on 512 forced devices."""
    ref, port, _ = runs
    rnd = port["cell"]["round_step"]
    assert rnd["comm_model"] == ref["comm"]
    assert rnd["purity_findings"] == []
    assert rnd["peers"] == "fake"
    # 7 masked leaves, a cohort a pod: one word stream each, and the
    # uplink every shard's block at 1 bit a parameter and cohort plus the
    # word padding (< 32 bits a leaf, cohort and shard: 256 shards a
    # cohort) and the replicas' share (none here)
    assert rnd["collective_bytes"]["all-gather"] * 8 * 512 == \
        rnd["comm_model"]["uplink_bits"]
    assert rnd["replica_share"] == 0.0
    slack = 32 * 7 * 256 / rnd["mask_params"]
    assert 1.0 <= rnd["comm_model"]["bpp_wire"] <= 1.0 + slack
    assert port["cell"]["stream_cover"]["ok"]
    # the train step runs partitioned on rank 0's block: its collectives
    # recorded, kernels 1 and 2 a 512th of the global step's flops
    train = port["cell"]["train_step"]
    assert set(train["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "total"}
    assert train["flops"] > 0
    for k in ("masked_matmul_fwd", "masked_matmul_dx"):
        assert train["kernel_work"][k]["flops"] * 512 == \
            train["global_step"]["kernel_work"][k]["flops"]
    assert rnd["memory"]["generated_code_size"] is None


def test_unpacked_round_fires_purity_and_costs_sixteen_bits(runs):
    _, port, _ = runs
    rnd = port["unpacked"]["round_step"]
    assert len(rnd["purity_findings"]) == 7
    assert all("collective-f32-weight" in f for f in rnd["purity_findings"])
    assert rnd["comm_model"]["bpp_wire"] == 16.0


def test_argument_bytes_equal_the_compiled_argument_size(runs):
    """Rank 0's block on a (2, 2, 2) mesh: the train step's state and
    batch equal the reference's compiled argument size; the round's,
    after dropping the arguments the reference's executable pruned (the
    moments it only zeroes)."""
    ref, port, _ = runs
    assert port["train_arg"] == ref["train_arg"]
    leaves = port["round_leaf_bytes"]
    assert port["round_arg"] == sum(leaves)
    assert sum(leaves[i] for i in ref["round_kept"]) == ref["round_arg"]
    assert len(ref["round_kept"]) < len(leaves)


def test_injected_f32_site_makes_a_packed_cell_raise(runs):
    _, port, _ = runs
    assert port["f32"] is not None
    assert "wire purity" in port["f32"]
    assert "collective-f32-weight" in port["f32"]


def test_injected_stream_overlap_makes_a_cell_raise(runs):
    _, port, _ = runs
    assert port["overlap"] is not None
    assert "mask-stream coverage" in port["overlap"]
    assert "stream-overlap" in port["overlap"]


def test_main_skips_an_ok_cell_and_fails_on_a_failing_one(runs):
    _, port, stdout = runs
    assert port["skip_rc"] == 0
    assert port["skip_file"] == {"internlm2-1.8b|train_4k|pod2x16x16": {
        "ok": True, "mark": 7}}
    assert "done: 0 ok, 0 failed" in stdout
    assert port["fail_rc"] == 1
    cell = port["fail_file"]["no-such-arch|train_4k|pod2x16x16"]
    assert cell["ok"] is False and "KeyError" in cell["error"]
    assert "[FAIL] no-such-arch|train_4k|pod2x16x16" in stdout
    assert "done: 0 ok, 1 failed" in stdout


def test_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k"])
