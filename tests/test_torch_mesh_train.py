"""The port's partitioned train step (`steps.make_train_step(api, cfg,
mesh, state_sh)`, `launch.partition`) over `torch.distributed`, held rank
by rank against the JAX package's train step jitted with in_shardings
(`fed_state_shardings`, the batch on ("pod", "data")) on a forced
8-device (2, 2, 2) CPU mesh, as its dry run jits it.

One reference subprocess runs REF_RUNS, SMOKE models with their floats
cast to f32 so that every activation is f32, two steps each: internlm2
under momentum and under adam, qwen2-7b (its qkv biases: float leaves
with a dim on "model") and whisper-medium (its frames and cross
attention under the batch's sharding) under momentum.  It writes each
device's shards with their block indices.  internlm2's Pallas kernels
run in interpret mode, as the reference's own CPU tests run them; the
other two runs take the reference's REPRO_EFF_PATH switch (see
REF_RUNS).  One spawn of 8 gloo ranks runs the port's counterparts,
each rank on its block of the same state and batch.  Each rank's blocks
are held against that device's shards: the loss within LOSS_RTOL, every
score, moment and float leaf's change within chip_smoke's
BACKWARD_BOUNDS["f32"] (the port against the reference on f32
activations: only the order of the sums differs), after both steps
(whisper: after the first, see REF_RUNS).

The same ranks hold the partitioned step against the port's own
`mesh=None` step from one state, one step, at f32: every dense-leaf
arch's SMOKE model (internlm2, qwen2-7b with its qkv
biases, deepseek-7b, gemma3-4b with its windows, qwen2-vl-2b with patch
embeddings, whisper-medium with frames), internlm2 on bf16 scores, and
internlm2 with d_ff = 129, whose w_gate and w_up columns do not split
over "model" and whose w_down rows do not split over "data" (the
replicated fallbacks).  One step draws the same masks on both sides, so
only the order of the sums differs: SELF_BOUNDS.  The ranks record
every collective of one internlm2 step, held to a closed form from the
shapes by kind, axis and bytes, and check that each placed leaf
(`TrainPlan.place`) draws the global leaf's block of masks.

In this process: a (1, 1, 1) mesh gives the `mesh=None` steps bit for
bit, the torchrun entry's steps too; a block leaf's masks are the
global leaf's block's, at an offset that wraps past 2**32; the step
refuses unaligned MoE routing groups.  The MoE family's partitioned
step is held in `test_torch_mesh_train_moe.py`, the ssm and hybrid
families' in `test_torch_mesh_train_ssm.py`, microbatches and
block-local dispatch in `test_torch_mesh_train_micro.py`.
"""
import dataclasses
import importlib.util
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESH, AXES = (2, 2, 2), ("pod", "data", "model")
C, B, S, SEED = 2, 4, 16, 17
LR = 0.3
RANK_TIMEOUT = 240
LOSS_RTOL = 1e-5
# the port's partitioned step against its own mesh=None step (one step,
# f32 activations, the same masks): per f32 leaf, (largest relative norm
# of the difference of the updates, smallest cosine).  Measured over the
# 8 cases and ranks: moments 9.2e-7, floats 6.1e-5, score updates 1.5e-4
# (an update read back as s1 - s0 keeps only the bits above the score's
# own ulp), cosines above 1 - 2e-8.  bf16 scores: each score within one
# bf16 ulp of mesh=None's (the gradient's last bits may tip its rounding;
# the update alone is ill-conditioned, most updates being below the
# score's ulp); the bf16 first moment, a gradient whose ds each data
# rank rounds to bf16 before the two are summed in bf16 (mesh=None
# rounds the batch's once), per leaf within BF16_MOMENT_BOUNDS, measured
# 3.6e-3 and 0.999994
SELF_BOUNDS = (1e-3, 0.999999)
BF16_MOMENT_BOUNDS = (1e-2, 0.9999)
# the reference runs: (name, arch, optimizers, the step after which the
# blocks are held, whether the reference's step runs its Pallas kernels
# in interpret mode; else REPRO_EFF_PATH=1, its own switch to the same
# hash masks on materialized weights, which halves the subprocess's
# time), two steps each, both losses held.  whisper's blocks
# are held after its first step: after its second, even the reference's
# GSPMD step and its own unpartitioned step differ by up to 0.13 in
# relative norm (the encoder's moments and scores): scores that one
# step's rounding moved apart flip masks in the second draw
REF_RUNS = (("internlm2", "internlm2-1.8b", ("momentum", "adam"), 2, True),
            ("qwen2", "qwen2-7b", ("momentum",), 2, False),
            ("whisper", "whisper-medium", ("momentum",), 1, False))
# (case, arch, config fields replaced, score dtype)
CASES = (("internlm2", "internlm2-1.8b", {}, "float32"),
         ("qwen2", "qwen2-7b", {}, "float32"),
         ("deepseek7b", "deepseek-7b", {}, "float32"),
         ("gemma3", "gemma3-4b", {}, "float32"),
         ("qwen2vl", "qwen2-vl-2b", {}, "float32"),
         ("whisper", "whisper-medium", {}, "float32"),
         ("bf16_scores", "internlm2-1.8b", {}, "bfloat16"),
         ("odd_ffn", "internlm2-1.8b", {"d_ff": 129}, "float32"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _api(arch, over=None):
    return build_model(dataclasses.replace(get_config(arch, smoke=True),
                                           **(over or {})))


def _start(api, score_dtype=torch.float32, optimizer="momentum", seed=5):
    """A SMOKE fed state of C cohorts whose thetas spread over (0, 1), its
    float leaves in f32 (so every activation is f32)."""
    st = steps.init_fed_state(torch.Generator().manual_seed(seed), api,
                              masking.MaskSpec(), C=C,
                              score_dtype=score_dtype, optimizer=optimizer)
    gen = torch.Generator().manual_seed(seed + 1)
    for s in tree.leaves(st["scores"]):
        if s is not None:
            s.copy_(s.float() + 2.0 * torch.randn(s.shape, generator=gen))
    st["floats"] = tree.tree_map(
        lambda t: None if t is None else t.float(), st["floats"])
    return st


def _batch(api, seed):
    """A global (C, B, ...) batch: tokens, and the VLM's patch embeddings
    or the encoder-decoder's frames in f32."""
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, api.cfg.vocab, (C, B, S),
                                   generator=gen)}
    if api.cfg.family == "vlm":
        out["vis_embeds"] = 0.1 * torch.randn(C, B, 4, api.cfg.d_model,
                                              generator=gen)
    if api.cfg.family == "encdec":
        out["frames"] = 0.1 * torch.randn(C, B, api.cfg.enc_seq,
                                          api.cfg.d_model, generator=gen)
    return out


def _local_batch(batch, mesh):
    """This rank's block of a global batch: its pod's cohorts, its "data"
    rows."""
    from repro_torch.launch import sharding as shd
    sh = shd.NamedSharding(mesh, shd.P("pod", "data"))
    return {k: sh.local(v) for k, v in batch.items()}


def _clone(t):
    return tree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, t)


def _blocks(prefix, local, shardings, host, out):
    keys = ("scores", "floats", "opt_m", "opt_v")
    for key in keys:
        if key not in local:
            continue
        for (p, x), sh, g in zip(tree.flatten_with_paths(local[key]),
                                 tree.leaves(shardings[key]),
                                 tree.leaves(host[key])):
            if x is None:
                continue
            out[f"{prefix}/{key}/{p}"] = x.float().numpy().copy()
            out[f"{prefix}/{key}/{p}/index"] = np.array(
                [[s.start, s.stop] for s in sh.index(tuple(g.shape))],
                np.int64)


# ---------------------------------------------------------------------------
# The reference: two GSPMD-jitted steps on 8 forced CPU devices
# ---------------------------------------------------------------------------

REFERENCE_TEMPLATE = r'''
import dataclasses
import os
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import masking
from repro.launch import steps
from repro.launch import sharding as shd
from repro.models import build_model

inp, out_path = sys.argv[1], sys.argv[2]
a = dict(np.load(inp))
NONE = lambda x: x is None

def rank(d):
    return int(np.ravel_multi_index(
        tuple(int(i) for i in np.argwhere(grid == d)[0]), grid.shape))

res = {}
def shards(prefix, tree_):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_, is_leaf=NONE)
    for path, x in flat:
        if x is None:
            continue
        name = prefix + "/" + shd._path_str(path)
        for s in x.addressable_shards:
            r = rank(s.device)
            res[f"{name}/{r}"] = np.asarray(s.data).astype(np.float32)
            res[f"{name}/{r}/index"] = np.array(
                [[sl.start or 0, sl.stop if sl.stop is not None else n]
                 for sl, n in zip(s.index, x.shape)], np.int64)

for run, arch, opts, held, fused, *more in REF_RUNS:
    over = more[0] if more else {}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(
        over.get("mesh", (2, 2, 2))), ("pod", "data", "model"))
    grid = np.asarray(mesh.devices)
    os.environ["REPRO_EFF_PATH"] = "0" if fused else "1"    # read at trace
    api = build_model(dataclasses.replace(get_config(arch, smoke=True),
                                          **over.get("patch", {})))
    for opt in opts:
        tag = f"{run}/{opt}"
        shape = jax.eval_shape(lambda k: steps.init_fed_state(
            k, api, masking.MaskSpec(), 2, optimizer=opt),
            jax.random.PRNGKey(0))
        def fill(key, t):
            flat, tdef = jax.tree_util.tree_flatten_with_path(
                t, is_leaf=NONE)
            return jax.tree_util.tree_unflatten(tdef, [
                None if x is None else jnp.asarray(
                    a[f"{tag}/{key}/" + shd._path_str(p)]).astype(
                        jnp.float32 if key == "floats" else x.dtype)
                for p, x in flat])
        state = {k: fill(k, v) for k, v in shape.items() if k != "step"}
        state["step"] = jnp.asarray(0, jnp.int32)
        sh = steps.fed_state_shardings(state, mesh)
        names = sorted(k.split("/")[2] for k in a
                       if k.startswith(f"{run}/batch0/"))
        bsh = {k: NamedSharding(mesh, P("pod", "data")) for k in names}
        cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED, optimizer=opt,
                               microbatch=over.get("microbatch", 1))
        fn = jax.jit(steps.make_train_step(api, cfg),
                     in_shardings=(sh, bsh),
                     out_shardings=(sh, shd.replicated(mesh)))
        st = jax.device_put(state, sh)
        for i in range(2):
            batch = jax.device_put({k: jnp.asarray(a[f"{run}/batch{i}/{k}"])
                                    for k in names}, bsh)
            st, m = fn(st, batch)
            res[f"{tag}/loss/{i}"] = np.asarray(m["loss"])
            if i + 1 == held:
                for key in ("scores", "floats", "opt_m", "opt_v"):
                    if key in st:
                        shards(f"{tag}/{key}", st[key])
np.savez(out_path, **res)
'''


def reference_script(runs) -> str:
    """The reference subprocess's script for the runs `runs` (REF_RUNS'
    layout, each run optionally followed by a dict: its "mesh" shape
    over ("pod", "data", "model"), (2, 2, 2) by default, its
    "microbatch" and its config fields replaced, "patch")."""
    return REFERENCE_TEMPLATE.replace("LR", repr(LR)).replace(
        "SEED", repr(SEED)).replace("REF_RUNS", repr(runs))


def _inputs(path, runs=REF_RUNS):
    """Each reference run's start states (the port's init, f32 floats) and
    two global batches, as numpy arrays keyed by
    '{run}/{opt}/{key}/{path}' and '{run}/batch{i}/{name}'."""
    out = {}
    for run, arch, opts, *_ in runs:
        api = _api(arch)
        for opt in opts:
            st = _start(api, optimizer=opt)
            for key in ("scores", "floats", "weights", "opt_m", "opt_v"):
                for p, x in tree.flatten_with_paths(st.get(key, {})):
                    if x is not None:
                        out[f"{run}/{opt}/{key}/{p}"] = x.float().numpy()
        for i in range(2):
            for k, v in _batch(api, 40 + i).items():
                out[f"{run}/batch{i}/{k}"] = v.numpy()
    np.savez(path, **out)
    return out


def _start_reference(inp, out, runs=REF_RUNS):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", reference_script(runs),
                             str(inp), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


# ---------------------------------------------------------------------------
# The port: one process a rank
# ---------------------------------------------------------------------------


def _host_from(arrs, arch, tag, opt):
    """The port's host-global state of run and optimizer `tag` from
    `_inputs`' arrays."""
    api = _api(arch)
    st = _start(api, optimizer=opt)
    for key in ("scores", "floats", "weights", "opt_m", "opt_v"):
        if key not in st:
            continue
        flat, tdef = tree.flatten(st[key])
        paths = [p for p, _ in tree.flatten_with_paths(st[key])]
        st[key] = tree.unflatten(tdef, [
            None if x is None else torch.from_numpy(
                arrs[f"{tag}/{key}/{p}"]).to(x.dtype)
            for p, x in zip(paths, flat)])
    return api, st


def _placed_masks(mesh, api, host, st, sh):
    """[leaf index, whether equal] for every masked leaf: the rank's block
    of it, placed by `TrainPlan.place` (the block's offsets, n_logical =
    N), materializes to the global leaf's block of effective weights bit
    for bit, under the seeds of the rank's first cohort."""
    from repro_torch.launch import partition
    plan = partition.TrainPlan(mesh, st, sh)
    c = plan.first_cohort(1)

    def masked(state, cohort):
        mp = masking.MaskedParams(
            state["weights"],
            tree.tree_map(lambda s: None if s is None else s[cohort],
                          state["scores"]),
            tree.tree_map(lambda f: None if f is None else f[cohort],
                          state["floats"]))
        return tree.flatten(masking.masked_forward_tree(
            mp, lambda i: masking.mask_stream_seed(0, 0, i, c,
                                                   run_seed=SEED)))[0]
    res = []
    for i, (g, p, wsh) in enumerate(zip(masked(host, c), masked(st, 0),
                                        tree.leaves(sh["weights"]))):
        if not isinstance(g, masking.MaskedLeaf):
            continue
        got = masking.materialize_leaf(plan.place(i, p)).detach()
        want = masking.materialize_leaf(g).detach()[
            wsh.index(tuple(g.w.shape))]
        res.append([i, int(torch.equal(got, want))])
    return np.array(res, np.int64)


def _calls(sites):
    return [[s.prim, s.dtype, list(s.axes), s.elems] for s in sites]


def _rank_main(rank, world, store, inp, out_dir):
    import torch.distributed as dist
    from repro_torch.analysis import comm_model
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime import elastic
    torch.set_num_threads(1)
    meshlib.init("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = meshlib.make_debug_pod_mesh()
        arrs = dict(np.load(inp))
        out, calls = {}, {}
        for run, arch, opts, held, _ in REF_RUNS:
            for opt in opts:
                tag = f"{run}/{opt}"
                api, host = _host_from(arrs, arch, tag, opt)
                sh = steps.fed_state_shardings(host, mesh)
                st = elastic.reshard_server(_clone(host), sh)
                fn = steps.make_train_step(
                    api, steps.StepConfig(lam=1.0, lr=LR, seed=SEED,
                                          optimizer=opt), mesh, sh)
                if run == "internlm2" and opt == "momentum":
                    out["placed_masks"] = _placed_masks(mesh, api, host,
                                                        st, sh)
                for i in range(2):
                    pre = f"{run}/batch{i}/"
                    batch = {k[len(pre):]: torch.from_numpy(v)
                             for k, v in arrs.items() if k.startswith(pre)}
                    st, m = fn(st, _local_batch(batch, mesh))
                    out[f"{tag}/loss/{i}"] = m["loss"].numpy()
                    if i + 1 == held:
                        _blocks(tag, st, sh, host, out)
        for name, arch, over, dtype in CASES:
            api = _api(arch, over)
            host = _start(api, getattr(torch, dtype))
            sh = steps.fed_state_shardings(host, mesh)
            batch = _batch(api, 50)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED,
                                   score_dtype=getattr(torch, dtype))
            plain, mp = steps.make_train_step(api, cfg)(_clone(host), batch)
            st = elastic.reshard_server(_clone(host), sh)
            with comm_model.record_collectives(mesh, check=True) as sites:
                st, mm = steps.make_train_step(api, cfg, mesh, sh)(
                    st, _local_batch(batch, mesh))
            calls[name] = _calls(sites)
            out[f"{name}/loss"] = np.array([float(mp["loss"]),
                                            float(mm["loss"])])
            _blocks(f"{name}/mesh", st, sh, host, out)
            _blocks(f"{name}/plain", {k: tree.tree_map(
                lambda x, h: None if x is None else h.local(x), v, sh[k])
                for k, v in plain.items() if k in sh and k != "step"},
                sh, host, out)
            _blocks(f"{name}/start", {k: tree.tree_map(
                lambda x, h: None if x is None else h.local(x), v, sh[k])
                for k, v in host.items() if k in sh and k != "step"},
                sh, host, out)
        out["coords"] = np.array([mesh.coords[a] for a in AXES])
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"calls{rank}.json").write_text(json.dumps(calls))
    finally:
        dist.destroy_process_group()


def _join(procs):
    try:
        for p in procs:
            p.join(RANK_TIMEOUT)
            assert not p.is_alive(), "a rank did not finish in time"
            assert p.exitcode == 0, f"a rank exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def mesh_run():
    """({rank: the port's arrays}, {rank: its recorded collectives}, the
    reference's arrays, the inputs), from one reference run and one
    spawn."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        inp = tmp / "inputs.npz"
        arrs = _inputs(inp)
        ref = _start_reference(inp, tmp / "ref.npz")
        try:
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_rank_main, args=(
                r, 8, str(tmp / "store"), str(inp), str(tmp)))
                for r in range(8)]
            for p in procs:
                p.start()
            _join(procs)
            _, err = ref.communicate(timeout=RANK_TIMEOUT)
            assert ref.returncode == 0, err[-4000:]
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait(10)
        port = {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)}
        calls = {r: json.loads((tmp / f"calls{r}.json").read_text())
                 for r in range(8)}
        want = dict(np.load(tmp / "ref.npz"))
    return port, calls, want, arrs


# ---------------------------------------------------------------------------
# The comparisons
# ---------------------------------------------------------------------------


def _agree(d_want, d_got):
    """(relative norm of the difference, cosine) of two updates."""
    a, b = d_want.astype(np.float64).ravel(), d_got.astype(np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 and nb == 0.0:
        return 0.0, 1.0
    return (float(np.linalg.norm(b - a) / na) if na else math.inf,
            float(a @ b / (na * nb)) if na and nb else 0.0)


def _bf16_ulps(a, b) -> float:
    """The largest difference of two arrays of bf16 values (held in f32),
    in bf16 ulps of the larger magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return float(np.max(np.abs(a.astype(np.float64) - b) / ulp))


def _leaves(arrays, prefix):
    return sorted(k[len(prefix) + 1:-len("/index")] for k in arrays
                  if k.startswith(prefix + "/") and k.endswith("/index"))


@pytest.mark.parametrize("run, opt", [
    pytest.param("internlm2", "momentum", id="momentum"),
    pytest.param("internlm2", "adam", id="adam"),
    pytest.param("qwen2", "momentum", id="qwen2-momentum"),
    pytest.param("whisper", "momentum", id="whisper-momentum")])
def test_two_steps_equal_the_reference_shard_by_shard(mesh_run, run, opt):
    """Every rank's blocks against its device's shards after the run's
    held step (REF_RUNS): the same leaves and block indices, both steps'
    losses within LOSS_RTOL, every leaf's change within chip_smoke's f32
    backward bounds."""
    port, _, want, arrs = mesh_run
    max_rel, min_cos = _chip_smoke().BACKWARD_BOUNDS["f32"]
    tag = f"{run}/{opt}"
    leaves = _leaves(port[0], tag)
    assert leaves == sorted(k[len(tag) + 1:-len("/0/index")] for k in want
                            if k.startswith(tag + "/")
                            and k.endswith("/0/index"))
    if run == "internlm2":
        # 7 score leaves, 5 float leaves, a moment (adam: two) a score leaf
        assert len(leaves) == (19 if opt == "momentum" else 26)
    keys = {k.split("/")[0] for k in leaves}
    assert keys == ({"scores", "floats", "opt_m", "opt_v"} if opt == "adam"
                    else {"scores", "floats", "opt_m"})
    for r in range(8):
        for i in range(2):
            np.testing.assert_allclose(port[r][f"{tag}/loss/{i}"],
                                       want[f"{tag}/loss/{i}"],
                                       rtol=LOSS_RTOL)
        for leaf in leaves:
            idx = port[r][f"{tag}/{leaf}/index"]
            assert np.array_equal(idx, want[f"{tag}/{leaf}/{r}/index"]), (
                leaf, r)
            key, path = leaf.split("/", 1)
            start = arrs.get(f"{tag}/{key}/{path}")
            start = np.zeros_like(want[f"{tag}/{leaf}/{r}"]) if start is None \
                else start[tuple(slice(a, b) for a, b in idx)]
            rel, cos = _agree(want[f"{tag}/{leaf}/{r}"] - start,
                              port[r][f"{tag}/{leaf}"] - start)
            assert rel <= max_rel and cos >= min_cos, (tag, leaf, r, rel,
                                                       cos)


def test_placed_leaves_draw_the_global_masks(mesh_run):
    """On every rank, each of internlm2's placed masked leaves (its block,
    the block's offsets, n_logical = N) materializes to the global leaf's
    block of effective weights bit for bit: the placed leaf alone
    describes its masks, whatever consumes it."""
    port, _, _, _ = mesh_run
    for r in range(8):
        got = port[r]["placed_masks"]
        assert len(got) == 7 and got[:, 1].all(), (r, got)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_step_equals_the_plain_step(mesh_run, case):
    """The partitioned step against `mesh=None` from one state, one step,
    block by block on every rank: the global mean loss within LOSS_RTOL,
    every leaf's update within SELF_BOUNDS."""
    port, _, _, _ = mesh_run
    dtype = dict((c[0], c[3]) for c in CASES)[case]
    for r in range(8):
        got = port[r]
        loss = got[f"{case}/loss"]
        np.testing.assert_allclose(loss[1], loss[0], rtol=LOSS_RTOL)
        leaves = _leaves(got, f"{case}/mesh")
        assert leaves == _leaves(got, f"{case}/plain")
        for leaf in leaves:
            want, have = got[f"{case}/plain/{leaf}"], got[f"{case}/mesh/{leaf}"]
            bf16 = dtype == "bfloat16" and not leaf.startswith("floats")
            if bf16 and leaf.startswith("scores"):
                assert _bf16_ulps(want, have) <= 1, (case, leaf, r)
                continue
            start = got[f"{case}/start/{leaf}"]
            rel, cos = _agree(want - start, have - start)
            bound = BF16_MOMENT_BOUNDS if bf16 else SELF_BOUNDS
            assert rel <= bound[0] and cos >= bound[1], (case, leaf, r, rel,
                                                         cos)


def _wire(api, host, sh, mesh_shape, tokens, act_bytes):
    """{(prim, dtype, axes): elements} one partitioned step of one cohort
    a rank sends, from the global shapes: a masked (K, N) layer block
    gathers its w (bf16) and s rows over "data", gathers its output
    columns and all-reduces its dx over "model", reduce-scatters ds over
    "data"; a float leaf gathers each sharded dim in turn and sends its
    gradient back (model dims sliced, then reduce-scattered over "data"
    on a data dim, else all-reduced there); the loss crosses the client
    axes once."""
    dd, dm = mesh_shape["data"], mesh_shape["model"]
    act = "float32" if act_bytes == 4 else "bfloat16"
    out = {}

    def add(prim, dtype, axes, n):
        key = (prim, dtype, axes)
        out[key] = out.get(key, 0) + n
    for s, spec in zip(tree.leaves(host["scores"]),
                       tree.leaves(sh["scores"])):
        if s is None:
            continue
        K, N = s.shape[-2:]
        layers = math.prod(s.shape[1:-2])
        rows, cols = K % dd == 0, N % dm == 0
        kl, nl = K // (dd if rows else 1), N // (dm if cols else 1)
        assert tuple(spec.spec)[-2:] == ("data" if rows else None,
                                         "model" if cols else None)
        for _ in range(layers):
            if rows:
                add("all_gather", "bfloat16", ("data",), kl * nl)
                add("all_gather", "float32", ("data",), kl * nl)
                add("reduce_scatter", "float32", ("data",), K * nl)
            else:
                add("psum", "float32", ("data",), K * nl)
            if cols:
                add("all_gather", act, ("model",), tokens * nl)
                add("psum", act, ("model",), tokens * K)
    for f, spec in zip(tree.leaves(host["floats"]),
                       tree.leaves(sh["floats"])):
        if f is None:
            continue
        parts = list(spec.spec)[1:] + [None] * (f.ndim - len(spec.spec))
        shape = [d // (dd if p == "data" else dm if p == "model" else 1)
                 for d, p in zip(f.shape[1:], parts)]
        for d, p in enumerate(parts):
            if p is not None:
                add("all_gather", "float32", (p,), math.prod(shape))
                shape[d] = f.shape[1 + d]
        grad = [d // dm if p == "model" else d
                for d, p in zip(f.shape[1:], parts)]
        add("reduce_scatter" if "data" in parts else "psum", "float32",
            ("data",), math.prod(grad))
    add("psum", "float32", ("pod", "data"), 1)
    return out


def test_recorded_wire_equals_the_closed_form(mesh_run):
    """internlm2's SMOKE step on every rank: the collectives it recorded,
    summed by kind, dtype and axes, equal `_wire` from the shapes."""
    _, calls, _, _ = mesh_run
    api = _api("internlm2-1.8b")
    host = _start(api)

    class Stub:
        shape, axis_names = dict(zip(AXES, MESH)), AXES
        coords = dict.fromkeys(AXES, 0)
    sh = steps.fed_state_shardings(host, Stub())
    want = _wire(api, host, sh, Stub.shape, B // MESH[1] * S, 4)
    assert want[("all_gather", "bfloat16", ("data",))] > 0
    for r in range(8):
        got = {}
        for prim, dtype, axes, n in calls[r]["internlm2"]:
            key = (prim, dtype, tuple(axes))
            got[key] = got.get(key, 0) + n
        assert got == want, r


def test_replicated_fallbacks_run(mesh_run):
    """d_ff = 129: w_gate and w_up (64 x 129) keep every column on each
    "model" rank and w_down's 129 rows every row on each "data" rank, its
    ds all-reduced there; the step still equals `mesh=None`
    (`test_partitioned_step_equals_the_plain_step`)."""
    port, calls, _, _ = mesh_run
    idx = port[0]["odd_ffn/mesh/scores/layers/mlp/w_up/index"]
    assert idx[-1].tolist() == [0, 129]
    idx = port[0]["odd_ffn/mesh/scores/layers/mlp/w_down/index"]
    assert idx[-2].tolist() == [0, 129]
    psums = [c for c in calls[0]["odd_ffn"]
             if c[:3] == ["psum", "float32", ["data"]]]
    assert [c[3] for c in psums].count(129 * 32) == 2    # 2 layers


def _world_of_one(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    meshlib.init("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                 rank=0, world_size=1, timeout=timedelta(seconds=60))
    return meshlib.make_debug_pod_mesh()


def test_world_of_one_equals_the_plain_step(tmp_path):
    """On a (1, 1, 1) mesh the partitioned step is the `mesh=None` step
    bit for bit, two steps under momentum and adam (scores, moments,
    floats, losses), and so are the torchrun entry's steps; one thread,
    so every CPU reduction sums in one order."""
    import torch.distributed as dist
    from repro_torch.launch import mesh_round
    from repro_torch.runtime import elastic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = _world_of_one(tmp_path)
    try:
        api = _api("internlm2-1.8b")
        for opt in ("momentum", "adam"):
            host = _start(api, optimizer=opt)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED, optimizer=opt)
            sh = steps.fed_state_shardings(host, mesh)
            a, b = _clone(host), elastic.reshard_server(_clone(host), sh)
            fa = steps.make_train_step(api, cfg)
            fb = steps.make_train_step(api, cfg, mesh, sh)
            for i in range(2):
                batch = _batch(api, 60 + i)
                a, ma = fa(a, batch)
                b, mb = fb(b, batch)
                assert torch.equal(ma["loss"], mb["loss"]), (opt, i)
            for key in ("scores", "floats", "opt_m", "opt_v"):
                for x, y in zip(tree.leaves(a.get(key)),
                                tree.leaves(b.get(key))):
                    assert (x is None and y is None) or torch.equal(x, y), (
                        opt, key)
            assert a["step"] == b["step"] == 2
        # the entry: --steps 2 before the round, against the plain steps
        # and round from the same start
        args = mesh_round.parse_args(["--smoke", "--device", "cpu",
                                      "--steps", "2"])
        api, start = mesh_round.global_state(args.arch, args.cohorts,
                                             smoke=True)
        out = mesh_round.run(args, mesh, (api, start))
        st = elastic.reshard_server(start, "cpu")
        plain = steps.make_train_step(api, mesh_round.step_config(args))
        losses = []
        for i in range(2):
            st, m = plain(st, mesh_round.step_batch(args, api, i, "cpu"))
            losses.append(float(m["loss"]))
        st, _ = steps.make_round_step(api, mesh_round.step_config(args),
                                      codec=mesh_round.CODEC)(st)
        assert out["losses"] == losses
        for key in ("scores", "opt_m"):
            for x, y in zip(tree.leaves(st[key]),
                            tree.leaves(out["state"][key])):
                assert (x is None and y is None) or torch.equal(x, y), key
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ("sample", "threshold"))
def test_block_leaf_draws_the_global_leafs_masks(mode):
    """A (rows, cols) block of a leaf as a leaf of its own, its offset
    moved to the block's origin on the leaf's stream and n_logical the
    leaf's N: its effective weights are the global leaf's block's bit for
    bit, at a layer offset where the block's indices wrap past 2**32; and
    the dense product on one-hot rows reads the same masks."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(11)
    K, N, r0, r1, c0, c1 = 48, 40, 16, 32, 10, 30
    w = torch.randn(K, N, generator=gen).to(torch.bfloat16)
    s = 2.0 * torch.randn(K, N, generator=gen)
    off = (1 << 32) - (r0 + 7) * N - 3         # wraps inside the block
    seed = masking.mask_stream_seed(3, 0, 5, 1, run_seed=SEED)
    leaf = masking.MaskedLeaf(w, s, np.uint32(seed), np.uint32(off), mode)
    boff = np.uint32((off + r0 * N + c0) & 0xFFFFFFFF)
    blk = masking.MaskedLeaf(w[r0:r1, c0:c1], s[r0:r1, c0:c1],
                             np.uint32(seed), boff, mode, n_logical=N)
    full = layers.effective_weight(leaf).detach()
    got = layers.effective_weight(blk).detach()
    assert torch.equal(got, full[r0:r1, c0:c1])
    assert off + r0 * N + c0 < 2 ** 32 < off + r1 * N
    x = torch.eye(r1 - r0, dtype=torch.float32)
    y = layers.masked_dense_apply(x, blk) if mode == "sample" else \
        ops.masked_dense_threshold(x, blk.w, blk.s)
    assert torch.equal(y, got.float())


def test_refusals():
    """What the partitioned step still refuses: a MoE layer's routing
    groups that M or G leave unaligned with the data ranks (6 rows on 2
    data ranks at M = 3: chunks of 32 tokens on ranks of 48;
    `check_train` runs on the step's first call, naming the condition),
    and a family outside FAMILIES; mesh without state_sh raises.
    Microbatches and block-local dispatch build, and aligned groups pass
    the check: a group inside a rank, one over whole ranks, G's global
    fallback and the dense families at any M (no mesh is built: the step
    refuses before it reads one)."""
    from repro_torch.launch import partition
    api = _api("internlm2-1.8b")
    moe = _api("deepseek-v2-lite-16b")
    with pytest.raises(NotImplementedError, match="routing groups of 32 "
                       "tokens, which neither lie inside a data rank's 48"):
        partition.check_train(moe, steps.StepConfig(microbatch=3), 2, 6, S)
    blocks = _api("deepseek-v2-lite-16b", {"moe_block_dispatch": 3})
    with pytest.raises(NotImplementedError, match="moe_block_dispatch 3"):
        partition.check_train(blocks, steps.StepConfig(), 2, 6, 16)
    for a, m, data, rows in ((moe, 2, 4, 4), (moe, 4, 2, 4), (moe, 1, 4, 4),
                             (blocks, 1, 1, 6), (api, 3, 2, 6)):
        partition.check_train(a, steps.StepConfig(microbatch=m), data, rows,
                              S)
    other = type("Api", (), {"cfg": dataclasses.replace(api.cfg,
                                                        family="cnn")})()
    with pytest.raises(NotImplementedError, match="'cnn'"):
        steps.make_train_step(other, steps.StepConfig(), mesh=object(),
                              state_sh={})
    for arch, over, m in (("internlm2-1.8b", {}, 2),
                          ("deepseek-v2-lite-16b", {"moe_block_dispatch": 4},
                           2), ("mamba2-370m", {}, 1),
                          ("recurrentgemma-9b", {}, 3)):
        assert callable(steps.make_train_step(
            _api(arch, over), steps.StepConfig(microbatch=m), mesh=object(),
            state_sh={}))
    with pytest.raises(ValueError):
        steps.make_train_step(api, steps.StepConfig(), mesh=object())
