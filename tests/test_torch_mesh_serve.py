"""The port's partitioned prefill and decode (`steps.make_prefill_step` /
`make_serve_step` with a mesh and a `partition.ServePlan`) over
`torch.distributed`, held rank by rank against the JAX package's prefill
closure and serve step jitted with in_shardings exactly as its dry run
jits them (`tree_param_shardings`, FSDP + TP and `tp_only`;
`prefill_batch_specs`' and `serve_batch_specs`' batch, token and
`cache_shardings`), on forced 8-device CPU meshes.

Two reference subprocesses run RUNS, SMOKE models with every param cast to
f32 (so every activation is f32), each in the default sharding and under
`tp_only`: the prefill of a batch of B rows, then DECODE_POS decode steps
over a cache of CACHE_SEQ positions filled with random keys and values
(a prompt's, as a prefill would leave them; the positions cross the
ranks' blocks where they split).  Its cache splits three ways on
"model": by kv heads (internlm2, deepseek-7b, qwen2-7b with its qkv
biases, qwen2-vl with patch embeddings, whisper with its frames and its
cross caches, all on (2, 2, 2)), by positions over "model" (internlm2 on
(1, 2, 4): 2 kv heads on 4 model ranks), and gemma3 at batch 1 by
positions over every axis (its windows applied by global position).
One spawn of 8 gloo ranks runs the port's partitioned counterparts on
the rank's blocks; each rank's rows of logits and its cache blocks are
held to the reference's global outputs sliced to them within REF_ATOL,
and to the port's own `mesh=None` steps (run in this process) within
SELF_ATOL; the collectives each rank recorded equal
`chip_smoke.serve_sites`.  In this process: a (1, 1, 1) mesh gives
`mesh=None`'s prefill bit for bit (one thread) and its decode within
SELF_ATOL; the moe, ssm and hybrid families and a layout outside the
scheme raise.
"""
import importlib.util
import json
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
from repro_torch.core import tree
from repro_torch.launch import partition, steps
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
B, S, N_VIS, CACHE_SEQ = 4, 8, 4, 16
DECODE_POS = (7, 8, 9)        # over (1, 2, 4)'s blocks of 4 positions: 1, 2
RANK_TIMEOUT = 240
# (name, arch, mesh, decode batch)
RUNS = (("internlm2", "internlm2-1.8b", (2, 2, 2), B),
        ("internlm2_seq", "internlm2-1.8b", (1, 2, 4), B),
        ("deepseek7b", "deepseek-7b", (2, 2, 2), B),
        ("qwen2", "qwen2-7b", (2, 2, 2), B),
        ("gemma3", "gemma3-4b", (2, 2, 2), 1),
        ("qwen2vl", "qwen2-vl-2b", (2, 2, 2), B),
        ("whisper", "whisper-medium", (2, 2, 2), B))
SHARDINGS = ("fsdp_tp", "tp_only")
# f32 logits (|logit| <= 0.69) and cache entries (normal draws, and the
# keys and values each step writes) of the port against the reference's
# GSPMD-jitted steps: only the order of the sums differs (XLA's CPU dots
# against torch's, the partials' merge against a softmax).  Measured over
# the runs, shardings and ranks (one thread a rank): prefill 5.8e-7,
# decode 6.6e-7, caches 3.2e-6.  Against the port's own mesh=None steps:
# prefill 0 (a column block's product is the whole product's columns),
# decode 6.0e-7, caches 2.3e-6.  The bounds leave 4-6x of that.
REF_ATOL = 2e-5
SELF_ATOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _api(arch):
    return build_model(get_config(arch, smoke=True))


def _inputs(arch, bd):
    """(api, params, prefill batch, decode cache, decode tokens): the
    port's init cast to f32; a (B, S) prompt (the vlm's N_VIS patch
    embeddings and whisper's frames beside it); a cache of bd rows and
    CACHE_SEQ positions of random f32 entries; a (len(DECODE_POS), bd)
    token a step."""
    api = _api(arch)
    params = tree.tree_map(
        lambda t: None if t is None else t.float(),
        api.init_params(torch.Generator().manual_seed(3)))
    gen = torch.Generator().manual_seed(4)
    D = api.cfg.d_model
    batch = {"tokens": torch.randint(0, api.cfg.vocab, (B, S),
                                     generator=gen, dtype=torch.int32)}
    if api.cfg.family == "vlm":
        batch["vis_embeds"] = torch.randn(B, N_VIS, D, generator=gen)
    if api.cfg.family == "encdec":
        batch["frames"] = torch.randn(B, api.cfg.enc_seq, D, generator=gen)
    cache = tree.tree_map(
        lambda t: torch.randn(t.shape, generator=gen),
        api.init_cache(bd, CACHE_SEQ, "cpu"))
    toks = torch.randint(0, api.cfg.vocab, (len(DECODE_POS), bd),
                         generator=gen, dtype=torch.int32)
    return api, params, batch, cache, toks


def _write_inputs(path):
    out = {}
    for run, arch, _, bd in RUNS:
        _, params, batch, cache, toks = _inputs(arch, bd)
        for key, t in (("params", params), ("cache", cache)):
            for p, x in tree.flatten_with_paths(t):
                out[f"{run}/{key}/{p}"] = x.numpy()
        for k, v in batch.items():
            out[f"{run}/batch/{k}"] = v.numpy()
        out[f"{run}/toks"] = toks.numpy()
    np.savez(path, **out)


def _client(mesh_shape):
    return 4 if mesh_shape == (2, 2, 2) else 2


class _Stub:
    """The mesh's axis names and sizes, all `sharding` reads."""

    def __init__(self, mesh_shape):
        self.shape = dict(zip(AXES, mesh_shape))
        self.axis_names = AXES
        self.coords = dict.fromkeys(AXES, 0)


def _shardings(mesh, api, params, cache, bd, tp_only):
    """(params, prefill batch, cache, token) shardings, as the dry run
    gives them."""
    psh = shd.tree_param_shardings(params, mesh, tp_only=tp_only)
    client = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bsh = {"tokens": shd.NamedSharding(mesh, shd.P(client, None)),
           "vis_embeds": shd.NamedSharding(mesh, shd.P(client, None, None)),
           "frames": shd.NamedSharding(mesh, shd.P(client, None, None))}
    csh = shd.cache_shardings(cache, mesh, bd)
    csize = _client(tuple(mesh.shape.values()))
    tsh = shd.NamedSharding(mesh, shd.P(client) if bd % csize == 0
                            else shd.P())
    return psh, bsh, csh, tsh


# ---------------------------------------------------------------------------
# The reference: the prefill closure and the serve step, GSPMD-jitted
# ---------------------------------------------------------------------------

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import sharding as shd
from repro.launch import steps
from repro.models import build_model

inp, out_path = sys.argv[1], sys.argv[2]
a = dict(np.load(inp))
NONE = lambda x: x is None
res = {}

def fill(prefix, shapes):
    flat, tdef = jax.tree_util.tree_flatten_with_path(shapes, is_leaf=NONE)
    return jax.tree_util.tree_unflatten(tdef, [
        None if x is None else jnp.asarray(a[prefix + shd._path_str(p)])
        for p, x in flat])

for run, arch, mesh_shape, bd in RUNS:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(
        mesh_shape), ("pod", "data", "model"))
    api = build_model(get_config(arch, smoke=True))
    params = fill(f"{run}/params/", jax.eval_shape(api.init_params,
                                                   jax.random.PRNGKey(0)))
    cache0 = fill(f"{run}/cache/", jax.eval_shape(
        lambda: api.init_cache(bd, CACHE_SEQ)))
    names = sorted(k.split("/")[2] for k in a if k.startswith(
        f"{run}/batch/"))
    batch = {k: jnp.asarray(a[f"{run}/batch/{k}"]) for k in names}
    client = ("pod", "data")
    csize = int(np.prod([mesh.shape[x] for x in client]))
    for tp in (False, True):
        tag = f"{run}/{'tp_only' if tp else 'fsdp_tp'}"
        psh = shd.tree_param_shardings(params, mesh, tp_only=tp)
        bsh = {k: NamedSharding(mesh, P(client, *[None] * (v.ndim - 1)))
               for k, v in batch.items()}
        prefill = jax.jit(lambda p, b: api.forward(p, b)[0][:, -1],
                          in_shardings=(psh, bsh))
        res[f"{tag}/prefill"] = np.asarray(prefill(params, batch))
        csh = shd.cache_shardings(cache0, mesh, bd)
        tsh = NamedSharding(mesh, P(client) if bd % csize == 0 else P())
        fn = jax.jit(steps.make_serve_step(api),
                     in_shardings=(psh, csh, tsh, shd.replicated(mesh)))
        cache = cache0
        for i, pos in enumerate(DECODE_POS):
            logits, cache = fn(params, cache, jnp.asarray(a[f"{run}/toks"][i]),
                               jnp.asarray(pos, jnp.int32))
            res[f"{tag}/decode{i}"] = np.asarray(logits)
        for p, x in jax.tree_util.tree_flatten_with_path(cache)[0]:
            res[f"{tag}/cache/{shd._path_str(p)}"] = np.asarray(x)
np.savez(out_path, **res)
'''


def _start_reference(inp, out, runs):
    """The reference over `runs` in a subprocess writing `out`.  Its
    programs are small and compiling them is most of its time: LLVM
    compiles them at -O0 (floating-point semantics are the same at every
    level; XLA's CPU backend does not enable fast math)."""
    script = REFERENCE.replace("RUNS", repr(runs)).replace(
        "CACHE_SEQ", repr(CACHE_SEQ)).replace("DECODE_POS", repr(DECODE_POS))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0")
    return subprocess.Popen([sys.executable, "-c", script, str(inp),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# The port: one process a rank
# ---------------------------------------------------------------------------


def _index(sh, t):
    return np.array([[s.start, s.stop] for s in sh.index(tuple(t.shape))],
                    np.int64)


def _rank_main(rank, world, store, out_dir):
    """One rank: every run's inputs drawn as `_inputs` draws them (the
    reference reads the same arrays), the partitioned steps on its
    blocks; writes its arrays and its recorded collectives."""
    import torch.distributed as dist
    from repro_torch.analysis import comm_model
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    torch.set_num_threads(1)
    meshlib.init("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world, timeout=timedelta(seconds=120))
    try:
        meshes = {s: meshlib.Mesh(s, AXES) for s in ((2, 2, 2), (1, 2, 4))}
        out, calls = {}, {}
        for run, arch, mesh_shape, bd in RUNS:
            mesh = meshes[mesh_shape]
            api, params, batch, cache, toks = _inputs(arch, bd)
            for tp in (False, True):
                tag = f"{run}/{SHARDINGS[tp]}"
                psh, bsh, csh, tsh = _shardings(mesh, api, params, cache, bd,
                                                tp)
                plan = partition.ServePlan(mesh, params, psh, csh)
                local = tree.tree_map(
                    lambda x, s: None if x is None else s.local(x).clone(),
                    params, psh)
                lb = {k: bsh[k].local(v) for k, v in batch.items()}
                with comm_model.record_collectives(mesh, check=True) as sites:
                    got = steps.make_prefill_step(api, None, mesh, plan)(
                        local, lb)
                calls[f"{tag}/prefill"] = dryrun.collective_operands(sites)
                out[f"{tag}/prefill"] = got.numpy()
                out[f"{tag}/prefill/index"] = _index(
                    bsh["tokens"], batch["tokens"])[:1]
                lc = tree.tree_map(lambda x, s: s.local(x).clone(), cache,
                                   csh)
                fn = steps.make_serve_step(api, mesh, plan)
                for i, pos in enumerate(DECODE_POS):
                    with comm_model.record_collectives(
                            mesh, check=True) as sites:
                        logits, _ = fn(local, lc, tsh.local(toks[i]),
                                       torch.tensor(pos))
                    if i == 0:
                        calls[f"{tag}/decode"] = dryrun.collective_operands(
                            sites)
                    out[f"{tag}/decode{i}"] = logits.numpy()
                out[f"{tag}/decode/index"] = _index(tsh, toks[0])
                for (p, x), s, g in zip(tree.flatten_with_paths(lc),
                                        tree.leaves(csh),
                                        tree.leaves(cache)):
                    out[f"{tag}/cache/{p}"] = x.numpy()
                    out[f"{tag}/cache/{p}/index"] = _index(s, g)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"calls{rank}.json").write_text(json.dumps(calls))
    finally:
        dist.destroy_process_group()


def _plain():
    """The port's mesh=None prefill and decode of every run: {name:
    array}; one thread, as each rank runs (a CPU product's blocking, so
    its last bits, follows the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _plain_runs()
    finally:
        torch.set_num_threads(threads)


def _plain_runs():
    out = {}
    for run, arch, _, bd in RUNS:
        api, params, batch, cache, toks = _inputs(arch, bd)
        out[f"{run}/prefill"] = steps.make_prefill_step(api)(
            params, batch).numpy()
        fn = steps.make_serve_step(api)
        for i, pos in enumerate(DECODE_POS):
            logits, _ = fn(params, cache, toks[i], pos)
            out[f"{run}/decode{i}"] = logits.numpy()
        for p, x in tree.flatten_with_paths(cache):
            out[f"{run}/cache/{p}"] = x.numpy()
    return out


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
def serve_run():
    """({rank: the port's arrays}, {rank: its recorded collectives}, the
    reference's arrays, the port's mesh=None arrays), from the reference's
    two processes and one spawn; the mesh=None steps run here meanwhile."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        inp = tmp / "inputs.npz"
        _write_inputs(inp)
        # the reference in two processes side by side with the ranks
        halves = (RUNS[:4], RUNS[4:])
        refs = [_start_reference(inp, tmp / f"ref{i}.npz", runs)
                for i, runs in enumerate(halves)]
        try:
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_rank_main, args=(
                r, 8, str(tmp / "store"), str(tmp)))
                for r in range(8)]
            for p in procs:
                p.start()
            plain = _plain()
            _join(procs)
            for ref in refs:
                _, err = ref.communicate(timeout=RANK_TIMEOUT)
                assert ref.returncode == 0, err[-4000:]
        finally:
            for ref in refs:
                if ref.poll() is None:
                    ref.kill()
                    ref.wait(10)
        port = {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)}
        calls = {r: json.loads((tmp / f"calls{r}.json").read_text())
                 for r in range(8)}
        want = {k: v for i in range(len(halves))
                for k, v in np.load(tmp / f"ref{i}.npz").items()}
    return port, calls, want, plain


# ---------------------------------------------------------------------------
# The comparisons
# ---------------------------------------------------------------------------


def _block(a, idx):
    return a[tuple(slice(x, y) for x, y in idx)]


def _held(port, want, run, tag, atol, what):
    """Every rank's prefill and decode logits and final cache blocks of
    `run` against `want`'s global arrays (keyed by `run` + the rest, or
    `tag` + the rest) sliced to the rank's block."""
    for r in range(8):
        got = port[r]
        rows = got[f"{tag}/prefill/index"][0]
        steps_ = [("prefill", rows)] + [
            (f"decode{i}", got[f"{tag}/decode/index"][0])
            for i in range(len(DECODE_POS))]
        for name, (lo, hi) in steps_:
            np.testing.assert_allclose(
                got[f"{tag}/{name}"], want[f"{run}/{name}"][lo:hi], rtol=0,
                atol=atol, err_msg=f"{what} {tag} {name} rank {r}")
        caches = [k for k in got if k.startswith(f"{tag}/cache/")
                  and not k.endswith("/index")]
        assert caches
        for k in caches:
            path = k[len(f"{tag}/cache/"):]
            np.testing.assert_allclose(
                got[k], _block(want[f"{run}/cache/{path}"], got[k + "/index"]),
                rtol=0, atol=atol, err_msg=f"{what} {k} rank {r}")


@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_each_rank_equals_the_reference(serve_run, run, sharding):
    """Each rank's rows of the prefill's and of 3 decode steps' logits,
    and its blocks of the caches after them, against the reference's
    GSPMD-jitted outputs sliced to the rank's block."""
    port, _, want, _ = serve_run
    tag = f"{run}/{sharding}"
    _held(port, {k.replace(tag, run, 1): v for k, v in want.items()
                 if k.startswith(tag + "/")}, run, tag, REF_ATOL,
          "reference")


@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_each_rank_equals_the_plain_steps(serve_run, run, sharding):
    """The same blocks against the port's own mesh=None prefill and
    decode from the same inputs: the prefill bit for bit, the decode
    within SELF_ATOL."""
    port, _, _, plain = serve_run
    tag = f"{run}/{sharding}"
    _held(port, plain, run, tag, SELF_ATOL, "mesh=None")
    for r in range(8):
        lo, hi = port[r][f"{tag}/prefill/index"][0]
        assert np.array_equal(port[r][f"{tag}/prefill"],
                              plain[f"{run}/prefill"][lo:hi]), (tag, r)


def _cache_split(run):
    """How RUNS' caches split on "model": (heads, position axes)."""
    _, arch, mesh_shape, bd = next(r for r in RUNS if r[0] == run)
    api = _api(arch)
    cache = api.init_cache(bd, CACHE_SEQ, "meta")
    spec = tree.leaves(shd.cache_shardings(cache, _Stub(mesh_shape),
                                           bd))[0].spec
    return spec


def test_runs_cover_the_three_cache_splits():
    """Heads on "model" (n_kv divides d_model), positions on "model"
    (it does not), positions on every axis (batch 1)."""
    client = ("pod", "data")
    assert _cache_split("internlm2") == shd.P(None, client, None, "model",
                                              None)
    assert _cache_split("internlm2_seq") == shd.P(None, client, "model",
                                                  None, None)
    assert _cache_split("gemma3") == shd.P(None, None,
                                           client + ("model",), None, None)
    assert _cache_split("whisper")[3] == "model"


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_recorded_collectives_equal_serve_sites(serve_run, run):
    """Every collective of one prefill and one decode step on every rank,
    by kind, axes, type and operand size, as `chip_smoke.serve_sites`
    gives them from the shapes; under tp_only none crosses "data"."""
    _, calls, _, _ = serve_run
    cs = _chip_smoke()
    _, arch, mesh_shape, bd = next(r for r in RUNS if r[0] == run)
    api, params, batch, cache, _ = _inputs(arch, bd)
    stub = _Stub(mesh_shape)
    csize = _client(mesh_shape)
    seq = S + (N_VIS if "vis_embeds" in batch else 0)
    for tp in (False, True):
        psh, _, csh, _ = _shardings(stub, api, params, cache, bd, tp)
        want = {"prefill": cs.serve_sites(params, psh, stub.shape, api.cfg,
                                          B // csize, seq, act="float32"),
                "decode": cs.serve_sites(
                    params, psh, stub.shape, api.cfg,
                    bd // csize if bd % csize == 0 else bd, 1, cache, csh,
                    act="float32")}
        for kind, sites in want.items():
            assert sites
            for r in range(8):
                got = calls[r][f"{run}/{SHARDINGS[tp]}/{kind}"]
                assert got == sites, (run, tp, kind, r)
                if tp:
                    assert not [k for k in got if k.split()[1] == "data"], (
                        run, kind, got)


def _world_of_one(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    meshlib.init("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                 rank=0, world_size=1, timeout=timedelta(seconds=60))
    return meshlib.make_debug_pod_mesh()


def test_world_of_one_equals_the_plain_steps(tmp_path):
    """On a (1, 1, 1) mesh (the positions "split" over one model rank)
    internlm2's and whisper's partitioned prefill, at their init's bf16
    weights, is the `mesh=None` prefill bit for bit (one thread), and 3
    decode steps are within SELF_ATOL of it, caches too."""
    import torch.distributed as dist
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = _world_of_one(tmp_path)
    try:
        for arch in ("internlm2-1.8b", "whisper-medium"):
            api = _api(arch)
            params = api.init_params(torch.Generator().manual_seed(3))
            _, _, batch, cache, toks = _inputs(arch, B)
            batch = {k: v if k == "tokens" else v.to(torch.bfloat16)
                     for k, v in batch.items()}
            psh = shd.tree_param_shardings(params, mesh)
            csh = shd.cache_shardings(cache, mesh, B)
            assert tree.leaves(csh)[0].spec[2] == "model"
            plan = partition.ServePlan(mesh, params, psh, csh)
            a = steps.make_prefill_step(api)(params, batch)
            b = steps.make_prefill_step(api, None, mesh, plan)(params, batch)
            assert torch.equal(a, b), arch
            ca = tree.tree_map(lambda t: t.to(torch.bfloat16), cache)
            cb = tree.tree_map(lambda t: t.clone(), ca)
            fa = steps.make_serve_step(api)
            fb = steps.make_serve_step(api, mesh, plan)
            for i, pos in enumerate(DECODE_POS):
                la, _ = fa(params, ca, toks[i], pos)
                lb, _ = fb(params, cb, toks[i], torch.tensor(pos))
                torch.testing.assert_close(lb, la, rtol=0, atol=SELF_ATOL)
            for x, y in zip(tree.leaves(ca), tree.leaves(cb)):
                assert torch.equal(x, y), arch
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_refusals():
    """What the partitioned serving refuses: the moe, ssm and hybrid
    families on a mesh (`check_serve`, before a mesh is read), a mesh
    without a plan, a projection split outside the (K on "data", N on
    "model") scheme and a cache whose heads split over "data", each
    naming its leaf."""
    for arch in ("deepseek-v2-lite-16b", "mamba2-370m", "recurrentgemma-9b"):
        for make in (steps.make_serve_step, steps.make_prefill_step):
            with pytest.raises(NotImplementedError, match="partitioned "
                               "prefill and decode run the families"):
                make(_api(arch), mesh=object(), plan=object())
    api = _api("internlm2-1.8b")
    with pytest.raises(ValueError):
        steps.make_serve_step(api, mesh=object())
    params = api.init_params(torch.Generator())
    stub = _Stub((2, 2, 2))
    psh = shd.tree_param_shardings(params, stub)
    flat, tdef = tree.flatten(psh)
    paths = [p for p, _ in tree.flatten_with_paths(psh)]
    bad = [shd.NamedSharding(stub, shd.P(None, "model", None))
           if p == "layers/attn/w_q" else s for p, s in zip(paths, flat)]
    with pytest.raises(NotImplementedError, match="layers/attn/w_q"):
        partition.ServePlan(stub, params, tree.unflatten(tdef, bad))
    cache = api.init_cache(B, CACHE_SEQ, "meta")
    csh = tree.tree_map(lambda t: shd.NamedSharding(
        stub, shd.P(None, None, None, "data", None)), cache)
    with pytest.raises(NotImplementedError, match="dense/k"):
        partition.ServePlan(stub, params, psh, csh)
