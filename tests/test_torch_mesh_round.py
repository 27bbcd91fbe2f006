"""The port's mesh round step (`steps.make_round_step(api, cfg, mesh,
state_sh)` over `torch.distributed`), its mask means over a mesh
(`aggregation.mask_mean_psum` / `mask_mean_packed`) and the mesh form of
`elastic.reshard_server`, held rank by rank against the JAX package's
jitted `shard_map` round on a forced 8-device (2, 2, 2) CPU mesh.

One reference subprocess runs every variant and writes each device's
shards keyed by its mesh coordinates, with each shard's block index; one
spawn of 8 gloo ranks runs the port's counterparts, each rank on its own
block.  The comparisons are per rank against that device's shard, never
against a global array: the reference's shards of a leaf replicated over
an axis differ (each "data" shard draws its own masks), and so does its
per-device `bpp`.  The ranks also record every collective they issue
(and check that none went past the recorder), so the wire's payload is
checked: one int32 all-gather of ceil(n_local/32) words a cohort per
leaf for the packed round, a bf16 all-reduce of n_local values per leaf
for the unpacked one.  A world-size-1 mesh gives
the `mesh=None` round bit for bit.

Theta is held exactly, as its level (the reset scores are logit(theta),
one to one); the scores themselves and bpp pass through logs, which
XLA's CPU code and libm round differently in the last bits, so they are
held within LOG_TOL.  The unpacked baseline's theta is a bf16 mean: its
tolerance is one bf16 rounding of a mean in [0, 1], half an ulp below 1,
2**-9.  (At C = 4 on two pods every mean is a multiple of 1/4 and that
path is exact too.)
"""
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

from repro_torch.core import tree
from repro_torch.launch import sharding as shd
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESH, AXES = (2, 2, 2), ("pod", "data", "model")
C, STEP, SEED = 4, 3, 17
PART = [1.0, 0.0, 1.0, 1.0]
DOWNLINK_LEAF = 1 << 20
MASK_ROWS, MASK_N = 2, 1000          # the mask means: (8 R, n) global
BF16_MEAN_TOL = 2.0 ** -9
# logit and the eq. 13 entropy take logs, and XLA's CPU log and libm's
# differ in the last bits: a few f32 ulps of log(theta) - log1p(-theta)
LOG_TOL = 2.0 ** -20
VARIANTS = {
    "packed": ({}, False), "packed_part": ({}, True),
    "unpacked": ({"packed_masks": False}, False),
    "unpacked_part": ({"packed_masks": False}, True),
    "downlink8": ({"downlink_bits": 8}, False),
    "threshold": ({"mask_mode": "threshold"}, False),
}
PACKED = ("packed", "packed_part", "downlink8", "threshold")
RANK_TIMEOUT = 240                   # seconds each join may wait
# (leaf path, global shape, dtype): a stacked leaf that splits over both
# axes, one whose 33 rows do not split over "data", an embed table, a
# None leaf (it keeps its leaf index), and two float leaves
SCORES = (("embed/table", (C, 64, 32)), ("layers/bias", None),
          ("layers/w", (C, 2, 32, 64)), ("layers/w_odd", (C, 3, 33, 70)))
FLOATS = (("final_norm/scale", (C, 16), "bfloat16"),
          ("layers/norm", (C, 2, 16), "float32"))


def _nest(items):
    out = {}
    for path, v in items:
        a, b = path.split("/")
        out.setdefault(a, {})[b] = v
    return out


def _inputs(path):
    rng = np.random.default_rng(2026)
    arrs = {}
    for p, shape in SCORES:
        if shape is not None:
            arrs["scores/" + p] = (1.5 * rng.standard_normal(shape)).astype(
                np.float32)
            arrs["weights/" + p] = rng.standard_normal(shape[1:]).astype(
                np.float32)
    for p, shape, _ in FLOATS:
        arrs["floats/" + p] = rng.standard_normal(shape).astype(np.float32)
    arrs["mask"] = (rng.random((8 * MASK_ROWS, MASK_N)) < 0.4).astype(
        np.uint8)
    np.savez(path, **arrs)
    return arrs


def _torch_state(arrs):
    """The global state on the CPU, as the port holds it."""
    def f(key, p, dtype="float32"):
        return torch.from_numpy(arrs[f"{key}/{p}"].copy()).to(
            getattr(torch, dtype))
    scores = _nest((p, None if s is None else f("scores", p))
                   for p, s in SCORES)
    return {"scores": scores,
            "floats": _nest((p, f("floats", p, dt)) for p, _, dt in FLOATS),
            "weights": _nest((p, None if s is None else f("weights", p))
                             for p, s in SCORES),
            "opt_m": tree.tree_map(
                lambda x: None if x is None else torch.zeros_like(x), scores),
            "step": STEP}


# ---------------------------------------------------------------------------
# The reference: every variant under jax.jit on 8 forced CPU devices
# ---------------------------------------------------------------------------

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import aggregation
from repro.launch import steps
from repro.launch import sharding as shd

inp, out_path = sys.argv[1], sys.argv[2]
SCORES, FLOATS, VARIANTS, PART, STEP = eval(sys.argv[3])
a = dict(np.load(inp))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
grid = np.asarray(mesh.devices)

def nest(items):
    out = {}
    for path, v in items:
        x, y = path.split("/")
        out.setdefault(x, {})[y] = v
    return out

def rank(d):
    return int(np.ravel_multi_index(
        tuple(int(i) for i in np.argwhere(grid == d)[0]), grid.shape))

scores = nest((p, None if s is None else jnp.asarray(a["scores/" + p]))
              for p, s in SCORES)
state = {"scores": scores,
         "floats": nest((p, jnp.asarray(a["floats/" + p], dt))
                        for p, _, dt in FLOATS),
         "weights": nest((p, None if s is None else
                          jnp.asarray(a["weights/" + p])) for p, s in SCORES),
         "opt_m": jax.tree_util.tree_map(
             lambda x: None if x is None else jnp.zeros_like(x), scores,
             is_leaf=lambda x: x is None),
         "step": jnp.asarray(STEP, jnp.int32)}
sh = steps.fed_state_shardings(state, mesh)
res = {}

def shards(prefix, tree_):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: x is None)
    for path, x in flat:
        if x is None:
            continue
        name = prefix + "/" + shd._path_str(path)
        for s in x.addressable_shards:
            r = rank(s.device)
            v = np.asarray(s.data)
            if v.dtype == jnp.bfloat16:
                v = v.astype(np.float32)
            res[f"{name}/{r}"] = v
            res[f"{name}/{r}/index"] = np.array(
                [[sl.start or 0, sl.stop if sl.stop is not None else n]
                 for sl, n in zip(s.index, x.shape)], np.int64)

placed = jax.device_put(state, sh)
for key in ("scores", "floats", "weights", "opt_m"):
    shards("placed/" + key, placed[key])
for name, (kw, part) in VARIANTS.items():
    cfg = steps.StepConfig(seed=17, **kw)
    fn = jax.jit(steps.make_round_step(None, cfg, mesh=mesh, state_sh=sh))
    st = jax.device_put(state, sh)
    new, m = fn(st, jnp.asarray(PART, jnp.float32)) if part else fn(st)
    for key in ("scores", "floats", "opt_m"):
        shards(name + "/" + key, new[key])
    for s in m["bpp"].addressable_shards:
        res[f"{name}/metric/bpp/{rank(s.device)}"] = np.asarray(s.data)
    for k in ("bpp_measured", "bits_measured", "downlink_bits",
              "downlink_bpp"):
        res[f"{name}/metric/{k}"] = np.asarray(m[k])

AX = ("pod", "data", "model")
mm = jax.jit(steps._shard_map(
    lambda m: (aggregation.mask_mean_psum(m, ("pod", "data")),
               aggregation.mask_mean_packed(m, ("pod", "data"))),
    mesh=mesh, in_specs=P(AX, None), out_specs=(P(AX, None), P(AX, None))))
gm = jax.device_put(jnp.asarray(a["mask"]), NamedSharding(mesh, P(AX, None)))
for tag, x in zip(("psum", "packed"), mm(gm)):
    for s in x.addressable_shards:
        res[f"maskmean/{tag}/{rank(s.device)}"] = np.asarray(s.data)
np.savez(out_path, **res)

# the static comm model and the purity findings of internlm2-1.8b's SMOKE
# round, packed and unpacked.  jax 0.9.0 moved ClosedJaxpr / Jaxpr out of
# jax.core into jax.extend.core; the reference's jaxpr engines read them
# through the alias `jcore`, so it is pointed there in this process
import json
import jax.extend.core
from repro.analysis import collective_lint, comm_model, jaxpr_lint
jaxpr_lint.jcore = jax.extend.core
comm = {}
for packed in (True, False):
    m = comm_model.arch_round_comm_model("internlm2-1.8b", packed=packed)
    jxp, shapes, sh_, _, mesh_ = m.pop("_trace")
    comm[str(packed)] = {"model": m, "purity": [
        str(f) for f in collective_lint.round_purity_findings(
            jxp, shapes, sh_, mesh_)]}
with open(out_path + ".comm.json", "w") as f:
    json.dump(comm, f)
'''


def _start_reference(inp, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    spec = repr((SCORES, FLOATS, VARIANTS, PART, STEP))
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(inp),
                             str(out), spec], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _uniforms(local_bodies):
    """The reference's downlink uniforms: every shard draws its leaf's
    local shape with the same key (`quantize_theta` under shard_map)."""
    import jax
    from repro.core import masking as jmasking
    key = jax.random.PRNGKey(jmasking.mask_stream_seed(
        STEP, 0, DOWNLINK_LEAF, 0, run_seed=SEED))
    keys = jax.random.split(key, len(local_bodies))
    return [np.asarray(jax.random.uniform(k, b))
            for k, b in zip(keys, local_bodies)]


# ---------------------------------------------------------------------------
# The port: one process a rank
# ---------------------------------------------------------------------------


def _calls(sites):
    """A rank's recorded collectives as [prim, dtype, elements sent, group
    size] rows."""
    return [[s.prim, s.dtype, s.elems,
             math.prod(dict(zip(AXES, MESH))[a] for a in s.axes)]
            for s in sites]


def _clone(t):
    return tree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, t)


def _save_tree(out, prefix, local, shardings, host):
    for (p, x), sh, g in zip(tree.flatten_with_paths(local),
                             tree.leaves(shardings), tree.leaves(host)):
        if x is None:
            continue
        out[f"{prefix}/{p}"] = x.float().numpy()
        out[f"{prefix}/{p}/index"] = np.array(
            [[s.start, s.stop] for s in sh.index(tuple(g.shape))], np.int64)


def _rank_main(rank, world, store, inp, out_dir):
    import torch.distributed as dist
    from repro_torch.analysis import collective_lint, comm_model, shard_lint
    from repro_torch.core import aggregation
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import mesh_round, steps
    from repro_torch.runtime import elastic
    torch.set_num_threads(1)
    # pieces of 1000 columns: the reset, the downlink and the unpacked
    # sampler cross piece edges inside every leaf
    steps.UPDATE_PIECE = 1000
    meshlib.init("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = meshlib.make_debug_pod_mesh()
        arrs = dict(np.load(inp))
        host = _torch_state(arrs)
        sh = steps.fed_state_shardings(host, mesh)
        out, calls = {}, {}
        placed = elastic.reshard_server(_clone(host), sh)
        for key in ("scores", "floats", "weights", "opt_m"):
            _save_tree(out, "placed/" + key, placed[key], sh[key], host[key])
        u = [torch.from_numpy(arrs[f"u/{j}"]) for j in range(
            sum(1 for _, s in SCORES if s is not None))]
        for name, (kw, part) in VARIANTS.items():
            cfg = steps.StepConfig(seed=SEED, **kw)
            st = elastic.reshard_server(_clone(host), sh)
            with comm_model.record_collectives(mesh, check=True) as sites:
                st, m = steps.make_round_step(
                    None, cfg, mesh=mesh, state_sh=sh)(
                    st, PART if part else None,
                    downlink_u=u if cfg.downlink_bits else None)
            calls[name] = _calls(sites)
            for key in ("scores", "floats", "opt_m"):
                _save_tree(out, f"{name}/{key}", st[key], sh[key], host[key])
            for k, v in m.items():
                out[f"{name}/metric/{k}"] = v.numpy()
        msh = shd.NamedSharding(mesh, shd.P(("pod", "data", "model"), None))
        mask = {"m": msh.local(torch.from_numpy(arrs["mask"])), "none": None}
        clients = mesh.group(("pod", "data"))
        with comm_model.record_collectives(mesh, check=True) as sites:
            out["maskmean/psum"] = aggregation.mask_mean_psum(
                mask, clients)["m"].numpy()
        calls["psum"] = _calls(sites)
        with comm_model.record_collectives(mesh, check=True) as sites:
            for use_kernel in (False, True):
                got = aggregation.mask_mean_packed(mask, clients, use_kernel)
                assert got["none"] is None
                out[f"maskmean/packed/{use_kernel}"] = got["m"].numpy()
        calls["packed_mean"] = _calls(sites)
        # declared vs held: the placed state is each rank's block, and a
        # block cut wrong (rolled contents, a short last dim) is caught
        calls["shard/placed"] = [
            str(f) for k in ("scores", "floats", "weights", "opt_m")
            for f in shard_lint.placement_mismatches(
                placed[k], sh[k], host[k], label=f"{k}/")]
        placed["scores"]["layers"]["w"] = \
            placed["scores"]["layers"]["w"].roll(1, -1)
        placed["weights"]["layers"]["w"] = \
            placed["weights"]["layers"]["w"][..., :-1]
        calls["shard/cut"] = [
            str(f) for k in ("scores", "weights")
            for f in shard_lint.placement_mismatches(
                placed[k], sh[k], host[k], label=f"{k}/")]
        calls["shard/round"] = [str(f) for f in shard_lint.round_shard_report(
            mesh, 2, start=mesh_round.global_state(
                "internlm2-1.8b", 2, smoke=True))[
                "findings"]]
        # internlm2-1.8b's SMOKE round, packed and unpacked, recorded:
        # the cost model, the purity findings and the metered bits
        for packed in (True, False):
            rep = collective_lint.arch_collective_report(
                "internlm2-1.8b", mesh=mesh, packed=packed)
            calls[f"comm/{packed}"] = {
                "model": rep["model"],
                "purity": [str(f) for f in rep["findings"]],
                "bits_measured": rep["metrics"]["bits_measured"]}
        out["coords"] = np.array([mesh.coords[a] for a in AXES])
        out["dev"] = np.array(mesh.device_index())
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"calls{rank}.json").write_text(json.dumps(calls))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world, store, inp, out_dir):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(store), str(inp), str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


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


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def _local_bodies():
    """Every masked leaf's local body shape on the (2, 2, 2) mesh."""
    from repro_torch.launch import steps

    class Stub:
        shape, axis_names = dict(zip(AXES, MESH)), AXES
        coords = dict.fromkeys(AXES, 0)
    scores = [(p, None if s is None else torch.empty(s, device="meta"))
              for p, s in SCORES]
    sh = steps.fed_state_shardings({"scores": _nest(scores), "floats": {},
                                    "weights": {}, "opt_m": {}}, Stub())
    return [tuple(i.stop - i.start for i in h.index(tuple(x.shape)))[1:]
            for (_, x), h in zip(scores, tree.leaves(sh["scores"]))
            if x is not None]


@pytest.fixture(scope="module")
def mesh_run():
    """({rank: the port's arrays}, {rank: its collective calls and comm
    models}, the reference's arrays, the reference's comm models), from
    one reference run and one spawn."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        inp = tmp / "inputs.npz"
        arrs = _inputs(inp)
        ref = _start_reference(inp, tmp / "ref.npz")
        try:
            for j, u in enumerate(_uniforms(_local_bodies())):
                arrs[f"u/{j}"] = u
            np.savez(inp.with_name("inputs_u.npz"), **arrs)
            procs = _spawn_ranks(8, tmp / "store",
                                 inp.with_name("inputs_u.npz"), tmp)
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
        comm = json.loads((tmp / "ref.npz.comm.json").read_text())
    return port, calls, want, comm


def _leaf_keys(want, prefix):
    return sorted({k.rsplit("/", 2)[0] for k in want
                   if k.startswith(prefix + "/") and k.endswith("/index")})


def test_ranks_sit_on_the_reference_devices(mesh_run):
    port, _, _, _ = mesh_run
    for r in range(8):
        assert tuple(port[r]["coords"]) == tuple(np.unravel_index(r, MESH))
        assert int(port[r]["dev"]) == r


def test_reshard_server_places_device_put_shards(mesh_run):
    port, _, want, _ = mesh_run
    keys = [k for key in ("scores", "floats", "weights", "opt_m")
            for k in _leaf_keys(want, "placed/" + key)]
    assert len(keys) == 11
    for k in keys:
        for r in range(8):
            assert np.array_equal(port[r][f"{k}/index"],
                                  want[f"{k}/{r}/index"]), (k, r)
            assert np.array_equal(port[r][k], want[f"{k}/{r}"]), (k, r)


def _levels(scores, levels):
    """theta's level k (theta = k / levels) from reset scores logit(theta):
    the map is one to one, so equal levels are equal thetas."""
    sig = 1.0 / (1.0 + np.exp(-scores.astype(np.float64)))
    return np.rint(sig * levels).astype(np.int64)


@pytest.mark.parametrize("variant", PACKED)
def test_packed_round_equals_reference_shard_by_shard(mesh_run, variant):
    """Every rank against its device's shard: the block index, theta
    exactly (its level: k/4 from the words of 4 cohorts, k/255 after the
    8-bit downlink), the floats and the zeroed moments bit for bit, the
    scores logit(theta) and bpp within LOG_TOL, and the bit totals
    exactly."""
    port, _, want, _ = mesh_run
    keys = [k for key in ("scores", "floats", "opt_m")
            for k in _leaf_keys(want, f"{variant}/{key}")]
    assert len(keys) == 8
    levels = 255 if variant == "downlink8" else C
    for k in keys:
        for r in range(8):
            got, ref = port[r][k], want[f"{k}/{r}"]
            assert np.array_equal(port[r][f"{k}/index"],
                                  want[f"{k}/{r}/index"]), (k, r)
            if "/scores/" in k:
                assert np.array_equal(_levels(got, levels),
                                      _levels(ref, levels)), (k, r)
                np.testing.assert_allclose(got, ref, rtol=LOG_TOL,
                                           atol=LOG_TOL)
            else:
                assert np.array_equal(got, ref), (k, r)
    _metrics_match(port, want, variant)


def _metrics_match(port, want, variant):
    for r in range(8):
        got = port[r]
        np.testing.assert_allclose(got[f"{variant}/metric/bpp"], want[
            f"{variant}/metric/bpp/{r}"], rtol=LOG_TOL, atol=0)
        for k in ("bpp_measured", "bits_measured", "downlink_bits",
                  "downlink_bpp"):
            assert got[f"{variant}/metric/{k}"] == want[
                f"{variant}/metric/{k}"], (k, r)


def test_replicated_blocks_diverge_as_in_the_reference(mesh_run):
    """w_odd's 33 rows do not split over "data": ranks (p, 0, m) and
    (p, 1, m) hold the same block, yet each drew its own masks, in the
    port as in the reference; bpp is each rank's own."""
    port, _, want, _ = mesh_run
    k = "packed/scores/layers/w_odd"
    a, b = port[0][k], port[2][k]           # coords (0,0,0) and (0,1,0)
    assert np.array_equal(port[0][f"{k}/index"], port[2][f"{k}/index"])
    assert not np.array_equal(a, b)
    assert not np.array_equal(want[f"{k}/0"], want[f"{k}/2"])
    bpps = {float(port[r]["packed/metric/bpp"]) for r in range(8)}
    assert len(bpps) > 1


@pytest.mark.parametrize("variant", ("unpacked", "unpacked_part"))
def test_unpacked_round_within_one_bf16_rounding(mesh_run, variant):
    port, _, want, _ = mesh_run
    sig = lambda s: 1.0 / (1.0 + np.exp(-s.astype(np.float64)))
    for k in _leaf_keys(want, f"{variant}/scores"):
        for r in range(8):
            got, ref = sig(port[r][k]), sig(want[f"{k}/{r}"])
            assert np.abs(got - ref).max() <= BF16_MEAN_TOL, (k, r)
    for key in ("floats", "opt_m"):
        for k in _leaf_keys(want, f"{variant}/{key}"):
            for r in range(8):
                assert np.array_equal(port[r][k], want[f"{k}/{r}"]), (k, r)
    _metrics_match(port, want, variant)


def test_mask_means_match_reference(mesh_run):
    port, _, want, _ = mesh_run
    for r in range(8):
        ref_psum = want[f"maskmean/psum/{r}"]
        ref_packed = want[f"maskmean/packed/{r}"]
        assert np.array_equal(port[r]["maskmean/psum"], ref_psum)
        for use_kernel in (False, True):
            assert np.array_equal(port[r][f"maskmean/packed/{use_kernel}"],
                                  ref_packed)
        # over ("pod", "data"): the 4 ranks of a model index agree
        assert np.array_equal(ref_psum, want[f"maskmean/psum/{r % 2}"])


def _mask_sizes():
    """(local elements a cohort, cohorts a rank) of each masked leaf."""
    return [math.prod(b) for b in _local_bodies()], C // MESH[0]


@pytest.mark.parametrize("variant", PACKED)
def test_packed_wire_is_one_bit_a_parameter(mesh_run, variant):
    """The packed round's only mask-sized collective is one int32
    all-gather over the pod pair a leaf, of ceil(n_local/32) words a
    cohort; every all-reduce is f32 (floats and the bit total)."""
    _, calls, _, _ = mesh_run
    n_local, cl = _mask_sizes()
    for r in range(8):
        got = calls[r][variant]
        gathers = [c for c in got if c[0] == "all_gather"]
        assert gathers == [["all_gather", "int32", cl * -(-n // 32), 2]
                           for n in n_local]
        for c in got:
            if c[0] != "all_gather":
                assert c[:2] == ["psum", "float32"] and c[2] not in n_local
        assert sum(c[2] * 32 for c in gathers) == sum(
            cl * 32 * -(-n // 32) for n in n_local)


def test_unpacked_wire_is_sixteen_bits_a_parameter(mesh_run):
    _, calls, _, _ = mesh_run
    n_local, _ = _mask_sizes()
    for r in range(8):
        got = calls[r]["unpacked"]
        assert not [c for c in got if c[0] == "all_gather"]
        masks = [c for c in got if c[2] in n_local]
        assert masks == [["psum", "bfloat16", n, 2] for n in n_local]
        psum = calls[r]["psum"]
        assert psum == [["psum", "bfloat16", MASK_ROWS * MASK_N, 4]]
        packed = calls[r]["packed_mean"]
        assert packed == [["all_gather", "int32",
                           -(-MASK_ROWS * MASK_N // 32), 4]] * 2


# the one place a dtype is mapped: the port's packed words are int32
# tensors holding uint32 bits, the reference's uint32
def _as_reference(model):
    rows = [dict(r, dtype="uint32") if r["role"] == "uplink"
            and r["dtype"] == "int32" else r for r in model["sites"]]
    return dict(model, sites=rows)


def _site_multiset(model):
    return sorted(json.dumps(r, sort_keys=True) for r in model["sites"])


@pytest.mark.parametrize("packed", (True, False))
def test_comm_model_equals_reference(mesh_run, packed):
    """internlm2-1.8b's SMOKE round on the (2, 2, 2) mesh: every rank's
    recorded sites (as a multiset) and whole `round_comm_model` dict equal
    the reference's, read off its jaxpr: 13 sites (7 word all-gathers or
    bf16 mask psums over "pod", 5 float-sidecar psums, 1 scalar bit
    total), bpp_wire 1.0 / 16.0."""
    _, calls, _, comm = mesh_run
    want = comm[str(packed)]["model"]
    assert want["n_sites"] == 13
    assert want["bpp_wire"] == (1.0 if packed else 16.0)
    assert want["uplink_bits"] == (147456 if packed else 2359296)
    for r in range(8):
        got = _as_reference(calls[r][f"comm/{packed}"]["model"])
        assert _site_multiset(got) == _site_multiset(want), r
        assert {k: v for k, v in got.items() if k != "sites"} == {
            k: v for k, v in want.items() if k != "sites"}, r


def test_uplink_bits_equal_the_metered_bits(mesh_run):
    """The packed round's uplink accounting bits equal the bits the round
    meters under the bitpack codec (every leaf's per-shard size is a
    multiple of 32 here, so no word padding separates them)."""
    _, calls, _, _ = mesh_run
    for r in range(8):
        c = calls[r]["comm/True"]
        assert c["model"]["uplink_bits"] == c["bits_measured"] == 147456


def test_purity_findings_equal_reference(mesh_run):
    """The packed round is clean; the unpacked baseline fires
    `collective-f32-weight` once a mask leaf (7), as the reference's."""
    _, calls, _, comm = mesh_run
    assert comm["True"]["purity"] == []
    assert len(comm["False"]["purity"]) == 7
    for r in range(8):
        for packed in ("True", "False"):
            assert sorted(calls[r][f"comm/{packed}"]["purity"]) == sorted(
                comm[packed]["purity"]), (r, packed)
    assert all("[collective-f32-weight] psum[pod]" in f
               for f in comm["False"]["purity"])


def test_declared_shardings_are_held(mesh_run):
    """Declared vs held on the 8 ranks: every placed leaf is the block its
    NamedSharding names (the test's state, and internlm2-1.8b's SMOKE fed
    state with its weights' silent-replication check), and a block cut
    wrong on a rank is caught, by contents and by shape."""
    _, calls, _, _ = mesh_run
    for r in range(8):
        assert calls[r]["shard/placed"] == [], r
        assert calls[r]["shard/round"] == [], r
        cut = calls[r]["shard/cut"]
        assert len(cut) == 2 and all(
            f.startswith("[shard-spec-mismatch] ") for f in cut), (r, cut)
        assert "scores/layers/w: the rank's" in cut[0]
        assert "weights/layers/w: declared" in cut[1]


def test_world_of_one_equals_the_plain_round(tmp_path):
    """On a (1, 1, 1) mesh (one gloo rank, in this process) every variant
    of the mesh round gives the `mesh=None` round bit for bit, and so does
    the torchrun entry point's round against a plain round from the same
    seed.  One exception, the reference's: without participation the mesh
    round averages floats over pods only, so the 4 cohorts of a pod of
    one keep their own float rows, where `mesh=None` averages them (the
    8-rank test holds that against the reference's shards)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import mesh_round, steps
    from repro_torch.runtime import elastic
    arrs = _inputs(tmp_path / "inputs.npz")
    host = _torch_state(arrs)
    meshlib.init("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                 rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = meshlib.make_debug_pod_mesh()
        assert mesh.shape == {"pod": 1, "data": 1, "model": 1}
        with pytest.raises(ValueError):        # 4 ranks on a world of 1
            meshlib.make_debug_mesh(2, 2)
        sh = steps.fed_state_shardings(host, mesh)
        for name, (kw, part) in VARIANTS.items():
            cfg = steps.StepConfig(seed=SEED, **kw)
            p = PART if part else None
            a, ma = steps.make_round_step(None, cfg)(_clone(host), p)
            b, mb = steps.make_round_step(None, cfg, mesh=mesh, state_sh=sh)(
                elastic.reshard_server(_clone(host), sh), p)
            for key in a:
                fold = key == "floats" and not part
                for x, y, h in zip(tree.leaves(a[key]), tree.leaves(b[key]),
                                   tree.leaves(host[key])):
                    if fold:
                        assert torch.equal(y, h) and not torch.equal(x, y)
                    else:
                        assert torch.equal(x, y) if isinstance(
                            x, torch.Tensor) else x == y, (name, key)
            assert all(torch.equal(ma[k], mb[k]) for k in ma), name
        with pytest.raises(ValueError):        # no collective spans it
            mesh.group(("pod", "model"))
        # the entry point's round from a start whose cohorts' float rows
        # differ: the pod-only float mean keeps each row, the rest is the
        # plain round's
        args = mesh_round.parse_args(["--arch", "internlm2-1.8b", "--smoke",
                                      "--device", "cpu", "--cohorts", "2"])
        api, start = mesh_round.global_state(args.arch, args.cohorts,
                                             smoke=args.smoke)
        start["floats"] = tree.tree_map(
            lambda t: None if t is None else t + torch.arange(
                2.0).view((2,) + (1,) * (t.ndim - 1)), start["floats"])
        out = mesh_round.run(args, mesh, (api, start))
        st, m = steps.make_round_step(
            api, mesh_round.step_config(args), codec=mesh_round.CODEC)(
            elastic.reshard_server(start, "cpu"))
        for key in st:
            for x, y, h in zip(tree.leaves(st[key]),
                               tree.leaves(out["state"][key]),
                               tree.leaves(start[key])):
                if x is None:
                    assert y is None
                elif key == "floats":
                    assert torch.equal(y, h) and not torch.equal(x, y)
                else:
                    assert x == y if not isinstance(x, torch.Tensor) else \
                        torch.equal(x, y), key
        assert out["metrics"] == {k: float(v) for k, v in m.items()}
    finally:
        dist.destroy_process_group()


def test_no_backend_gives_way():
    """`init("cuda")` on a machine without a card raises instead of
    starting gloo; an unknown device raises too."""
    from repro_torch.launch import mesh as meshlib
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.init("cuda", rank=0, world_size=1)
    with pytest.raises(ValueError):
        meshlib.init("tpu", rank=0, world_size=1)
