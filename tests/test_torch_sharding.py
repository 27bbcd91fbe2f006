"""The port's sharding rules (`repro_torch.launch.sharding` and the state
shardings of `repro_torch.launch.steps`) against the JAX package's, spec
for spec and rule for rule, on every arch's leaf shapes at SMOKE and at
full size, over four duck-typed meshes.

Shapes only: the port draws its states under `FakeTensorMode` (meta
storage), the reference under `jax.eval_shape`.  The port's meshes are
stubs with `.shape` / `.axis_names` / `.size`, as
`tests/test_collective.py` builds them, so axis sizes above 1 need no
devices; the reference's `NamedSharding` takes the same shape as a
`jax.sharding.AbstractMesh`."""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import masking, tree
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import build_model

_NONE = lambda x: x is None
C = 2
CACHE = ((1, 512), (32, 256))      # (batch, max_seq) of the cache shapes


class _StubMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.size = int(np.prod(shape))


MESHES = {"2x4x2": ((2, 4, 2), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    """(the reference's abstract mesh, the port's stub) of one shape."""
    shape, axes = MESHES[name]
    return jax.sharding.AbstractMesh(shape, axes), _StubMesh(shape, axes)


def _jpaths(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=_NONE)
    return [(jshd._path_str(p), x) for p, x in flat]


def _tpaths(t):
    return tree.flatten_with_paths(t)


def _shape(x):
    return None if x is None else tuple(x.shape)


@pytest.fixture(scope="module")
def shapes():
    """{(arch, smoke): (reference shapes, port shapes)} of the fed state
    (C = 2), the params and each cache of CACHE."""
    assert tuple(ARCH_NAMES) == tuple(JARCH_NAMES)
    out = {}
    for arch in ARCH_NAMES:
        for smoke in (True, False):
            japi = jbuild_model(jget_config(arch, smoke=smoke))
            tapi = build_model(get_config(arch, smoke=smoke))
            j = {"state": jax.eval_shape(
                lambda k: jsteps.init_fed_state(k, japi, jmasking.MaskSpec(),
                                                C=C), jax.random.PRNGKey(0)),
                 "params": jax.eval_shape(japi.init_params,
                                          jax.random.PRNGKey(0))}
            for b, s in CACHE:
                j[("cache", b)] = jax.eval_shape(
                    lambda: japi.init_cache(b, s))
            with FakeTensorMode():
                gen = torch.Generator()
                t = {"state": steps.init_fed_state(gen, tapi,
                                                   masking.MaskSpec(), C=C),
                     "params": tapi.init_params(gen)}
                for b, s in CACHE:
                    t[("cache", b)] = tapi.init_cache(b, s, "cpu")
            out[arch, smoke] = (j, t)
    return out


def _same_specs(jsh, tsh, what):
    """Two sharding trees: the same paths, and at each the same spec."""
    ja, ta = _jpaths(jsh), _tpaths(tsh)
    assert [p for p, _ in ja] == [p for p, _ in ta], what
    for (p, a), (_, b) in zip(ja, ta):
        if a is None:
            assert b is None, (what, p)
            continue
        assert tuple(b.spec) == tuple(a.spec), (what, p, a.spec, b.spec)


ARCH_SIZES = [(a, s) for a in ARCH_NAMES for s in (True, False)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,smoke", ARCH_SIZES,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in ARCH_SIZES])
def test_state_and_param_shardings_match(shapes, arch, smoke, mesh_name):
    jmesh, mesh = _mesh(mesh_name)
    j, t = shapes[arch, smoke]
    js, ts = j["state"], t["state"]
    assert [(p, _shape(x)) for p, x in _jpaths(js["scores"])] == \
        [(p, _shape(x)) for p, x in _tpaths(ts["scores"])]
    jsh = jsteps.fed_state_shardings(js, jmesh)
    tsh = steps.fed_state_shardings(ts, mesh)
    assert set(jsh) == set(tsh)
    for key in jsh:
        _same_specs(jsh[key], tsh[key], (arch, key))
    for tp_only in (False, True):
        _same_specs(jshd.tree_param_shardings(j["params"], jmesh,
                                              tp_only=tp_only),
                    shd.tree_param_shardings(t["params"], mesh,
                                             tp_only=tp_only),
                    (arch, "params", tp_only))
    fa = {"params": j["params"], "opt_m": j["params"],
          "step": jax.ShapeDtypeStruct((), np.int32)}
    fb = {"params": t["params"], "opt_m": t["params"], "step": 0}
    ja, tb = (jsteps.fedavg_state_shardings(fa, jmesh),
              steps.fedavg_state_shardings(fb, mesh))
    for key in ("params", "opt_m"):
        _same_specs(ja[key], tb[key], (arch, "fedavg", key))
    assert tuple(tb["step"].spec) == tuple(ja["step"].spec) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,smoke", ARCH_SIZES,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in ARCH_SIZES])
def test_explain_spec_rules_match(shapes, arch, smoke, mesh_name):
    """explain_spec leaf by leaf over the params at every scan depth the
    rules meet: the same spec, rule and skipped dims."""
    _, mesh = _mesh(mesh_name)
    j, t = shapes[arch, smoke]
    for (p, a), (q, b) in zip(_jpaths(j["params"]), _tpaths(t["params"])):
        assert p == q
        if a is None:
            continue
        for sd in (0, 1, 2):
            ea = jshd.explain_spec(p, a.shape, mesh, scan_dims=sd)
            eb = shd.explain_spec(q, tuple(b.shape), mesh, scan_dims=sd)
            assert (tuple(eb.spec), eb.rule, eb.skipped, eb.shape,
                    eb.path) == (tuple(ea.spec), ea.rule, ea.skipped,
                                 ea.shape, ea.path), (p, sd)
            assert tuple(shd.param_spec(q, tuple(b.shape), mesh,
                                        scan_dims=sd)) == tuple(ea.spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_shardings_match(shapes, mesh_name):
    jmesh, mesh = _mesh(mesh_name)
    assert tuple(shd.batch_spec(mesh)) == tuple(jshd.batch_spec(mesh))
    assert tuple(shd.replicated(mesh).spec) == tuple(
        jshd.replicated(jmesh).spec) == ()
    for rows in (1, 3, 32, 64):
        jb = {"tokens": jax.ShapeDtypeStruct((rows, 128), np.int32),
              "frames": jax.ShapeDtypeStruct((rows, 30, 8), np.float32),
              "pos": jax.ShapeDtypeStruct((), np.int32)}
        tb = {"tokens": torch.empty((rows, 128), device="meta"),
              "frames": torch.empty((rows, 30, 8), device="meta"),
              "pos": torch.empty((), device="meta")}
        tsh = shd.batch_shardings(tb, mesh)
        if "pod" in mesh.axis_names:
            _same_specs(jshd.batch_shardings(jb, jmesh), tsh,
                        ("batch", rows))
        else:
            # the reference iterates over the letters of "data" here
            with pytest.raises(KeyError):
                jshd.batch_shardings(jb, jmesh)
            want = ("data",) if rows % 16 == 0 else (None,)
            assert tuple(tsh["tokens"].spec) == want + (None,)
            assert tuple(tsh["frames"].spec) == want + (None, None)
            assert tuple(tsh["pos"].spec) == ()
    for (arch, smoke), (j, t) in shapes.items():
        for b, _ in CACHE:
            ja, tb = j[("cache", b)], t[("cache", b)]
            assert [(p, _shape(x)) for p, x in _jpaths(ja)] == \
                [(p, _shape(x)) for p, x in _tpaths(tb)], (arch, b)
            _same_specs(jshd.cache_shardings(ja, jmesh, b),
                        shd.cache_shardings(tb, mesh, b), (arch, b))


class _RankMesh(_StubMesh):
    def __init__(self, shape, axes, rank):
        super().__init__(shape, axes)
        self.coords = dict(zip(axes, np.unravel_index(rank, shape)))


@pytest.mark.parametrize("spec", [(), ("pod",), (None, "model"),
                                  (("pod", "data"), None),
                                  ("data", ("model", "pod")),
                                  (("pod", "data", "model"),)])
def test_named_sharding_blocks_tile_the_array(spec):
    """On a (2,2,2) mesh each rank's block (row-major ranks) is where the
    reference's device of that index holds its shard: a dim over an axis
    tuple counts major to minor in tuple order, and the blocks of the
    ranks tile the array with each element covered by the ranks that
    replicate it."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    full = (8, 8)
    cover = np.zeros(full, np.int64)
    for r in range(8):
        m = _RankMesh(shape, axes, r)
        ns = shd.NamedSharding(m, shd.P(*spec))
        idx = ns.index(full)
        cover[idx] += 1
        coords = m.coords
        for d, part in enumerate(list(spec) + [None] * (2 - len(spec))):
            parts = () if part is None else (
                (part,) if isinstance(part, str) else part)
            b = 0
            for a in parts:
                b = b * shape[axes.index(a)] + coords[a]
            k = int(np.prod([shape[axes.index(a)] for a in parts]))
            assert idx[d] == slice(b * full[d] // k, (b + 1) * full[d] // k)
        assert ns.global_shape(tuple(s.stop - s.start for s in idx)) == full
    replicas = 8 // int(np.prod([
        shape[axes.index(a)] for part in spec if part is not None
        for a in ((part,) if isinstance(part, str) else part)]))
    assert (cover == replicas).all()
    with pytest.raises(ValueError):
        shd.NamedSharding(_RankMesh(shape, axes, 0), shd.P("pod")).index(
            (3, 4))
