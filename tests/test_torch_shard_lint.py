"""The port's silent-replication lint (`repro_torch.analysis.shard_lint`)
against the reference's, on every arch's parameter shapes at full size
on the production mesh's axis sizes (2, 16, 16) and on the debug pod
mesh's (2, 2, 2): the same explanations (path, shape, spec, rule,
skipped dims) and the same findings.  The port's shapes lie on the meta
device, the reference's are `jax.eval_shape` structs.  Declared vs held
needs ranks: `tests/test_torch_mesh_round.py` holds it on 8."""
import jax
import pytest
import torch

from repro.analysis import shard_lint as jshard
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model

from repro_torch.analysis import shard_lint, stream_cover
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import sharding as shd
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

AXES = ("pod", "data", "model")
MESHES = {"production": (2, 16, 16), "debug_pod": (2, 2, 2)}


def _explained(rep):
    return [(e.path, tuple(e.shape), tuple(e.spec), e.rule, tuple(e.skipped))
            for e in rep["explanations"]]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_silent_replication_equals_reference(arch):
    jparams = jax.eval_shape(jbuild_model(jget_config(arch, smoke=False))
                             .init_params, jax.random.PRNGKey(0))
    params = stream_cover.meta_params(get_config(arch, smoke=False))
    for shape in MESHES.values():
        mesh = shard_lint.AxisSizes.of(shape, AXES)
        got = shard_lint.silent_replication_report(params, mesh,
                                                   label=f"{arch}/")
        want = jshard.silent_replication_report(jparams, mesh,
                                                label=f"{arch}/")
        assert _explained(got) == _explained(want)
        assert [str(f) for f in got["findings"]] == [
            str(f) for f in want["findings"]]


def test_silent_replication_fires():
    """A big leaf whose dims divide neither axis is replicated by the
    fallback and flagged; a norm, replicated by policy, is not."""
    mesh = shard_lint.AxisSizes.of((2, 16, 16), AXES)
    tree = {"layers": {"w_odd": torch.empty((4, 33, 70), device="meta"),
                       "norm": torch.empty((4, 4096), device="meta")}}
    rep = shard_lint.silent_replication_report(tree, mesh)
    assert [f.where for f in rep["findings"]] == ["layers/w_odd"]
    assert rep["findings"][0].rule == "shard-silent-replication"
    assert len(rep["explanations"]) == 2


def test_placement_mismatch_fires_on_a_world_of_one():
    """Declared vs held with the one rank's block the whole tensor: the
    placed tensor passes, a rolled or cut one fails, by contents and by
    shape; `positions` samples the contents."""
    mesh = shard_lint.AxisSizes.of((1, 1, 1), AXES)
    host = {"w": torch.arange(64.0).reshape(8, 8)}
    sh = {"w": shd.NamedSharding(mesh, shd.P(None, "model"))}
    assert shard_lint.placement_mismatches(
        {"w": host["w"].clone()}, sh, host) == []
    for positions in (None, 16):
        bad = shard_lint.placement_mismatches(
            {"w": host["w"].roll(1, 0)}, sh, host, positions=positions)
        assert [f.rule for f in bad] == ["shard-spec-mismatch"]
    bad = shard_lint.placement_mismatches({"w": host["w"][:, :7]}, sh, host)
    assert "declared" in bad[0].detail
