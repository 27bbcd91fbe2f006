"""The port's mask-stream coverage checker
(`repro_torch.analysis.stream_cover`) against the reference's
(`repro.analysis.stream_cover`): the same intervals, integer for integer,
the same findings and counts, on every arch of `ARCH_NAMES` at SMOKE size
over 8 shards and at full size over the (2, 16, 16) production grid's 512
shards.  The port's states lie on the meta device, the reference's are
`jax.eval_shape` structs: nothing is allocated.

At full size the checker finds what both packages share: the hash
stream's index is uint32 and wraps, so the blocks of a leaf past 2**32
elements (deepseek-v2-lite-16b's and deepseek-v2-236b's stacked expert
leaves, deepseek-v2-236b's stacked attention output) sample the indices
of its first blocks again.  Every finding lies on such a leaf, and every
other arch is clean."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import stream_cover as jstream
from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch.analysis import model_check, stream_cover
from repro_torch.configs import ARCH_NAMES
from repro_torch.core import masking
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

C = 2
WRAPS = {"deepseek-v2-lite-16b", "deepseek-v2-236b"}


def _reference(arch, smoke, devs):
    """The reference's report over its eval_shape state, and the
    intervals its report checks (rebuilt as `state_stream_report`
    builds them: shard devs[0], cohort 0)."""
    api = jbuild_model(jget_config(arch, smoke=smoke))
    state = jax.eval_shape(
        lambda k: jsteps.init_fed_state(k, api, jmasking.MaskSpec(), C=C),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    rep = jstream.state_stream_report(state, devs=devs)
    mp = jmasking.MaskedParams(state["weights"],
                               jstream._drop_cohort(state["scores"]),
                               jstream._drop_cohort(state["floats"]))
    tree = jmasking.masked_forward_tree(
        mp, lambda i: jmasking.mask_stream_seed(0, devs[0], i, 0,
                                                run_seed=17))
    return rep, jstream.collect_intervals(tree)


def _same(port, ref, ref_intervals):
    assert port["n_leaves"] == ref["n_leaves"]
    assert port["n_intervals"] == ref["n_intervals"]
    assert port["n_streams"] == ref["n_streams"]
    assert [tuple(vars(i).values()) for i in port["intervals"]] == [
        tuple(vars(i).values()) for i in ref_intervals]
    assert [str(f) for f in port["findings"]] == [
        str(f) for f in ref["findings"]]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_reports_equal_reference(arch):
    devs = range(8)
    port = stream_cover.arch_stream_report(arch, smoke=True, C=C, devs=devs)
    ref, ivs = _reference(arch, True, list(devs))
    _same(port, ref, ivs)
    assert port["findings"] == []
    assert port["n_intervals"] >= port["n_leaves"] > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_full_size_reports_equal_reference(arch):
    """Full size on the meta device over the 512 shards of (2, 16, 16):
    equal to the reference's report; findings only where a leaf's flat
    stream exceeds the uint32 index (every finding's owner), none on any
    other arch."""
    devs = range(512)
    port = stream_cover.arch_stream_report(arch, smoke=False, C=C, devs=devs)
    ref, ivs = _reference(arch, False, list(devs))
    _same(port, ref, ivs)
    wrapped = {iv.owner for iv in port["intervals"]
               if iv.flat_size > 2 ** 32}
    assert bool(wrapped) == (arch in WRAPS)
    assert {f.where for f in port["findings"]} == wrapped
    assert {f.rule for f in port["findings"]} <= {"stream-gap",
                                                  "stream-overlap"}


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def test_stream_cover_clean_tree():
    tree = {"a": masking.MaskedLeaf.build(_meta(3, 4, 8), None, 5),
            "b": masking.MaskedLeaf.build(_meta(16, 8), None, 9),
            "c": None}
    ivs = stream_cover.collect_intervals(tree)
    assert len(ivs) == 4                     # 3 stacked blocks + 1
    assert stream_cover.check_intervals(ivs) == []


def test_stream_overlap_detected():
    leaf = masking.MaskedLeaf.build(_meta(3, 4, 8), None, 5)
    leaf.off = np.zeros_like(leaf.off)       # every block reads [0, 32)
    found = stream_cover.check_intervals(
        stream_cover.collect_intervals({"a": leaf}))
    assert any(f.rule == "stream-overlap" for f in found)


def test_stream_gap_detected():
    leaf = masking.MaskedLeaf.build(_meta(2, 4, 8), None, 5)
    leaf.off = leaf.off * np.uint32(2)       # a hole between the blocks
    found = stream_cover.check_intervals(
        stream_cover.collect_intervals({"a": leaf}))
    assert any(f.rule == "stream-gap" for f in found)


def test_stream_seed_collision_across_leaves():
    tree = {"a": masking.MaskedLeaf.build(_meta(4, 8), None, 5),
            "b": masking.MaskedLeaf.build(_meta(4, 8), None, 5)}
    found = stream_cover.check_intervals(
        stream_cover.collect_intervals(tree))
    assert any(f.rule == "stream-overlap" and "seed" in f.detail
               for f in found)


def test_state_stream_report_flags_collision_sweep():
    """The (shard, cohort) sweep catches collisions: two shard ids that
    alias one id give every leaf's streams twice."""
    _, state = stream_cover.meta_fed_state(model_check.MODEL_CHECK_CFG, 2)
    rep = stream_cover.state_stream_report(state, devs=(0, 0),
                                           cohorts=range(2))
    assert any(f.rule == "stream-overlap" for f in rep["findings"])
    clean = stream_cover.state_stream_report(state, devs=(0, 1),
                                             cohorts=range(2))
    assert clean["findings"] == []
    assert clean["n_streams"] == clean["n_leaves"] * 4
