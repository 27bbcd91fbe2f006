"""The port's fault draws and elastic restore against the JAX package
(`repro.runtime.fault`, `elastic`, `agg_tree.TreeTopology`): every draw
equal bit for bit over a grid of seeds, rounds and streams (the
`FaultInjector` streams and `corrupt_words` included), the barrier
tree's round mask, the cohort plan and refit, and `restore_theta_only`
on a checkpoint of the reference SMOKE launcher's state, which must give
what the reference's own theta-only restore gives (the refit mean in f32
is exact here: two cohorts)."""
import jax
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.runtime import agg_tree as jagg_tree
from repro.runtime import elastic as jelastic
from repro.runtime import fault as jfault

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import tree as tu
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.runtime import agg_tree, elastic, fault
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
ROUNDS = (0, 1, 17, 10_000)


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_draws_equal_the_reference(seed):
    for r in ROUNDS:
        for stream in range(1, 16):
            np.testing.assert_array_equal(
                fault.counter_uniform(seed, r, stream, 33),
                jfault.counter_uniform(seed, r, stream, 33))
        np.testing.assert_array_equal(
            fault.counter_normal(seed, r, 3, 4, 21),
            jfault.counter_normal(seed, r, 3, 4, 21))


@pytest.mark.parametrize("kw", [
    dict(fail_prob=0.3), dict(fail_prob=1.0),
    dict(fail_prob=0.1, pod_size=4, pod_outage_prob=0.4),
    dict(fail_prob=0.2, latency_sigma=0.8)])
def test_simulator_equals_the_reference(kw):
    for seed in SEEDS[:3]:
        a = fault.FaultSimulator(13, seed=seed, **kw)
        b = jfault.FaultSimulator(13, seed=seed, **kw)
        for pol in (None, fault.StragglerPolicy(quorum_frac=0.6)):
            jpol = None if pol is None else jfault.StragglerPolicy(
                quorum_frac=0.6)
            for r in ROUNDS:
                np.testing.assert_array_equal(
                    a.sample_round(pol, round_idx=r),
                    b.sample_round(jpol, round_idx=r))
                np.testing.assert_array_equal(a.latencies(r),
                                              b.latencies(r))
        # cursor mode
        for _ in range(3):
            np.testing.assert_array_equal(a.sample_round(),
                                          b.sample_round())
    v = fault.participation_vector(a, 13, round_idx=4)
    assert v.dtype == torch.bool and v.device.type == "cpu"
    np.testing.assert_array_equal(v.numpy(), b.sample_round(round_idx=4))
    assert bool(fault.participation_vector(None, 5).all())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_injector_streams_equal_the_reference(seed):
    kw = dict(seed=seed, crash_prob=0.25, pod_size=3, partition_prob=0.3,
              straggler_prob=0.5, straggler_rounds_max=3, corrupt_prob=0.4,
              max_retries=2, agg_crash_prob=0.3, agg_partition_prob=0.2)
    a, b = fault.FaultInjector(10, **kw), jfault.FaultInjector(10, **kw)
    words = [(np.arange(10, dtype=np.uint64) * 2654435761 % 2**32).astype(
                 np.uint32),
             np.zeros(3, np.uint32), np.full(70, 0xFFFFFFFF, np.uint32)]
    for r in ROUNDS:
        np.testing.assert_array_equal(a.dropped(r), b.dropped(r))
        np.testing.assert_array_equal(a.delay_rounds(r), b.delay_rounds(r))
        np.testing.assert_array_equal(a.agg_crashed(r, 5),
                                      b.agg_crashed(r, 5))
        np.testing.assert_array_equal(a.agg_partitioned(r, 5),
                                      b.agg_partitioned(r, 5))
        for c in range(10):
            for att in range(3):
                assert a.corrupt_attempt(r, c, att) == \
                    b.corrupt_attempt(r, c, att)
                for got, want in zip(a.corrupt_words(words, r, c, att),
                                     b.corrupt_words(words, r, c, att)):
                    np.testing.assert_array_equal(got, want)


def test_tree_topology_round_mask_equals_the_reference():
    for seed, n, fanout, p in ((3, 8, 2, 0.5), (0, 4, 2, 1.0),
                               (9, 11, 3, 0.3), (1, 6, 1, 0.7)):
        a = agg_tree.TreeTopology(n, fanout, agg_fault_prob=p, seed=seed)
        b = jagg_tree.TreeTopology(n, fanout, agg_fault_prob=p, seed=seed)
        alive = np.arange(n) % 3 != 1
        for r in range(12):
            np.testing.assert_array_equal(a.crashed_edges(r),
                                          b.crashed_edges(r))
            assert a.surviving_edges(r) == b.surviving_edges(r)
            np.testing.assert_array_equal(a.round_mask(alive, r),
                                          b.round_mask(alive, r))


def test_counter_seed_keys_a_fresh_generator():
    """The port's generator seeds: a pure function of (seed, index,
    stream), distinct across indices and streams, within torch's range."""
    s = [fault.counter_seed(17, i, fault.S_BATCH) for i in range(50)]
    assert len(set(s)) == 50 and all(0 <= x < 2**63 for x in s)
    assert s[3] == fault.counter_seed(17, 3, fault.S_BATCH)
    assert s[3] != fault.counter_seed(17, 3, fault.S_TICK)
    g1 = torch.Generator().manual_seed(s[3])
    g2 = torch.Generator().manual_seed(fault.counter_seed(17, 3,
                                                          fault.S_BATCH))
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))


@pytest.mark.parametrize("k,s", [(32, 8), (7, 3), (5, 5), (100, 7)])
def test_cohort_plan_equals_the_reference(k, s):
    for a, b in zip(elastic.cohort_plan(k, s), jelastic.cohort_plan(k, s)):
        np.testing.assert_array_equal(a, b)


def test_reshard_server_places_host_arrays():
    host = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": None,
            "c": [torch.ones(2, dtype=torch.bfloat16)]}
    out = elastic.reshard_server(host, "cpu")
    assert out["b"] is None and out["c"][0].dtype == torch.bfloat16
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))


def test_fit_cohort_equals_the_reference():
    rng = np.random.default_rng(0)
    for shape, like in (((4, 3, 2), (2, 3, 2)), ((2, 5), (3, 5)),
                        ((3, 4), (3, 4))):
        arr = rng.normal(size=shape).astype(np.float32)
        got = elastic._fit_cohort(torch.from_numpy(arr), torch.zeros(like))
        want = jelastic._fit_cohort(arr, np.zeros(like))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="cannot fit"):
        elastic._fit_cohort(torch.ones(4, 3), torch.ones(2, 5))


@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    """A checkpoint of the reference SMOKE launcher's fed state (C = 2),
    written by the JAX package after one scores perturbation, and the
    reference's theta-only restore of it onto C = 3."""
    d = str(tmp_path_factory.mktemp("jsmoke"))
    cfg = jget_config("internlm2-1.8b", smoke=True)
    api = jbuild_model(cfg)
    st = jsteps.init_fed_state(jax.random.PRNGKey(5), api,
                               jmasking.MaskSpec(), C=2)
    st["scores"] = jax.tree_util.tree_map(
        lambda s: None if s is None else
        s + jax.random.normal(jax.random.PRNGKey(6), s.shape),
        st["scores"], is_leaf=lambda x: x is None)
    st["step"] = st["step"] + 12
    jckpt.save_checkpoint(d, 6, st)
    like3 = jsteps.init_fed_state(jax.random.PRNGKey(5), api,
                                  jmasking.MaskSpec(), C=3)
    want, wstep = jelastic.restore_theta_only(d, like3)
    return d, want, wstep


def test_restore_theta_only_on_a_reference_checkpoint(smoke_ckpt):
    d, want, wstep = smoke_ckpt
    api = build_model(get_config("internlm2-1.8b", smoke=True))
    like = steps.init_fed_state(torch.Generator().manual_seed(1), api,
                                steps.masking.MaskSpec(), C=3)
    state, step = elastic.restore_theta_only(d, like)
    assert step == wstep == 6 and state["step"] == 6
    want_np = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), want,
        is_leaf=lambda x: x is None)
    got_t = convert.state_from_jax(want_np, "cpu")
    for key in ("scores", "floats", "opt_m"):
        for a, b in zip(tu.leaves(state[key]), tu.leaves(got_t[key])):
            if a is None:
                assert b is None
                continue
            assert a.shape[0] == 3 and a.dtype == b.dtype
            assert torch.equal(a, b), key
    # the weights are the template's, never the checkpoint's
    for a, b in zip(tu.leaves(state["weights"]), tu.leaves(like["weights"])):
        assert a is b
    # the full restore refuses the resized structure
    from repro_torch.ckpt import checkpoint as ckpt
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, like)
