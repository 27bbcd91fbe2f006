"""The port's aggregator tree (`runtime.agg_tree`) on the reference tests'
tiny CNN with a dyadic cohort (K = 4 equal-size clients, H = 2, B = 8,
fanout 2).

* Against the JAX package: an edge's pooled record packs the same count
  words as the reference's `pack_counts` and costs what both static
  models say; `ByzantineFilter` decides as the reference's on the same
  density sequences; fedmask under edge crashes, partitions and corrupt
  uplinks logs the same events (every field) and commits the same theta
  (within 1e-6, as in test_torch_async_engine.py) as the reference tree.
* The port's own invariants, as the reference states them: at zero
  faults the tree commits bit-identically to the flat engine (theta and
  wire bits; floats and metrics within 1e-5, pooled in another order);
  the measured root bits equal the static model exactly; density bombs
  and forged-CRC flips are quarantined before the fold; an edge crash
  replays losslessly, a partition delays without using the wire;
  save/restore continues event for event, a corrupt fold log degrades;
  fedavg has no seam and is refused.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.analysis import comm_model as jcomm_model
from repro.core import aggregation as jaggregation
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro.runtime import agg_tree as jagg_tree
from repro.runtime import fault as jfault

from repro_torch import api, convert
from repro_torch.analysis import comm_model
from repro_torch.api import payloads as plds
from repro_torch.api import protocol
from repro_torch.core import tree as tu
from repro_torch.models import cnn
from repro_torch.runtime.agg_tree import (ByzantineFilter, PooledFoldRecord,
                                          TreeConfig, TreeRoundEngine,
                                          _ClassAcc, _Edge)
from repro_torch.runtime.async_engine import AsyncConfig, AsyncRoundEngine
from repro_torch.runtime.fault import FaultInjector
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

TINY = dict(name="t", conv_planes=(8, 8), dense_sizes=(16,), n_classes=4,
            img_size=8)
K, H, B = 4, 2, 8
KEY = jax.random.PRNGKey(0)
FAULTS = dict(seed=7, agg_crash_prob=0.3, agg_partition_prob=0.15)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: None if x is None else
                                  np.array(x), tree,
                                  is_leaf=lambda x: x is None)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jcnn.ConvConfig(**TINY), cnn.ConvConfig(**TINY)
    x, y = jax.jit(lambda k: (lambda t: (t.x, t.y))(
        jsynthetic.make_image_task(k, n=256, img=8, n_classes=4,
                                   noise=0.3)))(KEY)
    task = jsynthetic.ImageTask(x, y, 4)
    cidx = jpartition.partition_iid(np.random.default_rng(0),
                                    np.asarray(y), K)
    assert len({len(c) for c in cidx}) == 1, "the cohort must be dyadic"
    data = jsynthetic.federated_batches(KEY, task, cidx, K, H, B)
    params = jax.jit(lambda k: jcnn.init_params(k, jcfg))(KEY)
    tdata = {"images": torch.from_numpy(np.array(data["images"])),
             "labels": torch.from_numpy(np.array(data["labels"])).long()}
    sizes = np.asarray([len(c) for c in cidx], np.float32)
    tapply = lambda p, b: cnn.forward(p, cfg, b["images"])
    return dict(
        jcfg=jcfg, data=data, tdata=tdata, sizes=sizes, params=params,
        tparams=convert.tree_to_torch(_np(params), "cpu"), tapply=tapply,
        fedpm=api.get_algorithm("fedpm_reg", tapply, cnn.ce_loss,
                                local_steps=H))


def _init(setup):
    return setup["fedpm"].init(torch.Generator().manual_seed(1),
                               setup["tparams"])


def _tree(setup, **kw):
    kw.setdefault("tree", TreeConfig(fanout=2))
    return TreeRoundEngine(setup["fedpm"], _init(setup), setup["tdata"],
                           torch.from_numpy(setup["sizes"]), 5, **kw)


def _equal(a, b):
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def _close(a, b, **kw):
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        if x is not None:
            torch.testing.assert_close(x.float(), y.float(), **kw)


def test_record_words_and_bits_equal_the_reference():
    """One edge's pooled record: the count words are the reference's
    `pack_counts` of the same counts, its bits both static models'."""
    rng = np.random.default_rng(3)
    P = (64, 96, 32)
    for acc_bits in (8, 16, 32):
        counts = [rng.integers(0, 200, size=p).astype(np.int64) for p in P]
        acc = _ClassAcc(size=64.0, version=0, count=3, counts=counts,
                        fsums=[np.ones((5,), np.float32)],
                        msums={"loss": 1.5, "reg": 0.2}, bpp_sum=2.9,
                        clients=[(0, 0), (1, 0), (2, 0)])
        rec = PooledFoldRecord.from_edge(0, _Edge({(64.0, 0): acc}, []),
                                         acc_bits)
        assert rec.verify()
        for got, c in zip(rec.classes[0].count_words, counts):
            np.testing.assert_array_equal(
                got, jaggregation.pack_counts(c, acc_bits))
        leaf_params = [p - 5 for p in P]
        for model in (comm_model, jcomm_model):
            st = model.tree_root_record_bits(
                leaf_params, acc_bits=acc_bits, float_elems=5, n_metrics=2)
            assert st["wire_bits"] == rec.wire_bits
            assert st["sidecar_bits"] == rec.sidecar_bits
            assert st["header_bits"] == rec.header_bits
        assert comm_model.tree_root_round_bits(
            leaf_params, 3, acc_bits=acc_bits, n_classes=2) == \
            jcomm_model.tree_root_round_bits(leaf_params, 3,
                                             acc_bits=acc_bits, n_classes=2)


def test_byzantine_filter_equals_the_reference():
    rng = np.random.default_rng(1)
    for cfg_kw in (dict(), dict(min_cohort=4, z_thresh=3.0, trim_frac=0.4),
                   dict(z_thresh=0.0)):
        a = ByzantineFilter(TreeConfig(**cfg_kw))
        b = jagg_tree.ByzantineFilter(jagg_tree.TreeConfig(**cfg_kw))
        for _ in range(12):
            d = list(np.clip(rng.normal(0.5, 0.05, size=6), 0, 1)
                     + (rng.random(6) < 0.2) * 0.4)
            assert a.screen(d) == b.screen(d)
            adm, _, _ = a.screen(d)
            for i in adm:
                a.admit(float(d[i]))
                b.admit(float(d[i]))
            assert a.state_dict() == b.state_dict()


def test_fedavg_cannot_ride_the_tree(setup):
    algo = api.get_algorithm("fedavg", setup["tapply"], cnn.ce_loss,
                             local_steps=H)
    with pytest.raises(ValueError, match="pooled_aggregate"):
        TreeRoundEngine(algo, algo.init(None, setup["tparams"]),
                        setup["tdata"], torch.from_numpy(setup["sizes"]), 5)


def test_zero_fault_tree_bit_identical_to_flat(setup):
    flat = AsyncRoundEngine(setup["fedpm"], _init(setup), setup["tdata"],
                            torch.from_numpy(setup["sizes"]), 5)
    tree = _tree(setup)
    for _ in range(3):
        (cf,) = flat.tick(setup["tdata"])
        (ct,) = tree.tick(setup["tdata"])
        for k in ("uplink_bits_measured", "uplink_header_bits",
                  "n_folded", "clients", "downlink_bits"):
            assert cf[k] == ct[k], k
        _equal(flat.state.theta, tree.state.theta)
        _close(flat.state.floats, tree.state.floats, rtol=1e-5, atol=1e-6)
        assert ct["uplink_bpp"] == pytest.approx(cf["uplink_bpp"], rel=1e-5)
        assert ct["loss"] == pytest.approx(cf["loss"], rel=1e-4)
    assert {e["kind"] for e in tree.events} == {"fold", "commit"}
    assert tree.totals["root_bits_measured"] > 0


def test_root_record_bits_match_static_model(setup):
    tree = _tree(setup)
    (c,) = tree.tick(setup["tdata"])
    tmpl = tree._payload_template
    leaf_params = [int(np.prod(sh)) for sh in tmpl.shapes]
    float_elems = sum(f.numel() for f in tu.leaves(tmpl.floats)
                      if f is not None)
    probe = _tree(setup)
    probe._launch(setup["tdata"], 0)
    n_metrics = len(probe.pending[0].metrics)
    st = comm_model.tree_root_round_bits(
        leaf_params, tree.n_edges, acc_bits=tree.tree.acc_bits,
        float_elems=float_elems, n_metrics=n_metrics)
    assert st["root_bits"] == c["root_bits_measured"]
    assert st["root_header_bits"] == c["root_header_bits"]


@pytest.mark.parametrize("role,reason", [("ones", "density"),
                                         ("zeros", "density"),
                                         ("flip", "decl_mismatch")])
def test_adversary_quarantined_before_fold(setup, role, reason):
    eng = _tree(setup, adversary={1: role},
                config=AsyncConfig(quorum_frac=0.5))
    (c,) = eng.tick(setup["tdata"])
    q = [e for e in eng.events if e["kind"] == "byz_quarantine"]
    assert [(e["client"], e["reason"]) for e in q] == [(1, reason)]
    assert eng.byz_quarantined == {reason: 1}
    honest = [k for k in range(K) if k != 1]
    assert c["clients"] == honest and c["n_folded"] == K - 1
    # the oracle: the honest clients' payloads of tick 0, aggregated
    algo, st0 = setup["fedpm"], _init(setup)
    _, pays, _ = protocol.client_phase(algo, st0, setup["tdata"], K,
                                       eng.tick_generator(0))
    w = torch.tensor([float(setup["sizes"][k]) for k in honest])
    ref = algo.aggregate(st0, plds.stack_payloads([pays[k] for k in honest]),
                         w / w.sum(), torch.ones(K - 1, dtype=torch.bool))
    _close(eng.state.theta, ref.theta, rtol=1e-5, atol=1e-6)
    assert not any(e["kind"] == "corrupt_reject" for e in eng.events)


def test_flip_without_declaration_would_fold(setup):
    eng = _tree(setup, adversary={1: "flip"}, codec="bitpack",
                config=AsyncConfig(quorum_frac=0.5))
    eng._launch(setup["tdata"], 0)
    assert all(e.msg.verify() for e in eng.pending)
    eng._decl.clear()
    eng._deliver(0)
    assert not any(e["kind"] == "byz_quarantine" for e in eng.events)
    assert sum(e["kind"] == "fold" for e in eng.events) == K


def _force_edge_faults(eng, schedule):
    def fake(t):
        crashed = np.zeros(eng.n_edges, bool)
        parted = np.zeros(eng.n_edges, bool)
        cr, pa = schedule.get(t, ((), ()))
        crashed[list(cr)] = True
        parted[list(pa)] = True
        return crashed, parted
    eng._edge_alive = fake


def _partial_fold(setup, eng):
    """Launch tick 0 and deliver all but client 3 (a tick late): an
    uncommitted partial fold on the edges."""
    eng._launch(setup["tdata"], 0)
    eng.pending[3].deliver = 1
    eng._deliver(0)
    assert not eng._maybe_commit(0)
    eng.tick_idx = 1


def test_edge_crash_replay_is_lossless(setup):
    mk = lambda: _tree(setup, config=AsyncConfig(quorum_frac=1.0,
                                                 deadline_rounds=10))
    ref, eng = mk(), mk()
    _force_edge_faults(ref, {})
    _force_edge_faults(eng, {1: ((0,), ())})
    _partial_fold(setup, ref)
    _partial_fold(setup, eng)
    c_ref, c_eng = ref.flush(), eng.flush()
    crash = [e for e in eng.events if e["kind"] == "agg_crash"]
    assert crash and crash[0]["lost"] == 2
    assert {e["client"] for e in eng.events if e["kind"] == "replay"} == \
        {0, 1}
    assert {e["client"] for e in eng.events if e["kind"] == "failover"} == \
        {0, 1}
    assert len(c_ref) == len(c_eng) == 1
    _equal(ref.state.theta, eng.state.theta)
    _close(ref.state.floats, eng.state.floats, rtol=1e-5, atol=1e-6)
    assert c_eng[0]["uplink_bits_measured"] > c_ref[0]["uplink_bits_measured"]
    assert c_eng[0]["n_folded"] == c_ref[0]["n_folded"] == K
    assert eng.buffer_ones == ref.buffer_ones == 0


def test_edge_crash_without_failover_requeues(setup):
    eng = _tree(setup, tree=TreeConfig(fanout=2, failover=False),
                config=AsyncConfig(quorum_frac=1.0, deadline_rounds=10))
    _force_edge_faults(eng, {0: ((0,), ())})
    eng.tick(setup["tdata"])
    assert {e["client"] for e in eng.events
            if e["kind"] == "agg_unavailable"} == {0, 1}
    assert {e["client"] for e in eng.events if e["kind"] == "fold"} == {2, 3}
    _force_edge_faults(eng, {})
    commits = eng.flush()
    assert commits and commits[0]["n_folded"] == K


def test_edge_partition_delays_without_wire(setup):
    mk = lambda: _tree(setup, config=AsyncConfig(quorum_frac=1.0,
                                                 deadline_rounds=10))
    ref, eng = mk(), mk()
    _force_edge_faults(ref, {})
    _force_edge_faults(eng, {0: ((), (1,))})
    assert len(ref.tick(setup["tdata"])) == 1
    assert not eng.tick(setup["tdata"])
    assert {e["client"] for e in eng.events
            if e["kind"] == "agg_partition"} == {2, 3}
    c = eng.flush()
    assert c and c[0]["n_folded"] == K
    assert eng.totals["uplink_bits_measured"] == \
        ref.totals["uplink_bits_measured"]
    _equal(ref.state.theta, eng.state.theta)
    _equal(ref.state.floats, eng.state.floats)


def test_save_restore_continues_identically(setup, tmp_path):
    mk = lambda: _tree(setup, injector=FaultInjector(K, **FAULTS),
                       config=AsyncConfig(quorum_frac=0.75,
                                          deadline_rounds=2))
    ref, eng = mk(), mk()
    for _ in range(3):
        ref.tick(setup["tdata"])
        eng.tick(setup["tdata"])
    path = os.path.join(tmp_path, "eng")
    eng.save(path)
    fresh = mk()
    fresh.restore(path)
    assert not fresh._degraded_restore
    assert fresh.byz.state_dict() == eng.byz.state_dict()
    for _ in range(3):
        ref.tick(setup["tdata"])
        fresh.tick(setup["tdata"])
    ref.flush()
    fresh.flush()
    assert fresh.events == ref.events
    assert {"agg_crash", "commit"} <= {e["kind"] for e in ref.events}
    _equal(fresh.state, ref.state)
    assert fresh.totals == ref.totals


def test_corrupt_fold_log_degrades_restore(setup, tmp_path):
    mk = lambda: _tree(setup, config=AsyncConfig(quorum_frac=1.0,
                                                 deadline_rounds=10))
    eng = mk()
    _partial_fold(setup, eng)
    path = os.path.join(tmp_path, "eng")
    eng.save(path)
    man = json.load(open(path + ".json"))
    logs = man["extra"]["tree"]["edges"][0]["log"]
    assert logs
    logs[0]["checksum"] = (logs[0]["checksum"] + 1) % (1 << 32)
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    fresh = mk()
    fresh.restore(path)
    assert fresh._degraded_restore
    assert fresh.events[-1]["kind"] == "restore_degraded"
    assert not fresh.pending
    assert all(not e.log and not e.classes for e in fresh.edges)
    _equal(fresh.state, eng.state)


def test_fedmask_tree_events_match_the_reference(setup):
    jcfg = setup["jcfg"]
    jalgo = japi.get_algorithm(
        "fedmask", lambda p, b: jcnn.forward(p, jcfg, b["images"]),
        jcnn.ce_loss, lr=0.1, local_steps=H)
    talgo = api.get_algorithm("fedmask", setup["tapply"], cnn.ce_loss,
                              lr=0.1, local_steps=H)
    faults = dict(FAULTS, corrupt_prob=0.2, crash_prob=0.1)
    jst = jalgo.init(KEY, setup["params"])
    jeng = jagg_tree.TreeRoundEngine(
        jalgo, jst, setup["data"], jnp.asarray(setup["sizes"]), KEY,
        config=jagg_tree.AsyncConfig(quorum_frac=0.75, deadline_rounds=2),
        injector=jfault.FaultInjector(K, **faults),
        tree=jagg_tree.TreeConfig(fanout=2))
    teng = TreeRoundEngine(
        talgo, convert.mask_state_from_jax(_np(jst), "cpu"), setup["tdata"],
        torch.from_numpy(setup["sizes"]), 0,
        config=AsyncConfig(quorum_frac=0.75, deadline_rounds=2),
        injector=FaultInjector(K, **faults), tree=TreeConfig(fanout=2))
    jc, tc = [], []
    for _ in range(4):
        jc += jeng.tick(setup["data"])
        tc += teng.tick(setup["tdata"])
    jc += jeng.flush()
    tc += teng.flush()
    assert len(tc) == len(jc) >= 2
    assert teng.events == jeng.events
    assert {"agg_crash", "fold", "commit"} <= {e["kind"]
                                               for e in teng.events}
    for a, b in zip(tc, jc):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, float):
                assert abs(a[k] - v) <= 1e-6, k
            else:
                assert a[k] == v, k
    for a, b in zip([s for s in tu.leaves(teng.state.scores)
                     if s is not None],
                    jax.tree_util.tree_leaves(jeng.state.scores)):
        np.testing.assert_allclose(torch.sigmoid(a).numpy(),
                                   np.asarray(jax.nn.sigmoid(b)), atol=1e-6,
                                   rtol=0)
    assert teng.totals == jeng.totals
    assert teng.byz.state_dict() == pytest.approx(jeng.byz.state_dict())
