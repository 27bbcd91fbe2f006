"""The port's buffered-async round engine (`runtime.async_engine`) on the
reference tests' tiny CNN (Conv 8-8, dense 16, 4 classes, 8x8 images;
K = 3 clients, H = 2 local steps of batch 8).

* Against the JAX package: fedmask's masks are thresholds and draw
  nothing, so both packages' engines run it under the same
  `FaultInjector` seed on the same data and initial state.  The event
  logs are equal in every field (kind, client, round, tick, attempt,
  staleness, the folded ones); the committed theta within 1e-6 (a mask
  bit could only flip where its score's two sigmoids straddle tau); the
  commit metrics within 1e-6 (torch's and XLA's log2 differ in the last
  ulp).
* The port's own invariants, as the reference states them: at zero
  faults and quorum 1 every commit is bit-identical to `run_round` on
  the tick's generator (theta, every metric, the wire bits); a restored
  engine continues event for event and bit for bit; corrupt uplinks are
  cut, stale ones dropped, a corrupt buffer degrades the restore, and
  the CRC header is metered apart.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro.runtime import async_engine as jasync
from repro.runtime import fault as jfault

from repro_torch import api, convert
from repro_torch.core import tree as tu
from repro_torch.models import cnn
from repro_torch.runtime.async_engine import AsyncConfig, AsyncRoundEngine
from repro_torch.runtime.fault import FaultInjector
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

TINY = dict(name="t", conv_planes=(8, 8), dense_sizes=(16,), n_classes=4,
            img_size=8)
K, H, B = 3, 2, 8
KEY = jax.random.PRNGKey(0)
CHAOS = dict(seed=7, crash_prob=0.3, straggler_prob=0.3, corrupt_prob=0.4,
             max_retries=1)
CHAOS_CFG = dict(quorum_frac=0.6, deadline_rounds=2, max_staleness=3)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: None if x is None else
                                  np.array(x), tree,
                                  is_leaf=lambda x: x is None)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jcnn.ConvConfig(**TINY), cnn.ConvConfig(**TINY)
    x, y = jax.jit(lambda k: (lambda t: (t.x, t.y))(
        jsynthetic.make_image_task(k, n=192, img=8, n_classes=4,
                                   noise=0.3)))(KEY)
    task = jsynthetic.ImageTask(x, y, 4)
    cidx = jpartition.partition_iid(np.random.default_rng(0),
                                    np.asarray(y), K)
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


def _engine(setup, **kw):
    algo = setup["fedpm"]
    return AsyncRoundEngine(
        algo, algo.init(torch.Generator().manual_seed(1), setup["tparams"]),
        setup["tdata"], torch.from_numpy(setup["sizes"]), 5, **kw)


def _chaos(setup):
    return _engine(setup, config=AsyncConfig(**CHAOS_CFG),
                   injector=FaultInjector(K, **CHAOS))


def _equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_quorum_count_bounds():
    assert AsyncConfig(quorum_frac=0.0).quorum_count(5) == 1
    assert AsyncConfig(quorum_frac=1.0).quorum_count(5) == 5
    assert AsyncConfig(quorum_frac=0.5).quorum_count(5) == 3
    assert AsyncConfig(quorum_frac=2.0).quorum_count(5) == 5


def test_zero_faults_bit_identical_to_run_round(setup):
    """No injector, quorum 1: every commit reproduces `run_round` on the
    tick's generator exactly: theta, floats, every weighted metric, the
    entropy-bound Bpp and the measured wire bits."""
    algo, tdata = setup["fedpm"], setup["tdata"]
    sizes = torch.from_numpy(setup["sizes"])
    st = algo.init(torch.Generator().manual_seed(1), setup["tparams"])
    eng = _engine(setup)
    part = torch.ones(K, dtype=torch.bool)
    for t in range(3):
        st, m = algo.round(st, tdata, part, sizes, eng.tick_generator(t))
        (c,) = eng.tick(tdata)
        assert c["n_folded"] == K and not c["forced"]
        assert c["staleness_max"] == 0 and c["clients"] == list(range(K))
        for k in ("loss", "data_loss", "reg", "sparsity", "uplink_bpp",
                  "uplink_bits_measured", "downlink_bits", "downlink_bpp"):
            assert c[k] == float(m[k]), k
        _equal(eng.state, st)
    assert {e["kind"] for e in eng.events} == {"fold", "commit"}


def test_injected_uniforms_replace_the_tick_generator(setup):
    """`tick(data, uniforms=...)` draws nothing: it equals `run_round` on
    the same injected uniforms (the downlink's, then each client's H
    steps and final mask)."""
    algo, tdata = setup["fedpm"], setup["tdata"]
    sizes = torch.from_numpy(setup["sizes"])
    st = algo.init(torch.Generator().manual_seed(1), setup["tparams"])
    shapes = [t.shape for t in tu.leaves(st.theta) if t is not None]
    g = torch.Generator().manual_seed(9)
    draw = lambda: [torch.rand(sh, generator=g) for sh in shapes]
    u = {"downlink": draw(),
         "clients": [[draw() for _ in range(H + 1)] for _ in range(K)]}
    st, m = algo.round(st, tdata, torch.ones(K, dtype=torch.bool), sizes,
                       uniforms=u)
    eng = _engine(setup)
    (c,) = eng.tick(tdata, uniforms=u)
    assert c["loss"] == float(m["loss"])
    assert c["uplink_bits_measured"] == float(m["uplink_bits_measured"])
    _equal(eng.state, st)


def test_fedmask_events_and_theta_match_the_reference(setup):
    """fedmask under crash, straggler and corrupt faults in both packages:
    the same event log, theta and commit metrics."""
    jcfg = setup["jcfg"]
    jalgo = japi.get_algorithm(
        "fedmask", lambda p, b: jcnn.forward(p, jcfg, b["images"]),
        jcnn.ce_loss, lr=0.1, local_steps=H)
    talgo = api.get_algorithm("fedmask", setup["tapply"], cnn.ce_loss,
                              lr=0.1, local_steps=H)
    jst = jalgo.init(KEY, setup["params"])
    jeng = jasync.AsyncRoundEngine(
        jalgo, jst, setup["data"], jnp.asarray(setup["sizes"]), KEY,
        config=jasync.AsyncConfig(**CHAOS_CFG),
        injector=jfault.FaultInjector(K, **CHAOS))
    teng = AsyncRoundEngine(
        talgo, convert.mask_state_from_jax(_np(jst), "cpu"), setup["tdata"],
        torch.from_numpy(setup["sizes"]), 0,
        config=AsyncConfig(**CHAOS_CFG), injector=FaultInjector(K, **CHAOS))
    jc, tc = [], []
    for _ in range(4):
        jc += jeng.tick(setup["data"])
        tc += teng.tick(setup["tdata"])
    jc += jeng.flush()
    tc += teng.flush()
    assert len(tc) == len(jc) >= 2
    assert teng.events == jeng.events
    kinds = {e["kind"] for e in teng.events}
    assert {"drop", "straggle", "corrupt_reject", "fold"} <= kinds
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


def test_header_bits_metered_separately(setup):
    eng = _engine(setup)
    (c,) = eng.tick(setup["tdata"])
    assert c["uplink_header_bits"] == 32.0 * K
    assert c["uplink_bits_measured"] > 0


def test_stragglers_deadline_and_flush(setup):
    eng = _engine(setup, config=AsyncConfig(quorum_frac=1.0,
                                            deadline_rounds=2),
                  injector=FaultInjector(K, seed=3, straggler_prob=1.0,
                                         straggler_rounds_max=2))
    commits = []
    for _ in range(4):
        commits += eng.tick(setup["tdata"])
    commits += eng.flush()
    assert not eng.pending and not eng.buffer
    stale = sum(1 for e in eng.events if e["kind"] == "stale_drop")
    assert sum(c["n_folded"] for c in commits) + stale == 4 * K
    assert any(e["kind"] == "straggle" for e in eng.events)


def test_corrupt_uplinks_rejected_then_cut_without_abort(setup):
    eng = _engine(setup, injector=FaultInjector(K, seed=5, corrupt_prob=1.0,
                                                max_retries=1))
    commits = eng.tick(setup["tdata"]) + eng.flush()
    assert commits == []
    cuts = [e for e in eng.events if e["kind"] == "cut"]
    rejects = [e for e in eng.events if e["kind"] == "corrupt_reject"]
    assert {e["client"] for e in cuts} == set(range(K))
    assert len(rejects) == K and all(e["attempts"] == 2 for e in cuts)
    assert eng.totals["uplink_bits_measured"] > 0
    assert eng.totals["commits"] == 0


def test_stale_arrivals_discarded(setup):
    eng = _engine(setup, config=AsyncConfig(quorum_frac=0.5,
                                            deadline_rounds=1,
                                            max_staleness=0),
                  injector=FaultInjector(K, seed=11, straggler_prob=0.7,
                                         straggler_rounds_max=2))
    for _ in range(5):
        eng.tick(setup["tdata"])
    eng.flush()
    assert all(e["staleness"] == 0 for e in eng.events
               if e["kind"] == "fold")
    assert any(e["kind"] == "stale_drop" for e in eng.events)


def test_crash_restore_replays_identical_run(setup, tmp_path):
    """Crash, straggler and corrupt faults; the coordinator saved and
    thrown away mid-buffer, restored into a fresh engine: the continued
    run equals an unkilled twin event for event and bit for bit."""
    tdata = setup["tdata"]
    ref, eng = _chaos(setup), _chaos(setup)
    for _ in range(3):
        ref.tick(tdata)
        eng.tick(tdata)
    assert eng.buffer or eng.pending, "the chaos seed must leave work"
    path = str(tmp_path / "engine")
    eng.save(path)
    eng2 = _chaos(setup)
    eng2.restore(path)
    assert not eng2._degraded_restore and eng2.tick_idx == ref.tick_idx
    _equal(eng2.state, ref.state)
    assert eng2.buffer_ones == ref.buffer_ones
    assert eng2._since_commit == ref._since_commit
    for a, b in zip(eng2.pending, ref.pending):
        assert (a.client, a.deliver, a.attempt) == \
            (b.client, b.deliver, b.attempt)
        assert a.msg.checksum == b.msg.checksum and a.msg.verify()
    rc, nc = [], []
    for _ in range(3):
        rc += ref.tick(tdata)
        nc += eng2.tick(tdata)
    rc += ref.flush()
    nc += eng2.flush()
    assert eng2.events == ref.events
    assert len(nc) == len(rc) >= 1 and nc == rc
    _equal(eng2.state, ref.state)
    assert eng2.totals == ref.totals
    kinds = {e["kind"] for e in eng2.events}
    assert "drop" in kinds and "corrupt_reject" in kinds


def test_corrupt_buffer_degrades_restore(setup, tmp_path):
    """A saved buffer entry whose checksum no longer matches is refused
    wholesale: state and counters survive, buffer and wire are dropped."""
    eng = _engine(setup, config=AsyncConfig(quorum_frac=1.0,
                                            deadline_rounds=10),
                  injector=FaultInjector(K, seed=3, straggler_prob=0.5))
    eng.tick(setup["tdata"])
    assert eng.buffer, "some arrivals must wait in the buffer"
    path = str(tmp_path / "eng")
    eng.save(path)
    man = json.load(open(path + ".json"))
    man["extra"]["buffer"][0]["checksum"] ^= 1
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    fresh = _engine(setup, config=AsyncConfig(quorum_frac=1.0,
                                              deadline_rounds=10),
                    injector=FaultInjector(K, seed=3, straggler_prob=0.5))
    fresh.restore(path)
    assert fresh._degraded_restore
    assert fresh.events[-1]["kind"] == "restore_degraded"
    assert not fresh.buffer and not fresh.pending
    assert fresh.buffer_ones == 0 and fresh.tick_idx == eng.tick_idx
    _equal(fresh.state, eng.state)
