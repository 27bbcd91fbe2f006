"""The port's host-sim federated path against the JAX package, on the
quickstart CNN (`examples/quickstart.py`: Conv 8-8, dense 32, 4 classes,
8x8 images): `make_client_update`, `run_round` through the registered
fedpm_reg / fedpm / fedmask algorithms, the k-bit `ProbBroadcast`,
`make_eval_fn` / `evaluate`, and the Fig. 1 benchmark.  The reference's
threefry draws (mask uniforms, downlink uniforms) are injected, so the
two packages compute on the same draws.

Tolerances: integers (masks, words, bit counts, quantized levels) are
equal, except that a mask bit may flip where its uniform lies between
torch's and XLA's sigmoid of the same score (1 ulp apart); the scores
after H local steps agree to 2e-5 of their scale under sgd (the STE
gradient is rounded through the bf16 m * w, so two f32 sums in another
order can round one bf16 ulp apart) and, under adam, whose step is
scale-free, to H * lr * 2**-8 (one bf16 ulp of relative gradient error
a step moves a step by that share of lr); Bpp and the other f32 meters to 1e-6
(torch's and XLA's log2 differ in the last ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import federated as jfederated
from repro.core import masking as jmasking
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn

from repro_torch import api, convert
from repro_torch.api import payloads
from repro_torch.core import federated, masking
from repro_torch.core import tree as tu
from repro_torch.models import cnn
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

_NONE = lambda x: x is None
QUICK = dict(name="quick", conv_planes=(8, 8), dense_sizes=(32,),
             n_classes=4, img_size=8)
K, H, B = 3, 2, 16


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x), tree, is_leaf=_NONE)


def _tt(tree):
    return tu.tree_map(lambda a: None if a is None else torch.from_numpy(
        np.array(a)), tree)


def _scale_close(got, want, rel, atol=1e-7):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= max(rel * float(np.abs(want).max()), atol), (err, rel)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jcnn.ConvConfig(**QUICK), cnn.ConvConfig(**QUICK)
    key = jax.random.PRNGKey(0)
    x, y = jax.jit(lambda k: (lambda t: (t.x, t.y))(
        jsynthetic.make_image_task(k, n=256, img=8, n_classes=4,
                                   noise=0.35)))(key)
    task = jsynthetic.ImageTask(x, y, 4)
    cidx = jpartition.partition_iid(np.random.default_rng(0),
                                    np.asarray(task.y), K)
    data = jsynthetic.federated_batches(jax.random.PRNGKey(1), task, cidx,
                                        K, H, B)
    tdata = {"images": torch.from_numpy(np.array(data["images"])),
             "labels": torch.from_numpy(np.array(data["labels"])).long()}
    params = jax.jit(lambda k: jcnn.init_params(k, jcfg))(key)
    fns = dict(
        japply=lambda p, b: jcnn.forward(p, jcfg, b["images"]),
        jloss=jcnn.ce_loss, jmetric=jcnn.accuracy,
        tapply=lambda p, b: cnn.forward(p, cfg, b["images"]),
        tloss=cnn.ce_loss, tmetric=cnn.accuracy)
    test = {"images": task.x[:64], "labels": task.y[:64]}
    ttest = {"images": torch.from_numpy(np.array(test["images"])),
             "labels": torch.from_numpy(np.array(test["labels"])).long()}
    sizes = np.array([len(c) for c in cidx], np.float32)
    return dict(params=params, data=data, tdata=tdata, sizes=sizes,
                test=test, ttest=ttest, **fns)


def _split_uniforms(key, shapes):
    keys = jax.random.split(key, max(len(shapes), 1))
    return [jax.random.uniform(k, sh) for k, sh in zip(keys, shapes)]


def _client_uniforms(key, all_shapes, steps=H):
    """The uniforms the reference's `make_client_update` draws from `key`:
    H steps of `sample_effective` (split over the masked leaves), then
    `final_mask` (split over every leaf, None ones included).
    `all_shapes` lists every leaf's shape, None at a float leaf."""
    masked = [sh for sh in all_shapes if sh is not None]
    keys = jax.random.split(key, steps + 1)
    out = [_split_uniforms(keys[t], masked) for t in range(steps)]
    fk = jax.random.split(keys[steps], max(len(all_shapes), 1))
    out.append([jax.random.uniform(fk[i], sh)
                for i, sh in enumerate(all_shapes) if sh is not None])
    return out


def _round_uniforms(key, all_shapes):
    """The reference round's draws: the downlink's (`fold_in(key,
    0x0d0e)`, split over the masked leaves), then client k's from
    `split(key, K)[k]`."""
    masked = [sh for sh in all_shapes if sh is not None]
    ck = jax.random.split(key, K)
    return {"downlink": _split_uniforms(jax.random.fold_in(key, 0x0d0e),
                                        masked),
            "clients": [_client_uniforms(ck[k], all_shapes)
                        for k in range(K)]}


def _to_torch_u(u):
    if isinstance(u, dict):
        return {k: _to_torch_u(v) for k, v in u.items()}
    if isinstance(u, list):
        return [_to_torch_u(v) for v in u]
    return torch.from_numpy(np.array(u))


def _shapes(theta):
    return [None if t is None else tuple(t.shape) for t in
            jax.tree_util.tree_leaves(theta, is_leaf=_NONE)]


def _assert_mask_flips(tmask, jmask, u, tscores, jscores, max_flips):
    """Masks agree but where u lies between the two packages' sigmoids of
    their scores."""
    flips = 0
    for tm, jm, uu, ts, js in zip(tmask, jmask, u, tscores, jscores):
        tm, jm = np.asarray(tm), np.asarray(jm)
        diff = tm != jm
        th = np.stack([torch.sigmoid(torch.from_numpy(
            np.asarray(ts, np.float32))).numpy(),
            np.asarray(jax.nn.sigmoid(jnp.asarray(js)))])
        uu = np.asarray(uu)
        assert np.all((uu[diff] >= th.min(0)[diff])
                      & (uu[diff] <= th.max(0)[diff])), "flip off boundary"
        flips += int(diff.sum())
    assert flips <= max_flips, flips


@pytest.mark.parametrize("optimizer,steps", [("sgd", H), ("adam", 1)])
def test_client_update_matches_jax(setup, monkeypatch, optimizer, steps):
    """Local steps of one client from the same theta, data and mask
    uniforms: the scores (read where `final_mask` gets them), the float
    leaves, the uplink mask and the metrics.  Adam runs one step: its
    scale-free step moves a score by up to lr * 2**-8 between the
    packages, enough for a second step's mask to flip a bit at the
    boundary and send that client on another path."""
    fcfg = dict(lam=1.0, local_steps=steps, lr=0.1, float_lr=1e-3,
                optimizer=optimizer)
    jalgo = japi.get_algorithm("fedpm_reg", setup["japply"], setup["jloss"],
                               **fcfg)
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = convert.server_from_jax(_np(jst), "cpu")
    key = jax.random.PRNGKey(5)
    u = jax.jit(lambda k: _client_uniforms(k, _shapes(jst.theta),
                                           steps))(key)
    seen = {}

    def spy(mod, tag):
        orig = mod.final_mask

        def final_mask(mp, *a, **kw):
            seen[tag] = mp.scores
            return orig(mp, *a, **kw)
        monkeypatch.setattr(mod, "final_mask", final_mask)

    spy(jmasking, "jax")
    spy(masking, "torch")
    data0 = jax.tree_util.tree_map(lambda a: a[0, :steps], setup["data"])
    jclient = jfederated.make_client_update(
        setup["japply"], setup["jloss"], jfederated.FedConfig(**fcfg))
    # jitted, returning the scores the spy saw while tracing
    (jmask, jfl, jm), seen["jax"] = jax.jit(
        lambda *a: (jclient(*a), seen["jax"]))(
        jst.weights, jst.floats, jst.theta, data0, key)
    tmask, tfl, tm = federated.make_client_update(
        setup["tapply"], setup["tloss"], federated.FedConfig(**fcfg))(
        tst.weights, tst.floats, tst.theta,
        tu.tree_map(lambda a: a[0, :steps], setup["tdata"]), None,
        _to_torch_u(u))
    js = [np.asarray(s) for s in jax.tree_util.tree_leaves(seen["jax"])]
    ts = [s.numpy() for s in tu.leaves(seen["torch"]) if s is not None]
    adam_tol = steps * 0.1 * 2.0 ** -8 if optimizer == "adam" else 0.0
    for a, b in zip(js, ts):
        _scale_close(b, a, 2e-5, adam_tol)
    for a, b in zip(jax.tree_util.tree_leaves(jfl),
                    [f for f in tu.leaves(tfl) if f is not None]):
        _scale_close(b.numpy(), a, 2e-5)
    _assert_mask_flips([m.numpy() for m in tu.leaves(tmask) if m is not None],
                       jax.tree_util.tree_leaves(jmask), u[-1], ts, js, 2)
    for k in ("loss", "data_loss", "reg"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    for k in ("uplink_bpp", "sparsity"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-3


def _theta_close(tt, jt, wn, max_diff):
    """theta leaves equal but at a few entries, each off by one client's
    weight (that client's mask bit flipped at the sigmoid boundary)."""
    n = 0
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    [t for t in tu.leaves(tt) if t is not None]):
        d = np.abs(b.numpy() - np.asarray(a))
        bad = d > 1e-6
        n += int(bad.sum())
        for v in d[bad]:
            assert np.isclose(v, wn, atol=1e-6).any(), v
    assert n <= max_diff, n


@pytest.fixture(scope="module")
def fedpm_sgd(setup):
    """fedpm_reg at lam 1 with sgd in both packages (one JAX compile for
    every participation case)."""
    kw = dict(lam=1.0, local_steps=H, lr=0.1, optimizer="sgd",
              float_lr=1e-3)
    return (japi.get_algorithm("fedpm_reg", setup["japply"], setup["jloss"],
                               **kw),
            api.get_algorithm("fedpm_reg", setup["tapply"], setup["tloss"],
                              **kw))


@pytest.mark.parametrize("part", [(1, 1, 1), (1, 0, 1)])
def test_round_matches_jax(setup, fedpm_sgd, part):
    """One fedpm_reg round (sgd, lam 1) from the same state, data and
    draws, with all clients or with client 1 dropped: the new theta and
    floats, the k-bit downlink's levels and every metric, each to its
    stated tolerance.  (Adam's scale-free steps move the scores enough
    between the packages for a later local step's mask to flip a bit;
    its one-step agreement is `test_client_update_matches_jax`.)"""
    jalgo, talgo = fedpm_sgd
    assert talgo.codec.name == jalgo.codec.name == "arithmetic"
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = convert.server_from_jax(_np(jst), "cpu")
    key = jax.random.PRNGKey(21)
    u = _to_torch_u(jax.jit(lambda k: _round_uniforms(
        k, _shapes(jst.theta)))(key))
    # the downlink the clients see
    jdl = japi.ProbBroadcast.from_theta(
        jst.theta, jax.random.fold_in(key, 0x0d0e), bits=8,
        floats=jst.floats)
    tdl = payloads.ProbBroadcast.from_theta(tst.theta, bits=8,
                                            floats=tst.floats,
                                            u=u["downlink"])
    for a, b in zip(jax.tree_util.tree_leaves(jdl.q),
                    [q for q in tu.leaves(tdl.q) if q is not None]):
        assert b.dtype == torch.uint8 and np.array_equal(b.numpy(), a)
    assert (tdl.wire_bits(), tdl.sidecar_bits(), tdl.num_params()) == (
        jdl.wire_bits(), jdl.sidecar_bits(), jdl.num_params())
    jpart = jnp.asarray(part, bool)
    jnew, jm = jalgo.round(jst, setup["data"], jpart,
                           jnp.asarray(setup["sizes"]), key)
    tnew, tm = talgo.round(tst, setup["tdata"], torch.tensor(part).bool(),
                           torch.from_numpy(setup["sizes"]), None, u)
    w = setup["sizes"] * np.asarray(part, np.float32)
    _theta_close(tnew.theta, jnew.theta, w / w.sum(), 2)
    for a, b in zip(jax.tree_util.tree_leaves(jnew.floats),
                    [f for f in tu.leaves(tnew.floats) if f is not None]):
        _scale_close(b.numpy(), a, 2e-5)
    assert (tnew.round, tnew.seed) == (int(jnew.round), int(jnew.seed))
    assert sorted(tm) == sorted(jm)
    for k in ("uplink_bits_measured", "downlink_bits", "downlink_bpp"):
        assert float(tm[k]) == float(jm[k]), k
    for k in ("uplink_bpp", "uplink_bpp_measured", "sparsity"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6, k
    for k in ("loss", "data_loss", "reg"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    # evaluation from the new state on the reference's draws
    ek = jax.random.PRNGKey(8)
    jacc = japi.evaluate(jalgo, jnew, setup["test"], setup["japply"],
                         setup["jmetric"], ek, n_samples=2)
    eu = [_to_torch_u(_split_uniforms(jax.random.fold_in(ek, i), [
        sh for sh in _shapes(jnew.theta) if sh is not None]))
        for i in range(2)]
    tacc = api.evaluate(talgo, tnew, setup["ttest"], setup["tapply"],
                        setup["tmetric"], n_samples=2, uniforms=eu)
    assert abs(float(tacc) - float(jacc)) <= 2 / 64   # two flipped argmax


def test_fedmask_round_matches_jax(setup):
    """One fedmask round: deterministic threshold masks, momentum on the
    scores, the float broadcast downlink (32 Bpp)."""
    jalgo = japi.get_algorithm("fedmask", setup["japply"], setup["jloss"],
                               lr=0.1, local_steps=H)
    talgo = api.get_algorithm("fedmask", setup["tapply"], setup["tloss"],
                              lr=0.1, local_steps=H)
    jst = jalgo.init(jax.random.PRNGKey(4), setup["params"])
    tst = convert.mask_state_from_jax(_np(jst), "cpu")
    part = jnp.ones((K,), bool)
    jnew, jm = jalgo.round(jst, setup["data"], part,
                           jnp.asarray(setup["sizes"]),
                           jax.random.PRNGKey(2))
    tnew, tm = talgo.round(tst, setup["tdata"], torch.ones(K).bool(),
                           torch.from_numpy(setup["sizes"]))
    w = setup["sizes"] / setup["sizes"].sum()
    theta = lambda sc: tu.tree_map(lambda s: None if s is None else
                                   torch.sigmoid(s), sc)
    _theta_close(theta(tnew.scores),
                 jax.tree_util.tree_map(jax.nn.sigmoid, jnew.scores), w, 2)
    assert tnew.round == int(jnew.round) == 1
    assert float(tm["downlink_bpp"]) == float(jm["downlink_bpp"]) == 32.0
    for k in ("uplink_bits_measured", "downlink_bits"):
        assert float(tm[k]) == float(jm[k]), k
    for k in ("uplink_bpp", "uplink_bpp_measured", "sparsity"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6, k


def test_registry_and_fedpm_is_fedpm_reg_at_lam_zero(setup):
    """The registry names the six algorithms as the reference does;
    "fedpm" is "fedpm_reg" at lam 0 (a lam it is given is dropped); an
    unknown name or codec raises, and so does a codec that cannot
    serialize masks."""
    assert api.available() == japi.available()
    assert set(api.available()) == {"fedpm", "fedpm_reg", "fedmask", "topk",
                                    "mv_signsgd", "fedavg"}
    kw = dict(local_steps=H, lr=0.1, optimizer="adam", float_lr=1e-3)
    a = api.get_algorithm("fedpm", setup["tapply"], setup["tloss"],
                          lam=5.0, **kw)
    b = api.get_algorithm("fedpm_reg", setup["tapply"], setup["tloss"],
                          lam=0.0, **kw)
    st = a.init(torch.Generator().manual_seed(0),
                convert.tree_to_torch(_np(setup["params"]), "cpu"))
    part = torch.ones(K).bool()
    sizes = torch.from_numpy(setup["sizes"])
    ra = a.round(st, setup["tdata"], part, sizes,
                 torch.Generator().manual_seed(1))
    rb = b.round(st, setup["tdata"], part, sizes,
                 torch.Generator().manual_seed(1))
    for x, y in zip(tu.leaves(ra[0].theta), tu.leaves(rb[0].theta)):
        assert (x is None and y is None) or torch.equal(x, y)
    assert float(ra[1]["reg"]) == float(rb[1]["reg"])
    assert 0.0 < float(ra[1]["uplink_bpp"]) <= 1.0
    with pytest.raises(KeyError):
        api.get_algorithm("top_k", setup["tapply"], setup["tloss"])
    with pytest.raises(KeyError):
        api.get_algorithm("fedpm", setup["tapply"], setup["tloss"],
                          codec="rice")
    with pytest.raises(ValueError):
        api.get_algorithm("fedpm", setup["tapply"], setup["tloss"],
                          codec="float32")
    assert api.get_algorithm("fedpm", setup["tapply"], setup["tloss"],
                             codec="golomb").codec.name == "golomb"
    assert api.get_algorithm("fedpm", setup["tapply"], setup["tloss"],
                             codec="bitpack").codec.name == "bitpack"


def test_stack_and_slice_payloads_round_trip():
    rng = np.random.default_rng(3)
    masks = [{"a": torch.from_numpy((rng.random((5, 7)) < .4).astype(
        np.uint8)), "b": None} for _ in range(3)]
    floats = [{"a": None, "b": torch.randn(4)} for _ in range(3)]
    pays = [payloads.BitpackedMasks.from_masks(m, f)
            for m, f in zip(masks, floats)]
    st = payloads.stack_payloads(pays)
    assert st.words["a"].shape == (3, 2) and st.floats["b"].shape == (3, 4)
    for i, p in enumerate(pays):
        s = payloads.slice_payload(st, i)
        assert torch.equal(s.words["a"], p.words["a"])
        assert torch.equal(s.floats["b"], p.floats["b"])
        assert s.shapes == p.shapes and s.words["b"] is None
    wn = torch.tensor([0.5, 0.25, 0.25])
    mean = payloads.batched_packed_mean(st, wn)["a"]
    want = sum(w * m["a"].float() for w, m in zip(wn, masks))
    assert torch.allclose(mean, want)
    fm = payloads.batched_float_mean(st.floats, wn)["b"]
    assert torch.allclose(fm, sum(w * f["b"] for w, f in zip(wn, floats)))
