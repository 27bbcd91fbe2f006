"""The port's baselines (topk, mv_signsgd, fedavg; `api.algorithms`)
against the JAX package on the quickstart CNN (`examples/quickstart.py`:
Conv 8-8, dense 32, 4 classes, 8x8 images), with the reference's
threefry draws injected: topk's mask uniforms and mv_signsgd's
zero-gradient coins (the uniforms under `jax.random.rademacher`).  Also
the registry, the `core.baselines` shim and the launcher's `--codec`.

Tolerances: integers (mask and sign words, bit counts) are equal but
where the two packages' f32 sums land on the other side of a boundary:
a topk mask bit only where the score lies within the score tolerance of
the threshold, a sign only where the summed gradient is within 1e-3 of
its leaf's scale of zero.  Scores after H momentum steps agree to 2e-5
of their scale (bf16 m * w rounds the STE gradient, as in
test_torch_hostsim.py).  The CNN's weights are bf16: a bf16 leaf after
fedavg's momentum steps or a sign step may sit one bf16 ulp off
(2**-8 of its magnitude, the rounding of f32 sums taken in another
order), so bf16 leaves are held to one ulp of their scale and f32
leaves (the biases) to 1e-5 of theirs; the f32 deltas fedavg sends to
the bf16 ulp of the weight they move.  Losses agree to 1e-5 relative,
f32 meters to 1e-6, and bit counts exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import codecs as jcodecs
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn

from repro_torch import api, convert
from repro_torch.api import algorithms, payloads
from repro_torch.core import baselines
from repro_torch.core import tree as tu
from repro_torch.launch import train
from repro_torch.models import cnn
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

_NONE = lambda x: x is None
QUICK = dict(name="quick", conv_planes=(8, 8), dense_sizes=(32,),
             n_classes=4, img_size=8)
K, H, B = 3, 2, 16
BF16_ULP = 2.0 ** -8


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x), tree, is_leaf=_NONE)


def _to_torch_u(u):
    if isinstance(u, dict):
        return {k: _to_torch_u(v) for k, v in u.items()}
    if isinstance(u, list):
        return [_to_torch_u(v) for v in u]
    return torch.from_numpy(np.array(u))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _leaf_close(got, want, rel=1e-5):
    """f32 leaves to `rel` of their scale, bf16 leaves to one bf16 ulp of
    their scale."""
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        rel = max(rel, BF16_ULP)
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= rel * float(np.abs(w).max()) + 1e-7, (err, rel)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jcnn.ConvConfig(**QUICK), cnn.ConvConfig(**QUICK)
    key = jax.random.PRNGKey(0)
    x, y = jax.jit(lambda k: (lambda t: (t.x, t.y))(
        jsynthetic.make_image_task(k, n=256, img=8, n_classes=4,
                                   noise=0.35)))(key)
    task = jsynthetic.ImageTask(x, y, 4)
    cidx = jpartition.partition_by_class(np.random.default_rng(0),
                                         np.asarray(task.y), K, 2)
    data = jsynthetic.federated_batches(jax.random.PRNGKey(1), task, cidx,
                                        K, H, B)
    tdata = {"images": torch.from_numpy(np.array(data["images"])),
             "labels": torch.from_numpy(np.array(data["labels"])).long()}
    params = jax.jit(lambda k: jcnn.init_params(k, jcfg))(key)
    sizes = np.array([len(c) for c in cidx], np.float32)
    return dict(
        params=params, data=data, tdata=tdata, sizes=sizes,
        japply=lambda p, b: jcnn.forward(p, jcfg, b["images"]),
        jloss=jcnn.ce_loss,
        tapply=lambda p, b: cnn.forward(p, cfg, b["images"]),
        tloss=cnn.ce_loss)


def _pair(setup, name, **kw):
    return (japi.get_algorithm(name, setup["japply"], setup["jloss"], **kw),
            api.get_algorithm(name, setup["tapply"], setup["tloss"], **kw))


def _coins(key, leaves):
    """mv_signsgd's draws: `fold_in(key, 1)` split over the gradient
    leaves, the uniforms `rademacher` thresholds at 0.5."""
    keys = jax.random.split(jax.random.fold_in(key, 1), max(len(leaves), 1))
    return [jax.random.uniform(k, l.shape) for k, l in zip(keys, leaves)]


def _topk_uniforms(key, masked_shapes):
    keys = jax.random.split(key, H)
    out = []
    for t in range(H):
        ks = jax.random.split(keys[t], max(len(masked_shapes), 1))
        out.append([jax.random.uniform(k, sh)
                    for k, sh in zip(ks, masked_shapes)])
    return out


def _masked_shapes(jst):
    return [s.shape for s in jax.tree_util.tree_leaves(jst.scores)]


def _words(payload):
    return [w.numpy() for w in tu.leaves(payload.words) if w is not None]


def test_rademacher_is_the_uniform_coin():
    """The convention the port's coin rests on: `rademacher` is +1 exactly
    where `uniform` on the same key is below 0.5."""
    k = jax.random.PRNGKey(9)
    r = np.asarray(jax.random.rademacher(k, (1000,), jnp.float32))
    u = np.asarray(jax.random.uniform(k, (1000,)))
    assert np.array_equal(r, np.where(u < 0.5, 1.0, -1.0))


@pytest.mark.parametrize("n", (1, 2, 7, 1000, 33333))
def test_quantile_matches_jnp_quantile(n):
    """topk's threshold against `jnp.quantile` (linear, f32) on the same
    scores: within one f32 ulp (XLA's CPU code fuses the interpolation's
    high term into an FMA on hardware that has one, which the port
    follows; without it the two may part by that ulp)."""
    rng = np.random.default_rng(n)
    for rep in range(4):
        x = rng.standard_normal(n).astype(np.float32)
        for k_frac in (0.3, 0.1, 0.5, 0.99, 1.0):
            want = np.asarray(jnp.quantile(jnp.asarray(x), 1.0 - k_frac))
            got = algorithms._quantile_f32(torch.from_numpy(x),
                                           1.0 - k_frac)
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= float(
                np.spacing(np.abs(want))), (n, k_frac)


def test_topk_client_update_matches_jax(setup, monkeypatch):
    """One topk client from the same scores, data and mask uniforms: the
    scores the threshold is taken over, the threshold, the mask words and
    the metrics."""
    jalgo, talgo = _pair(setup, "topk", k_frac=0.3, lr=0.1, local_steps=H)
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = convert.mask_state_from_jax(_np(jst), "cpu")
    key = jax.random.PRNGKey(5)
    u = jax.jit(lambda k: _topk_uniforms(k, _masked_shapes(jst)))(key)
    seen = {}
    orig_q = jnp.quantile
    monkeypatch.setattr(jnp, "quantile", lambda a, q: seen.setdefault(
        "jax", (a, orig_q(a, q)))[1])
    orig_t = algorithms._quantile_f32
    monkeypatch.setattr(algorithms, "_quantile_f32", lambda f, q:
                        seen.setdefault("torch", (f.numpy(), orig_t(f, q)))[1])
    data0 = jax.tree_util.tree_map(lambda a: a[0], setup["data"])
    # the reference's client draws split(key, H)[t] for step t
    # jitted, returning what the spy saw while tracing
    (jpay, jm), seen["jax"] = jax.jit(
        lambda *a: (jalgo.client_update(*a), seen["jax"]))(jst, data0, key)
    tpay, tm = talgo.client_update(
        tst, tu.tree_map(lambda a: a[0], setup["tdata"]), None,
        _to_torch_u(u))
    js, jkth = (np.asarray(v) for v in seen["jax"])
    ts, tkth = seen["torch"]
    _leaf_close(ts, js, 2e-5)
    tol = 2e-5 * float(np.abs(js).max())
    assert abs(float(tkth) - float(jkth)) <= tol
    flips = 0
    for a, b in zip(jax.tree_util.tree_leaves(jpay.words), _words(tpay)):
        a = np.asarray(a).view(np.int32)
        diff = np.unpackbits(np.bitwise_xor(a, b).view(np.uint8)).sum()
        flips += int(diff)
    near = int((np.abs(ts - float(tkth)) <= 2 * tol).sum())
    assert flips <= near, (flips, near)
    assert tpay.shapes == jpay.shapes
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["sparsity"]) - float(jm["sparsity"])) <= \
        flips / ts.size + 1e-6
    # the uplink keeps ~k_frac of the scores (ties are at the threshold)
    assert abs((1.0 - float(tm["sparsity"])) - 0.3) <= 1.0 / ts.size + 1e-6


def _summed_grads(setup, tparams, tdata0):
    """The port's f32 gradient sums at `tparams` over the H batches."""
    acc = None
    for t in range(H):
        _, g = algorithms._float_grads(setup["tapply"], setup["tloss"],
                                       tparams, tu.tree_map(lambda v: v[t],
                                                            tdata0))
        g = [x.float() for x in tu.leaves(g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    return acc


def test_mv_signsgd_client_update_matches_jax(setup):
    """One mv_signsgd client from the same params, data and coins: the sign
    words (a bit may differ only where the summed gradient is within 1e-3
    of its leaf's scale of zero), exact zeros take the injected coin, and
    the metrics; 1 Bpp."""
    jalgo, talgo = _pair(setup, "mv_signsgd", lr=1e-3, local_steps=H)
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = convert.float_state_from_jax(_np(jst), "cpu")
    key = jax.random.PRNGKey(7)
    u = _coins(key, jax.tree_util.tree_leaves(jst.params))
    data0 = jax.tree_util.tree_map(lambda a: a[0], setup["data"])
    tdata0 = tu.tree_map(lambda a: a[0], setup["tdata"])
    jpay, jm = jax.jit(jalgo.client_update)(jst, data0, key)
    tpay, tm = talgo.client_update(tst, tdata0, None, _to_torch_u(u))
    assert type(tpay) is payloads.SignVotes and tpay.shapes == jpay.shapes
    g = _summed_grads(setup, tst.params, tdata0)
    zeros = 0
    for a, b, gl, uu in zip(jax.tree_util.tree_leaves(jpay.words),
                            _words(tpay), g, u):
        n = gl.numel()
        jb = np.unpackbits(np.asarray(a).view(np.uint8),
                           bitorder="little")[:n]
        tb = np.unpackbits(b.view(np.uint8), bitorder="little")[:n]
        gn = gl.reshape(-1).numpy()
        diff = jb != tb
        assert np.all(np.abs(gn[diff]) <= 1e-3 * np.abs(gn).max()), \
            "sign flip off zero"
        z = gn == 0.0
        zeros += int(z.sum())
        coin = np.asarray(uu).reshape(-1) < 0.5
        assert np.array_equal(tb[z].astype(bool), coin[z])
    assert zeros > 0        # dead units: the coin is exercised
    assert float(tpay.bpp()) == float(jpay.bpp()) == 1.0
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert float(tm["sparsity"]) == 0.0


def test_mv_signsgd_coin_from_the_generator_is_fair():
    """Without injected draws the coin comes from the generator: exact-zero
    gradients vote +1 and -1 about equally, never -1 by default."""
    lin = {"w": torch.zeros(64, 64)}
    apply_fn = lambda p, b: b["x"] @ p["w"]
    loss_fn = lambda out, b: (out * 0.0).sum()   # every gradient is 0
    algo = api.get_algorithm("mv_signsgd", apply_fn, loss_fn)
    data = {"x": torch.ones(1, 2, 64)}
    pay, _ = algo.client_update(algorithms.FloatState(lin, 0), {
        "x": data["x"][0][None]}, torch.Generator().manual_seed(0))
    share = float(pay.to_signs()["w"].eq(1.0).float().mean())
    assert 0.45 <= share <= 0.55, share


def test_fedavg_client_update_matches_jax(setup):
    """One fedavg client (momentum on the bf16 weights and f32 biases):
    the f32 deltas, the bits (32 a parameter) and the last step's loss.
    A weight after a step may sit one bf16 ulp off the reference's (XLA
    rounds the momentum update's bf16 products in other places), so a
    weight's delta is held to 2**-7 of the weight leaf's scale (one ulp
    of its largest binade), and what a later step computes through those
    weights (the biases' deltas, the loss) to 2**-8 of its scale and
    1e-3 relative."""
    jalgo, talgo = _pair(setup, "fedavg", lr=0.05, local_steps=H)
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = convert.float_state_from_jax(_np(jst), "cpu")
    data0 = jax.tree_util.tree_map(lambda a: a[0], setup["data"])
    jpay, jm = jax.jit(jalgo.client_update)(jst, data0,
                                            jax.random.PRNGKey(0))
    tpay, tm = talgo.client_update(
        tst, tu.tree_map(lambda a: a[0], setup["tdata"]), None)
    assert type(tpay) is payloads.FloatDeltas
    assert (tpay.shapes, tpay.bits) == (jpay.shapes, jpay.bits)
    assert float(tpay.bpp()) == float(jpay.bpp()) == 32.0
    for a, b, p in zip(jax.tree_util.tree_leaves(jpay.values),
                       [v for v in tu.leaves(tpay.values) if v is not None],
                       tu.leaves(tst.params)):
        assert b.dtype == torch.float32
        scale = float(p.float().abs().max()) if p.dtype == torch.bfloat16 \
            else float(np.abs(np.asarray(a)).max())
        rel = 2 * BF16_ULP if p.dtype == torch.bfloat16 else BF16_ULP
        assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= \
            rel * scale + 1e-7
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-3 * abs(float(jm["loss"]))


def _round_uniforms(name, key, jst):
    """Client k's draws from `split(key, K)[k]`, as the reference's round
    hands them out (the float downlink draws nothing)."""
    ck = jax.random.split(key, K)
    if name == "topk":
        return {"clients": [_topk_uniforms(ck[k], _masked_shapes(jst))
                            for k in range(K)]}
    leaves = jax.tree_util.tree_leaves(jst.params)
    return {"clients": [_coins(ck[k], leaves) for k in range(K)]}


@pytest.mark.parametrize("name,kw", [
    ("topk", dict(k_frac=0.3, lr=0.1)),
    ("mv_signsgd", dict(lr=1e-3)),
    ("fedavg", dict(lr=0.05)),
])
def test_round_matches_jax(setup, name, kw):
    """One round of each baseline from the same state, data and draws,
    client 1 dropped: the meters (`uplink_bpp`, `uplink_bpp_measured`,
    `uplink_bits_measured`, the downlink's bits and Bpp) and the new
    state.  topk's theta is held as test_torch_hostsim.py holds fedpm's
    (equal but where a client's bit flipped, each such entry off by that
    client's weight); mv_signsgd's params move by lr against the vote, a
    weight off by a flipped vote or a bf16 ulp; fedavg's params to one
    bf16 ulp of the weight leaf's scale (the f32 biases, stepped through
    bf16 weights, to 2**-8 of theirs)."""
    jalgo, talgo = _pair(setup, name, local_steps=H, **kw)
    jst = jalgo.init(jax.random.PRNGKey(3), setup["params"])
    tst = (convert.mask_state_from_jax if name == "topk" else
           convert.float_state_from_jax)(_np(jst), "cpu")
    key = jax.random.PRNGKey(21)
    u = _to_torch_u(jax.jit(lambda k: _round_uniforms(name, k, jst))(key))
    part = (1, 0, 1)
    jnew, jm = jalgo.round(jst, setup["data"], jnp.asarray(part, bool),
                           jnp.asarray(setup["sizes"]), key)
    tnew, tm = talgo.round(tst, setup["tdata"], torch.tensor(part).bool(),
                           torch.from_numpy(setup["sizes"]), None, u)
    assert talgo.codec.name == jalgo.codec.name
    assert sorted(tm) == sorted(jm)
    for k in ("uplink_bits_measured", "downlink_bits", "downlink_bpp"):
        assert float(tm[k]) == float(jm[k]), k
    for k in ("uplink_bpp", "uplink_bpp_measured", "sparsity"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6, k
    assert tnew.round == int(jnew.round) == 1
    w = setup["sizes"] * np.asarray(part, np.float32)
    wn = w / w.sum()
    if name == "topk":
        flips = 0
        for a, b in zip(jax.tree_util.tree_leaves(jnew.scores),
                        [s for s in tu.leaves(tnew.scores) if s is not None]):
            d = np.abs(torch.sigmoid(b).numpy()
                       - np.asarray(jax.nn.sigmoid(a)))
            bad = d > 1e-6
            flips += int(bad.sum())
            assert all(np.isclose(v, wn, atol=1e-6).any() for v in d[bad])
        assert flips <= 2, flips
        return
    n_bad = 0
    for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                    tu.leaves(tnew.params)):
        a = np.asarray(a).astype(np.float32)
        g = b.float().numpy()
        scale = float(np.abs(a).max())
        if name == "mv_signsgd":
            bad = np.abs(g - a) > 2 * BF16_ULP * np.abs(a) + 1e-7
            n_bad += int(bad.sum())
            assert np.all(np.abs(g - a)[bad] <= 2 * kw["lr"] * 1.01)
        else:
            rel = 2 * BF16_ULP if b.dtype == torch.bfloat16 else BF16_ULP
            assert float(np.abs(g - a).max()) <= rel * scale + 1e-7
    assert n_bad <= 8, n_bad
    if name == "mv_signsgd":
        n = sum(p.numel() for p in tu.leaves(tst.params))
        assert float(tm["uplink_bpp"]) == 1.0
        assert float(tm["uplink_bpp_measured"]) == np.float32(
            32 * ((n + 31) // 32) / n)
    else:
        assert float(tm["uplink_bpp"]) == float(
            tm["uplink_bpp_measured"]) == 32.0


def test_registry_shim_and_launcher_codecs(setup):
    """The registry holds the reference's six; the `baselines` shim's four
    factories resolve to the registered algorithms with their
    hyperparameters; the codecs and the launcher's --codec choices equal
    the reference's (every codec but float32,
    `src/repro/launch/train.py:45-48`)."""
    assert api.available() == japi.available() == (
        "fedavg", "fedmask", "fedpm", "fedpm_reg", "mv_signsgd", "topk")
    assert api.available_codecs() == japi.available_codecs()
    a, f = setup["tapply"], setup["tloss"]
    for algo, name, codec in (
            (baselines.fedavg(a, f, lr=0.1), "fedavg", "float32"),
            (baselines.mv_signsgd(a, f), "mv_signsgd", "signpack"),
            (baselines.topk_mask(a, f, None, k_frac=0.2), "topk",
             "arithmetic"),
            (baselines.fedmask(a, f, None, tau=0.4), "fedmask",
             "arithmetic")):
        assert isinstance(algo, baselines.Algorithm)
        assert (algo.name, algo.codec.name) == (name, codec)
        assert algo.payload_spec is api.get_entry(name).payload_spec
    want = [c for c in jcodecs.available() if c != "float32"]
    for c in api.available_codecs():
        if c in want:
            assert train.parse_args(["--codec", c]).codec == c
        else:
            with pytest.raises(SystemExit):
                train.parse_args(["--codec", c])
