"""The port's CNN path against the JAX package: the Bpp meters of eq. 13,
the STE functions, `sample_effective` in its three modes (the
reference's threefry uniforms injected), `masked_conv2d_apply` on plain
kernels and on `MaskedLeaf`s (the im2col through kernels 1-3), and the
paper's CNN (`models/cnn.py`) forward, loss, accuracy and score
gradients, with the CNN's MaskedParams carried across by `convert`.

Tolerances: integers (labels, masks, argmax) are equal; a mask bit may
flip only where its uniform lies between torch's and XLA's sigmoid of
the same score (1 ulp apart); f32 sums in another order agree to 1e-5
of their scale; a product rounded to bf16 (m * w of the materialized
path) to one bf16 ulp (2**-8 of its scale)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmasking
from repro.core import regularizer as jregularizer
from repro.models import cnn as jcnn
from repro.models import layers as jlayers

from repro_torch import convert
from repro_torch.core import masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.models import cnn, layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

_NONE = lambda x: x is None
QUICK = dict(name="quick", conv_planes=(8, 8), dense_sizes=(32,),
             n_classes=4, img_size=8)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.array(x), tree, is_leaf=_NONE)


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-7)


@pytest.fixture(scope="module")
def quick():
    """(JAX cfg, JAX MaskedParams, port cfg, port MaskedParams, images,
    labels) of the quickstart CNN."""
    jcfg = jcnn.ConvConfig(**QUICK)
    key = jax.random.PRNGKey(6)
    jmp = jax.jit(lambda k: jmasking.init_masked(
        k, jcnn.init_params(k, jcfg), jmasking.MaskSpec()))(key)
    tmp = convert.masked_params_from_jax(_np(jmp), "cpu")
    images = np.random.default_rng(0).standard_normal(
        (6, 8, 8, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1, 2], np.int32)
    return jcfg, jmp, cnn.ConvConfig(**QUICK), tmp, images, labels


def test_configs_and_param_layout_match(quick):
    for name in ("CONV4", "CONV6", "CONV10"):
        assert dataclasses_equal(getattr(cnn, name), getattr(jcnn, name))
    jcfg, jmp, cfg, tmp, *_ = quick
    jparams = jax.eval_shape(lambda k: jcnn.init_params(k, jcnn.CONV6),
                             jax.random.PRNGKey(0))
    tparams = cnn.init_params(torch.Generator().manual_seed(0), cnn.CONV6)
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl = tu.flatten_with_paths(tparams)
    assert [jmasking._path_str(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[1] == a.dtype.name
    # the masked leaves are the kernels, the biases stay float
    split = masking.split_params(tparams, masking.MaskSpec())
    jsplit = jmasking.split_params(jparams, jmasking.MaskSpec())
    assert tu.leaves(split) == jax.tree_util.tree_leaves(jsplit)
    # init_masked's fan-in quirk: a conv leaf's first dimension, 3
    w = tmp.weights["convs"][1]["w_conv"].float()
    assert torch.allclose(w.abs(), torch.full_like(w, (2 / 3) ** 0.5),
                          rtol=2 ** -8)


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in
               ("name", "conv_planes", "dense_sizes", "n_classes",
                "in_channels", "img_size"))


def test_bpp_meters_match_jax():
    rng = np.random.default_rng(1)
    mask = {"a": (rng.random((7, 5)) < 0.3).astype(np.uint8), "b": None,
            "c": [(rng.random(33) < 0.8).astype(np.uint8)]}
    scores = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": None, "c": [rng.standard_normal(33).astype(np.float32)]}
    jm = jax.tree_util.tree_map(lambda a: None if a is None else
                                jnp.asarray(a), mask, is_leaf=_NONE)
    js = jax.tree_util.tree_map(lambda a: None if a is None else
                                jnp.asarray(a), scores, is_leaf=_NONE)
    tm = convert.tree_to_torch(mask, "cpu")
    ts = convert.tree_to_torch(scores, "cpu")
    for f in ("empirical_entropy", "sparsity"):
        _close(getattr(regularizer, f)(tm), getattr(jregularizer, f)(jm),
               rel=2e-7)
    _close(regularizer.theta_entropy(ts), jregularizer.theta_entropy(js),
           rel=1e-6)
    assert float(regularizer.sparsity({"x": None})) == 0.0


@pytest.mark.parametrize("which", ["bernoulli", "threshold"])
def test_ste_forward_and_gradient_match_jax(which):
    rng = np.random.default_rng(2)
    theta = rng.random((9, 4)).astype(np.float32)
    u = rng.random((9, 4)).astype(np.float32)
    c = rng.standard_normal((9, 4)).astype(np.float32)
    if which == "bernoulli":
        jf = lambda th: jmasking.ste_bernoulli(th, jnp.asarray(u))
        tf = lambda th: masking.ste_bernoulli(th, _t(u))
    else:
        jf = lambda th: jmasking.ste_threshold(th, 0.45)
        tf = lambda th: masking.ste_threshold(th, 0.45)
    jm, jg = jax.value_and_grad(
        lambda th: jnp.sum(jf(th) * c * 1.0))(jnp.asarray(theta))
    th = _t(theta).requires_grad_()
    tm = tf(th)
    (tm * _t(c)).sum().backward()
    assert tm.dtype == torch.float32
    assert np.array_equal(tm.detach().numpy(), np.asarray(jf(theta)))
    assert np.array_equal(th.grad.numpy(), np.asarray(jg))   # dm/dth := 1


def _jax_uniforms(jmp, key):
    """The uniforms `jax sample_effective(mp, key)` draws, one a masked
    leaf in flatten order."""
    ws = [w for w in jax.tree_util.tree_leaves(jmp.weights, is_leaf=_NONE)
          if w is not None]
    keys = jax.random.split(key, max(len(ws), 1))
    return [np.array(jax.random.uniform(k, w.shape, dtype=jnp.float32))
            for k, w in zip(keys, ws)]


@pytest.mark.parametrize("mode", ["sample", "threshold", "expected"])
def test_sample_effective_matches_jax(quick, mode):
    """m * w leaf by leaf: equal where the masks agree, a flip only where
    u lies between the two sigmoids; the expected network to one bf16
    ulp (sigmoid(s) is rounded to bf16); the float leaves as they are;
    and the score gradient of sum(c * eff) to f32 rounding where the
    masks agree."""
    jcfg, jmp, cfg, tmp, *_ = quick
    key = jax.random.PRNGKey(4)
    us = _jax_uniforms(jmp, key)
    jeff = _np(jmasking.sample_effective(jmp, key, mode=mode, tau=0.55))
    teff = masking.sample_effective(tmp, mode=mode, tau=0.55,
                                    u=[torch.from_numpy(u) for u in us])
    jl = jax.tree_util.tree_leaves(jeff, is_leaf=_NONE)
    tl = tu.leaves(teff)
    masked = [s for s in jax.tree_util.tree_leaves(jmp.scores, is_leaf=_NONE)
              if s is not None]
    ui = iter(zip(us, masked))
    flips = 0
    for a, b in zip(jl, tl):
        assert str(b.dtype).split(".")[1] == a.dtype.name
        if a.ndim == 1:                       # a float leaf
            assert np.array_equal(b.numpy(), a)
            continue
        u, s = next(ui)
        a32, b32 = a.astype(np.float32), b.float().numpy()
        if mode == "expected":
            _close(b32, a32, rel=2 ** -8)
            continue
        diff = a32 != b32
        th_t = torch.sigmoid(torch.from_numpy(np.array(s))).numpy()
        th_j = np.asarray(jax.nn.sigmoid(jnp.asarray(s)))
        ref = u if mode == "sample" else np.full_like(u, 0.55)
        lo, hi = np.minimum(th_t, th_j), np.maximum(th_t, th_j)
        assert np.all((ref[diff] >= lo[diff]) & (ref[diff] <= hi[diff]))
        flips += int(diff.sum())
    assert flips <= 2
    # score gradients of sum(c * eff) through the STE
    cs = [np.random.default_rng(i).standard_normal(l.shape).astype(
        np.float32) for i, l in enumerate(jl)]

    def jloss(scores):
        e = jmasking.sample_effective(jmasking.MaskedParams(
            jmp.weights, scores, jmp.floats), key, mode=mode, tau=0.55)
        return sum(jnp.sum(l.astype(jnp.float32) * c) for l, c in
                   zip(jax.tree_util.tree_leaves(e), cs))

    jg = jax.tree_util.tree_leaves(jax.grad(jloss)(jmp.scores))
    sc = tu.tree_map(lambda s: None if s is None else
                     s.clone().requires_grad_(), tmp.scores)
    e = masking.sample_effective(masking.MaskedParams(
        tmp.weights, sc, tmp.floats), mode=mode, tau=0.55,
        u=[torch.from_numpy(u) for u in us])
    sum((l.float() * torch.from_numpy(c)).sum()
        for l, c in zip(tu.leaves(e), cs)).backward()
    tg = [s.grad.numpy() for s in tu.leaves(sc) if s is not None]
    for a, b in zip(jg, tg):
        _close(b, a, rel=2e-6)


@pytest.mark.parametrize("kh,kw", [(3, 3), (2, 2), (1, 3)])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_masked_conv2d_plain_matches_jax(kh, kw, wdt):
    """A plain kernel: SAME, stride 1, NHWC/HWIO, on a non-square image
    (an even kernel pads one more at the end, as XLA's SAME does)."""
    rng = np.random.default_rng(kh * 10 + kw)
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    w = rng.standard_normal((kh, kw, 3, 4)).astype(np.float32)
    w = np.asarray(jnp.asarray(w).astype(wdt))
    want = np.asarray(jlayers.masked_conv2d_apply(jnp.asarray(x),
                                                  jnp.asarray(w)))
    got = layers.masked_conv2d_apply(_t(x), _t(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_masked_conv2d_maskedleaf_matches_jax(mode):
    """A `MaskedLeaf` kernel: the im2col into one fused masked dense
    (plain versions of kernels 1-3 here; the reference's Pallas kernels in
    interpret mode), the output and the score gradient of sum(c * y) to
    f32 rounding of the sums, the mask the leaf's flat stream at off 0."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = np.sign(rng.standard_normal((3, 3, 4, 8))).astype(np.float32)
    w = np.asarray(jnp.asarray(w * 0.3).astype(jnp.bfloat16))
    s = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    c = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)

    def jf(s_):
        leaf = jmasking.MaskedLeaf.build(jnp.asarray(w), s_, 77, mode, 0.4)
        return jlayers.masked_conv2d_apply(jnp.asarray(x), leaf)

    jy = np.asarray(jf(jnp.asarray(s)))
    jg = np.asarray(jax.grad(lambda s_: jnp.sum(jf(s_) * c))(jnp.asarray(s)))
    ts = _t(s).requires_grad_()
    ty = layers.masked_conv2d_apply(
        _t(x), masking.MaskedLeaf.build(_t(w), ts, 77, mode, 0.4))
    (ty * _t(c)).sum().backward()
    _close(ty.detach().numpy(), jy)
    _close(ts.grad.numpy(), jg)
    # the fused conv equals the plain conv of the materialized leaf, whose
    # mask is the leaf's flat hash stream
    eff = masking.materialize_leaf(
        masking.MaskedLeaf.build(_t(w), _t(s), 77, mode, 0.4))
    _close(layers.masked_conv2d_apply(_t(x), eff).numpy(),
           ty.detach().numpy())


def _loss_and_grads(fwd, scores, images, labels):
    jax_ = isinstance(images, jax.Array)
    if jax_:
        def f(sc):
            logits = fwd(sc)
            return jcnn.ce_loss(logits, {"labels": labels}), logits
        (loss, logits), g = jax.value_and_grad(f, has_aux=True)(scores)
        return float(loss), np.asarray(logits), [
            np.asarray(a) for a in jax.tree_util.tree_leaves(g)]
    sc = tu.tree_map(lambda s: None if s is None else
                     s.clone().requires_grad_(), scores)
    logits = fwd(sc)
    loss = cnn.ce_loss(logits, {"labels": labels})
    loss.backward()
    return float(loss.detach()), logits.detach().numpy(), [
        s.grad.numpy() for s in tu.leaves(sc) if s is not None]


def test_cnn_forward_loss_and_score_grads_match_jax(quick):
    """The fused tree (every conv and dense a `MaskedLeaf`): logits, CE
    loss, accuracy and the score gradients of the port equal the
    reference's to f32 rounding of the sums (1e-5 of each scale); and,
    as `tests/test_archs.py` holds the reference, the port's fused tree
    agrees with its materialized twin (`hash_effective`) within 5% of
    the gradient scale (the twin rounds x^T g through the bf16 m * w)."""
    jcfg, jmp, cfg, tmp, images, labels = quick
    jseed = lambda i: jmasking.mask_stream_seed(0, 0, i, 0, run_seed=9)
    tseed = lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=9)
    ji, jlab = jnp.asarray(images), jnp.asarray(labels)
    ti, tlab = _t(images), _t(labels).long()
    jl, jlog, jg = _loss_and_grads(
        lambda sc: jcnn.forward(jmasking.masked_forward_tree(
            jmasking.MaskedParams(jmp.weights, sc, jmp.floats), jseed),
            jcfg, ji), jmp.scores, ji, jlab)
    tl, tlog, tg = _loss_and_grads(
        lambda sc: cnn.forward(masking.masked_forward_tree(
            masking.MaskedParams(tmp.weights, sc, tmp.floats), tseed),
            cfg, ti), tmp.scores, ti, tlab)
    _close(tlog, jlog)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for a, b in zip(jg, tg):
        _close(b, a)
    assert float(cnn.accuracy(torch.from_numpy(tlog), {"labels": tlab})) \
        == float(jcnn.accuracy(jnp.asarray(jlog), {"labels": jlab}))
    # the port's fused tree against its own materialized twin
    hl, hlog, hg = _loss_and_grads(
        lambda sc: cnn.forward(masking.hash_effective(
            masking.MaskedParams(tmp.weights, sc, tmp.floats), tseed),
            cfg, ti), tmp.scores, ti, tlab)
    _close(hlog, tlog)
    assert abs(hl - tl) <= 1e-6 * abs(tl)
    for a, b in zip(tg, hg):
        assert np.abs(a - b).max() <= 0.05 * np.abs(b).max() + 1e-5


def test_cnn_plain_forward_matches_jax(quick):
    """Plain effective params (the host-sim path): the same logits as the
    reference's lax conv path, to f32 rounding."""
    jcfg, jmp, cfg, tmp, images, _ = quick
    key = jax.random.PRNGKey(4)
    us = [torch.from_numpy(u) for u in _jax_uniforms(jmp, key)]
    want = jcnn.forward(jmasking.sample_effective(jmp, key), jcfg,
                        jnp.asarray(images))
    got = cnn.forward(masking.sample_effective(tmp, u=us), cfg, _t(images))
    _close(got.detach().numpy(), want)
