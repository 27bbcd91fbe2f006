"""The port's optimizer library (`repro_torch.optim`) against the JAX
package's: every optimizer, clip, chain and schedule over 5 steps of the
same numpy gradients on a tree with a None leaf and a bf16 leaf, to f32
rounding (rtol 1e-5) on the f32 leaves and within 4 bf16 ulps of the
leaf's scale (2**-6 of its largest value) on the bf16 one: JAX rounds a Python scalar such as lr to bf16
before it multiplies a bf16 leaf, torch keeps it in f32."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.optim import optimizers as topt
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

STEPS = 5


def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": None,
            "c": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16)]}


def _j(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else jnp.asarray(a), tree,
        is_leaf=lambda x: x is None)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), tree,
        is_leaf=lambda x: x is None)


def _close(got, want):
    assert got["b"] is None
    for g, w in [(got["a"], want["a"])] + list(zip(got["c"], want["c"])):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        if g.shape == (2, 2):   # the bf16 leaf
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2.0 ** -6 * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


CASES = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.05),
    "nesterov": lambda m: m.momentum(0.05, nesterov=True),
    "adam": lambda m: m.adam(0.1),
    "adamw": lambda m: m.adamw(0.1, weight_decay=0.05),
    "clip_then_adam": lambda m: m.chain(m.clip_by_global_norm(0.5),
                                        m.adam(0.01)),
    "sched_cosine": lambda m: m.scale_by_schedule(
        m.sgd, m.cosine_schedule(0.2, 4)),
    "sched_warmup": lambda m: m.scale_by_schedule(
        lambda lr: m.momentum(lr), m.warmup_cosine(0.2, 2, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_jax_over_steps(name):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jo, to = CASES[name](jopt), CASES[name](topt)
    jp, tp = _j(params), convert.tree_to_torch(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(_j(g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu_, ts = to.update(convert.tree_to_torch(g, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu_)
        assert tp["c"][1].dtype == torch.bfloat16
        _close(tu_, _np(ju))
        _close(tp, _np(jp))


@pytest.mark.parametrize("sched", ["cosine", "warmup"])
def test_schedules_match_jax(sched):
    mk = {"cosine": lambda m: m.cosine_schedule(0.3, 7, 0.2),
          "warmup": lambda m: m.warmup_cosine(0.3, 3, 11)}[sched]
    jf, tf = mk(jopt), mk(topt)
    for step in range(14):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = float(tf(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * abs(want) + 1e-9, (step, got, want)


def test_clip_by_global_norm_scales_to_the_norm():
    clip = topt.clip_by_global_norm(1.0)
    upd, _ = clip.update({"a": torch.tensor([3.0, 4.0]), "b": None}, ())
    assert abs(float(torch.linalg.norm(upd["a"])) - 1.0) < 1e-6
    assert upd["b"] is None
    small = {"a": torch.tensor([0.3, 0.4])}
    assert torch.equal(clip.update(small, ())[0]["a"], small["a"])
