"""The float reference (`--algo fedavg`) against the JAX package: two
`make_fedavg_step`s on internlm2 SMOKE from one state carried across by
`convert.fedavg_state_from_jax` (attention whole or in KV chunks), the
launch registry's names, and the launcher's fedavg run on the CPU.

Tolerance: the params are cast to f32, so every activation and update
is f32 and only the order of the sums differs: the losses to 1e-5 and
each leaf of the params and of the f32 momentum within a relative norm
of 1e-4 of its update (measured up to 7.1e-6)."""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import api as japi_registry
from repro.configs import get_config as jget_config
from repro.launch import plans as jplans  # noqa: F401  (registers plans)
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch import convert
from repro_torch.api import registry
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.kernels import dispatch
from repro_torch.launch import plans  # noqa: F401  (registers plans)
from repro_torch.launch import steps, train
from repro_torch.models import build_model, layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH = "internlm2-1.8b"
_NONE = lambda x: x is None


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def test_launchable_equals_the_reference():
    assert registry.launchable() == japi_registry.launchable()
    assert "fedavg" in registry.launchable()


def test_two_fedavg_steps_match_jax():
    _two_steps_match(None)


def test_fedavg_steps_with_chunk_kv_match_jax(monkeypatch):
    """`StepConfig.chunk_kv` reaches the fedavg step's forward: every
    attention runs over chunks of 8 of the 16 keys, as the reference's
    step runs it."""
    chunks = []
    real = layers.attention_core

    def recorded(*a, **k):
        chunks.append(inspect.signature(real).bind(*a, **k).arguments.get(
            "chunk_kv"))
        return real(*a, **k)

    monkeypatch.setattr(layers, "attention_core", recorded)
    _two_steps_match(8)
    assert chunks and set(chunks) == {8}


def _two_steps_match(chunk_kv):
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    tapi = build_model(get_config(ARCH, smoke=True))
    jstate = jax.jit(lambda k: jsteps.init_fedavg_state(k, japi))(
        jax.random.PRNGKey(3))
    jstate["params"] = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jstate["params"])
    tstate = convert.fedavg_state_from_jax(_np(jstate), "cpu")
    assert tstate["step"] == 0
    p0 = [np.asarray(p) for p in jax.tree_util.tree_leaves(jstate["params"])]
    cfg = dict(lr=0.3, momentum=0.9, chunk_kv=chunk_kv)
    jstep = jax.jit(jsteps.make_fedavg_step(japi, jsteps.StepConfig(**cfg)))
    tstep = steps.make_fedavg_step(tapi, steps.StepConfig(**cfg))
    rng = np.random.default_rng(0)
    dispatch.reset_launch_counts()
    for _ in range(2):
        tokens = rng.integers(0, 256, (2, 16))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= 1e-5 * abs(float(jm["loss"]))
    assert not any(dispatch.LAUNCHES.values())
    assert tstate["step"] == int(jstate["step"]) == 2
    jp = [np.asarray(p) for p in jax.tree_util.tree_leaves(jstate["params"])]
    tp = [p.numpy() for p in tree.leaves(tstate["params"])]
    jm_ = [np.asarray(m) for m in jax.tree_util.tree_leaves(jstate["opt_m"])]
    tm_ = [m.numpy() for m in tree.leaves(tstate["opt_m"])]
    assert len(tp) == len(jp) == len(p0) == len(tm_) == len(jm_)
    for a0, a, b in zip(p0, jp, tp):
        assert b.dtype == np.float32
        upd = np.linalg.norm(a - a0)
        assert upd > 0 and np.linalg.norm(b - a) <= 1e-4 * upd
    for a, b in zip(jm_, tm_):
        assert b.dtype == np.float32
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a)


def test_launcher_trains_fedavg_on_cpu(capsys):
    """`--algo fedavg`: no round, a loss line every 10 steps, `done`, no
    kernel launches (plain float weights)."""
    dispatch.reset_launch_counts()
    out = train.main(["--algo", "fedavg", "--smoke", "--device", "cpu",
                      "--steps", "10", "--round-every", "2", "--batch", "2",
                      "--seq", "16"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done"
    assert [l for l in lines if re.match(r"step \d+: loss=", l)] == [
        f"step 10: loss={out['losses'][-1]:.3f}"]
    assert len(out["losses"]) == 10 and not out["rounds"]
    assert all(np.isfinite(v) for v in out["losses"])
    assert not any(dispatch.LAUNCHES.values())
