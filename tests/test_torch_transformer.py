"""The port's dense transformer against the JAX package: internlm2 SMOKE
logits and loss on the fused masked tree, from one state carried across
by `convert.state_from_jax`."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

RUN_SEED, STEP = 17, 3


@pytest.fixture(scope="module")
def both():
    cfg = jget_config("internlm2-1.8b", smoke=True)
    japi = jbuild_model(cfg)
    state = jsteps.init_fed_state(jax.random.PRNGKey(5), japi,
                                  jmasking.MaskSpec(), C=2)
    np_state = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), state,
        is_leaf=lambda x: x is None)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 2, 16))
    return japi, state, np_state, tokens


@pytest.mark.parametrize("cohort,mode", [(0, "sample"), (1, "threshold")])
def test_smoke_logits_and_loss_match_jax(both, cohort, mode):
    japi, state, np_state, tokens = both
    pick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t,
        is_leaf=lambda x: x is None)
    jmp = jmasking.MaskedParams(state["weights"], pick(state["scores"]),
                                pick(state["floats"]))
    jparams = jmasking.masked_forward_tree(
        jmp, lambda i: jmasking.mask_stream_seed(STEP, 0, i, cohort,
                                                 run_seed=RUN_SEED),
        mode=mode, tau=0.5)
    jbatch = {"tokens": jax.numpy.asarray(tokens[cohort], jax.numpy.int32)}
    jout = jax.jit(japi.forward)(jparams, jbatch)
    jlogits = np.asarray(jout[0])
    jloss = float(japi.loss(jout, jbatch))

    tstate = convert.state_from_jax(np_state, "cpu")
    api = build_model(get_config("internlm2-1.8b", smoke=True))
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tmp = MaskedParams(tstate["weights"], tpick(tstate["scores"]),
                       tpick(tstate["floats"]))
    tparams = masking.masked_forward_tree(
        tmp, lambda i: masking.mask_stream_seed(STEP, 0, i, cohort,
                                                RUN_SEED),
        mode=mode, tau=0.5)
    tbatch = {"tokens": torch.from_numpy(tokens[cohort])}
    with torch.no_grad():
        tout = api.forward(tparams, tbatch)
        tloss = float(api.loss(tout, tbatch))
    tlogits = tout[0].numpy()
    assert tlogits.shape == jlogits.shape == (2, 16, 256)
    # bf16 activations through 2 layers: each framework rounds its bf16
    # elementwise ops at its own points (the reference's jit and eager
    # runs of this forward differ by up to 2.3% of the logit scale, 0.2%
    # typically), so the bound is a few such roundings: 6% of the scale
    # at worst and 0.5% on average; the mean loss agrees to 0.2%
    scale = np.abs(jlogits).max()
    diff = np.abs(tlogits - jlogits)
    assert diff.max() <= 0.06 * scale, diff.max() / scale
    assert diff.mean() <= 0.005 * scale, diff.mean() / scale
    assert abs(tloss - jloss) <= 2e-3 * abs(jloss)
