"""The port's masking conventions against the JAX package: MaskSpec
decisions, tree flatten order (which feeds every mask seed), the stream
seed formula, MaskedLeaf offsets, and the identity of a layer-stacked
leaf's forward masks with its uplink words."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.core import regularizer as jregularizer
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, regularizer, tree
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

PATHS = ["layers/attn/w_q", "layers/attn_norm/scale", "embed/table",
         "lm_head/table", "ssm/D", "ssm/d_inner", "ssm/A_log", "rec/a_param",
         "x/dt_bias", "layers/mlp/w_down", "Unembed/W", "blk/router_w",
         "conv/w_conv", "head/LayerNorm/gamma", "moe/w_up", "DD/w"]


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("mask_embeddings", [False, True])
def test_maskspec_decisions_match(ndim, mask_embeddings):
    leaf = np.zeros((2,) * ndim, np.float32)
    js = jmasking.MaskSpec(mask_embeddings=mask_embeddings)
    ts = masking.MaskSpec(mask_embeddings=mask_embeddings)
    for p in PATHS:
        assert ts.is_masked(p, leaf) == js.is_masked(p, leaf), p


@pytest.fixture(scope="module")
def smoke_state():
    cfg = jget_config("internlm2-1.8b", smoke=True)
    api = jbuild_model(cfg)
    state = jsteps.init_fed_state(jax.random.PRNGKey(3), api,
                                  jmasking.MaskSpec(), C=2)
    np_state = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), state,
        is_leaf=lambda x: x is None)
    return state, np_state


def test_flatten_order_and_paths_match_jax(smoke_state):
    state, np_state = smoke_state
    for key in ("weights", "scores", "floats"):
        jflat = jax.tree_util.tree_flatten_with_path(
            state[key], is_leaf=lambda x: x is None)[0]
        jpaths = [jmasking._path_str(p) for p, _ in jflat]
        tflat = tree.flatten_with_paths(convert.tree_to_torch(np_state[key], "cpu"))
        assert [p for p, _ in tflat] == jpaths
        assert [l is None for _, l in tflat] == [l is None for _, l in jflat]
    # the port's own init builds the same tree with the same decisions
    params = build_model(get_config("internlm2-1.8b", smoke=True)).init_params(
        torch.Generator().manual_seed(0))
    mp = masking.init_masked(torch.Generator().manual_seed(0), params,
                             masking.MaskSpec())
    jw = jax.tree_util.tree_flatten_with_path(
        state["weights"], is_leaf=lambda x: x is None)[0]
    tw = tree.flatten_with_paths(mp.weights)
    assert [(p, l is None) for p, l in tw] == \
        [(jmasking._path_str(p), l is None) for p, l in jw]
    for (_, a), (_, b) in zip(tw, jw):
        if a is not None:
            assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16


def test_tree_ops_free_their_leaves_without_the_garbage_collector():
    """flatten, unflatten and tree_map leave no reference cycle behind:
    a cycle holding the leaves list would keep every tensor of a tree
    (a whole fed state, on the card) alive until the collector runs."""
    x = torch.zeros(4)
    alive = weakref.ref(x)
    gc.disable()
    try:
        tree.tree_map(lambda a: None if a is None else a + 1,
                      {"b": (x, None), "a": [x, {"c": x}]})
        del x
        assert alive() is None
    finally:
        gc.enable()


def test_mask_stream_seed_matches():
    for step in (0, 1, 7, 2**31 - 1):
        for dev in (0, 3):
            for leaf in (0, 2, 11, 1 << 20):
                for cohort in (0, 1, 5):
                    for run_seed in (0, 17, 0xFFFFFFFF):
                        j = int(jmasking.mask_stream_seed(
                            step, dev, leaf, cohort, run_seed=run_seed))
                        assert masking.mask_stream_seed(
                            step, dev, leaf, cohort, run_seed) == j


@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 8), (24, 16, 32)])
def test_masked_leaf_build_offsets_match(shape):
    w = np.zeros(shape, np.float32)
    jl = jmasking.MaskedLeaf.build(jnp.asarray(w), jnp.asarray(w), 12345)
    tl = masking.MaskedLeaf.build(torch.zeros(shape), torch.zeros(shape),
                                  12345)
    assert np.array_equal(tl.off, np.asarray(jl.off))
    assert np.array_equal(tl.seed, np.asarray(jl.seed))


def test_stacked_leaf_forward_masks_equal_uplink_words():
    """A layer-stacked leaf's per-layer forward masks (off = l*K*N) are
    exactly the bits sample_and_pack packs for the flat leaf under one
    seed — in the port, and up to sigmoid-boundary flips against JAX."""
    L, K, N, seed = 3, 24, 56, 31
    s = np.random.default_rng(3).normal(size=(L, K, N)).astype(np.float32)
    leaf = masking.MaskedLeaf.build(torch.ones(L, K, N), torch.from_numpy(s),
                                    seed)
    fwd = torch.stack([ops.masked_dense(torch.eye(K), blk.w, blk.s,
                                        int(blk.seed), int(blk.off))
                       for blk in (leaf.block(l) for l in range(L))])
    words = mm.sample_and_pack(torch.from_numpy(s).reshape(1, -1), [seed])
    up = ref.unpack_bits(words[0], L * K * N).reshape(L, K, N)
    assert torch.equal(fwd, up.float())
    jwords = np.asarray(jref.sample_and_pack(
        jnp.asarray(s.reshape(1, -1)), jnp.asarray([seed], jnp.uint32)))
    jm = np.asarray(jref.unpack_bits(jnp.asarray(jwords[0]), L * K * N))
    flips = int((up.reshape(-1).numpy() != jm).sum())
    assert flips <= 1, flips


def test_materialized_leaf_equals_fused_masks():
    """hash_effective's m*w uses the fused path's masks exactly."""
    L, K, N = 2, 8, 12
    s = torch.randn(L, K, N, generator=torch.Generator().manual_seed(1))
    w = torch.randn(L, K, N, generator=torch.Generator().manual_seed(2))
    leaf = masking.MaskedLeaf.build(w, s, 77)
    mp = masking.MaskedParams({"a": w, "b": None}, {"a": s, "b": None},
                              {"a": None, "b": torch.ones(3)})
    eff = masking.hash_effective(mp, lambda i: 77)["a"]
    for l in range(L):
        blk = leaf.block(l)
        m = ref.sample_mask(blk.s, int(blk.seed), int(blk.off))
        assert torch.equal(eff[l], m.float() * w[l])


def test_entropy_proxy_and_its_gradient_match():
    """eq. 12's proxy equals the reference's; the train step's in-place
    gradient (lam / n) sigmoid'(s) equals autograd of lam * proxy."""
    rng = np.random.default_rng(9)
    leaves = [rng.normal(size=(3, 4, 5)).astype(np.float32),
              rng.normal(size=(6, 7)).astype(np.float32)]
    tree_j = {"a": jnp.asarray(leaves[0]), "b": None,
              "c": jnp.asarray(leaves[1])}
    ts = [torch.from_numpy(l).requires_grad_() for l in leaves]
    tree_t = {"a": ts[0], "b": None, "c": ts[1]}
    p_t = regularizer.entropy_proxy(tree_t)
    p_j = float(jregularizer.entropy_proxy(tree_j))
    assert abs(float(p_t.detach()) - p_j) <= 1e-7
    lam = 3.0
    (lam * p_t).backward()
    n = sum(l.size for l in leaves)
    coef = torch.tensor(lam, dtype=torch.float32) / n
    for t in ts:
        g = torch.zeros_like(t)
        regularizer.entropy_proxy_grad_(g, t.detach(), coef)
        torch.testing.assert_close(g, t.grad, rtol=1e-6, atol=1e-9)
    h_t = float(regularizer.binary_entropy(torch.tensor(0.1234)))
    assert h_t == float(jregularizer.binary_entropy(jnp.float32(0.1234)))
