"""The port's grouped masked matmul, MoE and MLA layers against the JAX
package on the CPU.

The grouped plain versions must draw the JAX oracles' masks (up to the
1-ulp sigmoid boundary flips explained in tests/test_torch_kernels.py)
and give the JAX kernels' (interpret mode) sums within float32
rounding, including stream offsets that wrap past 2**32.  Routing (top-k
expert ids, queue positions, drops) must equal `jax.lax.top_k`'s exactly;
gates, MoE and MLA outputs agree within the stated rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmasking
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.masked_matmul import masked_matmul_grouped as jgrouped
from repro.kernels.masked_matmul import masked_matmul_grouped_ds as jgrouped_ds
from repro.kernels.masked_matmul import masked_matmul_grouped_dx as jgrouped_dx
from repro.models import layers as jlayers

from repro_torch.convert import to_torch
from repro_torch.core import masking
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ULP = 2.0 ** -23        # float32 ulp just below 1.0
BF16_RTOL = 2.0 ** -7   # one bfloat16 ulp, relative
M32 = 0xFFFFFFFF
E, M, K, N = 3, 30, 40, 72
SEEDS = [7, M32, 123]
# group 0's stream crosses 2**32 inside the block, group 1 starts just
# past the wrap
OFFS = [(1 << 32) - 1000, ((1 << 32) - 1000 + K * N) & M32, 12345]


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _grouped_operands(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(jnp.bfloat16)
    s = rng.normal(size=(E, K, N)).astype(np.float32)
    g = rng.normal(size=(E, M, N)).astype(np.float32)
    return x, w, s, g


def _grouped_uniforms(seeds, offs):
    idx = (np.asarray(offs, np.uint64)[:, None, None]
           + np.arange(K, dtype=np.uint64)[:, None] * N
           + np.arange(N, dtype=np.uint64)) & M32
    return np.stack([np.asarray(jref.hash_uniform(
        jnp.asarray(idx[e].astype(np.uint32)), seeds[e]))
        for e in range(len(seeds))])


def test_grouped_masks_match_ref_across_the_wrap():
    """Each group's mask is the JAX oracle's at (seeds[e], offs[e]); masks
    may differ only where a uniform lies between torch's and JAX's
    sigmoid of the same score (1 ulp apart)."""
    _, _, s, _ = _grouped_operands(1)
    m_t = ref.grouped_mask(_t(s), SEEDS, OFFS).numpy()
    m_j = np.asarray(jref._grouped_mask(jnp.asarray(s), jnp.asarray(
        SEEDS, jnp.uint32), jnp.asarray(OFFS, jnp.uint32)))
    u = _grouped_uniforms(SEEDS, OFFS)
    th_t = torch.sigmoid(_t(s)).numpy()
    th_j = np.asarray(jax.nn.sigmoid(jnp.asarray(s)))
    assert np.max(np.abs(th_t - th_j)) <= ULP
    flips = m_t != m_j
    lo, hi = np.minimum(th_t, th_j), np.maximum(th_t, th_j)
    assert np.all((u[flips] >= lo[flips]) & (u[flips] < hi[flips]))
    assert flips.sum() <= 1
    # the wrap really happens inside group 0's block
    idx0 = (OFFS[0] + np.arange(K * N, dtype=np.uint64)) & M32
    assert idx0.min() == 0 and idx0.max() == M32


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_grouped_plain_versions_match_jax_kernels(mode):
    """y, dx and ds of the port's grouped wrappers on the CPU (the plain
    versions) against the JAX grouped kernels in interpret mode and the
    JAX oracles, at ragged M = 30 and wrapping offsets."""
    x, w, s, g = _grouped_operands(2)
    kw = dict(mode=mode, tau=0.45)
    jkw = dict(interpret=True, mode=mode, tau=0.45)
    seeds, offs = jnp.asarray(SEEDS, jnp.uint32), jnp.asarray(OFFS, jnp.uint32)
    y_t = mm.masked_matmul_grouped(_t(x), _t(w), _t(s), SEEDS, OFFS,
                                   **kw).numpy()
    y_j = np.asarray(jgrouped(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              seeds, offs, **jkw))
    y_o = np.asarray(jref.masked_matmul_grouped(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), seeds, offs, mode,
        0.45))
    dx_t = mm.masked_matmul_grouped_dx(_t(g), _t(w), _t(s), SEEDS, OFFS,
                                       **kw).numpy()
    dx_j = np.asarray(jgrouped_dx(jnp.asarray(g), jnp.asarray(w),
                                  jnp.asarray(s), seeds, offs, **jkw))
    ds_t = mm.masked_matmul_grouped_ds(_t(x), _t(g), _t(w), _t(s)).numpy()
    ds_j = np.asarray(jgrouped_ds(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(w), jnp.asarray(s),
                                  interpret=True))
    # the naive backward (stacked mask, m*w and x^T g materialized)
    bdx_t, bds_t = ref.masked_dense_grouped_bwd(_t(x), _t(w), _t(s), SEEDS,
                                                OFFS, _t(g), mode, 0.45)
    bdx_j, bds_j = jref.masked_dense_grouped_bwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), seeds, offs,
        jnp.asarray(g), mode, 0.45)
    assert y_t.dtype == dx_t.dtype == ds_t.dtype == np.float32
    assert y_t.shape == (E, M, N) and dx_t.shape == (E, M, K)
    assert ds_t.shape == (E, K, N)
    # f32 sums over K (y), N (dx) or M (ds) terms in another order:
    # relative 1e-5 of the output scale
    for a, b in ((y_t, y_j), (y_t, y_o), (dx_t, dx_j), (ds_t, ds_j),
                 (bdx_t.numpy(), bdx_j), (bds_t.numpy(), bds_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_grouped_autograd_matches_jax_grad(mode):
    """y, dx and ds of the port's grouped autograd Function against
    jax.vjp of repro.kernels.ops.masked_dense_grouped (its padded
    interpret-mode launches), f32 activations as the expert chain runs
    them, x with two inner axes (E, 2, 15, K)."""
    x, w, s, g = _grouped_operands(3)
    x = x.reshape(E, 2, 15, K)
    g = g.reshape(E, 2, 15, N)
    if mode == "sample":
        jf = lambda x_, s_: jops.masked_dense_grouped(
            x_, jnp.asarray(w), s_, jnp.asarray(SEEDS, jnp.uint32),
            jnp.asarray(OFFS, jnp.uint32))
        tf = lambda x_, s_: ops.masked_dense_grouped(x_, _t(w), s_, SEEDS,
                                                     OFFS)
    else:
        jf = lambda x_, s_: jops.masked_dense_grouped_threshold(
            x_, jnp.asarray(w), s_, 0.4)
        tf = lambda x_, s_: ops.masked_dense_grouped_threshold(
            x_, _t(w), s_, 0.4)
    y_j, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(s))
    dx_j, ds_j = vjp(jnp.asarray(g))

    xt = _t(x).requires_grad_()
    st = _t(s).requires_grad_()
    y_t = tf(xt, st)
    y_t.backward(_t(g))
    assert y_t.shape == (E, 2, 15, N) and xt.grad.shape == x.shape
    assert y_t.dtype == xt.grad.dtype == st.grad.dtype == torch.float32
    # f32 sums in another order: relative 1e-5 of each output's scale
    for a, b in ((y_t.detach(), y_j), (xt.grad, dx_j), (st.grad, ds_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_grouped_default_offsets_are_the_stacked_stream():
    """Without offsets, group e samples at e*K*N: the E masks are the
    flat stream of the stacked (E, K, N) leaf."""
    s = _grouped_operands(4)[2]
    eye = torch.eye(K).expand(E, K, K).contiguous()
    got = ops.masked_dense_grouped(eye, torch.ones(E, K, N), _t(s), 31)
    flat = ref.sample_rows(_t(s).reshape(1, -1), [31]).reshape(E, K, N)
    assert torch.equal(got, flat.float())


@pytest.mark.parametrize("shape", [(26, 64, 2048, 1408), (3, 4, 64, 32)])
def test_expert_leaf_offsets_match_jax(shape):
    """`MaskedLeaf.build` of a stacked (L, E, K, N) expert leaf gives the
    reference's (L, E) offsets (l*E + e)*K*N mod 2**32 (at deepseek-v2's
    full depth they wrap), and `block(l)` hands one grouped launch layer
    l's (E,) seeds and offsets."""
    w = torch.empty(shape, device="meta")
    leaf = masking.MaskedLeaf.build(w, w, 0xABCDEF01)
    jleaf = jmasking.MaskedLeaf.build(jax.ShapeDtypeStruct(shape, jnp.bfloat16),
                                      None, 0xABCDEF01)
    assert np.array_equal(leaf.off, np.asarray(jleaf.off))
    assert np.array_equal(leaf.seed, np.asarray(jleaf.seed))
    Lyr, Ex, Kd, Nd = shape
    want = (np.arange(Lyr * Ex, dtype=np.uint64) * (Kd * Nd)) & M32
    assert np.array_equal(leaf.off.reshape(-1), want.astype(np.uint32))
    blk = leaf.block(Lyr - 1)
    assert blk.off.shape == blk.seed.shape == (Ex,)
    assert blk.w.shape == (Ex, Kd, Nd)
    if Lyr * Ex * Kd * Nd > 1 << 32:
        assert (np.diff(leaf.off.reshape(-1).astype(np.int64)) < 0).any()


# ---------------------------------------------------------------------------
# Routing, MoE and MLA layers
# ---------------------------------------------------------------------------


def _jax_route(logits, n_experts, top_k, cf):
    """The routing lines of the reference's `moe_apply`
    (src/repro/models/layers.py:506-520) on given logits."""
    T = logits.shape[0]
    probs = jax.nn.softmax(logits, axis=-1)
    gval, gidx = jax.lax.top_k(probs, top_k)
    gval = gval / jnp.maximum(jnp.sum(gval, -1, keepdims=True), 1e-9)
    cap = max(int(T * top_k * cf / n_experts), 4)
    onehot = jax.nn.one_hot(gidx, n_experts, dtype=jnp.float32)
    flat = onehot.reshape(T * top_k, n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(
        T, top_k, n_experts) * onehot, axis=-1)
    keep = pos < cap
    return gval * keep, gidx, pos, keep, cap


@pytest.mark.parametrize("T,n_experts,top_k", [(32, 4, 2), (256, 64, 6)])
def test_moe_route_matches_jax_top_k_exactly(T, n_experts, top_k):
    """Expert ids, queue positions and drops equal the reference's on
    continuous logits and on logits with exact ties (lower index first);
    gates agree to f32 rounding.  At deepseek-v2-lite's T = 256, k = 6,
    E = 64 the capacity is int(256*6*1.25/64) = 30."""
    rng = np.random.default_rng(T)
    cont = (3.0 * rng.normal(size=(T, n_experts))).astype(np.float32)
    ties = np.round(rng.normal(size=(T, n_experts))).astype(np.float32)
    cont[:, 0] += 4.0  # expert 0 is over capacity
    ties[:, 0] += 2.0
    for logits in (cont, ties):
        _, gval_t, gidx_t, _, pos_t, keep_t, cap_t = layers.moe_route(
            _t(logits), n_experts, top_k, 1.25)
        gval_j, gidx_j, pos_j, keep_j, cap_j = _jax_route(
            jnp.asarray(logits), n_experts, top_k, 1.25)
        assert cap_t == cap_j
        assert np.array_equal(gidx_t.numpy(), np.asarray(gidx_j))
        assert np.array_equal(pos_t.numpy(), np.asarray(pos_j))
        assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))
        np.testing.assert_allclose(gval_t.numpy(), np.asarray(gval_j),
                                   rtol=1e-6, atol=1e-7)
        assert (~keep_t).any()  # some tokens are dropped at capacity
    if T == 256:
        assert cap_t == 30


def _masked_pair(jparams, seed, rng):
    """(JAX tree, port tree) of the same params, every >= 2-D leaf but
    the router a MaskedLeaf with the same random scores and seed."""
    flat, tdef = jax.tree_util.tree_flatten(jparams)
    jl, tl = [], []
    for i, a in enumerate(flat):
        a = np.asarray(a)
        if a.ndim >= 2 and a.dtype != np.float32:
            s = (2.0 * rng.normal(size=a.shape)).astype(np.float32)
            jl.append(jmasking.MaskedLeaf.build(jnp.asarray(a),
                                                jnp.asarray(s), seed + i))
            tl.append(masking.MaskedLeaf.build(_t(a), _t(s), seed + i))
        else:
            jl.append(jnp.asarray(a))
            tl.append(_t(a))
    return (jax.tree_util.tree_unflatten(tdef, jl),
            jax.tree_util.tree_unflatten(tdef, tl))


def test_moe_apply_matches_jax():
    """dsv2-lite SMOKE widths (d 64, 4 experts of width 32, top-2, one
    shared expert), T = 32 tokens, masked expert and shared leaves: the
    port routes exactly as the reference, and y and aux agree."""
    D, F_, Ex, k = 64, 32, 4, 2
    jp = jlayers.moe_init(jax.random.PRNGKey(1), D, F_, Ex, 1)
    rng = np.random.default_rng(5)
    jparams, tparams = _masked_pair(jp, 40, rng)
    x = rng.normal(size=(2, 16, D)).astype(jnp.bfloat16)
    y_j, aux_j = jax.jit(lambda p, x_: jlayers.moe_apply(p, x_, Ex, k))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        y_t, aux_t = layers.moe_apply(tparams, _t(x), Ex, k)
    # routing on the same logits (f32 x @ router, 64 terms)
    logits = np.asarray(x, np.float32).reshape(-1, D) @ np.asarray(
        jp["router_w"])
    _, _, gidx_t, _, pos_t, keep_t, _ = layers.moe_route(_t(logits), Ex, k,
                                                         1.25)
    _, gidx_j, pos_j, keep_j, _ = _jax_route(jnp.asarray(logits), Ex, k, 1.25)
    assert np.array_equal(gidx_t.numpy(), np.asarray(gidx_j))
    assert np.array_equal(pos_t.numpy(), np.asarray(pos_j))
    assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert y_t.dtype == torch.bfloat16 and y_t.shape == (2, 16, D)
    y_j = np.asarray(y_j, np.float32)
    # the routed part is f32 throughout and cast to bf16 once; the shared
    # expert runs bf16 projections whose casts each framework places
    # itself: a few bf16 ulps of the output scale
    scale = np.abs(y_j).max()
    assert np.abs(y_t.float().numpy() - y_j).max() <= 4 * BF16_RTOL * scale
    # aux = E * sum(mean probs * counts): f32 means in another order
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * abs(float(aux_j))


@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_apply_matches_jax(q_lora):
    """MLA at dsv2-lite SMOKE widths (d 64, 4 heads, kv_lora 32, nope 16 +
    rope 8, v 16), masked projections, with and without the q_lora
    branch: the output and the compressed cache (c_kv, k_rope) agree."""
    D, H, kv, nope, rope, v = 64, 4, 32, 16, 8, 16
    jp = jlayers.mla_init(jax.random.PRNGKey(2), D, H, kv, q_lora, nope,
                          rope, v)
    rng = np.random.default_rng(6 + q_lora)
    jparams, tparams = _masked_pair(jp, 90, rng)
    x = rng.normal(size=(2, 16, D)).astype(jnp.bfloat16)
    pos = np.arange(16)
    out_j, (ckv_j, kr_j) = jax.jit(lambda p, x_: jlayers.mla_apply(
        p, x_, jnp.asarray(pos), H, kv, nope, rope, v))(jparams,
                                                       jnp.asarray(x))
    with torch.no_grad():
        out_t, (ckv_t, kr_t) = layers.mla_apply(
            tparams, _t(x), torch.from_numpy(pos), H, kv, nope, rope, v)
    assert out_t.shape == (2, 16, D) and kr_t.shape == (2, 16, 1, rope)
    # bf16 projections, norms and rope, each framework rounding at its
    # own points: the cache within 2 bf16 ulps of its scale, the output
    # (three more bf16 products deep) within 4
    for a, b, ulps in ((ckv_t, ckv_j, 2), (kr_t, kr_j, 2),
                       (out_t, out_j, 4)):
        b = np.asarray(b, np.float32)
        d = np.abs(a.float().numpy() - b)
        assert d.max() <= ulps * BF16_RTOL * np.abs(b).max(), (
            d.max() / np.abs(b).max())
