"""The performance features no launcher config turns on, against the JAX
package: chunked online-softmax attention (`chunk_kv`) and the tanh soft
cap, block-local MoE dispatch (`moe_block_dispatch`), `cfg.remat`,
microbatched train steps (`StepConfig.microbatch`), a forward with
`attn_soft_cap` set (which no model of the reference reads) and a hybrid
tail of mixed block kinds.  The reference's own `test_perf_features.py`
cases run on the port at their tolerances (1e-4; remat's 2e-2 / 1e-3).

Tolerances against the reference.  `attention_core` and `moe_apply` on
f32 inputs differ only in the order of f32 sums: within 2e-5 of the
output's scale.  The SMOKE forwards with `chunk_kv` (every family) run
on f32 float leaves, so every activation is f32: logits within 1e-4 of
the logit scale, as the zoo's tests hold them.  A microbatched train
step is held to the f32 bounds of tests/test_torch_steps.py (per-leaf
update relative norm 1e-2, cosine 0.9999; loss 1e-5).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro.models import layers as JL

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.kernels import ref as kref
from repro_torch.launch import steps
from repro_torch.models import build_model, hybrid
from repro_torch.models import layers as L
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

_NONE = lambda x: x is None
RUN_SEED = 17


def _jx(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# attention_core: chunks and soft caps
# ---------------------------------------------------------------------------


def _qkv(seed, B=2, Sq=40, Sk=40, H=4, Kv=2, Hd=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, Hd), np.float32),
            rng.standard_normal((B, Sk, Kv, Hd), np.float32),
            rng.standard_normal((B, Sk, Kv, Hd), np.float32))


@pytest.mark.parametrize("chunk_kv,soft_cap,window,causal", [
    (None, 2.0, None, True), (16, 2.0, None, True), (8, None, 12, True),
    (16, None, None, False), (7, 3.0, None, False)])
def test_attention_core_matches_jax(chunk_kv, soft_cap, window, causal):
    """40 keys in chunks of 16, 8 or 7 (padded keys at position -1e9, as
    the reference pads them), capped or not, windowed or not."""
    q, k, v = _qkv(0)
    pos = np.arange(40)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos),
                             window=window, causal=causal,
                             chunk_kv=chunk_kv, soft_cap=soft_cap)
    t = torch.from_numpy
    got = L.attention_core(t(q), t(k), t(v), t(pos), t(pos), window=window,
                           causal=causal, chunk_kv=chunk_kv,
                           soft_cap=soft_cap)
    _close(got.numpy(), want, 2e-5)


def test_chunked_attention_matches_dense():
    """The reference's case: 64 keys in chunks of 16 equal the unchunked
    attention, with and without a window of 8 (1e-4)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, Sq=64, Sk=64))
    pos = torch.arange(64)
    for window in (None, 8):
        dense = L.attention_core(q, k, v, pos, pos, window=window)
        chunked = L.attention_core(q, k, v, pos, pos, window=window,
                                   chunk_kv=16)
        np.testing.assert_allclose(dense.numpy(), chunked.numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# block-local MoE dispatch
# ---------------------------------------------------------------------------

D, E, F = 32, 8, 16


def _moe_params(seed):
    p = L.moe_init(torch.Generator().manual_seed(seed), D, F, E, n_shared=1)
    return tree.tree_map(lambda x: x.float(), p)


def test_moe_block_dispatch_matches_global_when_capacity_ample():
    """The reference's case: at capacity factor 8 no block drops a token,
    so 8 blocks route as the global dispatch does (1e-4)."""
    p = _moe_params(1)
    p.pop("shared")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 64, D), np.float32))
    y0, _ = L.moe_apply(p, x, E, 2, capacity_factor=8.0)
    yb, _ = L.moe_apply(p, x, E, 2, capacity_factor=8.0, block_dispatch=8)
    np.testing.assert_allclose(y0.numpy(), yb.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,blocks", [((4, 64), 4), ((2, 12), 4)])
def test_moe_block_dispatch_matches_jax(shape, blocks):
    """Each block's own capacity max(int(t * k * cf / E), 4) drops tokens
    at cf 1.25 as the reference's vmapped blocks do; aux is the blocks'
    mean.  (2, 12): 24 tokens in 4 blocks of 6 < 8 fall back to the
    global dispatch, as the reference does.  Shared experts included."""
    p = _moe_params(2)
    x = np.random.default_rng(2).standard_normal(shape + (D,), np.float32)
    jp = tree.tree_map(_jx, p)
    want, jaux = JL.moe_apply(jp, jnp.asarray(x), E, 2, 1.25,
                              block_dispatch=blocks)
    got, aux = L.moe_apply(p, torch.from_numpy(x), E, 2, 1.25,
                           block_dispatch=blocks)
    _close(got.numpy(), want, 2e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_block_dispatch_folds_blocks_into_one_grouped_call(monkeypatch):
    """All G blocks go through each expert projection in one grouped
    call of (E, G * C) rows, as without block dispatch."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.masked_dense_grouped

    def counted(x, w, s, seeds, offs=None):
        calls.append(tuple(x.shape))
        return real(x, w, s, seeds, offs)

    monkeypatch.setattr(ops, "masked_dense_grouped", counted)
    gen = torch.Generator().manual_seed(3)
    p = L.moe_init(gen, D, F, E, n_shared=0)
    p = {k: masking.MaskedLeaf.build(
        v, torch.randn(v.shape, generator=gen), 5) if k != "router_w"
         else v.float() for k, v in p.items()}
    x = torch.randn(4, 16, D, generator=gen)
    for G in (0, 4):
        calls.clear()
        L.moe_apply(p, x, E, 2, 1.25, block_dispatch=G)
        cap = max(int(64 // max(G, 1) * 2 * 1.25 / E), 4)
        assert calls == [(E, max(G, 1) * cap, D)] * 2 + \
            [(E, max(G, 1) * cap, F)]


@functools.lru_cache(maxsize=None)
def _state(arch, C=2, score_dtype=torch.float32, **over):
    """(JAX api, port api, a perturbed fed state as the JAX package's,
    f32 floats), drawn by the port's init; `over` replaces config
    fields."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    japi, tapi = jbuild_model(jcfg), build_model(tcfg)
    st = steps.init_fed_state(torch.Generator().manual_seed(5), tapi,
                              masking.MaskSpec(), C=C,
                              score_dtype=score_dtype)
    gen = torch.Generator().manual_seed(5)
    for s in tree.leaves(st["scores"]):
        if s is not None:
            s.add_((2.0 * torch.randn(s.shape, generator=gen)).to(s.dtype))
    for m in tree.leaves(st["opt_m"]):
        if m is not None:
            m.add_((0.01 * torch.randn(m.shape, generator=gen)).to(m.dtype))
    jstate = {k: tree.tree_map(_jx, v) for k, v in st.items()
              if k != "step"}
    jstate["floats"] = jax.tree_util.tree_map(
        lambda x: None if x is None else x.astype(jnp.float32),
        jstate["floats"], is_leaf=_NONE)
    return japi, tapi, dict(jstate, step=jnp.asarray(0, jnp.int32))


def _masked(api_state, cohort, tick, torch_side):
    japi, tapi, jstate = api_state
    if torch_side:
        st = convert.state_from_jax(_np(jstate), "cpu")
        pick = lambda t: tree.tree_map(
            lambda x: None if x is None else x[cohort], t)
        return masking.masked_forward_tree(
            MaskedParams(st["weights"], pick(st["scores"]),
                         pick(st["floats"])),
            lambda i: masking.mask_stream_seed(tick, 0, i, cohort, RUN_SEED))
    from repro.core import masking as jmasking
    pick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t, is_leaf=_NONE)
    return jmasking.masked_forward_tree(
        jmasking.MaskedParams(jstate["weights"], pick(jstate["scores"]),
                              pick(jstate["floats"])),
        lambda i: jmasking.mask_stream_seed(tick, 0, i, cohort,
                                            run_seed=RUN_SEED))


def _forward_both(arch, batch, chunk_kv, **over):
    st = _state(arch, **over)
    japi, tapi, _ = st
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jax.jit(functools.partial(japi.forward, chunk_kv=chunk_kv))(
        _masked(st, 0, 3, False), jbatch)
    with torch.no_grad():
        tout = tapi.forward(_masked(st, 0, 3, True),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, chunk_kv=chunk_kv)
    return np.asarray(jout[0]), tout[0].numpy(), float(jout[1]), \
        float(tout[1])


@pytest.mark.parametrize("arch,chunk_kv,over", [
    ("internlm2-1.8b", 8, {}),
    ("deepseek-v2-lite-16b", 8, {"moe_block_dispatch": 4}),
    ("internlm2-1.8b", None, {"attn_soft_cap": 5.0})])
def test_forward_matches_jax(arch, chunk_kv, over):
    """`api.forward(params, batch, chunk_kv)` through the fused path
    against the reference's (16 tokens in chunks of 8): GQA, and MLA with
    block dispatch (aux too); a config with `attn_soft_cap` set equals
    the reference's, which no model reads (uncapped)."""
    batch = {"tokens": np.random.default_rng(7).integers(
        0, 256, (2, 16)).astype(np.int32)}
    jl, tl, jaux, taux = _forward_both(arch, batch, chunk_kv, **over)
    _close(tl, jl, 1e-4)
    assert abs(taux - jaux) <= 1e-5 * max(abs(jaux), 1.0)
    if over.get("attn_soft_cap"):
        _, plain, _, _ = _forward_both(arch, batch, None)
        np.testing.assert_array_equal(tl, plain)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium",
                                  "mamba2-370m", "qwen2-vl-2b"])
def test_every_family_takes_chunk_kv(arch):
    """`api.forward(..., chunk_kv=8)` of the hybrid (windowed attention),
    whisper (its encoder's 32 frames and decoder's 16 tokens in whole
    chunks), the ssm (ignored) and the VLM equals its unchunked forward
    (1e-4: at whole chunks the online softmax is the softmax; the
    chunked attention itself is held to the reference's above)."""
    cfg = get_config(arch, smoke=True)
    api = build_model(cfg)
    params = tree.tree_map(lambda x: x.float(), api.init_params(
        torch.Generator().manual_seed(4)))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 16)))}
    if arch == "whisper-medium":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        dense = api.forward(params, batch)[0].numpy()
        chunked = api.forward(params, batch, chunk_kv=8)[0].numpy()
    _close(chunked, dense, 1e-4)


def _bf16_spreads(logits):
    """(max |chunked - unchunked| on bf16 activations, max |unchunked on
    bf16 - unchunked on f32 activations|, logit scale) from the three
    forwards' logits."""
    f, u, c = (np.asarray(x, np.float32) for x in logits)
    return (float(np.abs(c - u).max()), float(np.abs(u - f).max()),
            float(np.abs(f).max()))


def test_bf16_chunked_spread_within_rounding_spread(capsys):
    """On bf16 activations the chunked and unchunked forwards round the
    attention output's f32 sums at other points, and deep models carry
    that apart; chip_smoke.py gates it on gemma3-4b at a share
    (CHUNK_BF16_SPREAD) of the bf16 rounding spread itself, the
    unchunked forward on bf16 against f32 activations.  Here both
    packages, on gemma3 SMOKE at 12 layers with a 64-token window, 256
    tokens in chunks of 32 (bf16 scores, masked), stay within that
    share; the readings are printed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    over = dict(n_layers=12, sliding_window=64)
    tcfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), **over)
    jcfg = dataclasses.replace(jget_config("gemma3-4b", smoke=True), **over)
    tapi, japi = build_model(tcfg), jbuild_model(jcfg)
    gen = torch.Generator().manual_seed(0)
    mp = masking.init_masked(gen, tapi.init_params(gen), masking.MaskSpec(),
                             score_dtype=torch.bfloat16)
    seed_fn = lambda i: masking.mask_stream_seed(0, 0, i, 0, RUN_SEED)
    fused = masking.masked_forward_tree(mp, seed_fn)
    f32 = tree.tree_map(lambda p: p if isinstance(p, masking.MaskedLeaf)
                        or p is None else p.float(), fused)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (1, 256))
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        port = _bf16_spreads([
            tapi.forward(f32, batch)[0], tapi.forward(fused, batch)[0],
            tapi.forward(fused, batch, chunk_kv=32)[0]])

    from repro.core import masking as jmasking
    jmp = [tree.tree_map(_jx, t) for t in (mp.weights, mp.scores, mp.floats)]
    up = jax.tree_util.tree_map(
        lambda x: None if x is None else x.astype(jnp.float32), jmp[2],
        is_leaf=_NONE)
    jseed = lambda i: jmasking.mask_stream_seed(0, 0, i, 0,
                                                run_seed=RUN_SEED)
    jf32, jfused = (jmasking.masked_forward_tree(
        jmasking.MaskedParams(jmp[0], jmp[1], fl), jseed)
        for fl in (up, jmp[2]))
    fwd = jax.jit(japi.forward, static_argnames=("chunk_kv",))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    ref = _bf16_spreads([fwd(jf32, jb)[0], fwd(jfused, jb)[0],
                         fwd(jfused, jb, chunk_kv=32)[0]])
    with capsys.disabled():
        print(f"\nbf16 chunked vs unchunked, rounding spread, scale: port "
              f"{port}, reference {ref}")
    for chunk, rounding, _ in (port, ref):
        assert 0.0 < rounding
        assert chunk <= chip_smoke.CHUNK_BF16_SPREAD * rounding


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def test_remat_preserves_forward_and_grads():
    """The reference's case on plain params, then the fused path: the
    loss and every gradient unchanged by `remat` (the port's recompute
    redraws the same masks, so both are bit for bit), and the recompute
    runs each projection's forward kernel a second time."""
    from repro_torch.kernels import masked_matmul as mm
    cfg = get_config("internlm2-1.8b", smoke=True)
    api, api_r = build_model(cfg), build_model(dataclasses.replace(
        cfg, remat=True))
    params = api.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))}

    def grads(a, p):
        p = tree.tree_map(lambda x: x.detach().requires_grad_(), p)
        loss = a.loss(a.forward(p, batch), batch)
        loss.backward()
        return float(loss), [x.grad for x in tree.leaves(p)]

    l1, g1 = grads(api, params)
    l2, g2 = grads(api_r, params)
    assert abs(l1 - l2) < 1e-4
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=1e-3)
    calls = {"n": 0}
    real = mm.masked_matmul

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    outs = []
    for a in (api, api_r):
        mp = masking.init_masked(torch.Generator().manual_seed(1),
                                 a.init_params(torch.Generator()),
                                 masking.MaskSpec())
        s = [x.requires_grad_() for x in tree.leaves(mp.scores)
             if x is not None]
        fwd = masking.masked_forward_tree(mp, lambda i: 11 + i)
        mm.masked_matmul, calls["n"] = counted, 0
        try:
            loss = a.loss(a.forward(fwd, batch), batch)
            loss.backward()
        finally:
            mm.masked_matmul = real
        outs.append((float(loss), [x.grad.clone() for x in s], calls["n"]))
    (la, ga, na), (lb, gb, nb) = outs
    assert la == lb and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert nb == 2 * na == 2 * 7 * cfg.n_layers


# ---------------------------------------------------------------------------
# microbatches
# ---------------------------------------------------------------------------


def _update_agreement(s0, jtree, ttree):
    out = []
    jl = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        jtree, is_leaf=_NONE) if x is not None]
    tl = [x.float().numpy() for x in tree.leaves(ttree) if x is not None]
    for a0, a, b in zip(s0, jl, tl):
        a0 = np.asarray(a0, np.float32)
        dj, dt = (a - a0).ravel(), (b - a0).ravel()
        if not dj.any() and not dt.any():
            continue
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


def test_microbatch_train_step_matches_jax(monkeypatch):
    """internlm2 SMOKE, 2 cohorts of batch 4 in 2 microbatches: the loss
    (the chunks' mean), every score, first-moment and float update at
    the f32 bounds.  Chunk j draws its masks at tick step * 2 + j: the
    recorded stream seeds are those, and the two chunks' masks differ."""
    japi, tapi, jstate = _state("internlm2-1.8b")
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (2, 4, 16))
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED, microbatch=2)
    s0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["scores"]) if x is not None]
    m0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["opt_m"]) if x is not None]
    f0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["floats"]) if x is not None]
    seeds = []
    real = masking.masked_forward_tree

    def recorded(mp, seed_fn, **k):
        seeds.append(seed_fn(1))
        return real(mp, seed_fn, **k)

    monkeypatch.setattr(masking, "masked_forward_tree", recorded)
    tstate["step"] = 3
    jstate3 = dict(jstate, step=jnp.asarray(3, jnp.int32))
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        **kw)))(jstate3, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(**kw))(
        tstate, {"tokens": torch.from_numpy(tokens)})
    assert seeds == [masking.mask_stream_seed(3 * 2 + j, 0, 1, c, RUN_SEED)
                     for c in range(2) for j in range(2)]
    w = tstate["weights"]["layers"]["attn"]["w_q"]
    masks = [kref.sample_mask(
        torch.zeros(w.shape[1:]), seed) for seed in seeds[:2]]
    assert not torch.equal(masks[0], masks[1])
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    agree = (_update_agreement(s0, jout["scores"], tout["scores"])
             + _update_agreement(m0, jout["opt_m"], tout["opt_m"])
             + _update_agreement(f0, jout["floats"], tout["floats"]))
    assert len(agree) >= 7 + 7 + 3
    for rel, cos in agree:
        assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


def test_microbatch_batch_must_split():
    _, tapi, jstate = _state("internlm2-1.8b")
    st = convert.state_from_jax(_np(jstate), "cpu")
    step = steps.make_train_step(tapi, steps.StepConfig(microbatch=3))
    with pytest.raises(ValueError, match="microbatches"):
        step(st, {"tokens": torch.zeros((2, 4, 16), dtype=torch.int64)})


# ---------------------------------------------------------------------------
# the hybrid's tail of mixed kinds
# ---------------------------------------------------------------------------


def test_mixed_tail_is_built_as_the_reference_builds_it_and_raises():
    """block_pattern (rec, attn, attn) at 5 layers leaves a tail (rec,
    attn): both packages build it as a list of one block each, and the
    reference's forward cannot scan it, so the port's forward and decode
    raise as well."""
    over = dict(block_pattern=("rec", "attn", "attn"), n_layers=5)
    jcfg = dataclasses.replace(jget_config("recurrentgemma-9b", smoke=True),
                               **over)
    tcfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                               **over)
    jp = jax.eval_shape(lambda k: jhybrid.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = hybrid.init_params(torch.Generator().manual_seed(0), tcfg)
    assert isinstance(jp["tail"], list) and isinstance(tp["tail"], list)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp["tail"])[0]]
    tpaths = [p for p, _ in tree.flatten_with_paths(tp["tail"])]
    assert jpaths == tpaths
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(jp["tail"])] \
        == [tuple(a.shape) for a in tree.leaves(tp["tail"])]
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(Exception):
        jax.eval_shape(lambda p: jhybrid.forward(p, jcfg,
                                                 jnp.asarray(tokens)), jp)
    with pytest.raises(NotImplementedError, match="mixed block kinds"):
        hybrid.forward(tp, tcfg, torch.from_numpy(tokens))
    cache = hybrid.init_cache(tcfg, 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="mixed block kinds"):
        hybrid.decode_step(tp, tcfg, cache, torch.zeros(1, dtype=torch.long),
                           0)
