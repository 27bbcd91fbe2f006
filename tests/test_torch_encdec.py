"""The encoder-decoder family (whisper) against the JAX package at the
SMOKE config, from one state drawn by the port's init and handed to both
packages: `layer_norm`; `encode` over stub frames; the fused masked
forward with frames (logits and loss, both mask modes); the KV-cache
decode with the cross K/V filled from `encode`, as tests/test_archs.py
fills them; one train step; one round, which must be exact (masks,
packed words, theta); and `convert` carrying whisper's tree unchanged.

Tolerances: with the float leaves (embedding, learned positions, layer
norms) and the frames in f32 every activation is f32 and only the order
of the sums differs: `layer_norm` within 1e-6 on unit-scale inputs and
its bf16 output within one bf16 ulp; `encode`, the logits and the decode
within 1e-4 of their scale (measured ~1e-6 to 2.5e-5 here and on
qwen2-7b); the loss to 1e-5; the train step's per-leaf updates within a
relative norm of 1e-2 and a cosine of 0.9999 (the f32 bounds of
tests/test_torch_steps.py).  The round is exact but bpp, within one f32
ulp of 1.0 (log2)."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jaggregation
from repro.core import masking as jmasking
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import layers as jlayers

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import aggregation, masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.launch import steps
from repro_torch.models import build_model, encdec, layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, C, RUN_SEED = "whisper-medium", 2, 17
_NONE = lambda x: x is None


def _jx(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _jleaves(t):
    return [np.asarray(x).astype(np.float32) for x in
            jax.tree_util.tree_leaves(t, is_leaf=_NONE) if x is not None]


def _tleaves(t):
    return [x.float().numpy() for x in tree.leaves(t) if x is not None]


def _frames(seed, lead, cfg):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(lead + (cfg.enc_seq, cfg.d_model))
            ).astype(np.float32)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2.0 + 0.5
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(jlayers.layer_norm(jp, jnp.asarray(x)))
    got = layers.layer_norm(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    xb = torch.from_numpy(x).bfloat16()
    gotb = layers.layer_norm(tp, xb)
    wantb = np.asarray(jlayers.layer_norm(jp, _jx(xb))).astype(np.float32)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), wantb,
                               atol=2.0 ** -7 * np.abs(wantb).max())


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX api, port api, a port fed state with cohorts spread, f32 float
    leaves and perturbed layer norms, the same state as the JAX
    package's)."""
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    tapi = build_model(get_config(ARCH, smoke=True))
    st = steps.init_fed_state(torch.Generator().manual_seed(11), tapi,
                              masking.MaskSpec(), C=C)
    gen = torch.Generator().manual_seed(12)
    for s in tree.leaves(st["scores"]):
        if s is not None:
            s.add_(2.0 * torch.randn(s.shape, generator=gen))
    st["floats"] = tree.tree_map(lambda f: None if f is None else f.float(),
                                 st["floats"])
    for p, f in tree.flatten_with_paths(st["floats"]):
        if f is not None and "norm" in p:
            f.add_(0.1 * torch.randn(f.shape, generator=gen))
    return japi, tapi, st, _to_jax(st)


def _to_jax(st):
    out = {k: tree.tree_map(_jx, v) for k, v in st.items() if k != "step"}
    return dict(out, step=jnp.asarray(st["step"], jnp.int32))


def _plain_f32(tapi, seed):
    """Plain all-f32 params, layer norms perturbed: (port, JAX)."""
    gen = torch.Generator().manual_seed(seed)
    tp = tree.tree_map(lambda t: t.float(), tapi.init_params(gen))
    for p, t in tree.flatten_with_paths(tp):
        if "norm" in p:
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return tp, tree.tree_map(_jx, tp)


def test_convert_carries_every_leaf():
    """`convert.state_from_jax` and `masked_params_from_jax` carry
    whisper's tree unchanged: the enc/dec stacks, the layer norms and
    both learned position tables, float leaves under "embed_float"."""
    _, _, st, jst = _pair()
    np_tree = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)
    back = convert.state_from_jax(
        {k: (v if k == "step" else np_tree(v)) for k, v in jst.items()},
        "cpu")
    pick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x)[1], t, is_leaf=_NONE)
    mp = convert.masked_params_from_jax(jmasking.MaskedParams(
        np_tree(jst["weights"]), pick(jst["scores"]), pick(jst["floats"])),
        "cpu")
    assert back["step"] == st["step"]
    for key, got in (("weights", mp.weights), ("scores", back["scores"]),
                     ("floats", back["floats"]), ("opt_m", back["opt_m"])):
        want = tree.flatten_with_paths(st[key])
        assert [p for p, _ in tree.flatten_with_paths(got)] == \
            [p for p, _ in want]
        for (_, a), b in zip(want, tree.leaves(got)):
            assert (a is None) == (b is None)
            assert a is None or (a.dtype == b.dtype and torch.equal(a, b))
    floats = {p for p, f in tree.flatten_with_paths(st["floats"])
              if f is not None}
    assert {"pos_embed_float", "enc_pos_embed_float",
            "enc_layers/attn_norm/bias", "dec_layers/cross_norm/scale",
            "enc_final_norm/bias"} <= floats
    assert torch.equal(mp.scores["dec_layers"]["cross"]["w_k"],
                       st["scores"]["dec_layers"]["cross"]["w_k"][1])


def test_encode_matches_jax():
    japi, tapi, _, _ = _pair()
    tp, jp = _plain_f32(tapi, 3)
    frames = _frames(1, (2,), tapi.cfg)
    want = np.asarray(jax.jit(lambda p, f: jencdec.encode(p, japi.cfg, f))(
        jp, jnp.asarray(frames)))
    got = encdec.encode(tp, tapi.cfg, torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == frames.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("cohort,mode", [(0, "sample"), (1, "threshold")])
def test_forward_with_frames_matches_jax(cohort, mode):
    japi, tapi, st, jst = _pair()
    tokens = np.random.default_rng(cohort).integers(0, 256, (2, 16))
    frames = _frames(cohort, (2,), tapi.cfg)
    jpick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t, is_leaf=_NONE)
    jparams = jmasking.masked_forward_tree(
        jmasking.MaskedParams(jst["weights"], jpick(jst["scores"]),
                              jpick(jst["floats"])),
        lambda i: jmasking.mask_stream_seed(3, 0, i, cohort,
                                            run_seed=RUN_SEED),
        mode=mode, tau=0.5)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "frames": jnp.asarray(frames)}
    jout = jax.jit(japi.forward)(jparams, jbatch)
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tparams = masking.masked_forward_tree(
        MaskedParams(st["weights"], tpick(st["scores"]),
                     tpick(st["floats"])),
        lambda i: masking.mask_stream_seed(3, 0, i, cohort, RUN_SEED),
        mode=mode, tau=0.5)
    tbatch = {"tokens": torch.from_numpy(tokens),
              "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        tout = tapi.forward(tparams, tbatch)
    jl, tl = np.asarray(jout[0]), tout[0].numpy()
    assert tl.shape == jl.shape == (2, 16, 256)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    jloss = float(japi.loss(jout, jbatch))
    assert abs(float(tapi.loss(tout, tbatch)) - jloss) <= 1e-5 * abs(jloss)


def test_decode_with_cross_kv_from_encode_matches_jax():
    """8 decode steps over cross K/V filled from `encode` (the port's
    `cross_kv` per layer, the reference's enc_out @ w_k / w_v as
    tests/test_archs.py fills them), f32 params and caches."""
    japi, tapi, _, _ = _pair()
    cfg = tapi.cfg
    tp, jp = _plain_f32(tapi, 4)
    B, S = 2, 8
    frames = _frames(5, (B,), cfg)
    tokens = np.random.default_rng(6).integers(0, 256, (B, S))

    enc = jencdec.encode(jp, japi.cfg, jnp.asarray(frames))
    fill = lambda lp: ((enc @ lp["cross"]["w_k"]).reshape(
        B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd), (enc @ lp["cross"]["w_v"])
        .reshape(B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd))
    ck, cv = jax.vmap(fill)(jp["dec_layers"])
    jc = dict(jencdec.init_cache(japi.cfg, B, S, dtype=jnp.float32),
              ck=ck, cv=cv)

    tc = tree.tree_map(lambda t: t.float(), tapi.init_cache(B, S, "cpu"))
    enc_t = encdec.encode(tp, cfg, torch.from_numpy(frames))
    for l in range(cfg.n_layers):
        k, v = encdec.cross_kv(cfg, encdec.layer_slice(tp["dec_layers"], l),
                               enc_t)
        tc["ck"][l].copy_(k)
        tc["cv"][l].copy_(v)
    np.testing.assert_allclose(tc["ck"].numpy(), np.asarray(ck),
                               atol=1e-4 * float(jnp.abs(ck).max()))

    dec = jax.jit(japi.decode_step)
    err, scale = 0.0, 0.0
    for t in range(S):
        jl, jc = dec(jp, jc, jnp.asarray(tokens[:, t], jnp.int32),
                     jnp.asarray(t, jnp.int32))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, t]), t)
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        scale = max(scale, float(np.abs(np.asarray(jl)).max()))
    assert err <= 1e-4 * scale, (err, scale)


def test_train_step_matches_jax():
    """One fedpm_reg step with frames in the batch, (C, B, enc_seq, D):
    the loss, every score leaf's update and every float leaf's update
    (layer norms, learned positions, the embedding)."""
    japi, tapi, st, jst = _pair()
    st = {k: (v if k == "step" else tree.tree_map(
        lambda t: None if t is None else t.clone(), v))
        for k, v in st.items()}
    tokens = np.random.default_rng(1).integers(0, 256, (C, 2, 16))
    frames = _frames(2, (C, 2), tapi.cfg)
    kw = dict(lam=1.0, lr=0.3, seed=RUN_SEED)
    s0, f0 = _jleaves(jst["scores"]), _jleaves(jst["floats"])
    jout, jm = jax.jit(jsteps.make_train_step(japi, jsteps.StepConfig(
        **kw)))(jst, {"tokens": jnp.asarray(tokens, jnp.int32),
                      "frames": jnp.asarray(frames)})
    tout, tm = steps.make_train_step(tapi, steps.StepConfig(**kw))(
        st, {"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    n = 0
    for before, jt, tt in ((s0, jout["scores"], tout["scores"]),
                           (f0, jout["floats"], tout["floats"])):
        for a0, a, b in zip(before, _jleaves(jt), _tleaves(tt)):
            dj, dt = (a - a0).ravel(), (b - a0).ravel()
            if not dj.any() and not dt.any():
                continue
            rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
            cos = dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)
            assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)
            n += 1
    assert n >= 16 + 10     # 16 masked leaves, the float leaves that move


def test_round_exact():
    """Per-leaf packed words of every cohort (16 stacked masked leaves),
    theta, the floats' mean and the codec's measured bits."""
    japi, tapi, st, jst = _pair()
    st = {k: (v if k == "step" else tree.tree_map(
        lambda t: None if t is None else t.clone(), v))
        for k, v in st.items()}
    st["step"] = 5
    jst = dict(jst, step=jnp.asarray(5, jnp.int32))
    flat = tree.leaves(st["scores"])
    assert sum(s is not None for s in flat) == 16
    for i, sl in enumerate(flat):
        if sl is None:
            continue
        seeds = [masking.mask_stream_seed(5, 0, i, c, RUN_SEED)
                 for c in range(C)]
        rows = sl.reshape(C, -1)
        jw = np.asarray(jaggregation.sample_and_pack_rows(
            _jx(rows), jnp.asarray(seeds, jnp.uint32)))
        tw = aggregation.sample_and_pack_rows(rows, seeds).numpy()
        assert np.array_equal(tw.view(np.uint32), jw), i
    kw = dict(seed=RUN_SEED, downlink_bits=0)
    jout, jm = jax.jit(jsteps.make_round_step(
        japi, jsteps.StepConfig(**kw)))(jst)
    tout, tm = steps.make_round_step(tapi, steps.StepConfig(**kw))(st)
    for a, b in zip(_jleaves(jout["scores"]), _tleaves(tout["scores"])):
        assert np.array_equal(np.sign(b), np.sign(a))
        np.testing.assert_allclose(b, a, rtol=1e-6)
    for a, b in zip(_jleaves(jout["floats"]), _tleaves(tout["floats"])):
        assert np.array_equal(b, a)
    for key in ("bits_measured", "bpp_measured", "downlink_bits"):
        assert float(tm[key]) == float(jm[key]), key
    assert abs(float(tm["bpp"]) - float(jm["bpp"])) <= 2.0 ** -23
    assert 0.0 < float(tm["bpp"]) <= 1.0
