"""The VLM family (qwen2-vl) against the JAX package: `apply_mrope` at the
SMOKE sections (2, 3, 3), head dim 16, and the published (16, 24, 24),
head dim 128; the SMOKE forward with 4 stub patch embeddings prepended
(`vis_embeds`, as tests/test_archs.py builds them), its logits and loss in
both mask modes from one fed state handed to both packages; the M-RoPE
position layout for a patch count that is not a square; and the
text-only KV-cache decode.

Tolerances: M-RoPE within 2e-6 on inputs of scale ~4 (sin and cos of
torch and XLA differ in their last ulps; measured 2.4e-7); with the
float leaves cast to f32 every activation is f32, so the logits agree
within 1e-4 of the logit scale and the loss to 1e-5 (sums in another
order; measured up to 2.5e-5 on qwen2-7b, tests/test_torch_qwen2.py);
the f32 decode within 2e-5 of the scale."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer

from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.launch import steps
from repro_torch.models import build_model, transformer
from repro_torch.models import layers
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH, C, RUN_SEED = "qwen2-vl-2b", 2, 17


def _jx(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 100, (3, 2, 12)).astype(np.int32)
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                          sections, 1_000_000.0))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             sections, 1_000_000.0).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_mrope_positions_follow_the_reference_layout():
    """6 patches (not a square): side = int(6 ** 0.5) = 2, so the grid
    rows run to 2 and text starts at 2 on every stream."""
    pos = transformer.mrope_positions(6, 9, 2, "cpu")
    assert pos.shape == (3, 2, 9)
    assert pos[0, 1].tolist() == [0] * 6 + [2, 3, 4]
    assert pos[1, 0].tolist() == [0, 0, 1, 1, 2, 2, 2, 3, 4]
    assert pos[2, 0].tolist() == [0, 1, 0, 1, 0, 1, 2, 3, 4]


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX api, port api, a fed state as the JAX package's, with cohorts
    spread, non-zero biases and f32 float leaves), drawn by the port's
    init and handed to both."""
    japi = jbuild_model(jget_config(ARCH, smoke=True))
    tapi = build_model(get_config(ARCH, smoke=True))
    st = steps.init_fed_state(torch.Generator().manual_seed(7), tapi,
                              masking.MaskSpec(), C=C)
    gen = torch.Generator().manual_seed(8)
    for s in tree.leaves(st["scores"]):
        if s is not None:
            s.add_(2.0 * torch.randn(s.shape, generator=gen))
    st["floats"] = tree.tree_map(lambda f: None if f is None else f.float(),
                                 st["floats"])
    for p, f in tree.flatten_with_paths(st["floats"]):
        if f is not None and "bias" in p:
            f.add_(0.5 * torch.randn(f.shape, generator=gen))
    return japi, tapi, st, {k: tree.tree_map(_jx, v) for k, v in st.items()
                            if k != "step"}


@pytest.mark.parametrize("cohort,mode", [(0, "sample"), (1, "threshold")])
def test_forward_with_vis_embeds_matches_jax(cohort, mode):
    japi, tapi, st, jst = _pair()
    rng = np.random.default_rng(cohort)
    tokens = rng.integers(0, 256, (2, 12))
    vis = (0.1 * rng.standard_normal((2, 4, 64))).astype(np.float32)
    jpick = lambda t: jax.tree_util.tree_map(
        lambda x: None if x is None else x[cohort], t,
        is_leaf=lambda x: x is None)
    jparams = jmasking.masked_forward_tree(
        jmasking.MaskedParams(jst["weights"], jpick(jst["scores"]),
                              jpick(jst["floats"])),
        lambda i: jmasking.mask_stream_seed(3, 0, i, cohort,
                                            run_seed=RUN_SEED),
        mode=mode, tau=0.5)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "vis_embeds": jnp.asarray(vis)}
    jout = jax.jit(japi.forward)(jparams, jbatch)
    tpick = lambda t: tree.tree_map(
        lambda x: None if x is None else x[cohort], t)
    tparams = masking.masked_forward_tree(
        MaskedParams(st["weights"], tpick(st["scores"]),
                     tpick(st["floats"])),
        lambda i: masking.mask_stream_seed(3, 0, i, cohort, RUN_SEED),
        mode=mode, tau=0.5)
    tbatch = {"tokens": torch.from_numpy(tokens),
              "vis_embeds": torch.from_numpy(vis)}
    with torch.no_grad():
        tout = tapi.forward(tparams, tbatch)
    jl, tl = np.asarray(jout[0]), tout[0].numpy()
    assert tl.shape == jl.shape == (2, 16, 256)
    scale = np.abs(jl).max()
    assert np.abs(tl - jl).max() <= 1e-4 * scale
    jloss = float(japi.loss(jout, jbatch))
    tloss = float(tapi.loss(tout, tbatch))
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    # the patches move the text logits: M-RoPE and the prefix both count
    with torch.no_grad():
        text_only = tapi.forward(tparams, {"tokens": tbatch["tokens"]})[0]
    assert not torch.allclose(text_only, tout[0][:, 4:], atol=1e-3)


def test_text_only_decode_matches_jax():
    """All-f32 plain params (biases non-zero), an f32 cache: 8 decode
    steps with 1-D rope against the reference's jitted decode."""
    japi, tapi, _, _ = _pair()
    gen = torch.Generator().manual_seed(2)
    tp = tree.tree_map(lambda t: t.float(), tapi.init_params(gen))
    for p, t in tree.flatten_with_paths(tp):
        if "bias" in p:
            t.add_(0.5 * torch.randn(t.shape, generator=gen))
    jp = tree.tree_map(_jx, tp)
    B, S = 2, 8
    tokens = np.random.default_rng(0).integers(0, 256, (B, S))
    jc = jtransformer.init_cache(japi.cfg, B, S, dtype=jnp.float32)
    tc = tree.tree_map(lambda t: t.float(), tapi.init_cache(B, S, "cpu"))
    dec = jax.jit(japi.decode_step)
    err, scale = 0.0, 0.0
    for t in range(S):
        jl, jc = dec(jp, jc, jnp.asarray(tokens[:, t], jnp.int32),
                     jnp.asarray(t, jnp.int32))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, t]), t)
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        scale = max(scale, float(np.abs(np.asarray(jl)).max()))
    assert err <= 2e-5 * scale, (err, scale)
