"""bf16 scores through the SSM family (mamba2: SSD and the masked
depthwise conv on kernels 8-9) against the JAX package, on the CPU.

Kernels 8-9's plain versions on a bf16 score block against the
reference's conv kernels in interpret mode (which widen the block to f32
in their bodies): the masks exactly (an identity probe in time reads
every tap's m * w back), the forward and the flipped dL/dx pass to
float32 rounding (both add separately rounded products in t order), ds
in bf16 within one ulp plus 1e-5 of the scale (both round one f32
value).  One momentum train step of mamba2's SMOKE config on bf16 scores
and moments against the reference's jitted step: the loss to 1e-5 and
every stored score and first moment by `_within_an_ulp`
(tests/test_torch_score_dtype.py's note); one round exactly, `convert`
both ways bit for bit, and the update and round reaching the (L, W, C)
conv leaves piece by piece, as in tests/test_torch_bf16_scores_moe.py.
The hybrid family's (recurrentgemma) are in
tests/test_torch_bf16_scores_hybrid.py.  Run as a script, this file
prints the reference's own jit/eager spread of a bf16-score step
(`reference_spread`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_matmul import masked_conv1d as jconv
from repro.kernels.masked_matmul import masked_conv1d_ds as jconv_ds

from repro_torch.core import tree
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ref

from test_torch_bf16_scores_moe import (_bf16, _close, _step_matches,
                                        convert_both_ways, pieces_reach,
                                        round_is_exact)
from test_torch_score_dtype import (BF16, BF16_RTOL, _jleaves, _jx,
                                    _tleaves, _within_an_ulp)
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH = "mamba2-370m"
M32 = 0xFFFFFFFF
W, B, S, CH = 4, 2, 16, 160
# the (W, C) block's stream crosses 2**32 (640 indices)
WRAP_OFF = (1 << 32) - 300


def _pad(x, time=None):
    """C padded to a multiple of 128, as the JAX ops pad it (layout only:
    the hash keeps n_logical), and the time axis of a (B, S, C) input
    with W - 1 zeros: "lead" (causal) or "trail" (the flipped pass)."""
    if time is not None:
        x = jnp.pad(x, ((0, 0), (W - 1, 0) if time == "lead"
                        else (0, W - 1), (0, 0)))
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, -CH % 128)])


@pytest.mark.parametrize("mode", ["sample", "threshold"])
def test_conv_plain_kernels_on_bf16_scores_match_jax(mode):
    """Kernels 8-9's plain versions on a bf16 score block against the
    reference's conv kernels (interpret mode) on the same block, at a
    stream offset that wraps past 2**32."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((B, S, CH)))
    g = rng.standard_normal((B, S, CH)).astype(np.float32)
    w = _bf16(rng.standard_normal((W, CH)))
    s = _bf16(2 * rng.standard_normal((W, CH)))
    jw, js = _pad(_jx(w)), _pad(_jx(s))
    kw = dict(mode=mode, tau=0.45)
    jkw = dict(n_logical=CH, interpret=True, mode=mode, tau=0.45)

    def jax_conv(inp, flip):
        return np.asarray(jconv(_pad(inp, "trail" if flip else "lead"), jw,
                                js, jnp.uint32(9),
                                jnp.uint32(WRAP_OFF), flip=flip,
                                **jkw))[..., :CH]

    # the masks exactly: w = 1 and a one-hot input in time read each tap
    ones = torch.ones(W, CH, dtype=BF16)
    probe = torch.zeros(1, 2 * W, CH, dtype=BF16)
    probe[0, W - 1] = 1
    got = mm.masked_conv1d(probe, ones, s, 9, WRAP_OFF, **kw)
    want = np.asarray(jconv(_pad(_jx(probe), "lead"), _pad(_jx(ones)), js,
                            jnp.uint32(9), jnp.uint32(WRAP_OFF),
                            **jkw))[..., :CH]
    assert np.array_equal(got.numpy(), want)
    read = torch.stack([got[0, 2 * (W - 1) - t] for t in range(W)])
    assert torch.equal(read, ref.conv_weight(ones, s, 9, WRAP_OFF, None,
                                             mode, 0.45))
    for inp, flip in ((x, False), (torch.from_numpy(g), True)):
        got = mm.masked_conv1d(inp, w, s, 9, WRAP_OFF, flip=flip, **kw)
        assert got.dtype == torch.float32
        _close(got.numpy(), jax_conv(_jx(inp), flip), 1e-6, 1e-6)
    ds = mm.masked_conv1d_ds(x, torch.from_numpy(g), w, s)
    jds = jconv_ds(_pad(_jx(x), "lead"), _pad(jnp.asarray(g)), jw, js,
                   interpret=True)
    assert ds.dtype == BF16 and jds.dtype == jnp.bfloat16
    _close(ds.float().numpy(), np.asarray(jds, np.float32)[:, :CH],
           BF16_RTOL, 1e-5)
    dw = mm.masked_conv1d_ds(x, torch.from_numpy(g), w, None, epilogue="dw")
    assert dw.dtype == torch.float32


def test_momentum_train_step_matches_jax():
    """mamba2 SMOKE (2 layers), 2 cohorts of batch 4 x 16 tokens, on bf16
    scores and moments (see the module's note)."""
    _, jout, tout = _step_matches(ARCH)
    n = sum(a.size for a in _jleaves(jout["opt_m"]))
    off, far = _within_an_ulp(_jleaves(jout["opt_m"]),
                              _tleaves(tout["opt_m"]), 1e-3)
    assert off <= 1e-3 * n, (off, far)


def test_round_on_bf16_scores_is_exact():
    round_is_exact(ARCH)


def test_convert_carries_the_bf16_state_both_ways():
    assert_conv_leaves(convert_both_ways(ARCH))


def assert_conv_leaves(back):
    """The carried state's (C, L, W, C) conv score leaves are bf16."""
    convs = [t for p, t in tree.flatten_with_paths(back["scores"])
             if t is not None and p.endswith("conv/w_conv")]
    assert convs and all(t.ndim == 4 and t.dtype == BF16 for t in convs)


def test_update_pieces_reach_the_conv_leaves(monkeypatch):
    """The (L, W, C) conv leaf of 4 x 160 scores a layer, in pieces of
    128."""
    assert pieces_reach(ARCH, lambda p: p.endswith("conv/w_conv"), 128,
                        monkeypatch) == 1


def reference_spread(arch):
    """The reference's own spread of a bf16-score train step of `arch`:
    its jitted step against the same step run eagerly (`jax.disable_jit`),
    on the SMOKE config, state and batch of `chip_smoke.smoke_states`.
    Returns {kind: (largest relative norm of a leaf's difference,
    smallest cosine)} for the score updates and the first moments (the
    eager step of recurrentgemma takes ~2 minutes on a CPU, so no test
    runs it: `python tests/test_torch_bf16_scores_conv.py` prints it)."""
    import importlib.util
    from pathlib import Path

    import jax
    from repro.configs import get_config as jget_config
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild_model

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, (st,), toks = smoke.smoke_states(torch, arch, ("cpu",),
                                           score_dtype=BF16)
    jstate = {k: tree.tree_map(_jx, v) for k, v in st.items() if k != "step"}
    jstate["step"] = jnp.asarray(0, jnp.int32)
    step = jsteps.make_train_step(
        jbuild_model(jget_config(arch, smoke=True)),
        jsteps.StepConfig(lam=1.0, lr=0.3, seed=17, score_dtype=jnp.bfloat16))
    batch = {"tokens": jnp.asarray(toks.numpy(), jnp.int32)}
    jit, _ = jax.jit(step)(jstate, batch)
    with jax.disable_jit():
        eager, _ = step(jstate, batch)
    out = {}
    for key, kind in (("scores", "score update"), ("opt_m", "first moment")):
        starts = (_jleaves(jstate["scores"]) if key == "scores"
                  else [0.0] * len(_jleaves(jit[key])))
        worst = (0.0, 1.0)
        for a0, a, b in zip(starts, _jleaves(jit[key]), _jleaves(eager[key])):
            a = np.asarray(a, np.float64).ravel() - np.ravel(a0)
            b = np.asarray(b, np.float64).ravel() - np.ravel(a0)
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if na == 0.0 and nb == 0.0:
                continue
            rel = np.linalg.norm(b - a) / na if na else np.inf
            cos = a @ b / (na * nb) if na and nb else 0.0
            worst = (max(worst[0], rel), min(worst[1], cos))
        out[kind] = worst
    return out


if __name__ == "__main__":
    for name in (ARCH, "recurrentgemma-9b"):
        print(name, reference_spread(name))
