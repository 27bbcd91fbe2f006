"""bf16 scores through the hybrid family (recurrentgemma: RG-LRU blocks
with the masked depthwise conv on kernels 8-9, windowed MQA, a rec tail)
against the JAX package, on the CPU.

One momentum train step of the SMOKE config on bf16 scores and moments
against the reference's jitted step: the loss to 1e-5 and every stored
score by `_within_an_ulp` (tests/test_torch_score_dtype.py's note).  The
first moments, under momentum from a spread start the bf16-rounded f32
gradient, by tests/test_torch_hybrid.py's f32 step bound on each leaf's
change (relative norm <= 1e-2, cosine >= 0.9999): torch and XLA spread
the hybrid's f32 gradient further than one bf16 ulp of it (gelu MLPs,
RG-LRU gates, the attention softmax), which rounding in bf16 then
shows.  One round exactly, `convert` both ways bit for bit, and the
update and round reaching the (L, W, C) conv leaves piece by piece, as
in tests/test_torch_bf16_scores_moe.py.
"""
import numpy as np

from test_torch_bf16_scores_conv import assert_conv_leaves
from test_torch_bf16_scores_moe import (_step_matches, convert_both_ways,
                                        pieces_reach, round_is_exact)
from test_torch_score_dtype import _jleaves, _tleaves
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCH = "recurrentgemma-9b"


def _moment_changes_agree(jstate, jout, tout):
    """Each first-moment leaf's change from its start, port against
    reference: (relative norm of the difference, cosine) per leaf."""
    out = []
    for a0, a, b in zip(_jleaves(jstate["opt_m"]), _jleaves(jout["opt_m"]),
                        _tleaves(tout["opt_m"])):
        a0 = np.asarray(a0, np.float32)
        dj = np.asarray(a, np.float32).ravel() - a0.ravel()
        dt = b.float().numpy().ravel() - a0.ravel()
        out.append((np.linalg.norm(dt - dj) / np.linalg.norm(dj),
                    dt @ dj / np.linalg.norm(dt) / np.linalg.norm(dj)))
    return out


def test_momentum_train_step_matches_jax():
    """recurrentgemma SMOKE (a rec, rec, attn group and a 2-layer rec
    tail), 2 cohorts of batch 4 x 16 tokens, on bf16 scores and moments
    (see the module's note)."""
    jstate, jout, tout = _step_matches(ARCH)
    for rel, cos in _moment_changes_agree(jstate, jout, tout):
        assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


def test_round_on_bf16_scores_is_exact():
    round_is_exact(ARCH)


def test_convert_carries_the_bf16_state_both_ways():
    assert_conv_leaves(convert_both_ways(ARCH))


def test_update_pieces_reach_the_conv_leaves(monkeypatch):
    """The (L, W, C) conv leaves of 4 x 64 scores a layer (both groups'
    rec blocks and the tail), in pieces of 128."""
    assert pieces_reach(ARCH, lambda p: p.endswith("conv/w_conv"), 128,
                        monkeypatch) == 3
