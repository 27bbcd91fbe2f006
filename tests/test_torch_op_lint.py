"""The port's op walker (`repro_torch.analysis.op_lint`, the twin of the
reference's jaxpr walker) and its end-to-end gate
(`repro_torch.analysis.model_check`) on the CPU.

Aten op counts are not jaxpr equation counts, so the walker is held to
the reference's invariants, not its numbers: on the three aligned check
configs' train steps the fused path defines no weight-shaped f32 value
and no mask at any block shape, forward and backward, and the
materializing path defines strictly more f32 values than the fused one
at every leaf shape.  The rules fire on their negative fixtures, and the
kernel boundary hides a wrapper's plain version (which computes m * w on
the CPU) from the walker."""
import pytest
import torch

from repro_torch.analysis import model_check, op_lint
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import masked_matmul as mm
from repro_torch.launch import steps
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

SCFG = steps.StepConfig(lam=0.1, lr=0.5)


@pytest.mark.parametrize("family", sorted(model_check.MODEL_CHECK_CFGS))
def test_fused_step_defines_no_weight_f32_or_mask(family):
    cfg, S = model_check.MODEL_CHECK_CFGS[family]
    out = model_check.model_step_weight_defs(cfg, S=S)
    assert out["block_shapes"]
    for sh, c in out["block_shapes"].items():
        assert c["fused"] == 0 and c["fused_masks"] == 0, (family, sh, c)
    for sh, c in out["leaf_shapes"].items():
        assert c["eff"] > c["fused"], (family, sh, c)


@pytest.mark.parametrize("family", sorted(model_check.MODEL_CHECK_CFGS))
def test_fused_step_clean_under_every_rule(family):
    """Every rule at every block shape over a train step of two cohorts:
    no finding; the kernels were seen as opaque calls; the state's
    leaves kept their storage through the step and through a round."""
    cfg, S = model_check.MODEL_CHECK_CFGS[family]
    api, state, batch = model_check.model_step_setup(cfg, C=2, S=S)
    blocks = model_check.masked_block_shapes(state)
    rules = [op_lint.weight_f32_temporaries(sh) for sh in blocks]
    rules += [op_lint.mask_materialization(sh) for sh in blocks]
    rules.append(op_lint.DtypePromotionRule())
    keep = op_lint.InPlaceRule(state)
    with op_lint.OpWalker(rules) as w:
        state, _ = steps.make_train_step(api, SCFG)(state, batch)
    assert w.findings == []
    assert w.n_kernels > 0 and w.n_ops > w.n_kernels
    assert not dispatch.WALKERS
    assert keep.check(state) == []
    keep = op_lint.InPlaceRule(state)
    state, _ = steps.make_round_step(api, SCFG)(state)
    assert keep.check(state) == []


def test_in_place_rule_fires_on_a_rebound_leaf():
    api, state, _ = model_check.model_step_setup(C=1, S=8)
    keep = op_lint.InPlaceRule(state)
    leaf = next(k for k, v in state["scores"]["layers"]["attn"].items()
                if v is not None)
    state["scores"]["layers"]["attn"][leaf] = \
        state["scores"]["layers"]["attn"][leaf].clone()
    found = keep.check(state)
    assert [f.rule for f in found] == ["in-place-reuse"]
    assert found[0].where == f"scores/layers/attn/{leaf}"


def _block(K=128, N=256):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, K, generator=g).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g).to(torch.bfloat16)
    s = torch.randn(K, N, generator=g)
    return x, w, s


def test_naive_masked_product_fires_at_the_block_shape():
    """x @ (m * w) outside the kernel boundary: a materialized mask and
    a weight-shaped f32 value, where the wrapper shows one opaque call."""
    x, w, s = _block()
    rules = [op_lint.weight_f32_temporaries(w.shape),
             op_lint.mask_materialization(w.shape)]

    def naive(x, w, s):
        m = ref.sample_mask(s, 7)
        return x.float() @ (m.float() * w.float())

    found = op_lint.lint_ops(naive, (x, w, s), rules)
    assert {f.rule for f in found} == {"weight-f32-temporary",
                                       "mask-materialization"}
    # the plain version itself computes m * w: seen without the boundary
    assert op_lint.lint_ops(ref.masked_matmul, (x, w, s, 7), rules)
    with op_lint.OpWalker(rules) as walker:
        mm.masked_matmul(x, w, s, 7)
    assert walker.findings == [] and walker.n_kernels == 1


def test_dtype_promotion_fires():
    x, w, s = _block()
    rule = op_lint.DtypePromotionRule([tuple(w.shape)])
    f64 = op_lint.lint_ops(lambda t: t.double() * 2, (s,), [rule])
    assert f64 and all(f.rule == "dtype-promotion" for f in f64)
    up = op_lint.lint_ops(lambda t: t.float(), (w,), [rule])
    assert [f.detail for f in up] == [
        f"weight-shaped bf16->f32 upcast {list(w.shape)}"]
    assert op_lint.lint_ops(lambda t: t.float(), (x,), [rule]) == []


def test_views_are_exempt():
    _, w, s = _block()
    rule = op_lint.weight_f32_temporaries(tuple(s.shape))
    flat = s.reshape(-1)
    assert op_lint.lint_ops(lambda t: t.reshape(s.shape), (flat,),
                            [rule]) == []
    assert op_lint.lint_ops(lambda t: t.reshape(s.shape) * 2, (flat,),
                            [rule])
