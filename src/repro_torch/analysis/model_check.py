"""Aligned whole-model check configs and the op walker's end-to-end gate
(the reference's `repro.analysis.model_check`).

The gate behind "the fused train step defines no weight-shaped f32
value": `tools.repro_lint`'s ops engine, the CPU tests and `chip_smoke.py`
run the same walk over the same configs.

The port's materializing path, which the fused one is held against, is
the same train step over a forward tree whose `MaskedLeaf`s are made
plain m * w first (`masking.materialize_leaf`, the reference's
REPRO_EFF_PATH; the models take plain tensors at masked leaves).
"""
from __future__ import annotations

import torch

from repro_torch.analysis import op_lint
from repro_torch.configs import ArchConfig
from repro_torch.core import masking
from repro_torch.core import tree as tu
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as steplib
from repro_torch.models import build_model

# every masked trailing-2D block -- the stacked MoE expert (E, K, N) and
# depthwise conv (W, C) leaves included -- is 128-aligned; vocab 320
# keeps the float unembedding from colliding with a block shape, and the
# activation sizes (B, S) are chosen so no 2-D f32 activation does.
# Torch runs a (B, S, D) matmul as one (B*S, D) mm, so its 2-D
# activations have B*S rows: the reference's S = 64 for the dense config
# gives 128 rows, whose f32 unembedding gradient (128, 128) would read as
# a block of a 128x128 leaf; the port takes S = 48 there (96 rows)
MODEL_CHECK_CFG = ArchConfig(
    name="bench-aligned", family="dense", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab=320, head_dim=64)

# deepseek-style MoE: MLA attention (every factor 128) + 1 dense + 1 MoE
# layer of 2 routed experts (stacked (2, 128, 128) leaves: the grouped
# kernels) + 1 shared expert
MOE_CHECK_CFG = ArchConfig(
    name="bench-moe-aligned", family="moe", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab=320,
    kv_lora_rank=128, q_lora_rank=0, qk_nope_dim=128, qk_rope_dim=128,
    v_head_dim=128, n_experts=2, n_shared_experts=1, top_k=2,
    moe_d_ff=128, first_dense_layers=1)

# recurrentgemma-style hybrid: RG-LRU blocks with a (4, 128) depthwise
# conv kernel leaf (the conv kernels) + local attention
HYBRID_CHECK_CFG = ArchConfig(
    name="bench-hybrid-aligned", family="hybrid", n_layers=3,
    d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, vocab=320,
    head_dim=64, sliding_window=16, block_pattern=("rec", "rec", "attn"),
    lru_width=128, conv_width=4)

MODEL_CHECK_CFGS = {"dense": (MODEL_CHECK_CFG, 48),
                    "moe": (MOE_CHECK_CFG, 48),
                    "hybrid": (HYBRID_CHECK_CFG, 32)}


def model_step_setup(cfg: ArchConfig = MODEL_CHECK_CFG, C: int = 1,
                     B: int = 2, S: int = 64, device="cpu"):
    """(api, fed state, cohort batch) for a check config on `device`."""
    api = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = steplib.init_fed_state(gen, api, masking.MaskSpec(), C=C)
    tokens = (torch.arange(B * S, dtype=torch.int32, device=device)
              .reshape(B, S) * 3) % cfg.vocab
    return api, state, {"tokens": tokens.expand(C, B, S)}


def masked_block_shapes(state) -> list:
    """Distinct trailing-2D block shapes of every masked leaf."""
    return sorted({tuple(t.shape[-2:]) for t in tu.leaves(state["scores"])
                   if t is not None})


def masked_leaf_shapes(state) -> list:
    """Distinct full leaf shapes (C, L[, E], K, N) of the score tree."""
    return sorted({tuple(t.shape) for t in tu.leaves(state["scores"])
                   if t is not None})


class _Materialized:
    """A model api whose forward first turns every `MaskedLeaf` of its
    params into plain m * w: the materializing path."""

    def __init__(self, api):
        self._api = api

    def __getattr__(self, name):
        return getattr(self._api, name)

    def forward(self, params, batch, **kw):
        return self._api.forward(tu.tree_map(
            lambda p: masking.materialize_leaf(p)
            if isinstance(p, masking.MaskedLeaf) else p, params), batch, **kw)


class LeafShapeRule(op_lint.OpRule):
    """f32 values of a score leaf's shape (C, L[, E], K, N) or of one
    cohort's slice (L[, E], K, N): the port's steps loop over cohorts, so
    the slice is the leaf's shape a cohort's step computes on."""

    name = "weight-f32-temporary"

    def __init__(self, leaf_shape):
        self._rules = [op_lint.weight_f32_temporaries(leaf_shape)]
        if len(leaf_shape) > 3:
            self._rules.append(op_lint.weight_f32_temporaries(leaf_shape[1:]))

    def check_eqn(self, ev):
        return [f for r in self._rules for f in r.check_eqn(ev)]


class CountRule(op_lint.OpRule):
    """Counts what a rule would report, and reports nothing."""

    def __init__(self, rule):
        self._rule, self.n = rule, 0

    def check_eqn(self, ev):
        self.n += len(list(self._rule.check_eqn(ev)))
        return ()


def _walk_counts(step, state, batch, block_shapes, leaf_shapes) -> dict:
    rules = {("block", sh): op_lint.weight_f32_temporaries(sh)
             for sh in block_shapes}
    rules.update({("mask", sh): op_lint.mask_materialization(sh)
                  for sh in block_shapes})
    rules.update({("leaf", sh): LeafShapeRule(sh) for sh in leaf_shapes})
    counters = {k: CountRule(r) for k, r in rules.items()}
    with op_lint.OpWalker(list(counters.values())):
        step(state, batch)
    return {k: c.n for k, c in counters.items()}


def model_step_weight_defs(cfg: ArchConfig = MODEL_CHECK_CFG, S: int = 48,
                           device="cpu") -> dict:
    """The end-to-end invariant on a whole-model train step, at two
    granularities:

      * block shapes -- the trailing-2D tile one fused launch consumes
        ((K, N) dense blocks, the (K, N) of a stacked (E, K, N) expert
        leaf, the (W, C) of a conv kernel leaf): the fused path must
        define ZERO f32 values and ZERO masks at any of them outside the
        kernels, forward and backward;
      * leaf shapes (C, L[, E], K, N) -- where the materializing path
        pays (hash uniforms, sigmoid(s), the STE mask); the claim is
        relative: it defines strictly more than the fused path at every
        leaf.

    Returns ``{"block_shapes": {"KxN": {"eff", "fused", "fused_masks"}},
    "leaf_shapes": {"CxLxKxN": {"eff", "fused"}}, "fused_launches":
    {kernel: launches of the fused step alone}}`` (no launch on the
    CPU, where the wrappers run their plain versions)."""
    scfg = steplib.StepConfig(lam=0.1, lr=0.5)
    counts = {}
    for eff in (False, True):
        api, state, batch = model_step_setup(cfg, S=S, device=device)
        blocks, leaves = masked_block_shapes(state), masked_leaf_shapes(state)
        step = steplib.make_train_step(_Materialized(api) if eff else api,
                                       scfg)
        before = dict(dispatch.LAUNCHES)
        counts[eff] = _walk_counts(step, state, batch, blocks, leaves)
        if not eff:
            launched = {k: n - before[k] for k, n in dispatch.LAUNCHES.items()
                        if n > before[k]}
    name = lambda sh: "x".join(map(str, sh))
    return {"block_shapes": {name(sh): {
                "eff": counts[True]["block", sh],
                "fused": counts[False]["block", sh],
                "fused_masks": counts[False]["mask", sh]} for sh in blocks},
            "leaf_shapes": {name(sh): {
                "eff": counts[True]["leaf", sh],
                "fused": counts[False]["leaf", sh]} for sh in leaves},
            "fused_launches": launched}
