"""repro_torch.analysis -- static guards for the mask-native invariants
(the reference's `repro.analysis`), behind one command line
(`python -m repro_torch.tools.repro_lint`):

  * ``op_lint``      -- the aten-op walker, the twin of the reference's
    ``jaxpr_lint`` (a torch program has no jaxpr): weight-shaped f32
    temporaries, materialized masks, dtype promotions outside the
    kernels, and the in-place rule in place of buffer donation;
  * ``stream_cover`` -- the mask-stream coverage checker: every
    `MaskedLeaf`'s (seed, off, size) intervals tile its flat hash stream
    exactly, and no two (leaf, shard, cohort) streams share a seed;
  * ``source_lint``  -- AST rules over ``src/repro_torch/`` (bare seeds,
    kernel oracles and boundaries, env-knob docs, the materializing-call
    allowlist);
  * ``collective_lint`` + ``comm_model`` -- wire purity of a round's
    recorded collectives (only packed words, the float sidecar and
    scalar metrics may cross) and the per-round cost model (bits and
    ring bytes per collective per mesh axis);
  * ``shard_lint``   -- `launch/sharding.py`'s rules against reality:
    big leaves silently replicated, and declared shardings against the
    blocks the ranks hold.

``model_check`` carries the aligned whole-model configs the op walker's
gate runs on (import it directly: it pulls in the model zoo).
"""
from repro_torch.analysis.comm_model import (CollectiveSite,
                                             record_collectives)
from repro_torch.analysis.op_lint import (OpWalker, count_weight_f32_defs,
                                          lint_ops)
from repro_torch.analysis.report import Finding

__all__ = ["CollectiveSite", "Finding", "OpWalker", "count_weight_f32_defs",
           "lint_ops", "record_collectives"]
