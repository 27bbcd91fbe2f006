"""Wire-purity rules over a round's recorded collectives (the
reference's `repro.analysis.collective_lint`).

The packed uplink's contract: the only values that may cross a
collective in the mask round are

  * bit-packed word streams (the 1 Bpp uplink itself: int32 tensors
    holding uint32 bits, whose rows are ceil(n/32) words of a mask
    leaf's per-shard size n),
  * the float sidecar leaves' mean over pods -- per-shard float-tree
    shapes, cohort axis included -- and
  * O(1) scalar metrics (the round's bit total).

Everything else is a leak: an f32 score or weight tree in an all-gather
sends 32x what the codec meters; an unpacked bool/uint8 mask 8x, an int32
one 32x.  `CollectivePurityRule` enforces the contract as a strict
allowlist over every site `comm_model.record_collectives` recorded, so
the metered bits and the wire's payload cannot drift apart unseen.

Findings carry two rule names:
  * ``collective-f32-weight``    -- a float operand not on the allowlist;
  * ``collective-unpacked-mask`` -- a mask-sized integer operand that is
    not a word stream.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis import comm_model
from repro_torch.analysis.report import Finding

# collective operands with at most this many integer elements that are no
# word stream are O(1) bookkeeping, not a mask stream
_SCALAR_SLACK_ELEMS = 32


class CollectivePurityRule:
    """Strict allowlist over collective operands (see the module doc)."""

    name = "collective-wire-purity"

    def __init__(self, allowed_float_shapes=frozenset(), *,
                 word_rows=frozenset(),
                 max_small_elems: int = _SCALAR_SLACK_ELEMS):
        self._allowed = frozenset(tuple(s) for s in allowed_float_shapes)
        self._rows = frozenset(word_rows)
        self._max_small = max_small_elems

    def check_site(self, site: comm_model.CollectiveSite) -> list:
        if site.prim not in comm_model.COLLECTIVE_PRIMS or site.shape == ():
            return []                # not a collective, or a scalar metric
        where = f"{site.prim}[{','.join(site.axes)}]"
        if site.dtype.startswith(("float", "bfloat")):
            if site.shape in self._allowed:
                return []            # float-sidecar mean
            return [Finding(
                "collective-f32-weight", where,
                f"{site.dtype}{list(site.shape)} operand is not a packed "
                f"word stream, a float-sidecar leaf, or a scalar")]
        if comm_model.classify_site(site, word_rows=self._rows) == "uplink":
            return []                # packed words
        if site.elems > self._max_small:
            return [Finding(
                "collective-unpacked-mask", where,
                f"{site.dtype}{list(site.shape)} operand: unpacked "
                f"mask-sized integer data on the wire")]
        return []


def purity_findings(sites: Sequence[comm_model.CollectiveSite],
                    allowed_float_shapes=frozenset(),
                    word_rows=frozenset()) -> list:
    """Run the purity rule over recorded sites."""
    rule = CollectivePurityRule(allowed_float_shapes, word_rows=word_rows)
    return [f for s in sites for f in rule.check_site(s)]


def round_purity_findings(sites, state_shapes, state_sh, mesh) -> list:
    """Purity findings of a recorded round: the float allowlist and the
    word rows come from the state's own per-shard shapes."""
    return purity_findings(
        sites, comm_model.float_shard_shapes(state_shapes, state_sh, mesh),
        comm_model.mask_word_rows(state_shapes, state_sh, mesh))


def arch_collective_report(arch: str, algo: str = "fedpm_reg", *, mesh,
                           C: Optional[int] = None, smoke: bool = True,
                           codec: str = "bitpack", packed: bool = True,
                           start=None) -> dict:
    """Run and record one (arch, algorithm) round cell on this rank, lint
    its collectives, and return the findings with the cost model and the
    round's metrics.  Every rank of the mesh must call it."""
    model = comm_model.arch_round_comm_model(
        arch, algo, mesh=mesh, C=C, smoke=smoke, codec=codec,
        packed=packed, start=start)
    sites, state_shapes, state_sh, _scfg, mesh_used, metrics = \
        model.pop("_run")
    findings = round_purity_findings(sites, state_shapes, state_sh,
                                     mesh_used)
    return {"findings": findings, "model": model,
            "n_sites": model["n_sites"], "metrics": metrics}
