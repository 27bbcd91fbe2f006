"""The static wire cost of the aggregator tree's root hop (the framework-
free `tree_root_record_bits` and `tree_root_round_bits` of
`repro.analysis.comm_model`; the rest of that module is not ported yet).

What one edge aggregator forwards upstream a commit is one
`runtime.agg_tree.PooledFoldRecord`: per weight class the packed
per-bit counts of every mask leaf plus a (size, version, count) header,
the pooled float, metric and entropy sums as a sidecar, and a CRC32
header.  None of it depends on how many clients folded: the O(params)
root-traffic claim, which the tree engine's measured `root_bits` meets
exactly.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.api.codecs import HEADER_BITS
from repro_torch.core import aggregation

# per weight class on the edge -> root wire: size (f32) + version + count
CLASS_HEADER_BITS = 96


def tree_root_record_bits(leaf_params: Sequence[int], *,
                          acc_bits: int = 16, n_classes: int = 1,
                          float_elems: int = 0,
                          n_metrics: int = 0) -> dict:
    """Wire cost of ONE edge's `PooledFoldRecord`.  `leaf_params` are the
    mask leaves' true parameter counts; each leaf's count accumulator
    covers the word-padded bit domain (32 * ceil(n/32) positions) at
    `acc_bits` a position (`aggregation.packed_count_bits`)."""
    wire = 0
    for n in leaf_params:
        padded = 32 * ((int(n) + 31) // 32)
        wire += aggregation.packed_count_bits(padded, acc_bits)
    wire = n_classes * (wire + CLASS_HEADER_BITS)
    sidecar = 32 * n_classes * (int(float_elems) + int(n_metrics) + 1)
    return {"wire_bits": int(wire), "sidecar_bits": int(sidecar),
            "header_bits": int(HEADER_BITS),
            "total_bits": int(wire + sidecar + HEADER_BITS)}


def tree_root_round_bits(leaf_params: Sequence[int], n_edges: int, *,
                         acc_bits: int = 16, n_classes: int = 1,
                         float_elems: int = 0,
                         n_metrics: int = 0) -> dict:
    """A commit's root traffic over the whole tree: one pooled record an
    edge, O(params) x n_edges, independent of the client count."""
    rec = tree_root_record_bits(leaf_params, acc_bits=acc_bits,
                                n_classes=n_classes,
                                float_elems=float_elems,
                                n_metrics=n_metrics)
    return {"n_edges": int(n_edges),
            "record_bits": rec,
            "root_bits": int(n_edges * (rec["wire_bits"]
                                        + rec["sidecar_bits"])),
            "root_header_bits": int(n_edges * rec["header_bits"]),
            "root_total_bits": int(n_edges * rec["total_bits"])}
