"""Numerical failure detection.

Port of `gnn_track_finding_tpu.utils.guards` (guards.py:1-41).  The
reference has no failure handling at all (SURVEY.md section 5: a failed
stage leaves its last gpickles; restart is manual).  Here the host driver
can cheaply audit the device state between iterations: NaN/Inf incursions
in the live state tensors, mask consistency, and edge/node invariants.
One device reduction per check, read back together; raises or returns a
report.
"""

from __future__ import annotations

from typing import Dict

import torch

from gnn_track_finding_tpu_torch.graph.state import GraphState


def _all_finite(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """All entries finite where keep (broadcast over trailing axes)."""
    keep = keep.reshape(keep.shape + (1,) * (x.dim() - keep.dim()))
    return torch.all(torch.isfinite(torch.where(keep, x, 0.0)))


def check_state(g: GraphState, strict: bool = False) -> Dict[str, bool]:
    """Returns {check: ok}; raises FloatingPointError on failure when
    strict."""
    em = g.edge_mask
    checks = {
        "seed_sv_finite": _all_finite(g.seed_sv, em),
        "seed_cov_finite": _all_finite(g.seed_cov, em),
        "upd_sv_finite": _all_finite(g.upd_sv, g.has_updated & em),
        "merged_finite": _all_finite(g.merged_state, g.has_merged),
        "weights_finite": _all_finite(g.seed_weight + g.upd_weight, em),
        "active_subset_mask": torch.all(~g.active | g.edge_mask),
        "edges_within_alive_nodes": torch.all(
            ~em | (g.node_mask[g.src] & g.node_mask[g.dst])),
    }
    values = torch.stack(list(checks.values())).tolist()
    checks = {k: bool(v) for k, v in zip(checks, values)}
    if strict:
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise FloatingPointError(f"graph state checks failed: {bad}")
    return checks
