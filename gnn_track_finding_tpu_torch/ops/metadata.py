"""State-metadata pruning between iterations.

Port of `gnn_track_finding_tpu.ops.metadata.remove_state_metadata`
(metadata.py:17-28; src/update/remove_state_metadata.py:31-53): after
extraction removes nodes, updated states keyed by vanished edges drop
out, then the seed priors and the updated prior/reweight are recomputed
(one table-resident pass, which also refreshes the degrees).
"""

from __future__ import annotations

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.ops import priors


def remove_state_metadata(g: GraphState, cfg: PipelineConfig) -> GraphState:
    g = g.replace(has_updated=g.has_updated & g.edge_mask)
    g = priors.compute_prior_probabilities(g, use_updated=False)
    return priors.reweight_stage(g, cfg, n_passes=1)
