"""Distances between updated track states at each node.

Port of `gnn_track_finding_tpu.analysis.state_distances`
(state_distances.py:1-52), the same host code over host copies of the
state's tensors.

Re-design of calculate_distance_between_updated_states/
calculate_distance_between_updated_track_states.py:27-104: pairwise chi2
([a, b] block Mahalanobis) and KL distances between the UPDATED states a
node received during message passing — the distributions that informed the
iteration-3 clustering thresholds.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, as_numpy


def updated_state_distances(g: GraphState, cfg: PipelineConfig
                            ) -> Dict[str, np.ndarray]:
    tab = as_numpy(g.in_edges)
    has_upd = as_numpy(g.has_updated & g.edge_mask)
    joint = as_numpy(g.upd_joint).astype(np.float64)
    jcov = as_numpy(g.upd_joint_cov).astype(np.float64)
    src = as_numpy(g.src)
    truth = as_numpy(g.truth)

    chi2s, kls, truths = [], [], []
    for node in range(g.n_nodes):
        edges = tab[node]
        edges = edges[edges >= 0]
        edges = edges[has_upd[edges]]
        if len(edges) < 2:
            continue
        means = joint[edges]
        covs = jcov[edges]
        invs = np.linalg.inv(covs)
        for i in range(len(edges)):
            for j in range(i):
                d = means[i][:2] - means[j][:2]
                c = covs[i][:2, :2] + covs[j][:2, :2]
                chi2s.append(d @ np.linalg.inv(c) @ d)
                dc = covs[i] - covs[j]
                di = invs[j] - invs[i]
                trace = np.trace(dc * di) if cfg.bug_compat else np.trace(dc @ di)
                dm = means[i] - means[j]
                kls.append(trace + dm @ (invs[i] + invs[j]) @ dm)
                truths.append(int(truth[node] == truth[src[edges[i]]]
                                  == truth[src[edges[j]]]))
    return {"chi2": np.asarray(chi2s), "kl": np.asarray(kls),
            "truth": np.asarray(truths)}
