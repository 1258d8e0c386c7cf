"""Shared-hit identification statistics (agglomerative dendrogram study).

Port of `gnn_track_finding_tpu.analysis.shared_hits` (shared_hits.py:
1-125): the same host linkage over host copies of the state's tensors, and
the study through the port's stages on `device` (the clustering kernel in
stage 1, the distinct-count kernel in stage 2's reweight on a CUDA
device).  `node_dendrogram_maxima` groups the edges by head node with one
stable sort instead of a full-length mask per node (the same maxima in the
same order).

Re-design of the reference's 50-run statistics loop
(r&d/shared_hit_identification/run_dendograms_statistics.sh:4-12 driving
weight_v_angle_dist_stats.py): for every node with >= 2 ACTIVE inward
edges, collect each edge's (mixture_weight, xy gradient dy/dx) feature
pair, keep the truth==1 edges, run average-linkage agglomerative
clustering over the feature pairs, and record the MAXIMUM linkage
distance of the dendrogram (weight_v_angle_dist_stats.py:100-129).  The
distribution of those maxima over many events/iterations is the study's
output — it quantifies how separable shared-hit edge bundles are in
(weight, angle) space.

The linkage math is self-contained (average linkage over Euclidean
pairwise distances on <= 16 points per node) rather than scipy's, with
the numpy operation order of the JAX module, so both give the same bits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import as_numpy
from gnn_track_finding_tpu_torch.models import pipeline, toymc


def average_linkage_max_distance(feats: np.ndarray) -> float:
    """Maximum merge distance of average-linkage agglomerative clustering
    (the np.amax(Z[:, 2]) of weight_v_angle_dist_stats.py:124-126).

    Lance-Williams update for average linkage: when clusters a (size na)
    and b (size nb) merge, d(ab, c) = (na*d(a,c) + nb*d(b,c)) / (na+nb).
    Ties go to the first index of the flattened distance matrix.
    """
    m = feats.shape[0]
    if m < 2:
        return float("nan")
    diff = feats[:, None, :] - feats[None, :, :]
    d = np.sqrt((diff * diff).sum(-1))
    np.fill_diagonal(d, np.inf)
    sizes = np.ones(m)
    last = 0.0
    for _ in range(m - 1):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        last = max(last, float(d[i, j]))
        na, nb = sizes[i], sizes[j]
        # merge j into i
        merged = (na * d[i] + nb * d[j]) / (na + nb)
        d[i] = merged
        d[:, i] = merged
        d[i, i] = np.inf
        sizes[i] = na + nb
        d[j, :] = np.inf
        d[:, j] = np.inf
    return last


def node_dendrogram_maxima(g, truth: np.ndarray,
                           use_updated: bool = False) -> np.ndarray:
    """Per-node maximum dendrogram distances for one network state, in
    ascending node order.

    Features per active inward edge of each node: (mixture_weight,
    dy/dx gradient toward the neighbour), truth==1 edges only — exactly
    the dataframe of weight_v_angle_dist_stats.py:100-118.  A node's edges
    keep their edge-index order (the linkage's tie-breaking reads it)."""
    src = as_numpy(g.src)
    dst = as_numpy(g.dst)
    ok = as_numpy(g.edge_mask & g.active)
    if use_updated:
        ok = ok & as_numpy(g.has_updated)
        weight = as_numpy(g.upd_weight)
    else:
        weight = as_numpy(g.seed_weight)
    xyzr = as_numpy(g.xyzr)
    truth = np.asarray(truth)

    nodes = dst[ok]
    nbrs = src[ok]
    w = weight[ok]
    dx = xyzr[nbrs, 0] - xyzr[nodes, 0]
    dy = xyzr[nbrs, 1] - xyzr[nodes, 1]
    grad = dy / np.where(dx == 0.0, np.finfo(float).tiny, dx)
    keep = np.flatnonzero(truth[nodes] == truth[nbrs])
    keep = keep[np.argsort(nodes[keep], kind="stable")]
    starts = np.flatnonzero(np.diff(nodes[keep], prepend=-1))
    stops = np.append(starts[1:], keep.size)

    maxima = []
    for a, b in zip(starts, stops):
        if b - a < 2:          # reference skips <= 1 active inward edges
            continue
        sel = keep[a:b]
        feats = np.stack([w[sel], grad[sel]], axis=1)
        maxima.append(average_linkage_max_distance(feats))
    return np.asarray(maxima)


def dendrogram_statistics(num_runs: int = 10, seed: int = 0,
                          cfg: PipelineConfig | None = None,
                          num_tracks: int = 16,
                          toy_kwargs: Dict | None = None, *,
                          device: torch.device | str = "cuda"
                          ) -> Dict[str, np.ndarray]:
    """The full repetition study (run_dendograms_statistics.sh:4-12):
    rerun the pipeline over seeded toy events, each built on `device` at
    float64, and record dendrogram maxima after iteration 1's clustering
    (seed weights) and iteration 2's extrapolation (updated weights) — the
    reference's iteration1.txt / iteration2.txt accumulation."""
    cfg = cfg or PipelineConfig(node_bucket=256, edge_bucket=1024)
    toy_kwargs = toy_kwargs or {"edge_dphi_window": 0.12}
    it1: List[np.ndarray] = []
    it2: List[np.ndarray] = []
    for run in range(num_runs):
        ev = toymc.generate_event(num_tracks=num_tracks, seed=seed + run,
                                  **toy_kwargs)
        g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                              device=device)
        g = pipeline.prepare(g, cfg)
        g = pipeline.stage_step(g, cfg, 1)
        it1.append(node_dendrogram_maxima(g, ev.truth, use_updated=False))
        g, _ = pipeline.extract_step(g, cfg, 1)
        g = pipeline.stage_step(g, cfg, 2)
        it2.append(node_dendrogram_maxima(g, ev.truth, use_updated=True))
    cat = lambda xs: (np.concatenate(xs) if xs else np.zeros(0))
    return {"iteration1": cat(it1), "iteration2": cat(it2)}
