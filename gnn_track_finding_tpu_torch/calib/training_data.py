"""KL-distance training-data generation for threshold calibration.

Port of `gnn_track_finding_tpu.calib.training_data` (training_data.py:
1-163), a re-design of learn_KL_linear_model/generate_training_data
(generate_events.py:36-176, compute_KL_distance.py:11-87): simulate seeded
toy events, seed per-edge track states with the same stages the pipeline
uses, and emit one row per in-edge state pair per node:

    kl_dist   pairwise KL distance between the two edge states
    emp_var   empirical variance of the node's xy edge gradients
              (helper.py:446, the LUT feature of empvar.lut)
    degree    number of edge states at the node (the kl_degree.lut feature)
    truth     1 when node and both neighbours share the truth particle
              (compute_KL_distance.py:73-85)

The rows use the production parabolic joint states, so the calibrated
thresholds transfer to the pipeline they gate.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.graph.state import GraphState
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import linalg


def _pairwise_rows(g: GraphState, cfg: PipelineConfig) -> np.ndarray:
    """Rows (kl_dist, emp_var, degree, truth) for every state pair: the
    JAX module's host loop, on host copies of a prepared state."""
    tab = g.in_edges.cpu().numpy()
    src = g.src.cpu().numpy()
    truth = g.truth.cpu().numpy()
    joint = g.seed_joint.cpu().numpy().astype(np.float64)
    jcov = g.seed_joint_cov.cpu().numpy().astype(np.float64)
    grad = g.grad_stats.cpu().numpy()

    rows = []
    for node in range(g.n_nodes):
        edges = tab[node]
        edges = edges[edges >= 0]
        d = len(edges)
        if d <= 1:
            continue
        emp_var = grad[node, 1]
        means = joint[edges]
        covs = jcov[edges]
        invs = np.linalg.inv(covs)
        nb_truth = truth[src[edges]]
        node_truth = truth[node]
        for i in range(d):
            for j in range(i):
                dc = covs[i] - covs[j]
                di = invs[j] - invs[i]
                trace = np.trace(dc * di)           # elementwise (ref quirk)
                dm = means[i] - means[j]
                kl = trace + dm @ (invs[i] + invs[j]) @ dm
                t = int(node_truth == nb_truth[i] == nb_truth[j])
                rows.append((kl, emp_var, d, t))
    return np.asarray(rows, np.float64)


def _block_rows(g: GraphState, cfg: PipelineConfig, start: int, stop: int
                ) -> torch.Tensor:
    """(pairs, 4) rows of the nodes start..stop, on the graph's device:
    the (B, K, K) pairwise KL of their in-edge states, the pairs i > j of
    valid slots at nodes with more than one state, in (node, i, j) order."""
    tab = g.in_edges[start:stop]
    valid = tab >= 0
    e = torch.clamp(tab, min=0)
    sv = torch.where(valid[..., None], g.seed_joint[e], 0.0)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    cov = torch.where(valid[..., None, None], g.seed_joint_cov[e], eye)
    nb_truth = g.truth[g.src[e]]
    node_truth = g.truth[start:stop]
    kl = linalg.kl_distance(sv[:, :, None], cov[:, :, None],
                            sv[:, None], cov[:, None],
                            bug_compat=cfg.bug_compat)          # (B, K, K)
    k = tab.shape[1]
    ar = torch.arange(k, device=g.device)
    degree = valid.sum(dim=1)
    ok = ((ar[:, None] > ar[None, :])[None] & valid[:, :, None]
          & valid[:, None, :] & (degree > 1)[:, None, None])
    same = ((nb_truth[:, :, None] == nb_truth[:, None, :])
            & (nb_truth[:, :, None] == node_truth[:, None, None]))
    b_idx, i_idx, j_idx = torch.nonzero(ok, as_tuple=True)
    f64 = torch.float64
    return torch.stack([kl[b_idx, i_idx, j_idx].to(f64),
                        g.grad_stats[start + b_idx, 1].to(f64),
                        degree[b_idx].to(f64),
                        same[b_idx, i_idx, j_idx].to(f64)], dim=1)


def extract_metadata_trackml(cfg: PipelineConfig, g: GraphState,
                             block: int = 2048) -> np.ndarray:
    """KL training rows from a real event graph (JAX
    training_data.py:65-142).

    The reference extracts calibration metadata from the production event
    too (learn_KL_parabolic_model/src/generate_training_data/
    extract_metadata_trackml_parabolic_model.py:15-99): for every node
    with >1 seed state, one row per state pair with the pairwise KL
    distance (elementwise-trace form under bug_compat, ibid.:15-17), the
    node's empirical xy-gradient variance ('xy_edge_gradient_mean_var'[1],
    ibid.:60), the state count, and truth = 1 when the node and both
    neighbours share the truth particle (ibid.:85-99).

    g: a prepared GraphState (pipeline.prepare), on any device; the rows
    are computed there, `block` nodes at a time (a (block, K, K, 3, 3)
    temporary per step), and read back once.  Returns (rows, 4) float64 =
    (kl_dist, emp_var, degree, truth), in the JAX function's row order."""
    parts = [_block_rows(g, cfg, start, min(start + block, g.n_nodes))
             for start in range(0, g.n_nodes, block)]
    if not parts:
        return np.zeros((0, 4))
    return torch.cat(parts).cpu().numpy()


def generate_training_data(num_events: int = 50, seed: int = 0,
                           cfg: PipelineConfig | None = None,
                           num_tracks: int = 20, *,
                           device: torch.device | str = "cuda",
                           dtype: torch.dtype = torch.float64) -> np.ndarray:
    """(rows, 4) array over `num_events` seeded toy events, each built and
    prepared on `device` at `dtype`."""
    cfg = cfg or PipelineConfig(node_bucket=256, edge_bucket=1024)
    all_rows = []
    for ev_i in range(num_events):
        ev = toymc.generate_event(num_tracks=num_tracks, seed=seed + ev_i)
        g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                              device=device, dtype=dtype)
        rows = _pairwise_rows(pipeline.prepare(g, cfg), cfg)
        if rows.size:
            all_rows.append(rows)
    return np.concatenate(all_rows, axis=0)


def save_training_csv(rows: np.ndarray, path: str) -> None:
    header = "kl_dist,emp_var,degree,truth"
    np.savetxt(path, rows, delimiter=",", header=header, comments="")
