"""Ingest: raw event arrays -> padded GraphState on a torch device.

Counterpart of `gnn_track_finding_tpu.graph.build.build_graph_state`, in
two halves:

  * a numpy host half (build.py:245-370): dedupe of the undirected pairs
    (first occurrence kept), the interleaved 2i / 2i+1 directed edges,
    dense layer and truth indices, the fixed-K in/out tables in insertion
    order with K doubled past `max_node_degree` as needed, and bucket
    padding;
  * a torch device init (build.py:79-180) that derives every other field
    on the device: the edge tables from one-writer (endpoint, slot)
    scatters, the gather caches and the zero state buffers.

The reference's set()-order `mirror` table comes in as an argument (from
the event cache, or from the JAX ingest in tests): computing it needs the
NetworkX-order emulation, which stays in the JAX package.  Clean mode
never reads it and uses the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def connected_components_host(n: int, pairs: np.ndarray) -> np.ndarray:
    """Min-node-index component label per node over undirected pairs (the
    labels of the JAX union-find `connected_components_host`)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    m = pairs.shape[0]
    adj = coo_matrix((np.ones(m, np.int8), (pairs[:, 0], pairs[:, 1])),
                     shape=(n, n))
    _, lab = connected_components(adj, directed=False)
    root = np.full(lab.max(initial=-1) + 1, n, np.int64)
    np.minimum.at(root, lab, np.arange(n))
    return root[lab]


def _slots(keys: np.ndarray) -> np.ndarray:
    """Each edge's position among the edges sharing its key, in edge order
    (its slot in the fixed-K table of that endpoint)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    slot = np.empty(keys.shape[0], np.int64)
    slot[order] = np.arange(keys.shape[0]) - np.searchsorted(sk, sk, side="left")
    return slot


def build_graph_state(
    xyzr: np.ndarray,               # (n, 4) float
    vivl: np.ndarray,               # (n, 2) int (volume_id, in_volume_layer_id)
    truth_particle: np.ndarray,     # (n,) original particle ids
    edge_pairs: np.ndarray,         # (m, 2) undirected pairs in file order
    cfg: PipelineConfig,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
    mirror: Optional[np.ndarray] = None,
    component: Optional[np.ndarray] = None,
) -> GraphState:
    """mirror: (e,) set()-order mirror edge of each directed edge after
    dedupe (required under bug_compat; identity in clean mode).
    component: (n,) ingest component labels; computed here when absent."""
    n = xyzr.shape[0]
    # -- dedupe unordered pairs, keep first occurrence (helper.py:510-518)
    a = np.minimum(edge_pairs[:, 0], edge_pairs[:, 1]).astype(np.int64)
    b = np.maximum(edge_pairs[:, 0], edge_pairs[:, 1]).astype(np.int64)
    _, first_idx = np.unique(a * n + b, return_index=True)
    pairs = edge_pairs[np.sort(first_idx)].astype(np.int64)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    m = pairs.shape[0]
    e = 2 * m
    # directed edges in insertion order: 2i = (u->v), 2i+1 = (v->u)
    src = pairs.reshape(-1)
    dst = pairs[:, ::-1].reshape(-1)

    if component is None:
        component = connected_components_host(n, pairs)
    layers, layer_idx = np.unique(vivl[:, 1], return_inverse=True)
    _, truth_idx = np.unique(truth_particle, return_inverse=True)

    max_deg = int(max(np.bincount(dst, minlength=n).max(initial=0),
                      np.bincount(src, minlength=n).max(initial=0)))
    k = cfg.max_node_degree
    while k < max_deg:
        k *= 2
    slot_in = _slots(dst)
    slot_out = _slots(src)

    if mirror is None:
        if cfg.bug_compat:
            raise ValueError("bug_compat ingest needs the set()-order mirror "
                             "table (event cache or JAX ingest)")
        mirror = np.arange(e, dtype=np.int64)
    mirror = np.asarray(mirror, np.int64)
    if mirror.shape != (e,):
        raise ValueError(f"mirror has shape {mirror.shape}, expected ({e},)")

    n_pad = _round_up(max(n, 1), cfg.node_bucket)
    e_pad = _round_up(max(e, 1), cfg.edge_bucket)

    def pad(x, rows, fill=0):
        out = np.full((rows,) + x.shape[1:], fill, x.dtype)
        out[:x.shape[0]] = x
        return out

    host = dict(
        xyzr=pad(np.asarray(xyzr, np.float64), n_pad),
        vivl=pad(np.asarray(vivl, np.int64), n_pad),
        layer_idx=pad(layer_idx.astype(np.int64), n_pad),
        truth=pad(truth_idx.astype(np.int64), n_pad, fill=-1),
        component=pad(np.asarray(component, np.int64), n_pad),
        src=pad(src, e_pad), dst=pad(dst, e_pad),
        slot_in=pad(slot_in, e_pad), slot_out=pad(slot_out, e_pad),
        # clean mode: identity over the padded range (never read)
        mirror=(pad(mirror, e_pad) if cfg.bug_compat
                else np.arange(e_pad, dtype=np.int64)),
    )
    dev = device_init(host, n, e, k, torch.device(device), dtype)
    return GraphState(n_nodes=n, n_edges=e, max_degree=k,
                      n_layers=len(layers), **dev)


def device_init(h: dict, n: int, e: int, k: int, device: torch.device,
                dtype: torch.dtype) -> dict:
    """Every GraphState tensor from the padded host arrays (build.py:79-180).

    The edge tables and per-slot caches are one-writer scatters of the
    real edges into their (endpoint, slot) cells; padded edges are routed
    to a dump row n_pad that is sliced off.  Unset cells keep the fill
    (0 or -1) of the JAX init."""
    t = {name: torch.from_numpy(v).to(device) for name, v in h.items()}
    xyzr = t["xyzr"].to(dtype)
    n_pad = xyzr.shape[0]
    e_pad = t["src"].shape[0]
    src, dst = t["src"], t["dst"]
    slot_in, slot_out = t["slot_in"], t["slot_out"]
    layer = t["layer_idx"]
    i64 = dict(dtype=torch.int64, device=device)
    f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)

    node_mask = torch.arange(n_pad, device=device) < n
    edge_mask = torch.arange(e_pad, device=device) < e
    e_idx = torch.arange(e_pad, **i64)
    row_src = torch.where(edge_mask, src, n_pad)    # padded edges -> dump row
    row_dst = torch.where(edge_mask, dst, n_pad)

    table = lambda rows, slots, vals, fill: slot_table(rows, slots, vals,
                                                       n_pad, k, fill)
    in_tab = table(row_dst, slot_in, e_idx, -1)
    out_tab = table(row_src, slot_out, e_idx, -1)
    mirror = t["mirror"]
    xyzr_src = xyzr[src]
    xyzr_dst = xyzr[dst]
    layer_src = layer[src]
    mirror_src = torch.where(edge_mask, src[mirror], 0)
    e_xyzr = torch.where(edge_mask[:, None],
                         torch.cat([xyzr_src, xyzr_dst], dim=1), 0.0)
    return dict(
        node_mask=node_mask, xyzr=xyzr, gnn_xyzr=xyzr,
        vivl=t["vivl"], layer_idx=layer, truth=t["truth"],
        component=t["component"], degree=torch.zeros(n_pad, **i64),
        has_merged=b(n_pad), merged_state=f(n_pad, 3),
        merged_cov=f(n_pad, 3, 3), merged_prior=f(n_pad),
        grad_stats=f(n_pad, 4),
        edge_mask=edge_mask, src=src, dst=dst, active=edge_mask,
        seed_sv=f(e_pad, 3), seed_cov=f(e_pad, 3, 3),
        seed_joint=f(e_pad, 3), seed_joint_cov=f(e_pad, 3, 3),
        seed_prior=f(e_pad), seed_weight=f(e_pad),
        has_updated=b(e_pad), upd_sv=f(e_pad, 3), upd_cov=f(e_pad, 3, 3),
        upd_joint=f(e_pad, 3), upd_joint_cov=f(e_pad, 3, 3),
        upd_prior=f(e_pad), upd_weight=f(e_pad), upd_likelihood=f(e_pad),
        upd_xyzr=f(e_pad, 4),
        in_edges=in_tab, out_edges=out_tab,
        slot_in=slot_in, slot_out=slot_out,
        e_xyzr=e_xyzr, e_src_layer=torch.where(edge_mask, layer_src, 0),
        out_head_xyzr=table(row_src, slot_out, xyzr_dst, 0.0),
        in_src_x=table(row_dst, slot_in, xyzr_src[:, 0], 0.0),
        in_src_layer=table(row_dst, slot_in, layer_src, -1),
        mirror=mirror, mirror_src=mirror_src,
    )
