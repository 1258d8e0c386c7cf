"""Ingest: raw event arrays -> padded GraphState on a torch device.

Counterpart of `gnn_track_finding_tpu.graph.build.build_graph_state`, in
two halves:

  * a numpy host half (build.py:245-370): dedupe of the undirected pairs
    (first occurrence kept), the interleaved 2i / 2i+1 directed edges,
    dense layer and truth indices, the fixed-K in/out tables in insertion
    order with K doubled past `max_node_degree` as needed, the reference's
    set()-order `mirror` table (build.py:183-224, through the
    NetworkX-order tracker of graph/nxorder.py), and bucket padding;
  * a torch device init (build.py:79-180) that derives every other field
    on the device: the edge tables from one-writer (endpoint, slot)
    scatters, the gather caches and the zero state buffers.

`build_event` returns the GraphState with the host record (node ids,
tracker, mirror) that the parity driver needs; `build_graph_state` the
GraphState alone.  A `mirror` passed in (from the event cache) skips the
order emulation; clean mode without a tracker never reads the mirror and
uses the identity.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.nxorder import RefOrderTracker
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table


@dataclasses.dataclass
class HostEvent:
    """Host-only per-event data beside the GraphState (the JAX `HostEvent`,
    build.py:28-44, without the hit and module id lists nothing here
    reads)."""
    node_ids: np.ndarray                        # original node id per dense node
    tracker: Optional[RefOrderTracker] = None   # feeds run_pipeline's leak replay
    mirror: Optional[np.ndarray] = None         # (e,) set()-order mirror, unpadded
    # particle ids of each node's hits (evaluation/efficiency.evaluate)
    hit_particle_ids: Optional[List[np.ndarray]] = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def connected_components_host(n: int, pairs: np.ndarray) -> np.ndarray:
    """Min-node-index component label per node over undirected pairs (the
    labels of the JAX union-find `connected_components_host`)."""
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


def _host_table(keys: np.ndarray, slots: np.ndarray, n: int, k: int
                ) -> np.ndarray:
    """(n, k) host table of edge ids at (keys[e], slots[e]), -1 elsewhere:
    each row lists a node's edges in edge (insertion) order."""
    tab = np.full((n, k), -1, np.int64)
    tab[keys, slots] = np.arange(keys.shape[0])
    return tab


def compute_mirror(n: int, src: np.ndarray, dst: np.ndarray,
                   orig_of: np.ndarray, orders) -> np.ndarray:
    """Mirror in-edge per directed edge (reference tau-pairing defect,
    helper.py:349-429; JAX build.py:183-224): for each node, the k-th
    neighbour in the reference's set() iteration order borrows tau from
    neighbour d-1-k.  `orders` is RefOrderTracker.neighbour_orders()
    (original ids).  Every neighbour has an in-edge (edges are
    bidirectional), so both lookups resolve: the edge lookup is a
    searchsorted over (dst, src) keys, the dense-id lookup one over the
    sorted original ids."""
    e = len(src)
    mirror = np.arange(e, dtype=np.int64)
    lens = np.fromiter((len(o) if o else 0 for o in orders), np.int64, n)
    total = int(lens.sum())
    if total == 0:
        return mirror
    flat = np.fromiter(itertools.chain.from_iterable(
        o for o in orders if o), np.int64, total)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    node_of = np.repeat(np.arange(n), lens)
    idx = np.arange(total)
    flat_rev = flat[offs[node_of] + offs[node_of + 1] - 1 - idx]

    sorter = np.argsort(orig_of, kind="stable")
    sorted_ids = orig_of[sorter]
    a_dense = sorter[np.searchsorted(sorted_ids, flat)]
    b_dense = sorter[np.searchsorted(sorted_ids, flat_rev)]

    ekeys = dst.astype(np.int64) * n + src
    esort = np.argsort(ekeys, kind="stable")
    ekeys_s = ekeys[esort]
    qa = node_of * np.int64(n) + a_dense
    qb = node_of * np.int64(n) + b_dense
    pa = np.searchsorted(ekeys_s, qa)
    pb = np.searchsorted(ekeys_s, qb)
    if not (np.array_equal(ekeys_s[pa], qa) and np.array_equal(ekeys_s[pb], qb)):
        raise ValueError("a neighbour of the set()-order lists has no in-edge")
    mirror[esort[pa]] = esort[pb]
    return mirror


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
    node_ids: Optional[np.ndarray] = None,
) -> GraphState:
    """The GraphState of one event (build_event without the host record)."""
    return build_event(xyzr, vivl, truth_particle, edge_pairs, cfg,
                       device=device, dtype=dtype, mirror=mirror,
                       component=component, node_ids=node_ids,
                       with_tracker=False)[0]


def build_event(
    xyzr: np.ndarray,
    vivl: np.ndarray,
    truth_particle: np.ndarray,
    edge_pairs: np.ndarray,
    cfg: PipelineConfig,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
    mirror: Optional[np.ndarray] = None,
    component: Optional[np.ndarray] = None,
    node_ids: Optional[np.ndarray] = None,
    with_tracker: bool = True,
    hit_particle_ids: Optional[List[np.ndarray]] = None,
) -> Tuple[GraphState, HostEvent]:
    """-> (GraphState, HostEvent), as the JAX build_graph_state returns.

    mirror: (e,) set()-order mirror edge of each directed edge after
    dedupe, e.g. from the event cache.  Without it, bug_compat ingest (and
    any ingest with_tracker) builds the NetworkX-order tracker and computes
    the mirror; clean mode without a tracker uses the identity.
    component: (n,) ingest component labels; computed here when absent.
    node_ids: (n,) original node ids (the tracker's set() orders hash them);
    default 0..n-1.
    with_tracker: keep the tracker in the HostEvent (run_pipeline's
    extraction-leak replay needs it); otherwise HostEvent.tracker is None.
    hit_particle_ids: the particle ids of each node's hits, one array per
    node, kept in the HostEvent for the TrackML efficiency report."""
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

    orig_of = (np.arange(n, dtype=np.int64) if node_ids is None
               else np.asarray(node_ids, np.int64))
    tracker = None
    if with_tracker or (mirror is None and cfg.bug_compat):
        tracker = RefOrderTracker(n, src, dst, _host_table(dst, slot_in, n, k),
                                  _host_table(src, slot_out, n, k), orig_of)
    if mirror is None:
        mirror = (compute_mirror(n, src, dst, orig_of,
                                 tracker.neighbour_orders())
                  if tracker is not None else np.arange(e, dtype=np.int64))
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
    g = GraphState(n_nodes=n, n_edges=e, max_degree=k,
                   n_layers=len(layers), **dev)
    return g, HostEvent(node_ids=orig_of,
                        tracker=tracker if with_tracker else None,
                        mirror=mirror, hit_particle_ids=hit_particle_ids)


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
