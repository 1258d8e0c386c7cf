"""Padded struct-of-arrays graph state, held on one torch device.

Same fields, shapes and meanings as `gnn_track_finding_tpu.graph.state`
(state.py:35-153); see that module for the reference semantics of each
field.  Orientation: every undirected hit pair is two directed edges,
interleaved so that the reverse of edge e is e ^ 1; the state of edge
e = (src -> dst) is owned by the head node dst.

Dtypes: float fields are the working dtype (float64 for parity, float32
for speed); masks are torch.bool; EVERY integer field (indices, tables,
labels, counts) is torch.int64, so tensors index each other directly.
The JAX package stores them as int32; tests compare values, not dtypes.

A state is immutable by convention: stages return `g.replace(...)` with
new tensors and never write into the tensors of the state they got.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

# static (host-side) metadata, not tensors
STATIC_FIELDS = ("n_nodes", "n_edges", "max_degree", "n_layers")


@dataclasses.dataclass(frozen=True)
class GraphState:
    # ---- static metadata ----
    n_nodes: int          # true node count
    n_edges: int          # true directed edge count
    max_degree: int       # K of the edge tables
    n_layers: int         # distinct vivl layers

    # ---- node arrays, padded to N ----
    node_mask: torch.Tensor      # (N,)   bool: node still in the graph
    xyzr: torch.Tensor           # (N,4)  hit coordinates (x, y, z, r)
    gnn_xyzr: torch.Tensor       # (N,4)  live GNN_Measurement coordinates
    vivl: torch.Tensor           # (N,2)  (volume_id, in_volume_layer_id)
    layer_idx: torch.Tensor      # (N,)   dense layer index in [0, n_layers)
    truth: torch.Tensor          # (N,)   dense truth-particle index (-1 pad)
    component: torch.Tensor      # (N,)   connected-component label
    degree: torch.Tensor         # (N,)   active in-degree

    has_merged: torch.Tensor     # (N,)   bool: clustering produced a merged state
    merged_state: torch.Tensor   # (N,3)  parabolic [a, b, c]
    merged_cov: torch.Tensor     # (N,3,3)
    merged_prior: torch.Tensor   # (N,)
    grad_stats: torch.Tensor     # (N,4)  [mean_xy, var_xy, mean_zr, var_zr]

    # ---- directed edge arrays, padded to E ----
    edge_mask: torch.Tensor      # (E,)   bool: edge exists
    src: torch.Tensor            # (E,)   tail node
    dst: torch.Tensor            # (E,)   head node (owns the edge state)
    active: torch.Tensor         # (E,)   bool 'activated' flag

    seed_sv: torch.Tensor        # (E,3)   parabolic [a, b, c] seed
    seed_cov: torch.Tensor       # (E,3,3)
    seed_joint: torch.Tensor     # (E,3)   joint [a, b, tau]
    seed_joint_cov: torch.Tensor  # (E,3,3)
    seed_prior: torch.Tensor     # (E,)
    seed_weight: torch.Tensor    # (E,)

    has_updated: torch.Tensor    # (E,)   bool: updated state present
    upd_sv: torch.Tensor         # (E,3)
    upd_cov: torch.Tensor        # (E,3,3)
    upd_joint: torch.Tensor      # (E,3)
    upd_joint_cov: torch.Tensor  # (E,3,3)
    upd_prior: torch.Tensor      # (E,)
    upd_weight: torch.Tensor     # (E,)
    upd_likelihood: torch.Tensor  # (E,)
    upd_xyzr: torch.Tensor       # (E,4)  tail GNN coords when the update was written

    # ---- per-node fixed-K edge tables (insertion order) ----
    in_edges: torch.Tensor       # (N,K) edge ids with dst == node, -1 pad
    out_edges: torch.Tensor      # (N,K) edge ids with src == node, -1 pad
    slot_in: torch.Tensor        # (E,)  e == in_edges[dst[e], slot_in[e]]
    slot_out: torch.Tensor       # (E,)  e == out_edges[src[e], slot_out[e]]
    e_xyzr: torch.Tensor         # (E,8) [xyzr[src] | xyzr[dst]]
    e_src_layer: torch.Tensor    # (E,)  dense layer index of the tail
    out_head_xyzr: torch.Tensor  # (N,K,4) head coordinates of each out-table slot
    in_src_x: torch.Tensor       # (N,K) tail x of each in-table slot
    in_src_layer: torch.Tensor   # (N,K) tail layer of each in-table slot (-1 pad)
    mirror: torch.Tensor         # (E,)  tau donor edge (reference set()-order defect)
    mirror_src: torch.Tensor     # (E,)  src[mirror]

    def replace(self, **changes) -> "GraphState":
        return dataclasses.replace(self, **changes)

    @property
    def num_padded_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_padded_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.xyzr.dtype

    @property
    def device(self) -> torch.device:
        return self.xyzr.device

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Every tensor field as a host numpy array (static fields left out)."""
        return {name: getattr(self, name).detach().cpu().numpy()
                for name in tensor_fields()}


def slot_table(rows: torch.Tensor, slots: torch.Tensor, vals, n_rows: int,
               width: int, fill) -> torch.Tensor:
    """(n_rows, width, ...) table with vals written at (rows, slots), fill
    elsewhere.  Each real cell has one writer; rows == n_rows is a dump
    row (for padded or masked-out entries) that is sliced off."""
    if not isinstance(vals, torch.Tensor):
        # a python scalar: made on the device (no host-to-device copy)
        vals = torch.full((), vals, device=rows.device)
    tab = torch.full((n_rows + 1, width) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=rows.device)
    tab[rows, slots] = vals
    return tab[:n_rows]


def as_numpy(x) -> np.ndarray:
    """A host numpy array of x: a tensor on any device, or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor_fields():
    return [f.name for f in dataclasses.fields(GraphState)
            if f.name not in STATIC_FIELDS]


def from_numpy(arrays: Dict[str, np.ndarray], *, n_nodes: int, n_edges: int,
               max_degree: int, n_layers: int,
               device: torch.device | str, dtype: torch.dtype) -> GraphState:
    """GraphState from per-field numpy arrays (e.g. a JAX GraphState turned
    leaf by leaf into numpy): floats become `dtype`, bools stay bool and
    every integer array becomes int64, on `device`."""
    out = {}
    for name in tensor_fields():
        a = np.asarray(arrays[name])
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.float64)).to(dtype)
        out[name] = t.to(device)
    return GraphState(n_nodes=n_nodes, n_edges=n_edges, max_degree=max_degree,
                      n_layers=n_layers, **out)
