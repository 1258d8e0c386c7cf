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

A state may hold a batch of B events of one pad bucket as their disjoint
union (stack_events, the counterpart of JAX's leading batch axis,
parallel/mesh.py:60-66): each field concatenated event after event, so
that event b's nodes are rows [b*N, (b+1)*N) and its edges rows
[b*E, (b+1)*E), its node indices (NODE_INDEX_FIELDS) offset by b*N and
its edge indices (EDGE_INDEX_FIELDS) by b*E.  The reverse of edge e stays
e ^ 1, since E is even.  Every stage runs on the union unchanged;
`batch` (B, 1 for one event) tells the extraction and the packing to
count, cap and pack per event, over (B, N) / (B, E) views.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# static (host-side) metadata, not tensors
STATIC_FIELDS = ("n_nodes", "n_edges", "max_degree", "n_layers")
# static batch metadata of a stacked state (default: one event)
BATCH_FIELDS = ("batch", "event_nodes", "event_edges")


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

    # ---- batch metadata (static); n_nodes / n_edges are the sums ----
    batch: int = 1                # events in the state
    event_nodes: Tuple[int, ...] = ()  # each event's true node count
    event_edges: Tuple[int, ...] = ()  # each event's true edge count

    def replace(self, **changes) -> "GraphState":
        return dataclasses.replace(self, **changes)

    @property
    def num_padded_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_padded_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def event_shape(self) -> Tuple[int, ...]:
        """The leading shape of a per-event result: () for one event, (B,)
        for a stacked batch of B."""
        return () if self.batch == 1 else (self.batch,)

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
            if f.name not in STATIC_FIELDS + BATCH_FIELDS]


# index fields of a GraphState: node indices, and edge indices (-1 pads
# the edge tables)
NODE_INDEX_FIELDS = ("src", "dst", "mirror_src", "component")
EDGE_INDEX_FIELDS = ("in_edges", "out_edges", "mirror")


def _offset(name: str, t: torch.Tensor, batch: int, step: Tuple[int, int],
            sign: int) -> torch.Tensor:
    """t, the concatenation of `batch` events' field `name`, with
    sign * b * N (a node index field) or sign * b * E (an edge index
    field) added to event b's rows, -1 of the edge tables left as it is;
    any other field as it is.  step: (N, E) of one event."""
    if name in NODE_INDEX_FIELDS:
        by = step[0]
    elif name in EDGE_INDEX_FIELDS:
        by = step[1]
    else:
        return t
    v = t.reshape(batch, -1, *t.shape[1:])
    off = (torch.arange(batch, device=t.device) * (sign * by)).view(
        batch, *([1] * (v.dim() - 1)))
    out = v + off
    if name in ("in_edges", "out_edges"):
        out = torch.where(v >= 0, out, v)
    return out.reshape(t.shape)


def pad_bucket(g: GraphState) -> tuple:
    """What events must share to stack: device, dtype, padded N and E, K,
    layers, and the events already stacked in g."""
    return (g.device, g.dtype, g.num_padded_nodes, g.num_padded_edges,
            g.max_degree, g.n_layers, g.batch)


def stack_events(graphs: Sequence[GraphState]) -> GraphState:
    """B events of one pad bucket as one GraphState, their disjoint union
    (module doc); the state records B and each event's true sizes.  One
    event comes back as it is.  Raises ValueError unless every event has
    the same device, dtype and pad bucket (padded N and E, K, layers), as
    JAX's stacking needs equal shapes."""
    graphs = list(graphs)
    if not graphs:
        raise ValueError("stack_events needs at least one event")
    g0 = graphs[0]
    for g in graphs:
        if pad_bucket(g) != pad_bucket(g0) or g.batch != 1:
            raise ValueError(f"stack_events takes single events of one pad "
                             f"bucket, not {pad_bucket(g0)} and "
                             f"{pad_bucket(g)} (device, dtype, N, E, K, "
                             "layers, batch)")
    if len(graphs) == 1:
        return g0
    batch = len(graphs)
    step = (g0.num_padded_nodes, g0.num_padded_edges)
    return g0.replace(
        n_nodes=sum(g.n_nodes for g in graphs),
        n_edges=sum(g.n_edges for g in graphs), batch=batch,
        event_nodes=tuple(g.n_nodes for g in graphs),
        event_edges=tuple(g.n_edges for g in graphs),
        **{name: _offset(name, torch.cat([getattr(g, name) for g in graphs]),
                         batch, step, 1)
           for name in tensor_fields()})


def unstack_events(g: GraphState) -> List[GraphState]:
    """Each event's GraphState from a stacked one, its offsets removed:
    the inverse of stack_events, bitwise (an event's fields that are no
    index fields are views of g's)."""
    if g.batch == 1:
        return [g]
    batch = g.batch
    step = (g.num_padded_nodes // batch, g.num_padded_edges // batch)
    per = {name: _offset(name, t, batch, step, -1).reshape(
               batch, -1, *t.shape[1:])
           for name, t in ((n, getattr(g, n)) for n in tensor_fields())}
    return [g.replace(n_nodes=g.event_nodes[b], n_edges=g.event_edges[b],
                      batch=1, event_nodes=(), event_edges=(),
                      **{name: v[b] for name, v in per.items()})
            for b in range(batch)]


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
