"""Directional tag propagation — the reference's parallel-CCA experiment.

Port of `gnn_track_finding_tpu.graph.tag_propagation` (tag_propagation.py:
1-64), a re-design of tag_propagation/tag_propagation.py:64-167: every node
starts with its own tag; each round a node adopts the min (or max) tag
among its INWARD neighbours — those at smaller radius, respecting track
direction — and iteration stops when fewer than `flip_fraction` of nodes
changed.  A round is two masked row-gathers over the edge tables (plain
indexing); the loop is a Python loop that reads the flip count once per
round.

(The production CCA is graph/cca.py; this module exists for parity with
the reference's experimental extractor and as a directional primitive.)
"""

from __future__ import annotations

import torch

from gnn_track_finding_tpu_torch.graph.state import GraphState


def propagate_tags(g: GraphState, edge_ok=None, minimize: bool = True,
                   flip_fraction: float = 0.10) -> torch.Tensor:
    """(N,) int64 tags after convergence (<flip_fraction of nodes changing
    per round; at least one round).

    A node pulls tags only from neighbours with SMALLER radius
    (tag_propagation.py:99-116): information flows outward along tracks.
    """
    n = g.num_padded_nodes
    edge_ok = g.edge_mask if edge_ok is None else edge_ok

    in_e = torch.clamp(g.in_edges, min=0)
    out_e = torch.clamp(g.out_edges, min=0)
    # inward = neighbour radius smaller than the node's
    r_node = g.xyzr[:, 3:4]
    in_nb = g.src[in_e]
    out_nb = g.dst[out_e]
    in_src_r = g.e_xyzr[in_e][..., 3]        # static src radius per in-slot
    in_ok = (g.in_edges >= 0) & edge_ok[in_e] & (in_src_r < r_node)
    out_ok = ((g.out_edges >= 0) & edge_ok[out_e]
              & (g.out_head_xyzr[..., 3] < r_node))

    init = torch.arange(n, device=g.device)
    fill = n if minimize else -1
    n_alive = max(int(g.node_mask.sum()), 1)

    tags = init
    while True:
        t_in = torch.where(in_ok, tags[in_nb], fill)
        t_out = torch.where(out_ok, tags[out_nb], fill)
        if minimize:
            new = torch.minimum(tags, torch.minimum(t_in.min(dim=1).values,
                                                    t_out.min(dim=1).values))
        else:
            new = torch.maximum(tags, torch.maximum(t_in.max(dim=1).values,
                                                    t_out.max(dim=1).values))
        flips = int(((new != tags) & g.node_mask).sum())
        tags = new
        if flips / n_alive < flip_fraction:
            break
    return torch.where(g.node_mask, tags, init)
