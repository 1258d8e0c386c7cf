"""Mixture weights, layer priors, degrees and Gaussian-mixture reweighting.

Port of the single-device functions of `gnn_track_finding_tpu.ops.priors`
(priors.py:37-138, 342-470):

  * compute_mixture_weights  (helper.py:76-96)
  * compute_prior_probabilities (helper.py:30-63)
  * update_degrees (helper.py:67-73)
  * reweight_stage: the table-resident double prior/reweight + degree
    recount of an extrapolation iteration (extrapolate_merged_states.py:
    554-566), whose side-norm distinct counts go through the CUDA kernel
    of ops/distinct_kernel.py on the card.

Every per-node count here is an integer count (exact whatever the order),
and every float per-node sum is a row sum over the (N, K) in-edge table:
no float scatter-add, whose CUDA atomics would reorder the sum.
"""

from __future__ import annotations

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import distinct_kernel, linalg


def count_by(idx: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """Integer count of the masked entries per value of idx in [0, size)."""
    slot = torch.where(mask, idx, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=idx.device)
    out.index_add_(0, slot, torch.ones_like(slot))
    return out[:size]


def _state_membership(g: GraphState, use_updated: bool) -> torch.Tensor:
    return g.has_updated if use_updated else g.edge_mask


def compute_mixture_weights(g: GraphState, use_updated: bool) -> GraphState:
    """weight = 1 / len(state dict at the head node) (helper.py:88-94)."""
    member = _state_membership(g, use_updated)
    count = count_by(g.dst, member, g.num_padded_nodes).to(g.dtype)
    w = 1.0 / torch.clamp(count, min=1.0)
    new_w = torch.where(member, w[g.dst], 0.0)
    if use_updated:
        return g.replace(upd_weight=new_w)
    return g.replace(seed_weight=new_w)


def compute_prior_probabilities(g: GraphState, use_updated: bool) -> GraphState:
    """prior = 1 / (#active same-src-layer edges into the head node)
    (helper.py:43-63); inactive entries keep their previous prior."""
    member = _state_membership(g, use_updated)
    eligible = member & g.active & g.edge_mask
    key = g.dst * g.n_layers + g.e_src_layer
    count = count_by(key, eligible, g.num_padded_nodes * g.n_layers)
    prior = 1.0 / torch.clamp(count[key].to(g.dtype), min=1.0)
    old = g.upd_prior if use_updated else g.seed_prior
    new = torch.where(eligible, prior, old)
    if use_updated:
        return g.replace(upd_prior=new)
    return g.replace(seed_prior=new)


def update_degrees(g: GraphState) -> GraphState:
    """Active in-degree per node (helper.py:67-73)."""
    deg = count_by(g.dst, g.edge_mask & g.active, g.num_padded_nodes)
    return g.replace(degree=deg)


def initialize_edge_activation(g: GraphState) -> GraphState:
    """All existing edges start activated (helper.py:24-25)."""
    return g.replace(active=g.edge_mask)


def _reweight_tables(g: GraphState):
    """The reweight membership (updated & active & existing), each edge's
    in-table row (non-members -> dump row N), and the x table whose +inf
    on unwritten cells doubles as the membership flag, plus node x."""
    n, k_tab = g.in_edges.shape
    member = g.has_updated & g.active & g.edge_mask
    row = torch.where(member, g.dst, n)
    x_tab = slot_table(row, g.slot_in, g.upd_xyzr[:, 0], n, k_tab,
                       float("inf"))
    return member, row, x_tab, g.gnn_xyzr[:, 0].contiguous()


def distinct_inputs(g: GraphState):
    """(ok_tab, x_tab, node_x): the first-pass side-norm distinct-count
    inputs of reweight_stage."""
    _, _, x_tab, node_x = _reweight_tables(g)
    return x_tab < float("inf"), x_tab, node_x


def reweight_stage(g: GraphState, cfg: PipelineConfig,
                   n_passes: int = 2) -> GraphState:
    """Table-resident prior recompute + mixture reweight, n_passes times,
    then the degree refresh (priors.py:342-447).

    Edge payloads scatter ONCE into (N, K) in-tables at their unique
    (dst, slot_in) cells; every pass is row-local table math (per-layer
    counts, mixture denominator, side-norm distinct counts, new weights,
    drops); per-edge results gather back once at the end."""
    n = g.num_padded_nodes
    n_l = g.n_layers
    k_tab = g.in_edges.shape[1]
    dtype = g.dtype
    dev = g.device

    member, row, x_tab, node_x = _reweight_tables(g)
    ok_tab = x_tab < float("inf")
    layer_tab = g.in_src_layer

    wl_tab = slot_table(row, g.slot_in, g.upd_weight * g.upd_likelihood, n,
                        k_tab, 0.0)
    lik_tab = slot_table(row, g.slot_in, g.upd_likelihood, n, k_tab, 0.0)
    act_tab = slot_table(torch.where(g.edge_mask & g.active, g.dst, n),
                         g.slot_in, True, n, k_tab, False)

    left_tab = x_tab < node_x[:, None]   # inf sentinel -> False, masked
    prior_out = torch.zeros((n, k_tab), dtype=dtype, device=dev)
    w_out = torch.zeros((n, k_tab), dtype=dtype, device=dev)
    # layer of each slot, with padding slots (-1) in an extra column n_l
    layer_col = torch.where(layer_tab >= 0, layer_tab, n_l)

    for _ in range(n_passes):
        start = ok_tab
        count_nl = torch.zeros((n, n_l + 1), dtype=torch.int64, device=dev)
        count_nl.scatter_add_(1, layer_col, start.to(torch.int64))
        count_nl[:, n_l] = 0                    # padding slots count nothing
        count_slot = torch.gather(count_nl, 1, layer_col).to(dtype)
        prior_tab = 1.0 / torch.clamp(count_slot, min=1.0)
        denom = torch.sum(wl_tab, dim=1)
        counts2 = distinct_kernel.distinct_counts(start, x_tab, node_x)
        norm_tab = torch.clamp(
            torch.where(left_tab, counts2[:, 0:1], counts2[:, 1:2]), min=1.0)
        w_new = (wl_tab * prior_tab
                 / torch.clamp(denom, min=linalg.tiny(dtype))[:, None]
                 / norm_tab)
        prior_out = torch.where(start, prior_tab, prior_out)
        w_out = torch.where(start, w_new, w_out)
        drop_tab = start & (w_new < cfg.reweight_threshold)
        ok_tab = start & ~drop_tab
        act_tab = act_tab & ~drop_tab
        wl_tab = torch.where(ok_tab, w_new * lik_tab, 0.0)

    degree = torch.sum(act_tab, dim=1)

    # gather-out, once: an edge was dropped (in whichever pass) iff its
    # final weight sits below the threshold (priors.py:432-441)
    prior_e = prior_out[g.dst, g.slot_in]
    w_e = w_out[g.dst, g.slot_in]
    dropped_e = member & (w_e < cfg.reweight_threshold)
    return g.replace(
        upd_prior=torch.where(member, prior_e, g.upd_prior),
        upd_weight=torch.where(member, w_e, g.upd_weight),
        active=g.active & ~dropped_e,
        degree=degree,
    )
