"""Mixture weights, layer priors, degrees and Gaussian-mixture reweighting.

Port of the single-device functions of `gnn_track_finding_tpu.ops.priors`
(priors.py:37-138, 342-470):

  * compute_mixture_weights  (helper.py:76-96)
  * compute_prior_probabilities (helper.py:30-63)
  * update_degrees (helper.py:67-73)
  * reweight_stage: the table-resident double prior/reweight + degree
    recount of an extrapolation iteration (extrapolate_merged_states.py:
    554-566), whose side-norm distinct counts go through the CUDA kernel
    of ops/distinct_kernel.py on the card;
  * prior_reweight (priors.py:149-339): one fused prior + reweight pass
    under an edge partition, each node's tables built on its owner rank.

Every per-node count here is an integer count (exact whatever the order),
and every float per-node sum is a row sum over the (N, K) in-edge table:
no float scatter-add, whose CUDA atomics would reorder the sum.  `group`
(an edge partition's process group, None on one device) all-sums the
counts' local partials.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import collect, distinct_kernel, linalg


def count_by(idx: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """Integer count of the masked entries per value of idx in [0, size)."""
    slot = torch.where(mask, idx, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=idx.device)
    out.index_add_(0, slot, torch.ones_like(slot))
    return out[:size]


def _state_membership(g: GraphState, use_updated: bool) -> torch.Tensor:
    return g.has_updated if use_updated else g.edge_mask


def compute_mixture_weights(g: GraphState, use_updated: bool,
                            group=None) -> GraphState:
    """weight = 1 / len(state dict at the head node) (helper.py:88-94)."""
    member = _state_membership(g, use_updated)
    count = collect.allsum(count_by(g.dst, member, g.num_padded_nodes),
                           group).to(g.dtype)
    w = 1.0 / torch.clamp(count, min=1.0)
    new_w = torch.where(member, w[g.dst], 0.0)
    if use_updated:
        return g.replace(upd_weight=new_w)
    return g.replace(seed_weight=new_w)


def compute_prior_probabilities(g: GraphState, use_updated: bool,
                                group=None) -> GraphState:
    """prior = 1 / (#active same-src-layer edges into the head node)
    (helper.py:43-63); inactive entries keep their previous prior."""
    member = _state_membership(g, use_updated)
    eligible = member & g.active & g.edge_mask
    key = g.dst * g.n_layers + g.e_src_layer
    count = collect.allsum(
        count_by(key, eligible, g.num_padded_nodes * g.n_layers), group)
    prior = 1.0 / torch.clamp(count[key].to(g.dtype), min=1.0)
    old = g.upd_prior if use_updated else g.seed_prior
    new = torch.where(eligible, prior, old)
    if use_updated:
        return g.replace(upd_prior=new)
    return g.replace(seed_prior=new)


def update_degrees(g: GraphState, group=None) -> GraphState:
    """Active in-degree per node (helper.py:67-73)."""
    deg = collect.allsum(
        count_by(g.dst, g.edge_mask & g.active, g.num_padded_nodes), group)
    return g.replace(degree=deg)


def initialize_edge_activation(g: GraphState) -> GraphState:
    """All existing edges start activated (helper.py:24-25)."""
    return g.replace(active=g.edge_mask)


def _layer_counts(ok_tab: torch.Tensor, layer_col: torch.Tensor,
                  n_l: int) -> torch.Tensor:
    """(rows, n_l + 1) int64 count of the ok cells of each source layer;
    layer_col holds each slot's layer, n_l on padding slots, whose column
    counts nothing."""
    count = torch.zeros((ok_tab.shape[0], n_l + 1), dtype=torch.int64,
                        device=ok_tab.device)
    count.scatter_add_(1, layer_col, ok_tab.to(torch.int64))
    count[:, n_l] = 0
    return count


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
        count_slot = torch.gather(_layer_counts(start, layer_col, n_l), 1,
                                  layer_col).to(dtype)
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


def owner_tables(g: GraphState, group, routing=None):
    """This rank's node rows of prior_reweight's tables, built on their
    owner: (ok (rows, K) bool, x (rows, K) with +inf on cells that are not
    ok, wl (rows, K), node_x (rows,), in_src_layer (rows, K)).

    With `routing` (parallel/edge_shard.OwnerRouting, this rank's shard)
    each edge sends its (x, w * L, member) payload to its head's owner
    (one all_to_all; owner rows interleaved, node r*D + rank); without it
    the (N, K) partial tables reduce-scatter to contiguous row blocks.
    Either way a table row holds exactly the single-device row's cells
    (priors._reweight_tables), one writer per cell; on an edge-partitioned
    stack the rows are the union's, B * N_event / D per rank."""
    n, k_tab = g.in_edges.shape
    member = g.has_updated & g.active & g.edge_mask
    xs = g.upd_xyzr[:, 0]
    wl = torch.where(member, g.upd_weight * g.upd_likelihood, 0.0)
    node_x = g.gnn_xyzr[:, 0].contiguous()
    if routing is not None:
        rows = n // routing.n_shards
        vals = torch.stack([torch.where(member, xs, 0.0), wl,
                            member.to(g.dtype)], dim=1)
        recv = collect.route_to_owners(vals, routing.owner, routing.pos,
                                       routing.bucket, group)
        my = dist.get_rank(group)
        rr = routing.recv_row[my].reshape(-1)
        ss = routing.recv_slot[my].reshape(-1)
        valid = rr >= 0
        ok = valid & (recv[:, 2] > 0.5)
        x_tab = slot_table(torch.where(ok, rr, rows), ss, recv[:, 0], rows,
                           k_tab, float("inf"))
        wl_tab = slot_table(torch.where(valid, rr, rows), ss, recv[:, 1],
                            rows, k_tab, 0.0)
        block = collect.owner_block_interleaved
    else:
        if not collect.owner_shards(n, group):
            raise ValueError(f"{n} node rows do not split over the group")
        row = torch.where(member, g.dst, n)
        ok_part = slot_table(row, g.slot_in, True, n, k_tab, False)
        x_tab = collect.ownsum(slot_table(row, g.slot_in, xs, n, k_tab, 0.0),
                               group)
        ok_own = collect.ownor(ok_part, group)
        x_tab = torch.where(ok_own, x_tab, float("inf"))
        wl_tab = collect.ownsum(slot_table(row, g.slot_in, wl, n, k_tab, 0.0),
                                group)
        block = collect.owner_block
    return (x_tab < float("inf"), x_tab, wl_tab, block(node_x, group),
            block(g.in_src_layer, group))


def prior_reweight(g: GraphState, cfg: PipelineConfig, group,
                   routing=None) -> GraphState:
    """Fused prior recompute + Gaussian-mixture reweight, one pass of the
    reference's back-to-back calls (extrapolate_merged_states.py:554-559),
    under an edge partition (JAX priors.py:149-278).

    Each rank builds its owner rows of the tables (owner_tables), computes
    the per-node results there (per-layer counts, mixture denominator as
    the table's row sum, node x, and the side-norm distinct counts through
    distinct_kernel on the owner's (N/D, K) rows), and only the
    (N, L + 4) packed results are gathered back; each edge reads its head's
    row.  The row contents and every product are those of one
    reweight_stage pass, so a pass is bitwise that pass's on the same
    device, also on an edge-partitioned stack, whose owner rows are the
    union's.  (The JAX module's edge_distinct A/B branch is not ported.)"""
    n = g.num_padded_nodes
    n_l = g.n_layers
    dtype = g.dtype
    member = g.has_updated & g.active & g.edge_mask
    xs = g.upd_xyzr[:, 0]
    wl = torch.where(member, g.upd_weight * g.upd_likelihood, 0.0)

    ok_own, x_own, wl_own, nx_own, layer_own = owner_tables(g, group, routing)
    layer_col = torch.where(layer_own >= 0, layer_own, n_l)
    results = torch.cat([
        _layer_counts(ok_own, layer_col, n_l)[:, :n_l].to(dtype),
        torch.sum(wl_own, dim=1)[:, None], nx_own[:, None],
        distinct_kernel.distinct_counts(ok_own, x_own, nx_own)], dim=1)
    table = collect.gather_rows(results, group)                 # (N, L + 4)
    # the row of each edge's head: owner-major under the interleaved
    # routing, node order under the contiguous blocks
    pe = table[routing.own_idx if routing is not None else g.dst]
    count_e = torch.gather(pe[:, :n_l], 1,
                           g.e_src_layer[:, None]).squeeze(1)
    denom_e = pe[:, n_l]
    node_x_e = pe[:, n_l + 1]

    new_prior = torch.where(member, 1.0 / torch.clamp(count_e, min=1.0),
                            g.upd_prior)
    left = xs < node_x_e
    norms = torch.clamp(torch.where(
        member, torch.where(left, pe[:, n_l + 2], pe[:, n_l + 3]), 1.0),
        min=1.0)
    w_new = (wl * new_prior / torch.clamp(denom_e, min=linalg.tiny(dtype))
             / norms)
    drop = member & (w_new < cfg.reweight_threshold)
    return g.replace(upd_prior=new_prior,
                     upd_weight=torch.where(member, w_new, g.upd_weight),
                     active=g.active & ~drop)
