"""Gaussian-mixture reduction (clustering) over the nodes of the graph.

Port of the single-device `gnn_track_finding_tpu.ops.clustering.cluster`
(clustering.py:40-77, 226-282, 470-496): for every node whose state dict
holds 3..15 entries, the GMR core (cluster_kernel.cluster_core) merges the
best chi2 pair and greedily absorbs further states by KL distance; the
in-edges of the states left unabsorbed are deactivated.

There is one code path.  The member in-edges of each node are compacted
to the first kc slots in insertion order; the (cg, kc) edge-id rows of the
cg gated nodes and the round's per-edge state tensors go to the core — the
CUDA kernel on the card reads the member slots through the ids, the plain
version on the CPU gathers packed rows first — and the narrow results
scatter back to node space.  Every scatter writes one value per real cell;
out-of-range writes go to one extra dump row that is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import cluster_kernel

KC = 16  # compact table width == reference's upper degree gate


def _member_slots(g: GraphState, member: torch.Tensor) -> torch.Tensor:
    """(N, K) membership flags of the in-edge table."""
    n, k = g.in_edges.shape
    row = torch.where(member & g.edge_mask, g.dst, n)
    return slot_table(row, g.slot_in, True, n, k, False) & (g.in_edges >= 0)


def _member_rank(g: GraphState, member_slot: torch.Tensor):
    """Each edge's membership and rank among its head's member in-edges."""
    rank_slot = torch.cumsum(member_slot, dim=1) - 1
    return member_slot[g.dst, g.slot_in], rank_slot[g.dst, g.slot_in]


def _compact_member_edges(g: GraphState, member_slot: torch.Tensor,
                          kc: int = KC) -> Tuple[torch.Tensor, torch.Tensor]:
    """First kc member in-edges per node in insertion order:
    (edge ids (N, kc), -1 padded; member count (N,))."""
    n = g.num_padded_nodes
    member_e, rank_e = _member_rank(g, member_slot)
    # padding edges carry dst = 0 / slot_in = 0 and so read node 0 slot
    # 0's membership: the edge mask keeps them out
    ok = member_e & g.edge_mask & (rank_e >= 0) & (rank_e < kc)
    compact = slot_table(torch.where(ok, g.dst, n), torch.where(ok, rank_e, 0),
                         torch.arange(g.num_padded_edges, device=g.device),
                         n, kc, -1)
    return compact, torch.sum(member_slot, dim=1)


def round_states(g: GraphState, use_updated: bool) -> cluster_kernel.SlotStates:
    """The per-edge state fields of a round; neighbour coordinates are the
    state dict's own record (seed-time e_xyzr tail, a strided view, or the
    extrapolation-time upd_xyzr snapshot)."""
    if use_updated:
        return cluster_kernel.SlotStates(g.upd_sv, g.upd_cov, g.upd_joint,
                                         g.upd_joint_cov, g.upd_prior,
                                         g.upd_xyzr)
    return cluster_kernel.SlotStates(g.seed_sv, g.seed_cov, g.seed_joint,
                                     g.seed_joint_cov, g.seed_prior,
                                     g.e_xyzr[:, :4])


class CoreInputs(NamedTuple):
    """The compacted rows a clustering round hands to the GMR core."""
    ids: torch.Tensor           # (cg,) node of each row (the gated nodes)
    tab: torch.Tensor           # (cg, kc) member edge ids, -1 padded
    states: cluster_kernel.SlotStates   # the round's per-edge fields
    node_xyzr: torch.Tensor     # (cg, 4)
    klthr: torch.Tensor         # (cg,) per-row KL threshold
    chi2_thr: float
    member_slot: torch.Tensor   # (N, K) membership of the in-edge table


def core_inputs(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                kl_thresholds: torch.Tensor | None = None,
                kc: int = KC) -> CoreInputs:
    """Gated compaction: the member in-edge ids of the nodes with 3..15
    members, compacted to kc slots in insertion order (so each row's
    members are its leading entries).  The gated rows are counted
    (one host sync): a fixed N / 3 bound would not hold, since a node's
    members are its in-edges and E / 3 exceeds N."""
    dtype = g.dtype
    member = (g.has_updated if use_updated else g.edge_mask) & g.edge_mask
    member_slot = _member_slots(g, member)
    tab, count = _compact_member_edges(g, member_slot, kc)
    gate = ((count > cfg.cluster_min_edges - 1)
            & (count < cfg.cluster_max_edges + 1))
    chi2_thr, kl_thr = cfg.cluster_thresholds(use_updated)
    ids = torch.nonzero(gate).squeeze(1)                            # (cg,)
    tab_c = tab[ids]
    if kl_thresholds is None:
        klthr_c = torch.full(ids.shape, kl_thr, dtype=dtype, device=g.device)
    else:
        klthr_c = kl_thresholds.to(dtype)[ids]
    return CoreInputs(ids=ids, tab=tab_c,
                      states=round_states(g, use_updated),
                      node_xyzr=g.xyzr[ids], klthr=klthr_c, chi2_thr=chi2_thr,
                      member_slot=member_slot)


def cluster(g: GraphState, cfg: PipelineConfig, use_updated: bool,
            kl_thresholds: torch.Tensor | None = None,
            kc: int = KC) -> GraphState:
    """One GMR clustering round over the whole graph.

    kl_thresholds: optional per-node (N,) KL acceptance thresholds (the
    calibration LUT); None -> the config's scalar threshold."""
    n = g.num_padded_nodes
    x = core_inputs(g, cfg, use_updated, kl_thresholds, kc)
    found_c, pm_c, pc_c, mprior_c, deact_c = cluster_kernel.cluster_core(
        x.states, x.tab, x.node_xyzr, x.klthr, chi2_thr=x.chi2_thr, cfg=cfg)

    # scatter the narrow per-row results back to node space
    def expand(vals):
        out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=g.device)
        out[x.ids] = vals
        return out

    return _apply_cluster_results(
        g, x.member_slot, expand(found_c), expand(pm_c),
        expand(pc_c).reshape(n, 3, 3), expand(mprior_c), expand(deact_c), kc)


def _apply_cluster_results(g: GraphState, member_slot, found, pm, pc, mprior,
                           deact_slot, kc: int = KC) -> GraphState:
    """Write merged states and apply the simultaneous edge deactivation;
    each member edge reads its verdict through its rank among the head's
    member in-edges (its compact-table position)."""
    member_e, rank_e = _member_rank(g, member_slot)
    in_compact = member_e & (rank_e >= 0) & (rank_e < kc)
    deact = (in_compact & deact_slot[g.dst, torch.clamp(rank_e, 0, kc - 1)]
             & g.edge_mask)
    return g.replace(
        has_merged=g.has_merged | found,
        merged_state=torch.where(found[:, None], pm, g.merged_state),
        merged_cov=torch.where(found[:, None, None], pc, g.merged_cov),
        merged_prior=torch.where(found, mprior, g.merged_prior),
        active=g.active & ~deact,
    )
