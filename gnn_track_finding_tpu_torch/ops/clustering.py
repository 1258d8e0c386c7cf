"""Gaussian-mixture reduction (clustering) over the nodes of the graph.

Port of the single-device `gnn_track_finding_tpu.ops.clustering.cluster`
(clustering.py:40-77, 226-282, 470-496): for every node whose state dict
holds 3..15 entries, the GMR core (cluster_kernel.cluster_core) merges the
best chi2 pair and greedily absorbs further states by KL distance; the
in-edges of the states left unabsorbed are deactivated.

There is one code path.  The member in-edges of each node are compacted
to the first kc slots in insertion order; the gated nodes' edge-id rows
are compacted, in node order, to the front of a static (N, kc) row table
(a cumsum scatter, JAX clustering.py:240-252, with room for every node)
whose live row count stays on the device; the table and the round's
per-edge state tensors go to the core — the CUDA kernel on the card reads
the member slots through the ids, the plain version on the CPU gathers
packed rows first — and the narrow results scatter back to node space.
No shape depends on the data and nothing is read back to the host.
Every scatter writes one value per real cell; out-of-range writes go to
one extra dump row that is sliced off.

Under an edge partition (`group` and `routing`, JAX clustering.py:186-224,
293-386) each rank routes its edges' state rows to their head node's
owner rank, runs the same core on its gated owner rows (compacted the
same way into a static (N / D)-row table, the count on the device), and
the narrow results are gathered back (`owner_core_inputs`, `cluster`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.state import GraphState, slot_table
from gnn_track_finding_tpu_torch.ops import cluster_kernel, collect

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
    ids: torch.Tensor           # (rows,) node of each row; N past the count
    tab: torch.Tensor           # (rows, kc) member edge ids, -1 padded
    states: cluster_kernel.SlotStates   # the round's per-edge fields
    node_xyzr: torch.Tensor     # (rows, 4)
    klthr: torch.Tensor         # (rows,) per-row KL threshold
    chi2_thr: float
    member_slot: torch.Tensor   # (N, K) membership of the in-edge table
    count: torch.Tensor         # () int64 live rows (the leading ones)


def core_inputs(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                kl_thresholds: torch.Tensor | None = None,
                kc: int = KC) -> CoreInputs:
    """Gated compaction: the member in-edge ids of the nodes with 3..15
    members, compacted to kc slots in insertion order (so each row's
    members are its leading entries), the gated nodes' rows first in node
    order.  The table holds N rows: a fixed N / 3 bound (JAX's) would not
    hold, since a node's members are its in-edges and E / 3 exceeds N (the
    full event gates 26,150 of 57,344 nodes).  Rows past the count hold no
    member (tab -1) and come out of the core not found."""
    n = g.num_padded_nodes
    member = (g.has_updated if use_updated else g.edge_mask) & g.edge_mask
    member_slot = _member_slots(g, member)
    tab, n_members = _compact_member_edges(g, member_slot, kc)
    gate = ((n_members > cfg.cluster_min_edges - 1)
            & (n_members < cfg.cluster_max_edges + 1))
    chi2_thr, kl_thr = cfg.cluster_thresholds(use_updated)
    ids, node, live = gated_rows(gate)
    if kl_thresholds is None:
        klthr = torch.full((n,), kl_thr, dtype=g.dtype, device=g.device)
    else:
        klthr = kl_thresholds.to(g.dtype)[node]
    return CoreInputs(ids=ids, tab=torch.where(live[:, None], tab[node], -1),
                      states=round_states(g, use_updated),
                      node_xyzr=g.xyzr[node], klthr=klthr, chi2_thr=chi2_thr,
                      member_slot=member_slot, count=torch.sum(gate))


def gated_rows(gate: torch.Tensor):
    """The static compaction of a (rows,) gate (a cumsum scatter, JAX
    clustering.py:240-252) -> (ids (rows,): the gated rows first, in
    order, then `rows`, the dump row; the same clamped to a readable row;
    live (rows,): ids < rows)."""
    n = gate.shape[0]
    dest = torch.where(gate, torch.cumsum(gate, dim=0) - 1, n)
    ids = torch.full((n + 1,), n, dtype=torch.int64, device=gate.device)
    ids[dest] = torch.arange(n, device=gate.device)
    ids = ids[:n]
    return ids, torch.clamp(ids, max=n - 1), ids < n


def owner_table(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                group, routing, kc: int = KC):
    """THIS rank's owner rows of a clustering round before compaction (JAX
    clustering.py:293-369), under the edge partition -> (tab (rows, kc)
    member positions in the received buffer, -1 padded; gate (rows,);
    states: the received buffer's columns; member_slot (N, K)).

    The (N, K) membership table is OR-combined over the group; every
    edge's packed state row [p_sv | p_cov | j_sv | j_cov | prior | xyzr]
    (29 values) rides one all_to_all to its head's owner.  The received
    (D * bucket, 29) buffer is the core's per-edge tensors, read through
    column views, and `tab` holds positions in that buffer.  Owner rows
    are the interleaved nodes r*D + rank, rows = N / D.  On a stacked
    batch N is the union's B * N_event; since N_event % D == 0 a node
    keeps its single event's owner, and the table has B * N_event / D
    rows."""
    n, k_tab = g.in_edges.shape
    rows = n // routing.n_shards
    member = (g.has_updated if use_updated else g.edge_mask) & g.edge_mask
    member_slot = collect.allor(_member_slots(g, member), group)
    recv = collect.route_to_owners(
        cluster_kernel.pack_states(round_states(g, use_updated)),
        routing.owner, routing.pos, routing.bucket, group)
    my = torch.distributed.get_rank(group)
    rr = routing.recv_row[my].reshape(-1)
    # each owner cell's position in the received buffer
    pos_tab = slot_table(torch.where(rr >= 0, rr, rows),
                         routing.recv_slot[my].reshape(-1),
                         torch.arange(rr.shape[0], device=g.device), rows,
                         k_tab, -1)
    mem_own = collect.owner_block_interleaved(member_slot, group)
    rank_own = torch.cumsum(mem_own, dim=1) - 1
    ok = mem_own & (rank_own < kc)
    r_idx = torch.arange(rows, device=g.device)[:, None].expand(rows, k_tab)
    tab = slot_table(torch.where(ok, r_idx, rows).reshape(-1),
                     torch.where(ok, rank_own, 0).reshape(-1),
                     pos_tab.reshape(-1), rows, kc, -1)
    count = torch.sum(mem_own, dim=1)
    gate = ((count > cfg.cluster_min_edges - 1)
            & (count < cfg.cluster_max_edges + 1))
    return tab, gate, cluster_kernel.unpack_states(recv), member_slot


def owner_core_inputs(g: GraphState, cfg: PipelineConfig, use_updated: bool,
                      group, routing,
                      kl_thresholds: torch.Tensor | None = None,
                      kc: int = KC) -> CoreInputs:
    """The compacted rows of THIS rank's gated owner nodes (owner_table),
    the gated rows first in owner-row order in a static (N / D, kc)
    table, as core_inputs compacts them: `ids` are owner rows, N / D past
    the live count, which stays on the device (on a stacked batch: the
    union's static B * N_event / D rows, every event's gated rows in
    one table)."""
    tab, gate, states, member_slot = owner_table(g, cfg, use_updated, group,
                                                 routing, kc)
    ids, row, live = gated_rows(gate)
    chi2_thr, kl_thr = cfg.cluster_thresholds(use_updated)
    if kl_thresholds is None:
        klthr = torch.full(ids.shape, kl_thr, dtype=g.dtype, device=g.device)
    else:
        klthr = collect.owner_block_interleaved(kl_thresholds.to(g.dtype),
                                                group)[row]
    return CoreInputs(ids=ids, tab=torch.where(live[:, None], tab[row], -1),
                      states=states,
                      node_xyzr=collect.owner_block_interleaved(g.xyzr,
                                                                group)[row],
                      klthr=klthr, chi2_thr=chi2_thr, member_slot=member_slot,
                      count=torch.sum(gate))


def _expand(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row results scattered to n rows; other rows zero.  Rows whose
    id is n (past the live count) land in a dump row that is sliced off."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out[ids] = vals
    return out[:n]


def cluster(g: GraphState, cfg: PipelineConfig, use_updated: bool,
            kl_thresholds: torch.Tensor | None = None,
            kc: int = KC, group=None, routing=None) -> GraphState:
    """One GMR clustering round over the whole graph.

    kl_thresholds: optional per-node (N,) KL acceptance thresholds (the
    calibration LUT); None -> the config's scalar threshold.
    group, routing: the edge partition (parallel/edge_shard.py); the core
    runs on each rank's owner rows and the (rows, 14) results and
    (rows, kc) uint8 verdicts are gathered back, then put in node order by
    the static interleaving permutation."""
    n = g.num_padded_nodes
    if group is None:
        x = core_inputs(g, cfg, use_updated, kl_thresholds, kc)
    else:
        if routing is None:
            raise ValueError("edge-partitioned clustering needs the owner "
                             "routing (parallel/edge_shard.build_owner_routing)")
        x = owner_core_inputs(g, cfg, use_updated, group, routing,
                              kl_thresholds, kc)
    core = cluster_kernel.cluster_core(
        x.states, x.tab, x.node_xyzr, x.klthr, x.count, chi2_thr=x.chi2_thr,
        cfg=cfg)
    if group is None:
        return apply_core(g, x, core, kc)
    found_c, pm_c, pc_c, mprior_c, deact_c = core
    d = routing.n_shards
    rows = n // d
    res = collect.gather_rows(_expand(torch.cat([
        found_c[:, None].to(g.dtype), pm_c, pc_c, mprior_c[:, None]],
        dim=1), x.ids, rows), group)                              # (N, 14)
    deact = collect.gather_rows(
        _expand(deact_c.to(torch.uint8), x.ids, rows), group) > 0
    # owner-major -> node order: node i is row (i % D) * rows + i // D
    i = torch.arange(n, device=g.device)
    perm = (i % d) * rows + i // d
    res, deact = res[perm], deact[perm]
    found, pm, pc, mprior = res[:, 0] > 0.5, res[:, 1:4], res[:, 4:13], \
        res[:, 13]
    return _apply_cluster_results(g, x.member_slot, found, pm,
                                  pc.reshape(n, 3, 3), mprior, deact, kc)


def apply_core(g: GraphState, x: CoreInputs, core: tuple,
               kc: int = KC) -> GraphState:
    """One device's tail of `cluster`: the core's narrow per-row results
    (found, pm, pc, mprior, deact) scattered back to node space and
    applied (_apply_cluster_results)."""
    n = g.num_padded_nodes
    found, pm, pc, mprior, deact = (_expand(v, x.ids, n) for v in core)
    return _apply_cluster_results(g, x.member_slot, found, pm,
                                  pc.reshape(n, 3, 3), mprior, deact, kc)


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
