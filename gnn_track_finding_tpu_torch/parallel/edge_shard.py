"""Edge-partitioned execution of one event over a process group.

Port of `gnn_track_finding_tpu.parallel.edge_shard` (edge_shard.py:59-278).
The scale-out axis of this workload is the directed-edge count.  Every
rank of an "edge" group (`edge_group`) holds its own GraphState:

  * the edge fields (EDGE_FIELDS) hold the rank's contiguous block of E/D
    rows; reverse pairs (e, e ^ 1) stay on one rank because E % 2D == 0;
  * node fields and the (N, K) tables are replicated; the edge ids inside
    the tables (in_edges, out_edges, mirror) stay global, and no sharded
    op reads another rank's edge through them;
  * every per-node aggregate is a local partial combined by one explicit
    collective (ops/collect.py); clustering and the prior/reweight passes
    route each edge's payload to its head node's owner rank (OwnerRouting)
    and gather back only the narrow per-node results.

Where JAX jits one program over a mesh with shard_map (prepare and every
iteration, edge_shard.py:245-270), every rank here runs the same static
program with its group: `schedule_sharded` is its body, which reads
nothing on the host, and `run_sharded` the entry point.  On an NCCL group
with CUDA tensors, run_sharded captures the body once per (pad bucket,
routing bucket, group) as one CUDA graph, its collectives inside
(models/pipeline.CapturedSchedule), and replays it per event; a gloo
group cannot be captured and runs it eagerly.  The results say which
(ScheduleResults.path).  An event whose accepted count exceeds the head
cap, or whose FastSV still changed labels after cca.R_CAP rounds (the
same flags on every rank), is rerun on every rank by the exact fallback
(`schedule_sharded_exact`) and counted in pipeline.fallbacks:

    g_loc = edge_shard.shard_graph(g, group)
    r_loc = edge_shard.routing_shard(edge_shard.build_owner_routing(g, d),
                                     rank)
    out = edge_shard.run_sharded(g_loc, cfg, group, r_loc)

A batch of events (graph/state.stack_events: their disjoint union, B*N
nodes and B*E edges) is stacked first and then sharded: shard_graph and
build_owner_routing take the union as they take one event, and every
sharded function runs on it unchanged, so one replay (or one eager run)
covers the batch.  Since N % D == 0, union node b*N + i keeps its
single-event owner i % D; the routing's bucket grows with B and is part
of the program key.  JAX shards each event's edge axis inside its vmap
(P("data", "edge"), mesh.py:40-52), so rank r holds another set of
edges there; the semantics are the same, and the extraction, FastSV's
convergence and the overflow flags are per event either way.  On a stack,
run_sharded takes the events' whole states, from which an overflowed
event reruns alone:

    st = stack_events(graphs)
    r_loc = edge_shard.routing_shard(edge_shard.build_owner_routing(st, d),
                                     rank)
    out = edge_shard.run_sharded(edge_shard.shard_graph(st, group), cfg,
                                 group, r_loc, graphs)
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gnn_track_finding_tpu_torch.graph.state import (GraphState, stack_events,
                                                     unstack_events)
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.ops import collect

# Directed-edge fields (leading axis E); everything else is replicated.
# Field names, not shapes, decide: padded N and E can coincide.
EDGE_FIELDS = frozenset({
    "edge_mask", "src", "dst", "active",
    "seed_sv", "seed_cov", "seed_joint", "seed_joint_cov",
    "seed_prior", "seed_weight",
    "has_updated", "upd_sv", "upd_cov", "upd_joint", "upd_joint_cov",
    "upd_prior", "upd_weight", "upd_likelihood", "upd_xyzr",
    "slot_in", "slot_out", "e_xyzr", "e_src_layer", "mirror",
    "mirror_src",
})

# every process group of the port waits at most this long in a collective
TIMEOUT = timedelta(seconds=60)


def _check_divides(g: GraphState, d: int) -> None:
    if g.num_padded_edges % (2 * d) or g.num_padded_nodes % d:
        raise ValueError(
            f"edge blocks must be even-sized so reverse pairs stay on one "
            f"rank, and node blocks whole: E={g.num_padded_edges}, "
            f"N={g.num_padded_nodes}, D={d}")


def shard_graph(g: GraphState, group) -> GraphState:
    """This rank's GraphState under the edge partition: its contiguous
    block of every edge field, nodes and tables replicated."""
    d = dist.get_world_size(group)
    _check_divides(g, d)
    e_loc = g.num_padded_edges // d
    lo = dist.get_rank(group) * e_loc
    return g.replace(**{f: getattr(g, f)[lo:lo + e_loc] for f in EDGE_FIELDS})


def gather_graph(g: GraphState, group) -> GraphState:
    """The whole state back from every rank's edge block (all_gather of
    each edge field, bools as uint8), on every rank of the group."""
    out = {}
    for f in sorted(EDGE_FIELDS):     # one order on every rank
        t = getattr(g, f)
        if t.dtype == torch.bool:
            out[f] = collect.gather_rows(t.to(torch.uint8), group) > 0
        else:
            out[f] = collect.gather_rows(t, group)
    return g.replace(**out)


@dataclasses.dataclass(frozen=True)
class OwnerRouting:
    """Static routing of per-edge payloads to their head node's owner rank
    (edge_shard.py:106-129).  Node ownership is interleaved: owner(i) =
    i % D, owner-local row i // D, which keeps the (sender, owner) buckets
    balanced.  All arrays depend only on dst, slot_in, edge_mask and D.
    owner / pos / own_idx are per edge (a rank's block after
    routing_shard); recv_row / recv_slot are replicated."""
    n_shards: int
    bucket: int                  # padded bucket capacity (a multiple of 128)
    owner: torch.Tensor          # (E,) owner rank of dst, -1 for padding
    pos: torch.Tensor            # (E,) position in the (sender, owner) bucket
    own_idx: torch.Tensor        # (E,) row of dst in the owner-major table:
    #                              (dst % D) * rows + dst // D
    recv_row: torch.Tensor       # (D, D, B) owner-local node row, -1 padding
    recv_slot: torch.Tensor      # (D, D, B) slot_in of the edge


def build_owner_routing(g: GraphState, n_shards: int) -> OwnerRouting:
    """Host construction of the routing tables (numpy; the arrays equal
    the JAX function's element for element), as int64 tensors on g's
    device."""
    e_pad = g.num_padded_edges
    n_pad = g.num_padded_nodes
    _check_divides(g, n_shards)
    e_loc = e_pad // n_shards
    rows = n_pad // n_shards

    dst = g.dst.cpu().numpy().astype(np.int64)
    slot = g.slot_in.cpu().numpy().astype(np.int64)
    mask = g.edge_mask.cpu().numpy()

    sender = np.arange(e_pad) // e_loc
    owner = np.where(mask, dst % n_shards, -1)

    # bucket positions: rank of each edge within its (sender, owner) pair
    key = sender * n_shards + np.where(mask, owner, 0)
    key = np.where(mask, key, np.int64(n_shards * n_shards))
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.zeros(e_pad, np.int64)
    change = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    start[change] = change
    np.maximum.accumulate(start, out=start)
    pos = np.empty(e_pad, np.int64)
    pos[order] = np.arange(e_pad) - start
    pos = np.where(mask, pos, -1)

    counts = np.bincount(key[mask], minlength=n_shards * n_shards)
    b = int(counts.max()) if counts.size else 1
    b = max(128, -(-b // 128) * 128)      # lane-aligned capacity, as JAX's

    recv_row = np.full((n_shards, n_shards, b), -1, np.int64)
    recv_slot = np.zeros((n_shards, n_shards, b), np.int64)
    m = mask & (pos < b)
    recv_row[owner[m], sender[m], pos[m]] = dst[m] // n_shards
    recv_slot[owner[m], sender[m], pos[m]] = slot[m]

    own_idx = (dst % n_shards) * rows + dst // n_shards
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(g.device)
    return OwnerRouting(n_shards=n_shards, bucket=b, owner=put(owner),
                        pos=put(pos), own_idx=put(own_idx),
                        recv_row=put(recv_row), recv_slot=put(recv_slot))


def routing_shard(r: OwnerRouting, rank: int) -> OwnerRouting:
    """Rank `rank`'s block of the per-edge routing arrays."""
    e_loc = r.owner.shape[0] // r.n_shards
    lo = rank * e_loc
    return dataclasses.replace(r, owner=r.owner[lo:lo + e_loc],
                               pos=r.pos[lo:lo + e_loc],
                               own_idx=r.own_idx[lo:lo + e_loc])


def _check_routing(group, routing: OwnerRouting | None) -> None:
    if routing is not None and routing.n_shards != dist.get_world_size(group):
        raise ValueError(f"routing for {routing.n_shards} ranks used over a "
                         f"group of {dist.get_world_size(group)}")


def extrapolation_stage_sharded(g: GraphState, cfg, group,
                                routing: OwnerRouting | None = None
                                ) -> GraphState:
    """The extrapolation stage edge-partitioned (edge_shard.py:191-215):
    message passing, two prior_reweight passes over the owner all_to_all
    (routing) or the dense reduce-scatter combine (routing None), and the
    degree refresh."""
    _check_routing(group, routing)
    return pipeline.extrapolation_stage(g, cfg, group, routing)


def iteration_sharded(g: GraphState, cfg, i: int, group,
                      routing: OwnerRouting, kl_thresholds=None):
    """One full iteration edge-partitioned (edge_shard.py:218-242): the
    stage, FastSV with (N,) MIN hook combines, extraction and (even
    iterations) metadata pruning.  -> (the rank's GraphState, the
    ExtractionResult, the same on every rank)."""
    _check_routing(group, routing)
    return pipeline.iteration(g, cfg, i, kl_thresholds, group, routing)


def schedule_sharded(g: GraphState, cfg, group, routing: OwnerRouting
                     ) -> pipeline.ScheduleResults:
    """The whole schedule edge-partitioned (edge_shard.py:245-270), the
    program body: prepare and every iteration, FastSV in cca.R_CAP fixed
    rounds, nothing read on the host; the accepted candidates are the same
    on every rank, the graph is the rank's block."""
    _check_routing(group, routing)
    return pipeline.full_pipeline_results(g, cfg, group, routing)


def schedule_sharded_exact(g: GraphState, cfg, group, routing: OwnerRouting
                           ) -> pipeline.ScheduleResults:
    """The exact fallback: the host driver edge-partitioned, FastSV in its
    adaptive loop (one host read per round) and every accepted row pulled,
    eagerly on every rank."""
    _check_routing(group, routing)
    return pipeline.exact_results(pipeline.run_pipeline(
        g, cfg, host_cca=False, group=group, routing=routing))


def captures(g: GraphState, group) -> bool:
    """Whether run_sharded replays a captured program: on an NCCL group
    with CUDA tensors.  gloo collectives cannot be captured."""
    return g.device.type == "cuda" and dist.get_backend(group) == "nccl"


def run_sharded(g: GraphState, cfg, group, routing: OwnerRouting,
                events: Sequence[GraphState] | None = None
                ) -> pipeline.ScheduleResults:
    """The schedule on this rank (its block g and routing): the captured
    program's replay where `captures`, else the body run eagerly; then one
    host read of the overflow flags, and the exact fallback on every rank
    for an event whose flag is set (counted in pipeline.fallbacks).
    Raises if the capture fails.

    On a stacked batch (g.batch = B > 1: this rank's block of the union,
    routing built over the union) every field but `graph` has a leading
    (B,) axis and `path` is a tuple, one per event; `events` are the B
    events' whole states (on this rank's device).  An overflowed event
    reruns alone from events[b], partitioned by itself, since a rank
    holds only its block of the union; its results, widened to the
    largest head cap, and its final state (gathered whole and restacked
    into the union, of which this rank keeps its block) replace the
    batched ones, and the other events keep theirs (as
    pipeline.run_schedule_batched does on one device)."""
    _check_routing(group, routing)
    if g.batch > 1 and (events is None or len(events) != g.batch):
        raise ValueError(f"run_sharded on a stack of {g.batch} events needs "
                         "their whole states (events)")
    if captures(g, group):
        res = pipeline.captured_program(g, cfg, group, routing).replay(
            g, routing)
    else:
        res = schedule_sharded(g, cfg, group, routing)
    over = res.overflow.reshape(g.batch, -1).any(dim=1).tolist()
    pipeline.fallbacks += sum(over)
    if g.batch == 1:
        return schedule_sharded_exact(g, cfg, group, routing) if over[0] \
            else res
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    reruns = {}
    for b in (b for b, o in enumerate(over) if o):
        r_b = routing_shard(build_owner_routing(events[b], d), rank)
        reruns[b] = schedule_sharded_exact(shard_graph(events[b], group),
                                           cfg, group, r_b)
    paths = tuple("exact" if b in reruns else res.path
                  for b in range(g.batch))
    if not reruns:
        return res._replace(path=paths)
    return _with_reruns(res, reruns, group)._replace(path=paths)


def _with_reruns(res: pipeline.ScheduleResults, reruns: dict, group
                 ) -> pipeline.ScheduleResults:
    """A stack's batched results with event b's replaced by reruns[b] (one
    event's exact results, this rank's block of its own partition): the
    heads widened to the largest cap (-1 nodes, zero p-values), the final
    state gathered whole, event b's put in, restacked and sharded again."""
    cap = max(r.acc_nodes.shape[-2] for r in (res, *reruns.values()))
    widen = lambda t, fill: F.pad(t, (0, 0, 0, cap - t.shape[-2]),
                                  value=fill)
    fields = {"acc_count": res.acc_count.clone(),
              "acc_nodes": widen(res.acc_nodes, -1),
              "acc_pvals": widen(res.acc_pvals, 0.0),
              "cca_rounds": res.cca_rounds.clone(),
              "overflow": res.overflow.clone()}
    whole = unstack_events(gather_graph(res.graph, group))
    for b, ex in reruns.items():
        fields["acc_count"][b] = ex.acc_count
        fields["acc_nodes"][b] = widen(ex.acc_nodes, -1)
        fields["acc_pvals"][b] = widen(ex.acc_pvals, 0.0)
        fields["cca_rounds"][b] = ex.cca_rounds
        fields["overflow"][b] = ex.overflow
        whole[b] = gather_graph(ex.graph, group)
    return res._replace(graph=shard_graph(stack_events(whole), group),
                        **fields)


def edge_group(n: int | None = None):
    """A process group of the first n ranks of the default group (all of
    them by default), in place of edge_mesh: every rank of the default
    group must call it.  Ranks past n get a handle that is no member."""
    world = dist.get_world_size()
    n = n or world
    if n > world:
        raise ValueError(f"edge_group({n}) over a world of {world}")
    return dist.new_group(list(range(n)), timeout=TIMEOUT)

