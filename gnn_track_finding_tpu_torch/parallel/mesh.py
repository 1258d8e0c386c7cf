"""The ("data", "edge") process mesh and batched execution over it.

Port of `gnn_track_finding_tpu.parallel.mesh` (mesh.py:29-89).  A mesh of
shape (data, edge) lays the world's ranks out row-major: rank
r = i * edge + j sits at data index i and edge index j.  The ranks of one
row form an "edge" group, which splits one event's edge arrays
(parallel/edge_shard.py); the ranks of one column form a "data" group,
over which the events of a batch are spread.  Where JAX runs one program
over the device mesh, every rank calls `run_batched` with its own mesh.

JAX stacks a batch's events on a leading axis and vmaps the schedule
(`stack_events`, mesh.py:60-66).  Here a batch is the events' disjoint
union (graph/state.stack_events, re-exported under JAX's name): every
stage runs unchanged over B*N nodes and B*E edges, each kernel launch
covering the whole batch.  On an edge group of D > 1 ranks the union is
then edge-partitioned as one event is (parallel/edge_shard.py), so a data
rank's chunk of events is one program per rank, with one set of
collectives, however many events it holds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch.distributed as dist

from gnn_track_finding_tpu_torch.graph.state import (  # noqa: F401
    pad_bucket, stack_events, unstack_events)
from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.parallel import edge_shard

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and its two groups."""
    shape: Tuple[int, int]       # (data, edge)
    data_index: int
    edge_index: int
    data_group: object           # the ranks of this rank's column
    edge_group: object           # the ranks of this rank's row


def make_mesh(shape: Tuple[int, int] | None = None) -> Mesh:
    """The mesh over the default group's ranks (all of them must call it:
    every group is built by every rank, in one order).  shape defaults to
    (2, world // 2) when the world is even and larger than one."""
    world = dist.get_world_size()
    if shape is None:
        data = 2 if world % 2 == 0 and world > 1 else 1
        shape = (data, world // data)
    data, edge = shape
    if data * edge != world:
        raise ValueError(f"mesh {shape} over a world of {world}")
    rank = dist.get_rank()
    mine = {}
    for i in range(data):
        g = dist.new_group([i * edge + j for j in range(edge)],
                           timeout=edge_shard.TIMEOUT)
        if i == rank // edge:
            mine["edge"] = g
    for j in range(edge):
        g = dist.new_group([i * edge + j for i in range(data)],
                           timeout=edge_shard.TIMEOUT)
        if j == rank % edge:
            mine["data"] = g
    return Mesh(shape=(data, edge), data_index=rank // edge,
                edge_index=rank % edge, data_group=mine["data"],
                edge_group=mine["edge"])


def event_slice(num_events: int, index: int, count: int) -> Tuple[int, int]:
    """[start, end) of the events that part `index` of `count` takes."""
    per = (num_events + count - 1) // count
    return index * per, min((index + 1) * per, num_events)


# padded nodes per batched program: eight full events (57,344 padded
# nodes each; 25-29 GiB peak allocated at float32 on an H100, PERF.md
# section 5), so that a long slice runs in chunks of bounded memory; on an
# edge group every rank holds the union's node tables whole, so the cap
# holds per rank there too
MAX_BATCH_NODES = 8 * 57_344


def batch_chunks(graphs: Sequence) -> List[List[int]]:
    """The events' indices grouped by pad bucket (in order of first
    appearance, each group in event order) and each group cut into
    chunks of at most MAX_BATCH_NODES padded nodes, one event at least:
    the batches that run as one program each."""
    groups = {}
    for i, g in enumerate(graphs):
        groups.setdefault(pad_bucket(g), []).append(i)
    out = []
    for idx in groups.values():
        per = max(1, MAX_BATCH_NODES // graphs[idx[0]].num_padded_nodes)
        out += [idx[k:k + per] for k in range(0, len(idx), per)]
    return out


def _run_chunks(graphs: Sequence, cfg, run, first: int = 0
                ) -> List[Tuple[int, pipeline.ScheduleResults]]:
    """graphs in batch_chunks' batches, each one program run(chunk, cfg)
    -> (first + event index, results), in event order."""
    out = []
    for chunk in batch_chunks(graphs):
        out += zip((first + i for i in chunk),
                   run([graphs[i] for i in chunk], cfg))
    return sorted(out, key=lambda pair: pair[0])


def _run_sharded_chunk(graphs: List, cfg, mesh: Mesh
                       ) -> List[pipeline.ScheduleResults]:
    """One chunk as one edge-partitioned program over the mesh's edge
    group: the events stacked, the union's routing built on the host,
    edge_shard.run_sharded (an NCCL group replays the rank's captured
    program), the final union gathered whole and split per event."""
    group = mesh.edge_group
    st = stack_events(graphs)
    routing = edge_shard.routing_shard(
        edge_shard.build_owner_routing(st, mesh.shape[1]), mesh.edge_index)
    res = edge_shard.run_sharded(edge_shard.shard_graph(st, group), cfg,
                                 group, routing, graphs)
    return pipeline.split_events(
        res._replace(graph=edge_shard.gather_graph(res.graph, group)))


def run_batched(graphs: Sequence, cfg, mesh: Mesh | None = None
                ) -> List[Tuple[int, pipeline.ScheduleResults]]:
    """Run the schedule over a batch of events (JAX mesh.py:69-89).

    With no mesh and no process group: JAX's one-device call, the batch
    as one program on the graphs' device (pipeline.run_schedule_batched:
    their union, on a CUDA device one replay of its captured program).
    On a mesh, data rank i takes its contiguous slice of the batch.
    Where the edge group has one rank the slice runs the same way, with
    no collective; otherwise the slice's union runs edge-partitioned over
    the edge group as one program per rank (_run_sharded_chunk: on an
    NCCL group one replay of the rank's captured program, eager on gloo),
    every rank of the group running the same chunks in the same order.
    Where JAX needs one pad bucket, the events here are grouped by
    bucket, and a group over MAX_BATCH_NODES runs in chunks
    (batch_chunks): one program per chunk.

    graphs: the batch's whole GraphStates, on this rank's device.  Returns
    (event index, results) for this rank's events, in order, each with
    its own state (unstacked, or gathered whole and unstacked) and `path`
    ("captured", "eager" or "exact": an overflowed event reruns alone);
    per-event results equal the single-device run's
    (tests/test_torch_batched.py, tests/test_torch_parallel.py)."""
    if mesh is None and not (dist.is_available() and dist.is_initialized()):
        return _run_chunks(list(graphs), cfg, pipeline.run_schedule_batched)
    mesh = mesh or make_mesh()
    lo, hi = event_slice(len(graphs), mesh.data_index, mesh.shape[0])
    if mesh.shape[1] == 1:
        return _run_chunks(list(graphs[lo:hi]), cfg,
                           pipeline.run_schedule_batched, lo)
    return _run_chunks(list(graphs[lo:hi]), cfg,
                       lambda chunk, c: _run_sharded_chunk(chunk, c, mesh), lo)
