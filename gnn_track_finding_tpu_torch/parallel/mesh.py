"""The ("data", "edge") process mesh and batched execution over it.

Port of `gnn_track_finding_tpu.parallel.mesh` (mesh.py:29-89).  A mesh of
shape (data, edge) lays the world's ranks out row-major: rank
r = i * edge + j sits at data index i and edge index j.  The ranks of one
row form an "edge" group, which splits one event's edge arrays
(parallel/edge_shard.py); the ranks of one column form a "data" group,
over which the events of a batch are spread.  Where JAX runs one program
over the device mesh, every rank calls `run_batched` with its own mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch.distributed as dist

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


def run_batched(graphs: Sequence, cfg, mesh: Mesh | None = None
                ) -> List[Tuple[int, pipeline.ScheduleResults]]:
    """Run the schedule over a batch of events on the mesh: data rank i
    takes its contiguous slice of the batch, and each of its events runs
    edge-partitioned over its edge group (edge_shard.schedule_sharded).

    graphs: the batch's whole GraphStates, on this rank's device.  Returns
    (event index, results) for this rank's events, each graph gathered
    whole (edge_shard.gather_graph); per-event results equal the
    single-device run's (tests/test_torch_parallel.py)."""
    mesh = mesh or make_mesh()
    d = mesh.shape[1]
    lo, hi = event_slice(len(graphs), mesh.data_index, mesh.shape[0])
    out = []
    for i in range(lo, hi):
        g = graphs[i]
        routing = edge_shard.routing_shard(
            edge_shard.build_owner_routing(g, d), mesh.edge_index)
        res = edge_shard.schedule_sharded(
            edge_shard.shard_graph(g, mesh.edge_group), cfg, mesh.edge_group,
            routing)
        out.append((i, res._replace(
            graph=edge_shard.gather_graph(res.graph, mesh.edge_group))))
    return out
