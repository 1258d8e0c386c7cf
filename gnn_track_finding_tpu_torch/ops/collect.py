"""Cross-rank combine helpers for edge-partitioned execution.

Port of `gnn_track_finding_tpu.ops.collect` (collect.py:33-122) over
`torch.distributed`.  Under the edge partition (parallel/edge_shard.py)
each rank of an "edge" process group holds a contiguous block of one
event's directed-edge arrays, while node arrays and the (N, K) tables are
replicated; every per-node aggregate is a LOCAL partial combined by one
explicit collective over the group.  `group` is a
`torch.distributed.ProcessGroup`; with `group=None` (one device) every
helper here is the identity, so the ops share one code path.

Exactness (collect.py:15-22): sums of one-writer-per-cell tables, integer
counts, ORs and MINs are exact whatever the order; float partial sums
reassociate at rank boundaries (last-ulp differences against the
single-device row sum).  Booleans travel as uint8.

The census: inside `with census() as records:` every collective appends
a record (op, shape, dtype, the device type of the tensor the backend was
handed, the bytes this rank puts on the wire, and the function that asked
for it) to `records`.  No collective is staged through the host: gloo and
NCCL both take the CUDA tensors of every collective here.  It is off otherwise; the tests
read it where the JAX tests read the compiled program's text.
"""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist

_census: list | None = None


@contextlib.contextmanager
def census():
    """Record the collectives called inside the block into a fresh list."""
    global _census
    outer, _census = _census, []
    try:
        yield _census
    finally:
        _census = outer


def _record(op: str, x: torch.Tensor) -> None:
    if _census is not None:
        _census.append({"op": op, "shape": tuple(x.shape),
                        "dtype": str(x.dtype).split(".")[1],
                        "device": x.device.type,
                        "bytes": x.numel() * x.element_size(),
                        "caller": sys._getframe(2).f_code.co_name})


def allsum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum partial per-node aggregates over the group (all_reduce SUM)."""
    if group is None:
        return x
    x = x.contiguous().clone()
    _record("all_reduce_sum", x)
    dist.all_reduce(x, group=group)
    return x


def allor(x: torch.Tensor, group) -> torch.Tensor:
    """OR partial boolean tables over the group: a uint8 SUM > 0 (exact
    for one-writer-per-cell tables; D < 256)."""
    if group is None:
        return x
    u = x.to(torch.uint8).contiguous()
    _record("all_reduce_or", u)
    dist.all_reduce(u, group=group)
    return u > 0


def allmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group (FastSV's hook combine)."""
    if group is None:
        return x
    x = x.contiguous().clone()
    _record("all_reduce_min", x)
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def owner_shards(n_rows: int, group) -> bool:
    """True when the node-owner exchange applies: a group whose size
    divides the node axis (the reduce-scatter tiling)."""
    return group is not None and n_rows % dist.get_world_size(group) == 0


def ownsum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum partial per-node rows over the group and keep THIS rank's
    contiguous block of N/D rows (reduce_scatter)."""
    d = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // d,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("reduce_scatter_sum", x)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def ownor(x: torch.Tensor, group) -> torch.Tensor:
    """Boolean-table ownsum (uint8 on the wire)."""
    d = dist.get_world_size(group)
    u = x.to(torch.uint8).contiguous()
    out = torch.empty((u.shape[0] // d,) + tuple(u.shape[1:]),
                      dtype=torch.uint8, device=u.device)
    _record("reduce_scatter_or", u)
    dist.reduce_scatter_tensor(out, u, group=group)
    return out > 0


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's row block, concatenated in rank order on every rank
    (all_gather into one tensor)."""
    d = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] * d,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("all_gather", x)
    # all_gather_single replaces all_gather_into_tensor in newer torch
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x, group=group)
    return out


def owner_block(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous row block of a replicated array."""
    d = dist.get_world_size(group)
    rows = x.shape[0] // d
    start = dist.get_rank(group) * rows
    return x[start:start + rows]


def owner_block_interleaved(x: torch.Tensor, group) -> torch.Tensor:
    """Rows {i : i % D == rank} of a replicated array as a contiguous
    (N/D, ...) block (row r <-> node r*D + rank): the node layout of the
    owner routing (parallel/edge_shard.OwnerRouting)."""
    d = dist.get_world_size(group)
    return x[dist.get_rank(group)::d].contiguous()


def route_to_owners(values: torch.Tensor, owner: torch.Tensor,
                    pos: torch.Tensor, bucket: int, group) -> torch.Tensor:
    """all_to_all of per-edge VALUES to their head node's owner rank.

    values: (E_loc, W); owner/pos: (E_loc,) static routing (destination
    rank, position in its send bucket; -1 = not routed).  Returns
    (D * bucket, W): block s holds what rank s sent here.  Rows that are
    not routed go to a dump row past the buckets, which is sliced off."""
    d = dist.get_world_size(group)
    w = values.shape[1]
    ok = (owner >= 0) & (pos >= 0) & (pos < bucket)
    idx = torch.where(ok, owner * bucket + pos, d * bucket)
    send = torch.zeros((d * bucket + 1, w), dtype=values.dtype,
                       device=values.device)
    send[idx] = values
    send = send[:d * bucket]
    recv = torch.empty_like(send)
    _record("all_to_all", send)
    dist.all_to_all_single(recv, send, group=group)
    return recv
