"""Multi-host initialisation and event distribution.

Port of `gnn_track_finding_tpu.parallel.multihost` (multihost.py:25-96)
over `torch.distributed`: one process per rank, started by torchrun (or
any launcher that sets RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT).  The global mesh puts one data rank per host by default,
so an event's edge partition stays inside a host.

    torchrun --nproc-per-node 4 my_driver.py    # calls initialize() first
"""

from __future__ import annotations

import os
import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from gnn_track_finding_tpu_torch.models import pipeline
from gnn_track_finding_tpu_torch.parallel import edge_shard, mesh as pmesh


def initialize(backend: str | None = None, init_method: str = "env://"
               ) -> None:
    """init_process_group from the launcher's environment; a no-op for a
    single process (WORLD_SIZE unset or 1).  backend defaults to NCCL when
    CUDA is available (each rank on the card of its LOCAL_RANK), else
    gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world,
                            rank=int(os.environ["RANK"]),
                            timeout=edge_shard.TIMEOUT)


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(data_axis: int | None = None) -> pmesh.Mesh:
    """The ("data", "edge") mesh over every rank; data defaults to the
    number of hosts (WORLD_SIZE / LOCAL_WORLD_SIZE), lowered until it
    divides the world."""
    _, world = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    data = data_axis or max(world // max(local, 1), 1)
    while world % data:
        data -= 1
    return pmesh.make_mesh((data, world // data))


def local_event_slice(num_events: int) -> Tuple[int, int]:
    """[start, end) of the event batch this rank should load and feed."""
    rank, world = _world()
    return pmesh.event_slice(num_events, rank, world)


def scaling_report(graphs: Sequence, cfg) -> dict:
    """Weak scaling on the ranks at hand: the batch's per-event wall on one
    rank (rank 0 runs every event in turn while the others wait) against
    one slice of the batch per rank (local_event_slice), with both
    checksums (the total accepted count).  graphs: the whole batch on
    this rank's device."""
    rank, world = _world()

    def run(events):
        total = 0
        for g in events:
            total += int(pipeline.full_pipeline_results(g, cfg)
                         .acc_count.sum())
        return total

    def barrier():
        if world > 1:
            dist.barrier()

    seq_sum = run(graphs) if rank == 0 else 0     # also the warm-up
    barrier()
    t0 = time.perf_counter()
    if rank == 0:
        run(graphs)
    t_seq = time.perf_counter() - t0
    barrier()
    lo, hi = local_event_slice(len(graphs))
    t0 = time.perf_counter()
    par = run(graphs[lo:hi])
    barrier()
    t_par = time.perf_counter() - t0
    sums = torch.tensor([seq_sum, par, t_seq], dtype=torch.float64,
                        device=graphs[0].device)
    if world > 1:
        dist.all_reduce(sums)
    t_seq = float(sums[2])
    return {"events": len(graphs), "devices": world,
            "sequential_s": t_seq, "parallel_s": t_par,
            "scaling_efficiency": t_seq / (t_par * world),
            "sequential_checksum": int(sums[0]),
            "parallel_checksum": int(sums[1])}
