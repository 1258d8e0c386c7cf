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
    """Weak scaling on the ranks at hand (JAX multihost.py:61-96): the
    batch's events one by one on one rank (rank 0 runs each in turn
    through the single-event program, pipeline.run_schedule_batched([g]),
    while the others wait) against the batch as one batched program per
    rank (mesh.run_batched on a (world, 1) mesh: each rank's
    local_event_slice stacked, on a CUDA device one replay), each side
    timed after a warm-up run that also gives its checksum (the total
    accepted count).  The report counts, and the efficiency divides by,
    the data ranks that run events, min(len(graphs), world), as JAX's
    mesh of min(len(graphs), len(jax.devices())) data devices does
    (multihost.py:80, :92): ranks past the batch get an empty slice and
    do no work.  graphs: the whole batch on this
    rank's device."""
    rank, world = _world()
    used = min(len(graphs), world)
    mesh = pmesh.make_mesh((world, 1)) if dist.is_initialized() else None

    def sequential():
        return sum(int(pipeline.run_schedule_batched([g], cfg)[0]
                       .acc_count.sum()) for g in graphs)

    def parallel():
        return sum(int(r.acc_count.sum())
                   for _, r in pmesh.run_batched(graphs, cfg, mesh))

    def barrier():
        if world > 1:
            dist.barrier()

    seq_sum = sequential() if rank == 0 else 0    # also the warm-up
    barrier()
    t0 = time.perf_counter()
    if rank == 0:
        sequential()
    t_seq = time.perf_counter() - t0
    par = parallel()                              # also the warm-up
    barrier()
    t0 = time.perf_counter()
    parallel()
    barrier()
    t_par = time.perf_counter() - t0
    sums = torch.tensor([seq_sum, par, t_seq], dtype=torch.float64,
                        device=graphs[0].device)
    if world > 1:
        dist.all_reduce(sums)
    t_seq = float(sums[2])
    return {"events": len(graphs), "devices": used,
            "sequential_s": t_seq, "parallel_s": t_par,
            "scaling_efficiency": t_seq / (t_par * used),
            "sequential_checksum": int(sums[0]),
            "parallel_checksum": int(sums[1])}
