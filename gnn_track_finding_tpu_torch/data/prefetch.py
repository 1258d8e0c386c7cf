"""Host-side event prefetcher for the streaming driver.

Counterpart of `gnn_track_finding_tpu.data.prefetch` (prefetch.py:43-88):
background threads run the next events' ingest (CSV parse in the C++
loader, which releases the interpreter lock, host arrays, the copy to the
device) while the driver works on the current one.

    for g in prefetch_trackml(paths, cfg, device="cuda"):
        ...                          # e.g. fed to pipeline.stream_pipeline

A thread that builds device tensors issues its work on the device's
current stream, the one the driver also uses, so a GraphState is complete
before any later work of the driver reads it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
from typing import Callable, Iterable, Iterator, Sequence

import torch

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import trackml


def prefetch(factories: Iterable[Callable], depth: int = 2,
             workers: int = 1) -> Iterator:
    """Yield factory() for each factory in order, running up to `depth`
    of them ahead on `workers` background threads.  A factory that raises
    re-raises at its position in the stream."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque = collections.deque()
        try:
            for f in factories:
                # drain before submitting: at most `depth` in flight
                if len(pending) >= depth:
                    yield pending.popleft().result()
                pending.append(pool.submit(f))
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()


def prefetch_trackml(paths_list: Sequence, cfg: PipelineConfig, *,
                     device: torch.device | str,
                     dtype: torch.dtype = torch.float64, depth: int = 2,
                     cache_dir: str | os.PathLike | None = None,
                     workers: int = 1) -> Iterator:
    """GraphStates of TrackML events by path (data/trackml.load_event), in
    order.  The streaming driver runs no leak replay, so no tracker is
    kept."""
    def make(p):
        return lambda: trackml.load_event(p, cfg, device=device, dtype=dtype,
                                          cache_dir=cache_dir,
                                          with_tracker=False)[0]

    return prefetch([make(p) for p in paths_list], depth=depth,
                    workers=workers)
