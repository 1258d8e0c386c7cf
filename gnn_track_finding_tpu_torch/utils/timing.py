"""Per-stage timing & profiling.

Port of `gnn_track_finding_tpu.utils.timing` (timing.py:1-62).  The
reference's only profiling is bash $SECONDS snapshots written to
execution_stages.txt / execution_times.txt (run_gnn_trackml_mod.sh:44-46,
171-186) plus inline time.time() prints.  Here:

  * StageTimer records named stage wall-clock, synchronising the device
    of the stage's result before each stamp (PyTorch returns before a CUDA
    device finishes, so device time lands in the right stage), and writes
    the reference's two text artifacts;
  * `trace` wraps a block in torch.profiler (the CPU, and the CUDA device
    when there is one) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _devices(obj) -> set:
    """The CUDA devices of the tensors in obj (a tensor, an object with a
    `device`, e.g. a GraphState, or a list/tuple/dict of them)."""
    if isinstance(obj, (list, tuple)):
        return set().union(*(_devices(o) for o in obj))
    if isinstance(obj, dict):
        return _devices(list(obj.values()))
    device = getattr(obj, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return {device}
    return set()


class StageTimer:
    def __init__(self) -> None:
        self.stages: List[str] = ["start_time"]
        self.times: List[float] = [0.0]
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Times the block; block_on: the stage's result (or the graph it
        runs on), whose CUDA device is synchronised before the stamp."""
        yield
        if block_on is not None:
            for device in _devices(block_on):
                torch.cuda.synchronize(device)
        self.stages.append(name)
        self.times.append(time.time() - self._t0)

    def durations(self) -> Dict[str, float]:
        return {self.stages[i]: self.times[i] - self.times[i - 1]
                for i in range(1, len(self.stages))}

    def write_artifacts(self, directory: str) -> None:
        """execution_stages.txt / execution_times.txt, as the reference
        writes them (run_gnn_trackml_mod.sh:177-187)."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "execution_stages.txt"), "w") as f:
            f.write("\n".join(self.stages) + "\n")
        with open(os.path.join(directory, "execution_times.txt"), "w") as f:
            f.write("\n".join(str(int(t)) for t in self.times) + "\n")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the block, written as a Chrome trace
    (`log_dir`/trace.json, viewable in chrome://tracing or Perfetto);
    yields the profiler, or None when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
