"""The traced sub-window: a fixed number of dispatches under torch.profiler.

The events are read from the trace the profiler exports (kineto's
chrome trace), device ops named as torch's EventList names them, and the
window is bracketed by spin kernels whose events are dropped: a copy of
`utils/timing.busy_share` and its markers (the program's
gnn_track_finding_tpu_torch/utils/timing.py), kept here so that the
yardstick does not move with the program.  Late in a long process the
profiler was seen to miss device events at a window's edge; the markers
take that loss.

The window is the device-clock span between the last leading marker's
end and the first trailing marker's start.  Device work is what the
profiler records as a kernel, a copy or a memset (an event's activity
type, its `cat`); anything else it puts on the device's timeline, such
as the range a `record_function` span covers there
(`gpu_user_annotation`), is not.
Idle gaps inside the window are named by the innermost host event that
covers them (a runtime call, an aten op, one of the harness's own
`record_function` spans, or the profiler's own work); the idle time under
the profiler's own work (its `overhead` activities, such as a `Buffer
Flush`) is summed apart, as the cost of tracing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

MARKERS, MARKER_CYCLES = 32, 62_500
MARKER_NAME = "spin_kernel"
NAMED_GAPS = 200     # the longest idle gaps named one by one
# the harness's record_function spans (benchmark/drivers.py)
SPANS = ("stream_pipeline", "run_pipeline_batched", "harness", "ingest")
# the profiler's activity types of device work, and of its own work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_TIMELINE = ("kernel", "gpu_")    # the types on the device's timeline
PROFILER_WORK = "overhead"


class Trace(NamedTuple):
    window_s: float                   # device-clock span of the sub-window
    device: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    busy_s: float                     # union of the device intervals
    gaps: List[Tuple[str, float]]     # (host activity, s) of each idle gap
    profiler_s: float                 # idle time under the profiler's work


def _markers() -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()


def _union(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """Busy ns of the sorted union, and the idle gaps between its parts."""
    busy, end, gaps = 0, None, []
    for a, b in sorted(intervals):
        if end is None:
            busy, end = b - a, b
        elif b > end:
            if a > end:
                gaps.append((end, a))
            busy += b - max(a, end)
            end = b
    return busy, gaps


def traced(fn: Callable[[], object]):
    """fn() under the profiler -> (fn's output, Trace).  The host events of
    every thread are recorded (`profile_all_threads`): the files driver's
    ingest runs on the prefetcher's thread."""
    import json
    import tempfile
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd.profiler import _rewrite_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _markers()
        out = fn()
        torch.cuda.synchronize()
        _markers()
    # the activity types are in the exported trace (its `cat`), not on
    # every torch version's event objects
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device, marks, host, own = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        kind, name = e.get("cat", ""), e.get("name", "")
        a = round(float(e["ts"]) * 1e3)
        b = a + round(float(e.get("dur", 0)) * 1e3)
        if kind == PROFILER_WORK:
            own.append((a, b))
        if kind in DEVICE_WORK:
            if MARKER_NAME in name:
                marks.append((a, b))
            else:
                device.append((_rewrite_name(name=name, with_wildcard=True),
                               a, b))
        elif not kind.startswith(DEVICE_TIMELINE):
            host.append((a, b, name))
    marks.sort()
    lead, trail = marks[:MARKERS], marks[MARKERS:]
    lo = lead[-1][1] if lead else min(a for _, a, _ in device)
    hi = trail[0][0] if trail else max(b for _, _, b in device)
    device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    busy, gaps = _union([(a, b) for _, a, b in device] + [(lo, lo), (hi, hi)])
    return out, Trace(window_s=(hi - lo) * 1e-9, device=device,
                      busy_s=busy * 1e-9, gaps=_name_gaps(gaps, host),
                      profiler_s=_covered(gaps, own) * 1e-9)


def _covered(gaps, spans) -> int:
    """ns of the gaps that the union of `spans` covers."""
    if not gaps or not spans:
        return 0
    a = np.array([g[0] for g in gaps], dtype=np.int64)
    b = np.array([g[1] for g in gaps], dtype=np.int64)
    covered, end = 0, None
    for s, e in sorted(spans):          # the union of the spans, in order
        if end is not None and s < end:
            s = end
        if e <= s:
            continue
        covered += int(np.clip(np.minimum(b, e) - np.maximum(a, s), 0,
                               None).sum())
        end = e
    return covered


def _name_gaps(gaps, host, named: int = NAMED_GAPS
               ) -> List[Tuple[str, float]]:
    """The `named` longest gaps, each named by the shortest host event
    covering its middle; the shorter ones (gaps between graph nodes,
    mostly) summed as one entry."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    starts = np.array([s for s, _, _ in host], dtype=np.int64)
    ends = np.array([e for _, e, _ in host], dtype=np.int64)
    out = []
    for a, b in gaps[:named]:
        mid = (a + b) // 2
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("(no host event: not traced)" if not cover.size else
                host[cover[np.argmin(ends[cover] - starts[cover])]][2])
        out.append((name, (b - a) * 1e-9))
    rest = gaps[named:]
    if rest:
        longest = (rest[0][1] - rest[0][0]) * 1e-3
        out.append((f"gaps under {longest:.2f} us (between graph nodes)",
                    sum(b - a for a, b in rest) * 1e-9))
    return out


def by_name(items, top: int = 10) -> List[list]:
    """[[name, seconds]] summed by name, the largest first."""
    acc: Dict[str, float] = {}
    for name, s in items:
        acc[name] = acc.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:top]]
