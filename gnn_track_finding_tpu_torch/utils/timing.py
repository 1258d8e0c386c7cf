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
    when there is one) and writes a Chrome trace;
  * `span` marks a part of the program's host work: while torch.profiler
    runs it is a `record_function` range in the profiler's trace (on the
    device timeline's clock) and a `Span` in an in-memory record
    (`spans`, `span_totals`, `clear_spans`); otherwise it does nothing;
  * the card's clocks, which every CUDA-device measurement of the port
    (chip_smoke.py, profile_stages.py) takes: `sync_time` (a host clock
    ending in torch.cuda.synchronize()), `call_ms` (CUDA events over
    back-to-back calls), `device_ms` / `replay_ms` (CUDA-graph replays
    between CUDA events) and `busy_share` (torch.profiler's device
    events).  They need a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


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


# ------------------------------------------------------------------ spans

class Span(NamedTuple):
    """One span of host work, on the host's perf_counter_ns clock."""
    name: str
    start_ns: int
    end_ns: Optional[int]       # None while the span is open
    parent: Optional[int]       # index in spans() of the enclosing span
                                # (of the same thread), None at the top
    event: Hashable             # what the span serves (the driver's
                                # dispatch, or (dispatch, row)), or None


class SpanTotal(NamedTuple):
    count: int                  # closed spans of the name
    total_s: float              # their summed durations
    self_s: float               # the same less what their children cover


_SPANS: List[Span] = []
_SPANS_LOCK = threading.Lock()
_STACKS = threading.local()     # per thread: (record, index) of its
                                # open spans


# the span given while no profiler runs: it records nothing
_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "event", "record", "index", "range")

    def __init__(self, name: str, event: Hashable):
        self.name, self.event = name, event

    def __enter__(self):
        stack = getattr(_STACKS, "stack", None)
        if stack is None:
            stack = _STACKS.stack = []
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        start = time.perf_counter_ns()
        with _SPANS_LOCK:
            self.record, self.index = _SPANS, len(_SPANS)
            # a parent opened before clear_spans() is in the old record
            parent = (stack[-1][1] if stack and stack[-1][0] is _SPANS
                      else None)
            _SPANS.append(Span(self.name, start, None, parent, self.event))
        stack.append((self.record, self.index))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _STACKS.stack.pop()
        with _SPANS_LOCK:
            self.record[self.index] = self.record[self.index]._replace(
                end_ns=end)
        self.range.__exit__(*exc)
        return False


def span(name: str, event: Hashable = None):
    """A context manager around a part of the host's work.  While
    torch.profiler runs (torch's own flag, a plain bool) it enters
    record_function(name), so the range lands in the profiler's trace, and
    appends a Span to the record that spans() returns; otherwise it is a
    shared no-op that records and allocates nothing.  Open one per call of
    a part, never per item of a loop."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _OpenSpan(name, event)


def spans() -> List[Span]:
    """The spans recorded since the last clear_spans(), in the order they
    were opened (a Span's `parent` indexes this list)."""
    with _SPANS_LOCK:
        return list(_SPANS)


def clear_spans() -> None:
    """Start a new record (spans still open close into the old one)."""
    global _SPANS
    with _SPANS_LOCK:
        _SPANS = []


def span_totals(name: str, records: Optional[List[Span]] = None
                ) -> SpanTotal:
    """Count, summed duration and self time of the closed spans named
    `name` in `records` (default: spans()).  A span's self time is its
    duration less its closed children's, which run one after another on
    its thread."""
    records = spans() if records is None else records
    children: Dict[int, int] = {}
    for r in records:
        if r.parent is not None and r.end_ns is not None:
            children[r.parent] = (children.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    count = total = own = 0
    for i, r in enumerate(records):
        if r.name == name and r.end_ns is not None:
            count += 1
            total += r.end_ns - r.start_ns
            own += r.end_ns - r.start_ns - children.get(i, 0)
    return SpanTotal(count, total * 1e-9, own * 1e-9)


# ------------------------------------------------------ the card's clocks

def sync_time(fn):
    """fn() on a host clock that starts and ends in torch.cuda.synchronize()
    -> (fn's output, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Time per call of fn over reps back-to-back calls (CUDA events): the
    device time, or the host's cost per call where that is larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(graph: "torch.cuda.CUDAGraph", before=None,
              repeats: int = 3) -> float:
    """The best of `repeats` replays of a captured graph, each between two
    CUDA events on the current stream (ms); before(), when given, is
    enqueued ahead of each start event (an L2 flush, or a spin that keeps
    the device busy while the host submits the replay)."""
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Device time per call of fn: reps calls captured into one CUDA graph
    (the kernel wrappers launch on the current stream, which the capture
    takes over), the graph replayed between CUDA events, so the host's cost
    per call does not enter; the best of three replays.  fn must not
    synchronise with the host.

    Without flush the repeats find their inputs in the L2 cache wherever
    they fit (warm).  With flush, a device buffer larger than the L2, each
    captured call follows a write of the whole buffer, so fn reads its
    inputs from HBM (cold); a graph of the writes alone is timed the same
    way and its time taken off."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def graph_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        torch.cuda.synchronize()
        return replay_ms(graph)

    if flush is None:
        return graph_ms(fn) / reps

    def cold():
        flush.zero_()
        fn()

    return (graph_ms(cold) - graph_ms(flush.zero_)) / reps


class Busy(NamedTuple):
    """What torch.profiler saw of one call on the device."""
    share: Optional[float]      # the union of the device's intervals over
                                # the call's wall; None: no device activity
    wall: float                 # s
    events: int                 # device events (kernels, copies, memsets)
    ms_by_name: list            # [(name, ms)], longest first
    count_by_name: Dict[str, int]


# spin kernels (torch.cuda._sleep) run just inside each end of a profiled
# window, 32 of ~30 us each: after minutes of device work in one process
# the profiler was seen to miss the first or last 13 device events of a
# window (a drift of its device clock against the host's), and the
# markers take that loss; their events are dropped from the result
MARKERS, MARKER_CYCLES = 32, 62_500
MARKER_NAME = "spin_kernel"
# the profiler's activity types (the `cat` of its exported trace) of
# device work; others on the device's timeline, such as the range a
# record_function covers there (gpu_user_annotation), or its own work
# (overhead), are not
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _markers() -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()


def device_work(events) -> list:
    """(name, start ns, end ns) of the device work among the profiler's
    (activity type, name, start ns, end ns) events: kernels, copies and
    memsets, the spin markers left out."""
    return [(name, a, b) for kind, name, a, b in events
            if kind in DEVICE_WORK and MARKER_NAME not in name]


def _profiler_events(prof) -> list:
    """(activity type, name, start ns, end ns) of the events of a finished
    torch.profiler run: from its event objects where they carry the type
    (activity_type, the exported trace's `cat`), else (torch 2.11) from
    the trace it exports."""
    events = prof.profiler.kineto_results.events()
    if events and hasattr(events[0], "activity_type"):
        return [(e.activity_type(), e.name(), e.start_ns(), e.end_ns())
                for e in events]
    return _trace_events(prof)


def _trace_events(prof) -> list:
    """(activity type, name, start ns, end ns) of every complete event of a
    finished torch.profiler run, read from the trace it exports."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    out = []
    for e in raw:
        if e.get("ph") == "X":
            a = round(float(e["ts"]) * 1e3)
            out.append((e.get("cat", ""), e.get("name", ""), a,
                        a + round(float(e.get("dur", 0)) * 1e3)))
    return out


def busy_share(fn) -> Busy:
    """fn() once under torch.profiler (the CPU and the CUDA device): the
    device's busy share of the call's wall, its events, and their time and
    count by name.  Kernels inside a CUDA-graph replay are seen one by
    one.  Device events are the profiler's kernels, copies and memsets
    (device_work), named as torch's EventList names them; fn must launch
    no spin kernel (MARKERS)."""
    from torch.autograd.profiler import _rewrite_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _markers()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _markers()
    device = [(_rewrite_name(name=name, with_wildcard=True), a, b)
              for name, a, b in device_work(_profiler_events(prof))]
    if not device:
        return Busy(None, wall, 0, [], {})
    by_name, count = {}, {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        count[name] = count.get(name, 0) + 1
    busy, end = 0, float("-inf")
    for a, b in sorted((a, b) for _, a, b in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    return Busy(busy * 1e-9 / wall, wall, len(device),
                sorted(by_name.items(), key=lambda kv: -kv[1]), count)
