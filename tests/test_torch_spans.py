"""The driver's spans and the profiler's device-work filter on the CPU.

`utils/timing.span` records only while torch.profiler runs: otherwise it
is one shared no-op.  Under a CPU-only profiler the eager batch driver's
spans land in the in-memory record, with their dispatch and row, under
the span that encloses the call, and as `user_annotation` ranges of the
same names in the exported trace.  The profiler's device work is its
kernels, copies and memsets, never a range a `record_function` puts on
the device's timeline, read alike from the profiler's event objects and
from the trace it exports.  The benchmark's readers of the record give their
ms per event on a synthetic record, and None on an empty one.  The
schedule itself is run once unprofiled: the profiled call replays its
output, so each case takes well under a second."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spec
from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.graph.build import build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.utils import timing

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)
OUTER = "test.outer"


def _toy(seed):
    ev = toymc.generate_event(seed=seed, num_tracks=20,
                              edge_dphi_window=0.12)
    return build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                             device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """run_pipeline_batched over 2 toys inside an enclosing span, under a
    CPU-only profiler -> (the spans recorded, the exported trace's complete
    events, the results, the same call's results unprofiled)."""
    graphs = [_toy(11), _toy(23)]
    packed = pipeline.full_pipeline_packed(pipeline.stack_events(graphs),
                                           CFG)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "full_pipeline_packed", lambda g, cfg: packed)
        want = pipeline.run_pipeline_batched(graphs, CFG)
        timing.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with timing.span(OUTER):
                got = pipeline.run_pipeline_batched(graphs, CFG)
        records = timing.spans()
        timing.clear_spans()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return records, events, got, want


def test_span_without_profiler_is_the_shared_no_op():
    timing.clear_spans()
    s = timing.span("pipeline.launch", 7)
    assert s is timing.span("pipeline.unpack") is timing._NO_SPAN
    with s:
        with timing.span("pipeline.replay", 7):
            pass
    assert timing.spans() == []
    assert timing.span_totals("pipeline.launch") == (0, 0.0, 0.0)


def test_eager_batch_records_stack_once_and_unpack_per_event(profiled):
    records, _, got, want = profiled
    assert [(c.iteration, c.nodes.tolist(), c.pval_xy, c.pval_zr)
            for r in got for c in r.candidates] == \
        [(c.iteration, c.nodes.tolist(), c.pval_xy, c.pval_zr)
         for r in want for c in r.candidates]
    names = [r.name for r in records]
    assert names == [OUTER, "pipeline.stack", "pipeline.unpack",
                     "pipeline.unpack"]
    outer, stack, *unpacks = records
    assert outer.parent is None
    assert all(r.parent == 0 for r in records[1:])
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns
               for r in records)
    dispatch = stack.event
    assert isinstance(dispatch, int)
    assert [u.event for u in unpacks] == [(dispatch, 0), (dispatch, 1)]
    assert all(outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns
               for r in records[1:])
    tot = timing.span_totals(OUTER, records)
    assert tot.count == 1 and tot.total_s == (outer.end_ns
                                              - outer.start_ns) * 1e-9
    assert 0 <= tot.self_s < tot.total_s


def test_exported_trace_holds_the_spans_inside_the_enclosing_one(profiled):
    _, events, _, _ = profiled
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    by_name = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    assert {k: len(v) for k, v in by_name.items()} == {
        OUTER: 1, "pipeline.stack": 1, "pipeline.unpack": 2}
    outer = by_name[OUTER][0]
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    for e in by_name["pipeline.stack"] + by_name["pipeline.unpack"]:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e


def test_span_totals_self_time_leaves_out_closed_children():
    S = timing.Span
    records = [S("pipeline.launch", 0, 100, None, 1),
               S("pipeline.copy_in", 10, 30, 0, 1),
               S("pipeline.replay", 30, 70, 0, 1),
               S("pipeline.launch", 200, 250, None, 2),
               S("pipeline.copy_in", 210, None, 3, 2),     # still open
               S("pipeline.launch", 300, None, None, 3)]   # still open
    launch = timing.span_totals("pipeline.launch", records)
    assert launch.count == 2
    assert launch.total_s == pytest.approx(150e-9, rel=1e-12)
    assert launch.self_s == pytest.approx(90e-9, rel=1e-12)
    assert timing.span_totals("pipeline.copy_in", records).count == 1


def test_device_work_drops_annotations_overhead_and_markers():
    events = [("kernel", "gmr_cluster_f64", 10, 20),
              ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 20, 25),
              ("gpu_memset", "Memset (Device)", 25, 26),
              ("gpu_user_annotation", "pipeline.launch", 0, 100),
              ("gpu_user_annotation", "run_pipeline_batched", 0, 200),
              ("overhead", "Buffer Flush", 30, 40),
              ("user_annotation", "pipeline.launch", 0, 100),
              ("cuda_runtime", "cudaGraphLaunch", 1, 9),
              ("cpu_op", "aten::copy_", 1, 2),
              ("kernel", "void spin_kernel(long)", 0, 5)]
    assert timing.device_work(events) == [
        ("gmr_cluster_f64", 10, 20),
        ("Memcpy DtoH (Device -> Pinned)", 20, 25),
        ("Memset (Device)", 25, 26)]
    assert timing.device_work([]) == []


def test_profiler_events_agree_with_the_exported_trace(tmp_path):
    """busy_share's events, read from the profiler's event objects where
    they carry the activity type, hold the same (type, name) pairs as the
    trace the same run exports."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("pipeline.launch", 0):
            torch.ones(8).add_(1)
    got = timing._profiler_events(prof)
    want = timing._trace_events(prof)
    assert ("user_annotation", "pipeline.launch") in \
        {(kind, name) for kind, name, _, _ in got}
    # the export adds one event of its own, the profiled window ("Trace")
    assert sorted((k, n) for k, n, _, _ in got) == \
        sorted((k, n) for k, n, _, _ in want if k != "Trace")
    assert timing.device_work(got) == []
    timing.clear_spans()


def _capture(warmup, capture, instantiate):
    return pipeline.Capture(bucket=(64, 256, 8, 1), warmup_s=warmup,
                            record_s=capture, instantiate_s=instantiate,
                            pool_bytes=1 << 20, graph_nodes=1000,
                            kernel_launches={"gmr_cluster": 2,
                                             "distinct_counts": 3})


CHILD_MS = {"pipeline.unpack": ("pipeline.fallback", 1.0),
            "pipeline.launch": ("pipeline.replay", 1.5)}


def _spans(ms_by_name):
    """A record of top-level spans of the given ms, with a child under
    every `pipeline.unpack` (its fallback, 1 ms) and `pipeline.launch`
    (its replay, 1.5 ms), and an open span."""
    out = []
    t = 0
    for name, ms in ms_by_name:
        ns = round(ms * 1e6)
        out.append(timing.Span(name, t, t + ns, None, (0, len(out))))
        if name in CHILD_MS:
            child, child_ms = CHILD_MS[name]
            out.append(timing.Span(child, t, t + round(child_ms * 1e6),
                                   len(out) - 1, None))
        t += ns
    out.append(timing.Span("pipeline.launch", t, None, None, 9))
    return out


SPANS = [("pipeline.stack", 0.5), ("pipeline.launch", 2.0),
         ("pipeline.launch", 4.0), ("pipeline.unpack", 6.0),
         ("pipeline.unpack", 10.0), ("pipeline.wait", 3.0)]


@pytest.mark.parametrize("metric, want", [
    ("launch_host_ms_per_event", (2.0 - 1.5 + 4.0 - 1.5) / 4),
    ("unpack_host_ms_per_event", (6.0 - 1 + 10.0 - 1) / 4),
    ("stack_host_ms_per_event", 0.5 / 4),
    ("capture_s", 1.5 + 2.25 + 0.25 + 0.5 + 1.0 + 0.125),
])
def test_readers_of_the_program_record(monkeypatch, metric, want):
    reader = spec.metric_reader(metric)
    run = SimpleNamespace(trace_done=[object()] * 4)
    monkeypatch.setattr(timing, "_SPANS", _spans(SPANS))
    monkeypatch.setattr(pipeline, "captures", [_capture(1.5, 2.25, 0.25),
                                               _capture(0.5, 1.0, 0.125)])
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(timing, "_SPANS", [])
    monkeypatch.setattr(pipeline, "captures", [])
    assert reader.read(run) is None
    assert reader.read(SimpleNamespace(trace_done=[])) is None
