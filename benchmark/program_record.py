"""The program's own record of a run, read by the metrics that come from
it: its spans (gnn_track_finding_tpu_torch/utils/timing.py `spans`,
recorded only while torch.profiler runs, so exactly the traced
sub-window's dispatches) and what each capture cost
(models/pipeline.py `captures`, which outlive the freed programs).  A
version of the program that keeps no such record gives None, and the
metric is left out of the result line."""

from __future__ import annotations


def span_ms_per_event(run, name: str, own: bool = False):
    """ms per traced event of the spans named `name`: their summed
    durations, or (own) their self time, the part no child span covers;
    None without traced events or spans of that name."""
    if not run.trace_done:
        return None
    try:
        from gnn_track_finding_tpu_torch.utils import timing
    except ImportError:
        return None
    totals = getattr(timing, "span_totals", None)
    if totals is None:
        return None
    t = totals(name)
    if not t.count:
        return None
    return 1e3 * (t.self_s if own else t.total_s) / len(run.trace_done)


def captures() -> list | None:
    """The program's capture records of this process, or None."""
    try:
        from gnn_track_finding_tpu_torch.models import pipeline
    except ImportError:
        return None
    return getattr(pipeline, "captures", None) or None
