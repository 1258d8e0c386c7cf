"""Summed durations of the traced sub-window's device events per event,
in ms."""


def read(run):
    if run.trace is None or not run.trace_done:
        return None
    return sum(b - a for _, a, b in run.trace.device) * 1e-6 / \
        len(run.trace_done)
