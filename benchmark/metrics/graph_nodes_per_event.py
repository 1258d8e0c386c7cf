"""Device events (kernels, copies, memsets) in the traced sub-window per
event: the nodes of the captured program plus the copies around it."""


def read(run):
    if run.trace is None or not run.trace_done:
        return None
    return len(run.trace.device) / len(run.trace_done)
