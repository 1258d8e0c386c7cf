"""Share of the traced sub-window (device clock, between the bracketing
spin kernels) in which no device event ran, in %, with the idle time
under the profiler's own work (its buffer flushes) taken out of both the
idle time and the window: the cost of tracing, not of the program."""


def read(run):
    if run.trace is None:
        return None
    window = run.trace.window_s - run.trace.profiler_s
    if window <= 0:
        return None
    idle = run.trace.window_s - run.trace.busy_s - run.trace.profiler_s
    return 100.0 * idle / window
