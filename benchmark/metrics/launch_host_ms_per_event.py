"""Host time the driver takes to enqueue the traced sub-window's replays,
per traced event, in ms: the program's `pipeline.launch` spans less their
`pipeline.replay` children, summed.  What is left is the inputs copied
in, the final state cloned out with the readback's copy enqueued, and the
batch unstacked.  The replay's own call (cudaGraphLaunch) is left out:
under the profiler it holds the host for most of the device's replay, so
its span reads the profiled replay, not host work."""

from benchmark import program_record


def read(run):
    launch = program_record.span_ms_per_event(run, "pipeline.launch")
    if launch is None:
        return None
    replay = program_record.span_ms_per_event(run, "pipeline.replay")
    return launch - (replay or 0.0)
