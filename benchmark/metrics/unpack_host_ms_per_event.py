"""Host time the driver takes to turn the traced sub-window's readbacks
into candidates, per traced event, in ms: the self time of the program's
`pipeline.unpack` spans (unpack_packed; an overflowed event's exact rerun,
its `pipeline.fallback` child, left out), summed."""

from benchmark import program_record


def read(run):
    return program_record.span_ms_per_event(run, "pipeline.unpack", own=True)
