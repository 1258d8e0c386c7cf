"""Host time the batch driver takes to stack the traced sub-window's
batches into one state (stack_events), per traced event, in ms: the
program's `pipeline.stack` spans, summed."""

from benchmark import program_record


def read(run):
    return program_record.span_ms_per_event(run, "pipeline.stack")
