"""Time the stream waited for the program's ingest per event, in ms: the
seconds the files driver's feed of stream_pipeline was blocked on
data/prefetch.prefetch for each event, summed over the window's events,
over their count: the part of ingest that the stream did not hide.  Near
the period less the replay, ingest sets the pace.  Read in the traced
run from its untraced window, as ingest_host_ms_per_event is.  Only the
files driver ingests inside the window."""


def read(run):
    seconds = [d.wait_s for d in run.done if d.wait_s is not None]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / len(seconds)
