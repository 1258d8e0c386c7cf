"""Host time of the program's ingest per event, in ms: each event's
factory in the files driver (its file read by data/event_cache.load_npz
and its state built by graph/build.build_graph_state, on the prefetch
worker's thread), summed over the window's events, over their count:
ingest's busy time.  Read in the traced run from its untraced window
(hundreds of events, none under the profiler; the traced sub-window's
few start from an empty prefetch queue).  Only the files driver ingests
inside the window."""


def read(run):
    seconds = [d.ingest_s for d in run.done if d.ingest_s is not None]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / len(seconds)
