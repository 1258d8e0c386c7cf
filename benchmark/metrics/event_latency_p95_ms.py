"""95th percentile over the window's events of the time from when the
harness hands an event to the stream driver to when its result is
returned (host clock), read in the traced run from its untraced window.
Only a stream's events have latencies of their own."""

import numpy as np


def read(run):
    if run.kind != "stream" or not run.done:
        return None
    return float(np.percentile([(d.t_out - d.t_in) * 1e3 for d in run.done],
                               95))
