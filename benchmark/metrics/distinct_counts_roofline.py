"""Share of its roofline the side-norm distinct-count kernel
(csrc/distinct_counts.cu) runs at in the traced sub-window, in %: the
least time of its three tables per traced event, from the bytes and
operations they need (benchmark/roofline.py over the reference's
tables), over the summed durations of the kernel's device events."""

KERNEL = "distinct_counts"


def read(run):
    if run.trace is None:
        return None
    seconds = run.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.least_seconds(KERNEL) / seconds
