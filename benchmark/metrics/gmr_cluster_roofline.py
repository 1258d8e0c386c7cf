"""Share of its roofline the clustering kernel (csrc/gmr_cluster.cu) runs
at in the traced sub-window, in %: the least time of both clustering
rounds of every traced event, from the bytes and operations their live
rows need (benchmark/roofline.py over the reference's rows), over the
summed durations of the kernel's device events."""

KERNEL = "gmr_cluster"


def read(run):
    if run.trace is None:
        return None
    seconds = run.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.least_seconds(KERNEL) / seconds
