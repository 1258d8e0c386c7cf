"""Seconds from the start of the run to the end of the warm-up: torch and
the CUDA context, the events built on the device (the files driver's:
written as files), the kernel library loaded (built on a checkout's
first run), the program captured and the traffic's warm-up dispatches
run."""


def read(run):
    return run.setup_s
