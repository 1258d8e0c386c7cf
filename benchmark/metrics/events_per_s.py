"""Events completed in the window over the window's seconds (host clock:
from the window's start to the last result's return)."""


def read(run):
    return len(run.done) / run.window_s
