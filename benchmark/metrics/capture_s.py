"""Seconds the program spent capturing its CUDA graphs in this run (all
in the set-up): the eager warm-up, the recording and the instantiation of
every capture the program recorded (models/pipeline.py `captures`),
summed."""

from benchmark import program_record


def read(run):
    caps = program_record.captures()
    if not caps:
        return None
    return sum(c.warmup_s + c.record_s + c.instantiate_s for c in caps)
