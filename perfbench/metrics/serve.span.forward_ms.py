"""Mean host milliseconds of a ``scorer.forward`` span, one per group (the
model's launches for the merged requests; the call does not wait for the
card), in the program stretch (``perfbench/program.py``)."""

from perfbench import program

UNIT = "ms"


def read(rec):
    return program.mean_ms(rec, "serve", "scorer.forward")
