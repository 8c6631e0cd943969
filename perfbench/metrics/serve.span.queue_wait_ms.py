"""Mean milliseconds a request spends in ``ScorerQueue``, from ``submit``
to the dispatcher draining it (its ``queue.wait`` span), in the program
stretch (``perfbench/program.py``)."""

from perfbench import program

UNIT = "ms"


def read(rec):
    return program.mean_ms(rec, "serve", "queue.wait")
