"""Mean host milliseconds of a ``scorer.merge`` span, one per group (the
requests' arrays concatenated, pinned and sent to the card, the u-side
rows repeated; ``Scorer.score_group_async``), in the program stretch
(``perfbench/program.py``)."""

from perfbench import program

UNIT = "ms"


def read(rec):
    return program.mean_ms(rec, "serve", "scorer.merge")
