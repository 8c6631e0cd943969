"""Bytes that ``Scorer`` sends from the host to the card per request in
the program stretch (``perfbench/program.py``): the counter
``scorer.h2d_bytes`` over ``queue.requests``."""

from perfbench import program

UNIT = "bytes"


def read(rec):
    return program.ratio(rec, "serve", "scorer.h2d_bytes", "queue.requests")
