"""Requests per scorer call of ``ScorerQueue`` in the program stretch
(``perfbench/program.py``): the counter ``queue.requests`` over
``queue.groups`` (padding rows not counted)."""

from perfbench import program

UNIT = "requests"


def read(rec):
    return program.ratio(rec, "serve", "queue.requests", "queue.groups")
