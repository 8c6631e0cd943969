"""Percent of the traced program stretch (``perfbench/program.py``) in
which the device idles while the queue's dispatcher thread waits for a
request (its ``queue.idle`` spans)."""

from perfbench import program

UNIT = "%"


def read(rec):
    return program.idle_share(rec, "serve", "queue.idle")
