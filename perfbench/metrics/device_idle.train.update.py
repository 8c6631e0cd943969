"""Percent of the traced program stretch (``perfbench/program.py``) in
which the device idles while the host is in a ``train.update`` span: the
dense optimizer, LazyAdam and the streaming metrics of
``Trainer.train_step``."""

from perfbench import program

UNIT = "%"


def read(rec):
    return program.idle_share(rec, "train", "train.update")
