"""Mean host milliseconds of a ``train.collect`` span of the program's
tracer (``cikm2020_dmt_torch/train/loop.py`` ``Trainer.train_step``) in
the program stretch: the tracer on, no profiler (``perfbench/program.py``)."""

from perfbench import program

UNIT = "ms"


def read(rec):
    return program.mean_ms(rec, "train", "train.collect")
