"""The training step's share of the card's peak: the model's forward and
backward operations for the window's batches (3x the forward's, real
positions; ``perfbench/work.py``) per second of the window, over the
TF32 tensor-core peak."""

from perfbench import work

UNIT = "%"


def read(rec):
    if rec.get("entry") != "train" or not rec.get("ops_per_s"):
        return None
    return 100.0 * rec["ops_per_s"] / work.PEAK_FLOPS
