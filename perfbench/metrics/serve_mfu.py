"""The served forward's share of the card's peak: the operations the
window's completed requests need (the user's rows once per request,
per-candidate parts per candidate; ``perfbench/work.py``) per second of
the window, over the TF32 tensor-core peak."""

from perfbench import work

UNIT = "%"


def read(rec):
    if rec.get("entry") != "serve" or not rec.get("ops_per_s"):
        return None
    return 100.0 * rec["ops_per_s"] / work.PEAK_FLOPS
