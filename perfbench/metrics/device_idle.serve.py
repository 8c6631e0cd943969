"""The share of the traced stretch in which no operation ran on the
device, from the union of the device's intervals in the profiler's
trace (serve cells)."""

UNIT = "%"


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "serve" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
