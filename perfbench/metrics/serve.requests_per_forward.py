"""Real requests in each forward the queue ran in the window (a group
padded to its size repeats a request, which is not counted), counted by
the benchmark's wrapper around the ``Scorer``, averaged."""

UNIT = "requests"


def read(rec):
    f = rec.get("forwards")
    if rec.get("entry") != "serve" or not f:
        return None
    return sum(n for _, n in f) / len(f)
