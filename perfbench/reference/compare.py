"""The numbers that decide ``correct``, each the program's reading against
the plain reference's, and the check against the cell's limits."""

from __future__ import annotations

import statistics

# a leaf whose reference gradient is below this share of the median
# leaf's moves under Adam by round-off alone (a key bias under softmax):
# it is left out of the change
ROUNDOFF_LEAF = 1e-3


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss1_gap``: the first step's loss, relative gap.  ``loss_gap``:
    the largest relative gap of any step's loss.  ``grad_gap``: by the
    worst float32 leaf, the gap between the program's norm of the first
    step's gradient and the reference's, over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  ``grad_gap_bf16``:
    the same over the leaves stored in bfloat16, whose gradient is rounded
    to bfloat16 once, so that a flip of rounding in one of the few
    dominant rows of a Zipf-skewed table moves its norm by up to 2**-9.
    ``change_gap``: as ``grad_gap`` for each leaf's change over the steps,
    leaving out the leaves whose reference gradient is round-off."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different steps")
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    g_ref, g_prog = ref["grad_norms"], prog["grad_norms"]
    c_ref, c_prog = ref["change_norms"], prog["change_norms"]
    for name, a, b in (("gradient", g_prog, g_ref), ("change", c_prog, c_ref)):
        if set(a) != set(b):
            raise ValueError(f"{name} leaves differ: program only "
                             f"{sorted(set(a) - set(b))[:5]}, reference only "
                             f"{sorted(set(b) - set(a))[:5]}")
    g_med = statistics.median(g_ref.values())
    bf16 = set(ref["bf16"])

    def gap(p):
        return abs(g_prog[p] - g_ref[p]) / max(g_ref[p], g_med)

    moved = [p for p in g_ref if g_ref[p] >= ROUNDOFF_LEAF * g_med]
    c_med = statistics.median(c_ref[p] for p in moved)
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": max(gap(p) for p in g_ref if p not in bf16),
            "grad_gap_bf16": max((gap(p) for p in g_ref if p in bf16),
                                 default=0.0),
            "change_gap": max(abs(c_prog[p] - c_ref[p]) / max(c_ref[p], c_med)
                              for p in moved)}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves of the largest gradient and change gaps, each
    [gap, leaf, reference norm], and each step's loss gap (for the log)."""
    g_ref, g_prog = ref["grad_norms"], prog["grad_norms"]
    c_ref, c_prog = ref["change_norms"], prog["change_norms"]
    g_med = statistics.median(g_ref.values())
    moved = [p for p in g_ref if g_ref[p] >= ROUNDOFF_LEAF * g_med]
    c_med = statistics.median(c_ref[p] for p in moved)

    def top(a, b, med, keys):
        return sorted(([abs(a[p] - b[p]) / max(b[p], med),
                        "/".join(map(str, p)), b[p]] for p in keys),
                      reverse=True)[:n]

    return {"grad": top(g_prog, g_ref, g_med, g_ref),
            "change": top(c_prog, c_ref, c_med, moved),
            "loss": [abs(a - b) / abs(b) for a, b in
                     zip(prog["losses"], ref["losses"])]}


def check(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    without a limit, or NaN, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
