"""Batch key suffixes of the fixed-shape batch layout.

Every ragged id feature ``f`` travels as three arrays:
``f__ids`` int32 ``[B, L]``, ``f__wts`` float32 ``[B, L]`` and ``f__len``
int32 ``[B]``.  The TFRecord input pipeline itself is not ported yet.
"""

IDS = "__ids"
WTS = "__wts"
LEN = "__len"
