"""Offline ranking metrics: session P@N / MRR@N and grouped AUC (the
port's own copy of ``cikm2020_dmt_tpu/metrics/offline.py``; the same
numbers, float64 numpy throughout).

Semantics of the reference (reference metrics/metrics.py):

- groups: sid (session) for P@N/MRR@N, uuid (user) for AUC
- per group sort by (score desc, label asc)  [metrics.py:97]
- P@N  = mean over top-N of (label >= action); N in {2,4,6,8,10,12,14}
- MRR@N = 1/rank of first top-N hit, else 0
- thresholds: CLICK -> label>=2, ORDER -> label>=5  [metrics.py:49-50]
- averages divide by the number of groups  [metrics.py:171-194]
- AUC: size-1 groups skipped; single-class groups count as 1.0
  (the reference's ``except -> return 1``, metrics.py:69-74); mean over
  the remaining groups

Every metric is a vectorized pass over group segments (``reduceat``), no
per-group Python.  Header lines are parsed without pandas: below 4096
lines by the ``csv`` module, from 4096 by the C factorizer
(``data/native.factorize_headers``), which raises where the JAX package
falls back to pandas.  Group codes are numbered in order of first
occurrence, as ``pd.factorize`` numbers them there, so every per-group
sum runs in the reference's order and gives its bits.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np

CLICK = 2
ORDER = 5
AT_LIST = (2, 4, 6, 8, 10, 12, 14)
# from this many lines on, headers are parsed by the C factorizer
NATIVE_PARSE_ROWS = 4096


def _text(h) -> str:
    return h.decode() if isinstance(h, bytes) else h


def _parse_headers(header_schema: Sequence[str], headers: Sequence[bytes]):
    """(label int64, sid object, uuid object) columns of raw header lines,
    split on tabs by the ``csv`` module with quoting off (header fields
    are arbitrary bytes).  Below ``NATIVE_PARSE_ROWS`` lines each line is
    stripped first, as the JAX package's per-line parse does; from there
    on it is not, as the CSV parser the JAX package uses there does not."""
    idx = {name: i for i, name in enumerate(header_schema)}
    label_i, sid_i = idx["label"], idx["sid"]
    uuid_i = idx.get("uuid", sid_i)
    n = len(headers)
    lines = (_text(h) for h in headers)
    if n < NATIVE_PARSE_ROWS:
        lines = (line.strip() for line in lines)
    labels = np.empty(n, np.int64)
    sids = np.empty(n, object)
    uuids = np.empty(n, object)
    reader = csv.reader(lines, delimiter="\t", quoting=csv.QUOTE_NONE)
    for j, f in enumerate(reader):
        labels[j] = int(f[label_i])
        sids[j] = f[sid_i]
        uuids[j] = f[uuid_i]
    return labels, sids, uuids


def factorize(values: np.ndarray) -> np.ndarray:
    """int64 codes of ``values`` numbered in order of first occurrence
    (``pd.factorize``'s numbering)."""
    if len(values) == 0:
        return np.zeros(0, np.int64)
    _, first, inverse = np.unique(values, return_index=True,
                                  return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse.reshape(-1)]


class ParsedHeaders:
    """Header columns parsed once and shared by every metric call on the
    same split: labels, and integer group codes per key, memoized
    (``codes``).  Built by the C factorizer it holds labels and codes
    only; the raw ``sids`` / ``uuids`` (read by
    ``offline_ext.save_scores_csv`` alone) are parsed from the kept lines
    on first access.  The streaming collector keeps no lines."""

    __slots__ = ("labels", "_sids", "_uuids", "_codes", "_raw")

    def __init__(self, labels, sids=None, uuids=None, codes=None, raw=None):
        self.labels = labels
        self._sids = sids
        self._uuids = uuids
        self._codes: dict = dict(codes or {})
        self._raw = raw  # (header_schema, headers) for the lazy parse

    def _materialize(self):
        if self._raw is None:
            raise RuntimeError(
                "raw sid/uuid columns are unavailable: this ParsedHeaders "
                "was built by the streaming collector, which keeps labels "
                "and group codes only.  Raise DMT_EVAL_SPILL_ROWS above the "
                "split's size to keep the raw lines for save_scores_csv.")
        schema, headers = self._raw
        self.labels, self._sids, self._uuids = _parse_headers(schema, headers)
        self._raw = None

    @property
    def sids(self):
        if self._sids is None:
            self._materialize()
        return self._sids

    @property
    def uuids(self):
        if self._uuids is None:
            self._materialize()
        return self._uuids

    def codes(self, group_by) -> np.ndarray:
        key = group_by if isinstance(group_by, str) else tuple(group_by)
        got = self._codes.get(key)
        if got is None:
            if key == "sid":
                got = factorize(self.sids)
            elif key == "uuid":
                got = factorize(self.uuids)
            else:  # composite (uuid, sid): combine the per-column codes
                cu = self.codes("uuid")
                cs = self.codes("sid")
                span = int(cs.max()) + 1 if len(cs) else 1
                got = factorize(cu * span + cs)
            self._codes[key] = got
        return got


class HeaderCollector:
    """Header lines of an eval split, held in bounded memory.

    Below ``spill_rows`` (``$DMT_EVAL_SPILL_ROWS``, default 2,000,000) it
    keeps the raw lines.  At the threshold it feeds them, and every later
    chunk, to the C streaming factorizer (``data/native.HeaderFactorizer``)
    and drops them; ``result()`` then returns a ``ParsedHeaders`` of
    labels and group codes.  A failed build of the library raises: the
    collector does not go on holding every line instead."""

    def __init__(self, header_schema, spill_rows: Optional[int] = None):
        if spill_rows is None:
            spill_rows = int(os.environ.get("DMT_EVAL_SPILL_ROWS",
                                            2_000_000))
        self.schema = list(header_schema)
        self.spill_rows = spill_rows
        self._raw: Optional[list] = []
        self._fact = None
        self.rows = 0

    def __len__(self) -> int:
        return self.rows

    def extend(self, lines) -> None:
        self.rows += len(lines)
        if self._fact is not None:
            self._fact.feed(lines)
            return
        self._raw.extend(lines)
        if self.rows >= self.spill_rows:
            from ..data.native import HeaderFactorizer
            self._fact = HeaderFactorizer(self.schema)
            self._fact.feed(self._raw)
            self._raw = None

    def result(self):
        """list[bytes] (below the threshold) or ParsedHeaders."""
        if self._fact is None:
            return self._raw
        labels, sid_codes, uuid_codes = self._fact.result()
        return ParsedHeaders(labels,
                             codes={"sid": sid_codes, "uuid": uuid_codes})


def parse_headers(header_schema, headers) -> ParsedHeaders:
    """Raw header lines parsed (or an existing ``ParsedHeaders`` passed
    through): every public metric function accepts either."""
    if isinstance(headers, ParsedHeaders):
        return headers
    if len(headers) >= NATIVE_PARSE_ROWS:
        from ..data.native import factorize_headers
        labels, sid_codes, uuid_codes = factorize_headers(header_schema,
                                                          headers)
        return ParsedHeaders(labels,
                             codes={"sid": sid_codes, "uuid": uuid_codes},
                             raw=(header_schema, headers))
    return ParsedHeaders(*_parse_headers(header_schema, headers))


def _group_segments(keys: np.ndarray, order: np.ndarray):
    """Given a sort order grouping identical keys contiguously, return
    (starts, ends) segment boundaries."""
    sorted_keys = keys[order]
    change = np.empty(len(order), bool)
    change[0] = True
    change[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(order))
    return starts, ends


def _sort_groups(keys, scores, labels):
    """Lexsort: groups contiguous, within group score desc then label asc."""
    if not np.issubdtype(np.asarray(keys).dtype, np.integer):
        keys = np.unique(keys, return_inverse=True)[1]
    return np.lexsort((labels, -scores, keys))   # last key is primary


def _segment_pre_mrr(hits: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                     at_list) -> tuple[np.ndarray, np.ndarray]:
    """Per-group P@N / MRR@N sums over contiguous segments.

    ``hits`` must already be in group-sorted order (score desc within
    group).  Returns (pre_sums, mrr_sums), each len(at_list); the caller
    divides by the group count (reference metrics.py:171-194)."""
    n = len(hits)
    glen = ends - starts
    chits = np.concatenate([[0.0], np.cumsum(hits)])
    # 1-based within-group rank of the first hit; inf when the group has none
    pos = np.where(hits > 0, np.arange(n), n)
    first_global = np.minimum.reduceat(pos, starts) if n else np.empty(0)
    first = np.where(first_global < ends,
                     first_global - starts + 1.0, np.inf)
    pre = np.empty(len(at_list))
    mrr = np.empty(len(at_list))
    inv_first = np.where(np.isfinite(first), 1.0 / first, 0.0)
    for ai, N in enumerate(at_list):
        k = np.minimum(N, glen)
        pre[ai] = float(((chits[starts + k] - chits[starts]) / k).sum())
        mrr[ai] = float((inv_first * (first <= k)).sum())
    return pre, mrr


def precision_mrr_at_n(header_schema, headers, scores,
                       at_list=AT_LIST) -> dict:
    """Reference get_offline_metrics (metrics.py:122-199):
    {CLICK: (pre@N array, mrr@N array), ORDER: (...)} averaged over sid
    groups."""
    ph = parse_headers(header_schema, headers)
    labels = ph.labels
    codes = ph.codes("sid")
    scores = np.asarray(scores, np.float64)
    order = _sort_groups(codes, scores, labels)
    starts, ends = _group_segments(codes, order)
    sorted_labels = labels[order]
    n_groups = len(starts)

    out = {}
    for action in (CLICK, ORDER):
        hits = (sorted_labels >= action).astype(np.float64)
        pre, mrr = _segment_pre_mrr(hits, starts, ends, at_list)
        out[action] = (pre / max(n_groups, 1), mrr / max(n_groups, 1))
    return out


def _tie_averaged_ranks(scores_sorted: np.ndarray, ranks: np.ndarray,
                        seg_change: np.ndarray) -> np.ndarray:
    """Average ``ranks`` over runs of equal score (within segments marked
    by ``seg_change``): the tie handling of sklearn's roc_auc_score."""
    n = len(scores_sorted)
    tchange = seg_change.copy()
    tchange[1:] |= scores_sorted[1:] != scores_sorted[:-1]
    tstarts = np.flatnonzero(tchange)
    tlen = np.diff(np.append(tstarts, n))
    tsum = np.add.reduceat(ranks, tstarts)
    return np.repeat(tsum / tlen, tlen)


def _auc_rank(labels01: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with tie-averaged ranks (== sklearn roc_auc_score)."""
    n = len(scores)
    n_pos = int(labels01.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 1.0  # reference except->1 (metrics.py:69-74)
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    seg = np.zeros(n, bool)
    seg[0] = True
    r_avg = _tie_averaged_ranks(s, np.arange(1.0, n + 1.0), seg)
    rank_sum = float(r_avg[labels01[order] > 0].sum())
    return (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def _grouped_prep(codes: np.ndarray, scores: np.ndarray):
    """Sort/segment structure shared by every action label: (order,
    gstarts, glen, r_avg), so the CLICK and ORDER passes share one
    lexsort."""
    n = len(codes)
    order = np.lexsort((scores, codes))
    c = codes[order]
    s = scores[order]
    gchange = np.empty(n, bool)
    gchange[0] = True
    gchange[1:] = c[1:] != c[:-1]
    gstarts = np.flatnonzero(gchange)
    glen = np.diff(np.append(gstarts, n))
    # within-group ascending 1-based rank
    gid = np.cumsum(gchange) - 1
    r = np.arange(n, dtype=np.float64) - gstarts[gid] + 1.0
    r_avg = _tie_averaged_ranks(s, r, gchange)
    return order, gstarts, glen, r_avg


def _segment_grouped_auc(codes: np.ndarray, y: np.ndarray,
                         scores: np.ndarray, prep=None):
    """Per-group tie-averaged AUC for every group at once.

    Returns (auc[ngroups], glen, gstarts, order) where ``auc`` is 1.0 for
    single-class groups (reference except->1, metrics.py:69-74); the
    caller masks size-1 groups (metrics.py:235-237)."""
    n = len(codes)
    if n == 0:
        z = np.zeros(0)
        return z, z.astype(np.int64), z.astype(np.int64), z.astype(np.int64)
    order, gstarts, glen, r_avg = prep or _grouped_prep(codes, scores)
    yy = y[order].astype(np.float64)
    n_pos = np.add.reduceat(yy, gstarts)
    n_neg = glen - n_pos
    rank_sum_pos = np.add.reduceat(r_avg * yy, gstarts)
    with np.errstate(divide="ignore", invalid="ignore"):
        auc = (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    auc = np.where((n_pos == 0) | (n_neg == 0), 1.0, auc)
    return auc, glen, gstarts, order


def grouped_auc(header_schema, headers, scores,
                group_method: str = "uuid") -> dict:
    """Reference get_offline_metrics_auc (metrics.py:204-276):
    {CLICK: auc, ORDER: auc}, per-group AUC averaged over groups with >= 2
    rows; single-class groups count 1.0."""
    ph = parse_headers(header_schema, headers)
    labels = ph.labels
    scores = np.asarray(scores, np.float64)
    codes = ph.codes("uuid" if group_method == "uuid" else "sid")

    prep = _grouped_prep(codes, scores) if len(codes) else None
    out = {}
    for action in (CLICK, ORDER):
        y = (labels >= action).astype(np.int8)
        auc, glen, _, _ = _segment_grouped_auc(codes, y, scores, prep)
        valid = glen >= 2
        n_valid = int(valid.sum())
        out[action] = float(auc[valid].sum()) / max(n_valid, 1)
    return out


def overall_auc(header_schema, headers, scores) -> dict:
    """Ungrouped test AUC per task, the paper's Table-1 metric."""
    labels = parse_headers(header_schema, headers).labels
    scores = np.asarray(scores, np.float64)
    return {
        CLICK: _auc_rank((labels >= CLICK).astype(np.int8), scores),
        ORDER: _auc_rank((labels >= ORDER).astype(np.int8), scores),
    }
