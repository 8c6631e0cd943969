"""Host milliseconds inside ``Scorer.score_group_async`` for each forward
of the window (merging the group, the copies to the card and the
launches; the call does not wait for the card), by the host clock of the
benchmark's wrapper, averaged."""

UNIT = "ms"


def read(rec):
    f = rec.get("forwards")
    if rec.get("entry") != "serve" or not f:
        return None
    return 1e3 * sum(s for s, _ in f) / len(f)
