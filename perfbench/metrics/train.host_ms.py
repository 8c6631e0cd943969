"""Host milliseconds of one ``Trainer.train_step`` call (its launches and
any wait it makes for the card), by the host clock around each call of
the window, averaged."""

UNIT = "ms"


def read(rec):
    spans = rec.get("spans", {}).get("train_step")
    if rec.get("entry") != "train" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
