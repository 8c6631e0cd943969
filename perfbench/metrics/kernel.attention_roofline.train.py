"""The attention kernels' share of their roofline in training: the traced
steps' attention-core work, forward plus backward
(``work.attention_train_work``, real positions), as the least time it
could take, over the device time of the attention kernels in those
steps."""

UNIT = "%"
KERNELS = r"^attention_(fwd|bwd)_(kernel|rows|cols)$"


def read(rec):
    tr, w = rec.get("trace"), rec.get("trace_work", {})
    if rec.get("entry") != "train" or tr is None or not w.get("attention_s"):
        return None
    spent = tr.kernel_seconds(KERNELS)
    return 100.0 * w["attention_s"] / spent if spent > 0 else None
