"""The fused block forward's share of its roofline in serving: the block
work the traced stretch's requests need (``work.block_serve_work``: the
user's rows once per request, the query path per candidate), as the
least time it could take, over the device time of the block forward and
weight-packing kernels in the stretch."""

UNIT = "%"
KERNELS = r"^(fused_block_fwd_kernel|pack_kernel)$"


def read(rec):
    tr, w = rec.get("trace"), rec.get("trace_work", {})
    if rec.get("entry") != "serve" or tr is None or not w.get("block_s"):
        return None
    spent = tr.kernel_seconds(KERNELS)
    return 100.0 * w["block_s"] / spent if spent > 0 else None
