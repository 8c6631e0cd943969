"""The fused block kernels' share of their roofline in training: the
traced steps' block work, forward plus backward (``work.block_train_work``:
3x the forward's operations, each input and output byte once, real
positions), as the least time it could take, over the device time of
every block kernel in those steps (forward, backward, weight-gradient and
weight-packing kernels)."""



UNIT = "%"
KERNELS = r"^(fused_block_fwd_kernel|block_bwd_kernel|wgrad_kernel|pack_kernel)$"


def read(rec):
    tr, w = rec.get("trace"), rec.get("trace_work", {})
    if rec.get("entry") != "train" or tr is None or not w.get("block_s"):
        return None
    spent = tr.kernel_seconds(KERNELS)
    return 100.0 * w["block_s"] / spent if spent > 0 else None
