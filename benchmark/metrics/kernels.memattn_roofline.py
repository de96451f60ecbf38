"""kernels.memattn_roofline: the bound (``work/peaks.py``) of every memory
self- and cross-attention call of the traced clip (one head of 256; each
frame's keys: its memories' 64 x 64 tokens and 4 a pointer) over the device
time of the kernels PyTorch's flash attention runs at head width 256, the
only attention of that width in the tracker, %."""

from benchmark.work.trace import kernel_seconds

KERNELS = "Flash_fwd_kernel_traits<256"


def read(rec):
    if rec["trace"] is None or rec["work"] is None \
            or "memattn_bound_s" not in rec["work"]:
        return None
    t = kernel_seconds(rec["trace"]["kernels"], KERNELS)
    return 100.0 * rec["work"]["memattn_bound_s"] / t if t > 0 else None
