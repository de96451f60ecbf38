"""kernels.flash40_roofline: the bound (``work/peaks.py``) of the traced
clip's level-0 attention (d = 40: both CFG halves of every step, the cond
half's keys [self ‖ bank], and the reference UNet's) over the device time
of ``flash_fwd_kernel<40>`` in that clip, %."""

from benchmark.work.trace import kernel_seconds


def read(rec):
    if rec["trace"] is None or rec["work"] is None:
        return None
    t = kernel_seconds(rec["trace"]["kernels"], "flash_fwd_kernel<40>")
    return 100.0 * rec["work"]["flash40_bound_s"] / t if t > 0 else None
