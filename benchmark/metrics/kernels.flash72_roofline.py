"""kernels.flash72_roofline: the bound (``work/peaks.py``) of the traced
clip's Hiera-L global attention (blocks 23, 33 and 43 of every frame: 8
heads of 72 over 64 x 64 tokens) over the device time of
``flash_fwd_kernel<72>`` in that clip, %."""

from benchmark.work.trace import kernel_seconds


def read(rec):
    if rec["trace"] is None or rec["work"] is None \
            or "flash72_bound_s" not in rec["work"]:
        return None
    t = kernel_seconds(rec["trace"]["kernels"], "flash_fwd_kernel<72>")
    return 100.0 * rec["work"]["flash72_bound_s"] / t if t > 0 else None
