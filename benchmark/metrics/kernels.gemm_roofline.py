"""kernels.gemm_roofline: the bound (``work/peaks.py``) of the traced clip's
tile-core products (self-attention q|k|v and out + residual, GEGLU FFN and
its out, the motion modules' proj_in / proj_out and temporal q|k|v / out)
over the device time of ``gemm_kernel`` in that clip, %."""

from benchmark.work.trace import kernel_seconds


def read(rec):
    if rec["trace"] is None or rec["work"] is None:
        return None
    t = kernel_seconds(rec["trace"]["kernels"], "gemm_kernel")
    return 100.0 * rec["work"]["gemm_bound_s"] / t if t > 0 else None
