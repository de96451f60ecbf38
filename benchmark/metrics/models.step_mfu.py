"""models.step_mfu: one denoising step's FLOPs (``work/count.py``, counted
on the reference's shapes) over the mean step's time and the card's bf16
peak, %."""

from benchmark.work import peaks


def read(rec):
    work, steps = rec["work"], [c["timings"]["step_mean"]
                                for c in rec["clips"] if c["ok"]]
    if work is None or not steps:
        return None
    step_s = sum(steps) / len(steps) / 1e3
    return 100.0 * work["flops"]["step"] / (step_s * peaks.PEAK_BF16)
