"""models.track_mfu: the FLOPs of every tracked clip of the window
(``work/track_count.py``, counted on the reference's shapes) over the
window's seconds and the card's bf16 peak, %."""

from benchmark.work import peaks


def read(rec):
    work = rec["work"]
    if work is None or "clip_flops" not in work:
        return None
    done = sum(1 for c in rec["clips"] if c["ok"])
    return (100.0 * done * work["clip_flops"]
            / (rec["window_s"] * peaks.PEAK_BF16))
