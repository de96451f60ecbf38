"""frames_per_s: every output frame of the window's clips over the
window's seconds (first hand-off to last return)."""


def read(rec):
    return sum(c["frames"] for c in rec["clips"]) / rec["window_s"]
