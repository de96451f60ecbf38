"""pipeline.step_ms: the mean denoising step of the window's clips
(``Runner.last_timings``, CUDA events), ms."""


def read(rec):
    steps = [c["timings"]["step_mean"] for c in rec["clips"] if c["ok"]]
    return sum(steps) / len(steps) if steps else None
