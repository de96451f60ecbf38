"""pipeline.step_ms_max: the slowest single denoising step of the window's
clips (``Runner.last_timings["step_ms"]``, CUDA events), ms."""


def read(rec):
    steps = [s for c in rec["clips"] if c["ok"]
             for s in c["timings"].get("step_ms", ())]
    return max(steps) if steps else None
