"""pipeline.decode_ms: the VAE decode phase of the window's clips
(``Runner.last_timings``, CUDA events), ms, their mean."""


def read(rec):
    dec = [c["timings"]["decode"] for c in rec["clips"] if c["ok"]]
    return sum(dec) / len(dec) if dec else None
