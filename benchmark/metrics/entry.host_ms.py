"""entry.host_ms: a clip's wall time less its pipeline span (prepare +
steps × mean step + decode, CUDA events of ``Runner.last_timings``), ms,
the mean over the window's clips: the entry's host work (reference prep,
crops, pads, resizes, transfers, edit's paste-back) that the card does not
overlap."""


def read(rec):
    spans = [c["wall_s"] * 1e3 - (t["prepare"] + t["steps"] * t["step_mean"]
                                  + t["decode"])
             for c in rec["clips"] if c["ok"] for t in [c["timings"]]]
    return sum(spans) / len(spans) if spans else None
