"""track.frame_ms: one propagated frame of the tracker (``track.frame``:
memory attention, mask decoder, memory encoder; ``track_video.last_record``'s
CUDA events, one a frame), ms, the mean over every frame of the window's
clips."""


def read(rec):
    ms = [v for c in rec["clips"] if c["ok"]
          for v in c["timings"].get("frame_ms", ())]
    return sum(ms) / len(ms) if ms else None
