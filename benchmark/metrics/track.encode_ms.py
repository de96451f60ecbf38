"""track.encode_ms: the tracker's encode of a clip (``track.encode``: the
frames' uploads and 1024² resizes, normalisation, Hiera-L and the neck in
chunks of 8; ``track_video.last_record``'s CUDA events), ms, the mean over
the window's clips."""


def read(rec):
    ms = [c["timings"]["encode"] for c in rec["clips"]
          if c["ok"] and c["timings"].get("encode") is not None]
    return sum(ms) / len(ms) if ms else None
