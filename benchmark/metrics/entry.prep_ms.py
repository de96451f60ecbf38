"""entry.prep_ms: the entry's host work before the card's first phase, the
spans ``entry.reference`` (matting, crop, pad), ``entry.template`` (the
human crop or shot split, pads) and ``entry.inputs`` (resizes,
normalisation, the noise draw, the copies to the card) of
``Runner.last_timings["spans"]`` (host clock), ms, summed a clip and
averaged over the window's clips."""

SPANS = ("entry.reference", "entry.template", "entry.inputs")


def read(rec):
    per_clip = [sum(s["end"] - s["start"] for s in t["spans"]
                    if s["name"] in SPANS)
                for c in rec["clips"] if c["ok"] for t in [c["timings"]]
                if "spans" in t]
    return sum(per_clip) / len(per_clip) if per_clip else None
