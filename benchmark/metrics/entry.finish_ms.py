"""entry.finish_ms: the entry's host work after the card's last phase, the
spans ``entry.output`` (the video's copy back to the host) and
``entry.paste_back`` (edit's paste-back; animate has none) of
``Runner.last_timings["spans"]`` (host clock), ms, summed a clip and
averaged over the window's clips."""

SPANS = ("entry.output", "entry.paste_back")


def read(rec):
    per_clip = [sum(s["end"] - s["start"] for s in t["spans"]
                    if s["name"] in SPANS)
                for c in rec["clips"] if c["ok"] for t in [c["timings"]]
                if "spans" in t]
    return sum(per_clip) / len(per_clip) if per_clip else None
