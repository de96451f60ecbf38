"""clip_s_max: the slowest clip of the window, from its hand-off to its
frames on the host, in seconds."""


def read(rec):
    return max(c["wall_s"] for c in rec["clips"])
