"""device.idle_share: the share of the traced clip's window in which no
operation ran on the device (profiler), %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
