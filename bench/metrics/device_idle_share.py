"""device_idle_share: the share of the window in which no activity ran on
the device (the union of the trace's device intervals)."""


def read(w):
    t = w["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
