"""attention_roofline: the least time of every ``ops.attention`` call of
the window, forward and backward (``arith.attention_work``), over the
device time of the activities those calls launched."""


def read(w):
    t = w["trace"]
    dev = t["op_device_s"].get("attention", 0.0)
    if not t["calls"].get("attention") or dev <= 0:
        return None
    return 100.0 * t["bound_s"]["attention"] / dev
