"""ssd_roofline: the least time of every ``ops.ssd`` call of the window,
forward and backward (``arith.ssd_work``), over the device time of the
activities those calls launched."""


def read(w):
    t = w["trace"]
    dev = t["op_device_s"].get("ssd", 0.0)
    if not t["calls"].get("ssd") or dev <= 0:
        return None
    return 100.0 * t["bound_s"]["ssd"] / dev
