"""optimizer_share: device time launched inside ``optimizer.update`` over
all the device time of the window."""


def read(w):
    t = w["trace"]
    if not t["calls"].get("optimizer") or t["device_s"] <= 0:
        return None
    return 100.0 * t["op_device_s"]["optimizer"] / t["device_s"]
