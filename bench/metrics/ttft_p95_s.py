"""ttft_p95_s: the 95th percentile over every request of the measured
window of the time from its call's start to its first token on the host;
nothing where the units carry no latency (training)."""
import numpy as np


def read(w):
    latency = [x for u in w["units"] for x in u["latency"]]
    return float(np.percentile(latency, 95)) if latency else None
