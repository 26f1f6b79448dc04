"""tokens_per_s: the tokens of the steps or calls that finished in the
measured window, over the wall time from its start to the last one's
completion."""


def read(w):
    if w["wall_s"] <= 0 or not w["units"]:
        return None
    return sum(u["tokens"] for u in w["units"]) / w["wall_s"]
