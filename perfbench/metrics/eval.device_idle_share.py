"""The share of the traced window in which no operation ran on the card:
1 - (union of device activity) / (host-clock length of the window)."""
LAYER = "device"
MOVES = "pairs_per_s"
UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
