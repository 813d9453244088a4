"""The backbone's share of the device's busy time: the device time of the
operations launched while the backbone's forward ran on the host (the
`ngm.backbone` range the benchmark opens around it) over the union of all
device activity in the traced window."""
LAYER = "backbone"
MOVES = "pairs_per_s"
UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["busy_s"] or "ngm.backbone" not in t["by_range"]:
        return None
    return 100.0 * t["by_range"]["ngm.backbone"] / t["busy_s"]
