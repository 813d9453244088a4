"""Device operations launched per training step in the traced window: the
forward, autograd's backward and the optimizer."""
LAYER = "host dispatch"
MOVES = "train_pairs_per_s"
UNIT = "launches/step"


def read(ctx):
    t, steps = ctx.get("trace"), ctx["work"].get("steps")
    if not t or not steps:
        return None
    return t["launches"] / steps
