"""Device operations (kernels, copies, sets) launched per pair scored in
the traced window: the host dispatch of `NGMNet.forward` and the ops it
calls. Fewer launches a pair is what a larger batch or a fused op buys."""
LAYER = "host dispatch"
MOVES = "pairs_per_s"
UNIT = "launches/pair"


def read(ctx):
    t, pairs = ctx.get("trace"), ctx["work"].get("pairs")
    if not t or not pairs:
        return None
    return t["launches"] / pairs
