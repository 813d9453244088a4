"""The training step's share of the card's peak: forward and backward
FLOPs (3x the forward, `perfbench/counts/model.py`) of the steps in the
traced window over its host-clock length, over the dense TF32 peak."""
LAYER = "model step"
MOVES = "train_pairs_per_s"
UNIT = "%"


def read(ctx):
    t, flops = ctx.get("trace"), ctx["work"].get("flops")
    if not t or not flops:
        return None
    return 100.0 * flops / t["window_s"] / ctx["peaks"]["tf32_flops_per_s"]
