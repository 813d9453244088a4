"""The evaluation step's share of the card's peak: the model FLOPs of the
pairs scored in the traced window (`perfbench/counts/model.py`) over the
window's host-clock length, over the dense TF32 peak (`peaks.json`; cuDNN
runs the float32 convolutions, most of the FLOPs, in TF32)."""
LAYER = "model step"
MOVES = "pairs_per_s"
UNIT = "%"


def read(ctx):
    t, flops = ctx.get("trace"), ctx["work"].get("flops")
    if not t or not flops:
        return None
    return 100.0 * flops / t["window_s"] / ctx["peaks"]["tf32_flops_per_s"]
