"""The card's idle share under the fixed-trip loops of the assignment:
the idle time under the spans `op.sinkhorn` (the final Sinkhorn and the
GNN layers' embedded ones), `op.soft_topk` and `op.greedy`, over the traced
window."""
from perfbench import idle

LAYER = "host dispatch"
MOVES = "pairs_per_s"
UNIT = "%"
SPANS = ("op.sinkhorn", "op.soft_topk", "op.greedy")


def read(ctx):
    return idle.share(ctx, SPANS)
