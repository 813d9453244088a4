"""The card's idle share in the train step's backward: the idle time under
the span `train_step.backward` (on the calling thread and on the autograd
engine's), under every span opened inside the backward (their names end in
`.backward`: `op.assoc.backward`, `op.sinkhorn.backward`, ...), and under
the autograd thread's launches outside any span, over the traced window."""
from perfbench import idle, trace

LAYER = "host dispatch"
MOVES = "train_pairs_per_s"
UNIT = "%"


def read(ctx):
    return idle.share(ctx, ("train_step.backward",), suffix=".backward",
                      also=(trace.OTHER_THREAD,))
