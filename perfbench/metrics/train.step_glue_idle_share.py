"""The card's idle share under the train step's glue: the idle time under
the spans `train_step` (outside its phases), `step.loss` (the loss terms and
accuracy after the forward), `train_step.clip` and `train_step.grad_sync`,
over the traced window."""
from perfbench import idle

LAYER = "host dispatch"
MOVES = "train_pairs_per_s"
UNIT = "%"
SPANS = ("train_step", "step.loss", "train_step.clip", "train_step.grad_sync")


def read(ctx):
    return idle.share(ctx, SPANS)
