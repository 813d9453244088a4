"""The card's idle share at the batch boundary of `evaluate_loader`: the
idle time under its spans `evaluate.load` (the next batch, to the card),
`evaluate.on_batch` (the caller's callback), `evaluate.fetch` (scores and
metrics to the host: nine round trips a batch), `evaluate.report`, and
under `ngm.input`, the first work of the next batch, which ends the gap
that a fetch leaves, over the traced window."""
from perfbench import idle

LAYER = "host dispatch"
MOVES = "pairs_per_s"
UNIT = "%"
SPANS = ("evaluate.load", "evaluate.on_batch", "evaluate.fetch",
         "evaluate.report", "ngm.input")


def read(ctx):
    return idle.share(ctx, SPANS)
