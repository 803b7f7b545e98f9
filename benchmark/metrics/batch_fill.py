"""batch_fill: the dispatcher's batches filled, mean queries a batch over
the engine's width B, over the measured window; from the dispatcher's own
``Metrics.batch_fill`` (serve/dispatcher.py).  Moves kmers_per_s: a
batch's host and device cost is paid per batch, so fuller batches answer
more queries for it."""


def read(run):
    if not run.batch_fill:
        return None
    return sum(run.batch_fill) / len(run.batch_fill) / run.config["serve"]["batch_size"]
