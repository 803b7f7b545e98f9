"""Serving: the single-device engine, the time-multiplexed cohort front
(``MultiEngine``), the async micro-batcher and the REST front
(``http.RestServer``).  ``dispatcher``, ``http`` and ``metrics`` are copies
of the JAX package's modules with the package name substituted."""

from readserver_tpu_torch.serve.engine import (
    MultiEngine,
    QueryEngine,
    QueryResult,
    fold_strand_results,
    rc_string,
)
from readserver_tpu_torch.serve.dispatcher import Dispatcher
from readserver_tpu_torch.serve.metrics import Metrics

__all__ = [
    "Dispatcher",
    "Metrics",
    "MultiEngine",
    "QueryEngine",
    "QueryResult",
    "fold_strand_results",
    "rc_string",
]
