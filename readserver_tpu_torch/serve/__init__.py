"""Serving: the single-device count engine."""

from readserver_tpu_torch.serve.engine import (
    QueryEngine,
    QueryResult,
    fold_strand_results,
    rc_string,
)

__all__ = ["QueryEngine", "QueryResult", "fold_strand_results", "rc_string"]
