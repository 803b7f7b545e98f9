"""Pure-NumPy exact FM-index oracle — the parity anchor (SURVEY.md §4.1).

Small, slow, obviously correct. Every device-side result (interval bounds,
occurrence counts, read/sample hit sets) is tested for exact equality against
this oracle, which plays the role of the reference server's answers
(BASELINE.json: "results must match ... exactly").
"""

from readserver_tpu_torch.oracle.fm import OracleFMIndex, suffix_array_ints
from readserver_tpu_torch.oracle.naive import naive_count, naive_find_reads

__all__ = [
    "OracleFMIndex",
    "suffix_array_ints",
    "naive_count",
    "naive_find_reads",
]
