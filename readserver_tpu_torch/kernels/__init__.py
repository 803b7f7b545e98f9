"""The port's hand-written CUDA kernels (sources in ``csrc/``).

* ``RANK_OCC`` (K1, ``csrc/rank.cu``): batched occ over a rank-row table;
  launched by ``ops/rank.occ_rows`` for CUDA tensors.
* ``LUT_LEVEL`` (K1's level entry, ``csrc/rank.cu``): one level of the
  prefix-LUT build; launched by ``ops/lut.build_prefix_lut`` for CUDA
  tensors.
* ``BACKWARD_SEARCH`` (K2, ``csrc/search.cu``): the whole backward search,
  one thread per query; launched by the search functions of
  ``ops/search.py`` for CUDA tensors.
* ``RESOLVE_DSA`` (K5), ``RESOLVE_FUSED`` (K6), ``RESOLVE_WALK`` and
  ``EXACT_HISTOGRAM`` (K7), ``csrc/resolve.cu``: the dsa decode, the
  fused-row walk, the marks, lf and slow walks (ranking through K1's table
  layout) and the exact per-sample histogram sweep through any walk;
  launched by ``ops/resolve.py``.
* ``SHARD_OCC`` (K9), ``SHARDED_SEARCH``, ``SHARDED_LUT_LEVEL`` (K11) and
  ``SHARDED_RESOLVE`` (K10), ``csrc/sharded.cu``: the interval-sharded
  index's rank, search, LUT level, and lookups, walks and exact sweep,
  every shard on one device; launched by ``ops/sharded.py``.
* ``SHARD_OCC_PARTIAL`` (K9's partial), ``SHARD_LOOKUP_PARTIAL`` (K13),
  ``SHARDED_LUT_LEVEL_PARTIAL`` (K11's partial), ``WALK_LF_STEP`` and
  ``WALK_SLOW_STEP`` (the walk steps), ``csrc/sharded_partial.cu``: one
  rank's contribution over its run of the shards (a rank, a search step,
  the masked lookups, a LUT level, a step of the LF or the slow walk with
  the walk's state advanced on the card), which the ranks of a process
  group sum by one all-reduce; launched by ``ops/sharded.py``.
* ``ROW_COMPACT`` and ``ROW_GATHER`` (K14) and ``CAPPED_HISTOGRAM`` (K15),
  ``csrc/compact.cu``: the resolve's row-budget compaction (the prefix of
  each query's hit lanes and the budget's int32 or int64 rows, then the
  walk's answers, and a sample column, gathered back to the lanes) and
  the capped per-sample histogram (by read id or by the lanes' samples);
  launched by ``ops/resolve.py`` on one device, on doc shards and on the
  interval shards' programs (``parallel/sharded.py``).

Each is a :class:`~readserver_tpu_torch.kernels.build.Kernel` carrying its
launch count in ``launches``.
"""

from readserver_tpu_torch.kernels.build import LIBRARY, Kernel

RANK_OCC = Kernel("rs_rank_occ")
LUT_LEVEL = Kernel("rs_lut_level")
BACKWARD_SEARCH = Kernel("rs_backward_search")
RESOLVE_DSA = Kernel("rs_resolve_dsa")
RESOLVE_FUSED = Kernel("rs_resolve_fused")
RESOLVE_WALK = Kernel("rs_resolve_walk")
EXACT_HISTOGRAM = Kernel("rs_exact_histogram")
SHARD_OCC = Kernel("rs_shard_occ")
SHARDED_SEARCH = Kernel("rs_sharded_search")
SHARDED_LUT_LEVEL = Kernel("rs_sharded_lut_level")
SHARDED_RESOLVE = Kernel("rs_sharded_resolve")
SHARD_OCC_PARTIAL = Kernel("rs_shard_occ_partial")
SHARD_LOOKUP_PARTIAL = Kernel("rs_shard_lookup_partial")
SHARDED_LUT_LEVEL_PARTIAL = Kernel("rs_sharded_lut_level_partial")
WALK_LF_STEP = Kernel("rs_walk_lf_step")
WALK_SLOW_STEP = Kernel("rs_walk_slow_step")
ROW_COMPACT = Kernel("rs_row_compact")
ROW_GATHER = Kernel("rs_row_gather")
CAPPED_HISTOGRAM = Kernel("rs_capped_histogram")
KERNELS = {
    "rank_occ": RANK_OCC,
    "lut_level": LUT_LEVEL,
    "backward_search": BACKWARD_SEARCH,
    "resolve_dsa": RESOLVE_DSA,
    "resolve_fused": RESOLVE_FUSED,
    "resolve_walk": RESOLVE_WALK,
    "exact_histogram": EXACT_HISTOGRAM,
    "shard_occ": SHARD_OCC,
    "sharded_search": SHARDED_SEARCH,
    "sharded_lut_level": SHARDED_LUT_LEVEL,
    "sharded_resolve": SHARDED_RESOLVE,
    "shard_occ_partial": SHARD_OCC_PARTIAL,
    "shard_lookup_partial": SHARD_LOOKUP_PARTIAL,
    "sharded_lut_level_partial": SHARDED_LUT_LEVEL_PARTIAL,
    "walk_lf_step": WALK_LF_STEP,
    "walk_slow_step": WALK_SLOW_STEP,
    "row_compact": ROW_COMPACT,
    "row_gather": ROW_GATHER,
    "capped_histogram": CAPPED_HISTOGRAM,
}

__all__ = [
    "BACKWARD_SEARCH", "CAPPED_HISTOGRAM", "EXACT_HISTOGRAM", "KERNELS",
    "LIBRARY", "LUT_LEVEL", "Kernel", "RANK_OCC", "RESOLVE_DSA",
    "RESOLVE_FUSED", "RESOLVE_WALK", "ROW_COMPACT", "ROW_GATHER",
    "SHARD_LOOKUP_PARTIAL", "SHARD_OCC", "SHARD_OCC_PARTIAL",
    "SHARDED_LUT_LEVEL", "SHARDED_LUT_LEVEL_PARTIAL", "SHARDED_RESOLVE",
    "SHARDED_SEARCH", "WALK_LF_STEP", "WALK_SLOW_STEP",
]
