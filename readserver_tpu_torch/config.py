"""Frozen configuration dataclasses.

The reference wires configuration through command-line flags on server
binaries plus Perl pipeline scripts (SURVEY.md §5 "Config / flag system");
here a single frozen ``IndexConfig`` is serialized into the index artifact's
manifest so serve-time configuration can never drift from build-time.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class IndexConfig:
    """Build-time layout of the device index.

    The rank structure is a fused-block layout: for each symbol ``c`` and each
    block of ``block_size`` BWT positions, one row of ``row_words`` uint32
    words holds ``[occ_checkpoint, bitplane words...]``. One gather therefore
    fetches both the checkpoint and the in-block bits — the TPU-native
    replacement for SGA's LargeMark/SmallMark two-level sampling
    (SURVEY.md §2.1 "Occ/rank structure").

    Defaults (64-symbol blocks, 16-byte rows) were measured on v5e: XLA's
    row gather is issue-rate-bound per row (flat in table size), and
    16-byte rows gather ~13% faster than 20-byte (75 vs 66 Mrows/s at
    B=512k) — the fourth word is padding (ckpt + 2 plane words), worth
    the 1.25 B/sym table for the rate.
    """

    block_size: int = 64           # BWT symbols per rank block (power of 2)
    row_words: int = 4             # uint32 words per row (ckpt + 2 + pad)
    max_query_len: int = 32        # max k-mer length served per batch
    max_read_len: int = 256        # bound on LF-walk depth at resolve time
    format_version: int = 1

    def __post_init__(self) -> None:
        if self.block_size & (self.block_size - 1):
            raise ValueError("block_size must be a power of 2")
        words = self.block_size // 32
        if self.block_size % 32:
            raise ValueError("block_size must be a multiple of 32")
        if self.row_words < words + 1:
            raise ValueError(
                f"row_words={self.row_words} too small for "
                f"{words} plane words + 1 checkpoint word"
            )

    @property
    def words_per_block(self) -> int:
        return self.block_size // 32

    @property
    def log2_block(self) -> int:
        return self.block_size.bit_length() - 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "IndexConfig":
        return cls(**json.loads(s))


@dataclass(frozen=True)
class ServeConfig:
    """Serve-time knobs for the dispatcher (SURVEY.md §7.7)."""

    batch_size: int = 4096         # max device batch width (queries)
    # smaller widths compiled alongside batch_size; light batches pad to
    # the smallest width that fits, keeping p50 low under light load
    small_batch_sizes: tuple = (256,)
    max_hits: int = 64             # rows resolved per query interval
    prefix_lut_order: int | None = None  # p-mer LUT order; None = auto
    # resolve-row compaction: walk only ~this fraction of B*max_hits rows
    # (valid rows are compacted under the budget; overflow rows drop and
    # their queries report hits_truncated). None disables.
    resolve_budget_frac: float | None = 0.6
    batch_deadline_ms: float = 2.0 # max wait to fill a batch
    # exact per-sample attribution: sweep FULL query intervals for the
    # sample histogram instead of only the max_hits resolved rows
    # (BASELINE.json config 5 — population-scale presence queries
    # routinely exceed any per-query hit cap).  max_sweep_rows bounds the
    # per-batch walked rows (adversarially frequent k-mers); queries cut
    # off by it report sample_hist_complete=False.
    exact_attribution: bool = True
    max_sweep_rows: int | None = 1 << 20
    # uniform query lengths to precompile at warmup, besides max_query_len
    # (uniform batches are column-sliced to their length — a distinct XLA
    # shape; a length first seen in production pays its full-width compile
    # inside a served request).  Deployments serving k-mers shorter than
    # max_query_len should list their k here (e.g. (31,)).
    warmup_query_lengths: tuple = ()
    # exact-attribution sweep chunk (worklist lanes per while_loop round).
    # None = auto: min(batch·max_hits, 8·batch) — the worklist holds
    # Σ interval counts rows, so a B·H window wastes most lanes on typical
    # (low-multiplicity) workloads; 8 rows/query/round covers them in one
    # round and repetitive batches just run more cheap rounds
    sweep_window: int | None = None
    # whole-batch early termination (lax.while_loop): skips remaining scan
    # steps once every interval is empty — wins on miss-heavy workloads
    # (e.g. contamination screens), costs one any-reduce per step otherwise
    early_exit: bool = False
    # HBM budget (GiB) for the tier planner (index/budget.py): None =
    # auto-detect from the device (no cap on the CPU test mesh); tiers the
    # artifact carries are dropped in value order until the index fits
    hbm_budget_gb: float | None = None
    # serving-profile lever: tiers force-excluded from the HBM plan, with
    # their budget reallocated to later tiers (index/budget.plan_tiers
    # ``exclude``).  ("rank2",) turns a search-optimized plan into a
    # resolve-optimized one (dsa-resident) where both can't fit.
    drop_tiers: tuple = ()
    host: str = "127.0.0.1"
    port: int = 8080
    num_shards: int = 1            # BWT-interval shards (mesh 'shard' axis)
    data_parallel: int = 1         # query data-parallel width (mesh 'dp' axis)
    # owner-routed search rank: per-round gather-lane capacity per shard
    # (None = 1.25x the uniform share, 128-aligned — parallel/sharded.py;
    # undersizing is correct but runs extra local overflow rounds)
    owner_route_capacity: int | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ServeConfig":
        return cls(**json.loads(s))
