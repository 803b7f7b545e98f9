"""HBM budget planner: which optional index tiers fit on the chip.

The packed artifact stores every tier it was built with; the *engine*
decides at load time what to ship to HBM.  At chr20-30x scale
(n ≈ 1.95e9 symbols) the full tier set is ~20 GB against a v5e's 16 GB,
so the planner greedily keeps tiers in value order until the budget is
spent (the reference never faces this — its RLE-BWT lives in host RAM;
SURVEY.md §7 "HBM budget" names it as a build-vs-serve constraint of the
TPU design):

  base   (mandatory)  fused rank rows + sym4 + payload arrays
  rank2  4 B/sym      pair planes: one gather advances the search 2 chars
  dsa    4 B/sym      per-row (read_id << bits | offset): resolution is ONE
                      gather, no walk — strictly dominates lf at equal cost
  fused  ~1.25 B/sym  fused resolve rows + sampled pairs: bounded walk at
                      1 gather/step (vs the mark-walk's 3)
  marks  ~0.5 B/sym   mark-rank bits + sampled pairs: bounded mark-walk
                      (3 gathers/step) — the cheapest resolve bound
  rank3  16 B/sym     triple planes: 3 chars per gather
  lf     4 B/sym      precomputed LF walk (legacy/imported artifacts that
                      carry no dsa; skipped whenever dsa or fused ship)

Dropping a tier never changes any answer — only the gather count of the
step that would have used it.  Tiers share arrays (``sample_pairs`` backs
both ``fused`` and ``marks``); the planner charges each array once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from readserver_tpu_torch.index.builder import PackedIndex

# greedy keep order: the 2-step search tier first (the headline metric),
# then resolve tiers best-first (dsa > fused > marks), then luxuries
TIER_ORDER = ("rank2", "dsa", "fused", "marks", "rank3", "lf")

_TIER_ARRAYS = {
    "marks": ("mark_rank", "sample_pairs"),
    "dsa": ("dsa",),
    "fused": ("fused_rows", "sample_pairs"),
    "rank2": ("rank2_blocks", "C2"),
    "rank3": ("rank3_blocks", "C3"),
    "lf": ("lf",),
}

# a tier is pointless when a strictly better resolve tier already shipped:
# the walk selection in ops/resolve.resolve_intervals prefers dsa > lf >
# fused > marks, so e.g. fused would never be consulted once dsa is kept
_SKIP_IF_KEPT = {
    "fused": ("dsa",),
    "marks": ("dsa", "fused"),
    "lf": ("dsa", "fused"),
}
_BASE_ARRAYS = (
    "rank_blocks",
    "sym4",
    "C",
    "dollar_map",
    "read_to_sample",
    "read_lengths",
)


@dataclass(frozen=True)
class TierPlan:
    keep: frozenset[str]
    base_bytes: int
    tier_bytes: dict[str, int] = field(default_factory=dict)
    budget_bytes: int | None = None
    # HBM actually used by base + kept tiers, shared arrays charged once
    used_bytes: int | None = None

    @property
    def dropped(self) -> tuple[str, ...]:
        return tuple(
            t for t in TIER_ORDER if self.tier_bytes.get(t, 0) and t not in self.keep
        )

    @property
    def total_bytes(self) -> int:
        if self.used_bytes is not None:
            return self.used_bytes
        return self.base_bytes + sum(
            self.tier_bytes.get(t, 0) for t in self.keep
        )


def tier_bytes(packed: PackedIndex) -> tuple[int, dict[str, int]]:
    """(base_bytes, {tier: bytes}); absent tiers report 0.  Shared arrays
    are charged to every tier listing them (plan_tiers de-duplicates)."""
    base = sum(
        getattr(packed, a).nbytes
        for a in _BASE_ARRAYS
        if getattr(packed, a) is not None
    )
    tiers = {}
    for t, arrays in _TIER_ARRAYS.items():
        vals = [getattr(packed, a) for a in arrays]
        tiers[t] = sum(v.nbytes for v in vals) if all(
            v is not None for v in vals
        ) else 0
    # the walk tiers only exist when the artifact carries a sample rate
    if packed.sample_rate <= 0:
        tiers["marks"] = 0
        tiers["fused"] = 0
        tiers["lf"] = 0
    return base, tiers


def plan_tiers(
    packed: PackedIndex, budget_bytes: int | None, exclude=()
) -> TierPlan:
    """Greedy keep-while-it-fits over TIER_ORDER (skipping over tiers that
    don't fit — a too-big rank3 must not shadow a fitting fused tier).
    Arrays shared between tiers are charged once; a tier dominated by an
    already-kept resolve tier (_SKIP_IF_KEPT) is skipped outright.

    ``exclude`` force-drops tiers BEFORE planning, so their budget
    reallocates to later tiers — the serving-profile lever: e.g. at wg
    scale per-shard {rank2, marks} is the default greedy outcome, but
    ``exclude=("rank2",)`` frees 4 B/sym and dsa (ONE-gather resolve)
    becomes resident, trading 2-chars-per-gather search for ~an order of
    magnitude on attribution-heavy workloads (VERDICT r4 weak #2/#3)."""
    exclude = set(exclude)
    base, tiers = tier_bytes(packed)
    tiers = {t: (0 if t in exclude else b) for t, b in tiers.items()}
    if budget_bytes is None:
        keep = frozenset(t for t in TIER_ORDER if tiers[t] > 0)
        arrays = {a for t in keep for a in _TIER_ARRAYS[t]}
        used = base + sum(
            getattr(packed, a).nbytes
            for a in arrays
            if getattr(packed, a) is not None
        )
        return TierPlan(keep, base, tiers, None, used)
    if base > budget_bytes:
        raise ValueError(
            f"base index tier ({base/2**30:.2f} GiB) exceeds the HBM budget "
            f"({budget_bytes/2**30:.2f} GiB); shard the index "
            "(parallel/sharded.py) or use a cohort artifact"
        )
    used = base
    keep: set[str] = set()
    shipped: set[str] = set()
    for t in TIER_ORDER:
        if not tiers[t]:
            continue
        if any(better in keep for better in _SKIP_IF_KEPT.get(t, ())):
            continue
        # lf without marks has no consumer (resolve_rows_fast's terminal
        # lookup needs the mark-rank table) — only keep lf if marks made it
        if t == "lf" and tiers["marks"] and "marks" not in keep:
            continue
        inc = sum(
            getattr(packed, a).nbytes
            for a in _TIER_ARRAYS[t]
            if a not in shipped
        )
        if used + inc <= budget_bytes:
            keep.add(t)
            shipped.update(_TIER_ARRAYS[t])
            used += inc
    return TierPlan(frozenset(keep), base, tiers, budget_bytes, used)


def device_budget_bytes(device=None, headroom: float = 0.92) -> int | None:
    """The card's memory budget for the tier planner: ``headroom`` of the
    CUDA device's total memory as ``torch.cuda.mem_get_info`` reports it.

    None on the CPU (no cap: the budget there is host RAM), as the JAX
    package's planner does on its CPU test mesh.
    """
    import torch

    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total * headroom)
