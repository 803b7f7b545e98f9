"""Compile-time collective accounting for the SPMD query programs.

The interval-sharded search pays one ``psum`` per k-gram step and the
resolve walk pays several per LF step; shard-scaling regressions show up
first as collective-count growth (SURVEY.md §2.4 — the merge cost is the
sharded design's whole overhead vs the reference's scatter-gather star).
This module counts the collectives XLA actually emitted — parsed from the
compiled HLO, not estimated — so benches and tests can pin them.
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

# `s64[2,512]{1,0} all-reduce(` / `u32[] all-reduce-start(`
_OP_RE = re.compile(
    r"(\w+)\[([0-9,]*)\][^ ]* ("
    + "|".join(_COLLECTIVES)
    + r")(?:-start)?\("
)


def hlo_collective_stats(hlo_text: str) -> dict:
    """→ {op: count} + ``bytes_out`` (sum of collective result sizes) +
    ``total`` — one entry per collective op in the compiled module."""
    counts = {op: 0 for op in _COLLECTIVES}
    total_bytes = 0
    for m in _OP_RE.finditer(hlo_text):
        dtype, dims, op = m.group(1), m.group(2), m.group(3)
        counts[op] += 1
        size = _DTYPE_BYTES.get(dtype, 4)
        for d in dims.split(","):
            if d:
                size *= int(d)
        total_bytes += size
    counts["total"] = sum(counts[op] for op in _COLLECTIVES)
    counts["bytes_out"] = total_bytes
    return counts


def query_psum_estimate(
    K: int,
    lut_p: int = 0,
    kstep: int = 1,
    sample_rate: int = 0,
    fast_resolve: bool = False,
    max_read_len: int = 0,
    direct_resolve: bool = False,
) -> dict:
    """Analytic per-batch psum counts for ``_query_body`` (mirrors its
    step schedule exactly — HLO static counts can't see loop trip counts).

    Returns {"search": s, "resolve": r, "total": s+r} where each unit is
    one psum collective over the 'shard' axis per executed step.
    """
    r = K - (lut_p if lut_p else 1)  # C-init costs no rank
    if kstep >= 3:
        ntrip = r // 3
        rem = r - 3 * ntrip
        search = ntrip + rem // 2 + rem % 2
    elif kstep == 2:
        search = r // 2 + r % 2
    else:
        search = r
    if direct_resolve:
        # dsa tier: one masked psum-gather resolves every lane, plus the
        # sample-attribution psum — the walk's collective rounds vanish
        resolve = 2
    elif fast_resolve and sample_rate > 0:
        # walk: 1 lf psum/step; terminal: 2 fused psums (lf+mark_rank,
        # dollar+pair); attribution: sample gather psum
        resolve = sample_rate + 2 + 1
    else:
        # slow walk: sym + occ per step (the $-rank is carried and looked
        # up once after the loop), + dollar + sample
        resolve = 2 * max_read_len + 2
    return {"search": search, "resolve": resolve, "total": search + resolve}


def collective_stats(jitted_fn, *args, **kwargs) -> dict:
    """Lower+compile a jitted fn and count its collectives.

    Static — no execution; safe to call on the CPU-simulated mesh with the
    same shapes the real slice would see.
    """
    compiled = jitted_fn.lower(*args, **kwargs).compile()
    return hlo_collective_stats(compiled.as_text())
