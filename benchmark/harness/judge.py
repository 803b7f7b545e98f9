"""The comparison that decides ``correct``: the program's answers of the
kept requests against the NumPy reference, field by field.

Every number compared is a count of answers that differ, and its limit is
0: the configuration states exact answers.  Which fields, by route:

* count: the both-strand count;
* full: the count, the hit set (read id, sample id, offset, strand), its
  truncation flag, the per-sample histogram and its completeness flag;
* hist: the count, the per-sample histogram, its completeness flag and
  the truncation flag.
"""

from __future__ import annotations

import numpy as np

from reference import expected_answers


class Digest:
    """A request's answers kept as a few arrays, not as the program's
    result objects: a run keeps many, and live objects by the hundred
    thousand would slow the collector, and so the program, in the
    window."""

    def __init__(self, mode: str, results: list, names: dict):
        self.count = np.array([r.count for r in results], dtype=np.int64)
        if mode == "count":
            return
        self.trunc = np.array([bool(r.hits_truncated) for r in results])
        self.complete = np.array([r.sample_hist_complete is True
                                  for r in results])
        cells = [(i, names.get(k, -1), v) for i, r in enumerate(results)
                 for k, v in (r.sample_hist or {}).items()]
        self.hist = np.array(cells, dtype=np.int64).reshape(-1, 3)
        if mode == "full":
            hits = [(i, h["read_id"], h["sample_id"], h["offset"],
                     h["strand"] == "-") for i, r in enumerate(results)
                    for h in r.hits]
            self.hits = np.array(hits, dtype=np.int64).reshape(-1, 5)


def _rows_by_query(rows: np.ndarray, n: int) -> list:
    """[k, c] rows whose first column is a query number → n sorted lists
    of the other columns as tuples."""
    out: list = [[] for _ in range(n)]
    for row in rows.tolist():
        out[row[0]].append(tuple(row[1:]))
    for x in out:
        x.sort()
    return out


def compare(mode: str, got: list, exp, names: list) -> dict[str, int]:
    """Answers that differ from ``exp``, by field, over the digests
    ``got`` of consecutive requests."""
    count = np.concatenate([d.count for d in got])
    wrong = {"count_wrong": int((count != exp.count).sum())}
    if mode == "count":
        return wrong
    n = len(count)
    base = np.cumsum([0] + [len(d.count) for d in got])
    shift = lambda a, j: a + np.array([base[j]] + [0] * (a.shape[1] - 1))  # noqa: E731
    hist = _rows_by_query(np.concatenate(
        [shift(d.hist, j) for j, d in enumerate(got)]), n)
    want_hist = [sorted((names.index(k), v) for k, v in h.items())
                 for h in exp.hist]
    wrong["hist_wrong"] = sum(a != b for a, b in zip(hist, want_hist))
    trunc = np.concatenate([d.trunc for d in got])
    complete = np.concatenate([d.complete for d in got])
    want_trunc = exp.hits_truncated if mode == "full" else exp.hist_truncated
    wrong["flags_wrong"] = int(((trunc != want_trunc) | ~complete).sum())
    if mode == "full":
        hits = _rows_by_query(np.concatenate(
            [shift(d.hits, j) for j, d in enumerate(got)]), n)
        want = [[(r, s, o, st == "-") for r, s, o, st in h] for h in exp.hits]
        wrong["hits_wrong"] = sum(a != b for a, b in zip(hits, want))
    return wrong


def judge(mode: str, kept: dict, pool_codes: np.ndarray, reads, sids,
          names, max_hits: int, partitions: int):
    """``kept``: (client, request) → (pool indices, :class:`Digest`)."""
    """→ (numbers compared {name: {"value": v, "at_most" or "at_least":
    limit}}, correct)."""
    keys = sorted(kept)
    if keys:
        queries = np.concatenate([pool_codes[kept[k][0]] for k in keys])
        exp = expected_answers(reads, sids, names, queries, max_hits,
                               partitions, detail=mode != "count")
        wrong = compare(mode, [kept[k][1] for k in keys], exp, names)
    else:
        queries, wrong = np.zeros((0, 0)), {"count_wrong": 0}
    numbers = {"kmers_checked": {"value": len(queries), "at_least": 1}}
    numbers.update({k: {"value": v, "at_most": 0} for k, v in wrong.items()})
    correct = len(queries) >= 1 and all(v == 0 for v in wrong.values())
    return numbers, correct
