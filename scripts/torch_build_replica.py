#!/usr/bin/env python
"""An exact m-fold replica of a packed index, packed without a suffix sort.

Repeat every read of a corpus m times and number copy j of read i as read
m·i + j.  The builder gives read i's ``$`` the value i, so every suffix-array
row r of the original becomes the m adjacent rows m·r + j, one per copy in
order of j, each preceded by the same symbol.  Hence:

* BWT' = ``np.repeat(BWT, m)``;
* row m·r + j attributes to (m·i + j, o) where row r attributes to (i, o);
* LF'(m·r + j) = m·LF(r) + j, and the ``$``-rank m·k + j maps to read
  m·dollar_map[k] + j;
* every count is multiplied by m, and a hit (i, o) becomes the m hits
  (m·i + j, o), read m·i + j holding read i's text.

Copy j of every read is put in sample j, so the per-sample histograms
are known too: the replica is a cohort of m samples with equal genomes.

``replicate_packed`` derives BWT', the per-row (read, offset) (the
artifact's own dsa tier, decoded), LF', lengths, read text, names and
metadata from the artifact (of one sample) by that identity, and packs
them with the port's own functions (``index/packing.py``,
``builder.resolve_tiers_from_rows``, the k-step tiers as
``from_bwt.pack_from_bwt`` builds them), with the tiers ``build_index``
would choose at n' = m·n.  ``replica_answers`` and ``fold_strands`` derive
the replica engine's answers from the source engine's.  It is a way to
make an index of a size whose answers are known (E. coli 30x at m = 15
gives n' = 2,090,700,000, past human chr20 30x), not a feature of the
program.

    python scripts/torch_build_replica.py --m 15          # E. coli 30x
    python scripts/torch_build_replica.py --m 2 --scale 0.01

prints the build's host seconds by step and the process's peak RSS: at
m = 15 on E. coli 30x 88.1 s and 40.5 GiB for 30.5 GiB of arrays on the
8-core host of an NVIDIA H100 80GB HBM3 machine.  Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from readserver_tpu_torch import alphabet  # noqa: E402
from readserver_tpu_torch.index import packing  # noqa: E402
from readserver_tpu_torch.index.builder import (  # noqa: E402
    TRIPLE_TIER_MAX_N,
    PackedIndex,
    resolve_tiers_from_rows,
)


def copies(values: np.ndarray, m: int, dtype) -> np.ndarray:
    """``m·v + j`` for every value v and copy j, copies adjacent:
    the replica's numbering of a read id or a row."""
    out = np.repeat(np.asarray(values).astype(dtype) * dtype(m), m)
    out.reshape(-1, m)[:] += np.arange(m, dtype=dtype)
    return out


def repeat_segments(flat: np.ndarray, offsets: np.ndarray, m: int,
                    chunk: int = 1 << 20) -> tuple[np.ndarray, np.ndarray]:
    """Variable-length items ``flat[offsets[i]:offsets[i+1]]`` → each item
    m times in a row, and the new offsets (int64 [m·items + 1])."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lens = np.repeat(np.diff(offsets), m)
    new_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    out = np.empty(int(new_off[-1]), dtype=flat.dtype)
    items = len(offsets) - 1
    for a in range(0, items, chunk):
        b = min(a + chunk, items)
        seg = flat[offsets[a]:offsets[b]]
        ln = np.diff(offsets[a:b + 1])
        if ln[0] > 0 and (ln == ln[0]).all():  # equal lengths: one repeat over a matrix
            block = np.repeat(seg.reshape(b - a, -1), m, axis=0).reshape(-1)
        else:
            starts = np.repeat(offsets[a:b] - offsets[a], m)
            rl = np.repeat(ln, m)
            pos = np.repeat(starts - np.cumsum(rl) + rl, rl)
            block = seg[pos + np.arange(len(pos))]
        out[new_off[a * m]:new_off[b * m]] = block
    return out, new_off


def _pack_chunk(src: dict, a: int, b: int, m: int, cfg, lengths2, rate: int,
                out: dict) -> dict:
    """Rows [m·a, m·b) of the replica, packed by the port's functions into
    ``out`` with chunk-local occ checkpoints; returns the chunk's counts
    (symbols, planes, marks) and its sampled pairs."""
    S = cfg.block_size
    b0 = m * a // S
    bwt2 = np.repeat(src["bwt"][a:b], m)
    rank, _, counts = packing.pack_rank_blocks(bwt2, cfg)
    nbk = rank.shape[1] - 1
    last = b == len(src["bwt"])
    rows = nbk + 1 if last else nbk  # the last chunk also writes the totals
    out["rank_blocks"][:, b0:b0 + rows] = rank[:, :rows]
    out["sym4"][m * a // 8:m * a // 8 + (len(bwt2) + 7) // 8] = (
        packing.pack_sym4(bwt2))
    planes = {}
    for tier, codes, k in (("rank2_blocks", "pair", 16),
                           ("rank3_blocks", "triple", 64)):
        if src.get(codes) is not None:
            table, planes[tier] = packing.pack_plane_blocks(
                np.repeat(src[codes][a:b], m), k, cfg)
            out[tier][:, b0:b0 + rows] = table[:, :rows]
    tiers = resolve_tiers_from_rows(
        copies(src["read_of"][a:b], m, np.int32),
        np.repeat(src["offsets"][a:b], m), lengths2,
        copies(src["lf0"][a:b], m, np.int32), bwt2, cfg, rate)
    if tiers["dsa"] is None:
        raise ValueError("the replica's read ids overflow the dsa word")
    out["lf"][m * a:m * b] = tiers["lf"]
    out["dsa"][m * a:m * b] = tiers["dsa"]
    out["mark_rank"][b0:b0 + rows] = tiers["mark_rank"][:rows]
    out["fused_rows"][b0:b0 + nbk] = tiers["fused_rows"]
    marks = int(tiers["mark_rank"][nbk, 0])
    return dict(counts=counts, planes=planes, marks=marks,
                pairs=tiers["sample_pairs"][:marks], dsa_bits=tiers["dsa_bits"])


def _add_checkpoints(out: dict, b0: int, b1: int, run: dict) -> None:
    """Chunk-local occ checkpoints of blocks [b0, b1) → global ones."""
    for tier in ("rank_blocks", "rank2_blocks", "rank3_blocks"):
        if tier in run:
            out[tier][:, b0:b1, 0] += run[tier].astype(np.uint32)[:, None]
    out["mark_rank"][b0:b1, 0] += np.uint32(run["marks"])
    fb1 = min(b1, len(out["fused_rows"]))
    out["fused_rows"][b0:fb1, :5] += run["rank_blocks"].astype(np.uint32)
    out["fused_rows"][b0:fb1, 5] += np.uint32(run["marks"])


def replicate_packed(packed: PackedIndex, m: int,
                     steps: dict | None = None) -> PackedIndex:
    """The index ``build_index`` gives over every read of ``packed`` (one
    sample) repeated ``m`` times, copy j of read i as read m·i + j in
    sample j, array for array.  The replica is a cohort of m samples with
    equal genomes: a query's rows m·r + j are in sample j, so its
    per-sample histograms are known as its counts are, and serving it runs
    the exact per-sample sweep (one sample's histogram is its count).

    ``packed`` must carry the dsa tier (its per-row attribution), the lf
    tier and the pair tier.  The replica's rows are packed in 64 chunks of
    whole blocks by the port's functions, on a thread a core up to 8
    (each chunk's temporaries about 40 bytes a replica row), each chunk's
    occ checkpoints then offset by the counts of the chunks before it.
    ``steps``, when given, receives each step's host seconds.
    """
    if m < 1:
        raise ValueError("m must be >= 1")
    if packed.dsa is None or packed.lf is None or packed.sample_rate <= 0:
        raise ValueError("the source artifact needs its dsa, lf and mark "
                         "tiers (build_index's defaults)")
    if packed.rank2_blocks is None:
        raise ValueError("the source artifact has no pair tier")
    if packed.num_samples != 1:
        raise ValueError("the source must hold one sample")
    n, reads = int(packed.n), int(packed.num_reads)
    n2 = n * m
    if n2 >= (1 << 31) - 1:  # builder.concat_with_sentinels' limit
        raise ValueError(f"n' = {n2} exceeds the int32 build range")
    steps = {} if steps is None else steps
    cfg = packed.config
    S = cfg.block_size
    chunk = -(-n // (64 * S)) * S
    workers = min(8, os.cpu_count() or 1)
    t = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + now - t
        t = now

    # ---- the source's rows, derived once: the replica's follow by identity
    bwt = packing.unpack_sym4(packed.sym4, n)
    lf0 = np.asarray(packed.lf, dtype=np.int32) & np.int32(0x7FFFFFFF)
    bits = int(packed.dsa_bits)
    dsa = np.asarray(packed.dsa, dtype=np.uint32)
    kstep = 3 if n2 <= TRIPLE_TIER_MAX_N else 2
    src = dict(
        bwt=bwt,
        lf0=lf0,
        read_of=(dsa >> np.uint32(bits)).astype(np.int32),
        offsets=(dsa & np.uint32((1 << bits) - 1)).astype(
            np.uint8 if bits <= 8 else np.int32),
        pair=packing.pair_codes_from_lf(bwt, lf0),
        triple=(packing.triple_codes_from_lf(bwt, lf0) if kstep >= 3
                else None),
    )
    del dsa
    lengths2 = np.repeat(np.asarray(packed.read_lengths, np.int32), m)
    lap("derive")

    # ---- packed chunk by chunk by the port's functions
    nb2 = -(-n2 // S)
    R = cfg.row_words
    out = dict(
        rank_blocks=np.zeros((5, nb2 + 1, R), np.uint32),
        sym4=np.empty(-(-n2 // 8), np.uint32),
        rank2_blocks=np.zeros((16, nb2 + 1, R), np.uint32),
        rank3_blocks=(np.zeros((64, nb2 + 1, R), np.uint32)
                      if kstep >= 3 else None),
        lf=np.empty(n2, np.int32),
        dsa=np.empty(n2, np.uint32),
        mark_rank=np.zeros((nb2 + 1, R), np.uint32),
        fused_rows=np.zeros((nb2, packing.fused_row_words(cfg)), np.uint32),
    )
    spans = [(a, min(a + chunk, n)) for a in range(0, n, chunk)]
    rate = int(packed.sample_rate)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        parts = list(pool.map(
            lambda ab: _pack_chunk(src, *ab, m, cfg, lengths2, rate, out),
            spans))
        lap("pack")
        runs, run = [], None
        for (a, b), part in zip(spans, parts):
            if run is not None:
                runs.append((m * a // S, -(-m * b // S) + (b == n), run))
            nxt = dict(rank_blocks=part["counts"], marks=part["marks"],
                       **part["planes"])
            run = nxt if run is None else {
                k: run[k] + nxt[k] for k in run}
        totals = run
        list(pool.map(lambda r: _add_checkpoints(out, *r), runs))
    del src
    counts = totals["rank_blocks"].astype(np.int64)
    C = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=C[1:])
    sample_pairs = np.concatenate([p["pairs"] for p in parts])
    if sample_pairs.shape[0] == 0:  # as resolve_tiers_from_rows does
        sample_pairs = np.zeros((1, 2), dtype=np.int32)
    dsa_bits = parts[0]["dsa_bits"]
    del parts
    C2 = packing.pair_C2(out["rank_blocks"], C, cfg)
    C3 = (None if out["rank3_blocks"] is None
          else packing.kgram_starts(out["rank_blocks"], C, cfg, 3))
    lap("checkpoints")

    # ---- the host cold store and the per-read payload
    read_offsets = np.asarray(packed.read_offsets, dtype=np.int64)
    bases = alphabet.unpack_2bit(packed.corpus_packed, int(read_offsets[-1]))
    bases2, read_offsets2 = repeat_segments(bases, read_offsets, m)
    corpus_packed = alphabet.pack_2bit(bases2)
    del bases, bases2
    blobs = {}
    for col in ("name", "meta"):
        blob = getattr(packed, f"{col}_blob")
        blobs[col] = (None, None) if blob is None else repeat_segments(
            np.asarray(blob), getattr(packed, f"{col}_offsets"), m)
    lap("payload")

    if int(counts[0]) != reads * m:
        raise AssertionError("the replica's BWT does not hold m·reads $")
    return PackedIndex(
        config=cfg,
        n=n2,
        num_reads=reads * m,
        num_samples=m,
        C=C,
        symbol_counts=counts,
        rank_blocks=out["rank_blocks"],
        sym4=out["sym4"],
        dollar_map=copies(packed.dollar_map, m, np.uint32),
        read_to_sample=np.tile(np.arange(m, dtype=np.int32), reads),
        read_lengths=lengths2,
        corpus_packed=corpus_packed,
        read_offsets=read_offsets2,
        sample_names=[f"sample_{j}" for j in range(m)],
        name_blob=blobs["name"][0],
        name_offsets=blobs["name"][1],
        meta_blob=blobs["meta"][0],
        meta_offsets=blobs["meta"][1],
        lf=out["lf"],
        mark_rank=out["mark_rank"],
        sample_pairs=sample_pairs,
        sample_rate=rate,
        dsa=out["dsa"],
        dsa_bits=dsa_bits,
        fused_rows=out["fused_rows"],
        rank2_blocks=out["rank2_blocks"],
        C2=C2,
        rank3_blocks=out["rank3_blocks"],
        C3=C3,
    )


def expand_hits(hits: list[dict], m: int) -> list[dict]:
    """One copy's hits in row order → the replica's, in row order: hit
    (i, o) at row r becomes (m·i + j, o) in sample j at row m·r + j."""
    return [{**h, "read_id": m * h["read_id"] + j, "sample_id": j}
            for h in hits for j in range(m)]


def _swept_hist(m: int, swept: int, names: list[str]) -> dict:
    """The histogram of the first ``swept`` of a query's replica rows:
    row m·r + j is in sample j."""
    if len(names) == 1:  # m = 1: the histogram is the count
        return {names[0]: swept} if swept else {}
    per = [swept // m + (j < swept % m) for j in range(m)]
    return {names[j]: v for j, v in enumerate(per) if v}


def replica_answers(one: list, m: int, H: int, sample_names: list[str],
                    width: int, row_budget: int | None = None,
                    reach: int | None = None) -> list:
    """The replica engine's one-strand answers to a batch, from the source
    engine's one-strand answers ``one`` to the same k-mers in the same
    order (hits in row order, at least ceil(H / m) of each query's);
    ``sample_names`` are the replica's (:func:`replicate_packed`).

    Counts and intervals are m times the source's.  A query keeps the
    replica's first min(m·count, H) rows as hits, less what the engine's
    ``row_budget`` drops where it cuts the ``width`` x H lanes (a walk
    tier serves): the first ``row_budget`` valid lanes in batch order walk,
    the rest drop.  A replica of several samples sweeps the batch's rows
    in order for its exact histograms, up to ``reach`` of them
    (``max_sweep_rows`` rounded up to whole sweep windows, None for no
    cap): a query is complete iff its rows end inside that prefix, and
    counts the rows of it that do.  One sample's histogram is the count."""
    from readserver_tpu_torch.serve.engine import QueryResult

    cut = row_budget is not None and row_budget < width * H
    swept_all = len(sample_names) == 1 or reach is None
    lanes_before = rows_before = 0
    out = []
    for r in one:
        c = m * r.count
        lanes = min(c, H)
        kept = lanes
        if cut:
            kept = min(max(row_budget - lanes_before, 0), lanes)
        lanes_before += lanes
        hits = expand_hits(r.hits[:-(-lanes // m)], m)[:kept]
        if len(hits) != kept:
            raise ValueError(f"{r.kmer}: the source answer holds too few "
                             "hits to expand")
        hist, complete = r.sample_hist, r.sample_hist_complete
        if hist is not None:
            swept = c if swept_all else min(c, max(reach - rows_before, 0))
            # rows_before + c <= reach, a query of no rows past it included
            complete = swept_all or rows_before + c <= reach
            hist = _swept_hist(m, swept, sample_names)
        rows_before += c
        out.append(QueryResult(
            kmer=r.kmer,
            count=c,
            interval=(None if r.interval is None
                      else (m * r.interval[0], m * r.interval[1])),
            hits=hits,
            sample_hist=hist,
            hits_truncated=c > len(hits),
            sample_hist_complete=complete,
        ))
    return out


def fold_strands(kmers: list[str], single: list, back: dict) -> list:
    """One-strand answers of ``expand_rc(kmers)`` → both-strands answers,
    as the engines fold them: counts and histograms summed, the forward
    strand's hits (``"strand": "+"``) then the reverse's (``"-"``), the
    forward interval, truncated if either strand is; the folded answer
    keeps ``sample_hist_complete`` at its default True, as the JAX
    package's fold does (ROADMAP.md §3)."""
    from readserver_tpu_torch.serve.engine import QueryResult

    out = []
    for i, km in enumerate(kmers):
        f = single[i]
        r = single[back[i]] if i in back else None
        hist = f.sample_hist
        if r is not None and (hist is not None or r.sample_hist is not None):
            hist = dict(hist or {})
            for k, v in (r.sample_hist or {}).items():
                hist[k] = hist.get(k, 0) + v
        out.append(QueryResult(
            kmer=km,
            count=f.count + (r.count if r is not None else 0),
            interval=f.interval,
            hits=[{**h, "strand": "+"} for h in f.hits]
            + ([{**h, "strand": "-"} for h in r.hits] if r is not None
               else []),
            sample_hist=hist,
            hits_truncated=f.hits_truncated or (
                r is not None and r.hits_truncated),
        ))
    return out


def peak_rss_gib() -> float:
    """This process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def source_artifact(scale: float) -> PackedIndex:
    """The E. coli 30x artifact at ``scale``, from ``chip_smoke.py``'s cache
    under ``data/`` or built (SA-IS) and left there."""
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index

    cache = REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}"
    if artifact.artifact_exists(cache):
        return artifact.load_artifact(cache, mmap=False)
    corpus = simulate.simulate_config("ecoli", scale=scale)
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    artifact.save_artifact(packed, cache)
    return packed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=15, help="copies of each read")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="E. coli 30x scale of the source artifact")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    src = source_artifact(args.scale)
    print(f"source n={src.n} reads={src.num_reads} in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    steps: dict = {}
    t0 = time.perf_counter()
    rep = replicate_packed(src, args.m, steps)
    dt = time.perf_counter() - t0
    arrays = sum(v.nbytes for v in vars(rep).values()
                 if isinstance(v, np.ndarray))
    print(f"replica m={args.m}: n'={rep.n} reads={rep.num_reads} "
          f"dsa_bits={rep.dsa_bits} rank3={rep.rank3_blocks is not None} "
          f"in {dt:.3f}s (" + ", ".join(
              f"{k} {v:.3f}s" for k, v in steps.items())
          + f"); arrays {arrays / 2**30:.2f} GiB; peak RSS "
          f"{peak_rss_gib():.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
