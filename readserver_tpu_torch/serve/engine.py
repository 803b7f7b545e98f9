"""QueryEngine: artifact → device tensors → batched queries on one device.

The single-device slice of the JAX package's ``serve/engine.py``: plan tiers
for the device's memory, ship the ``DeviceIndex``, build the prefix LUT,
then per batch pad and encode on the host, search on the device (k-step for
uniform batches, masked 1-step otherwise) and bring back one buffer: (l, u,
count) for counts, or the sparse pack of counts, exact per-sample
histograms and resolved hits for full answers.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.index.budget import device_budget_bytes, plan_tiers
from readserver_tpu_torch.index.builder import PackedIndex
from readserver_tpu_torch.ops import (
    DeviceIndex,
    build_prefix_lut,
    default_lut_order,
    encode_query_batch,
    exact_sample_histogram,
    resolve_intervals,
    sample_histogram,
)
from readserver_tpu_torch.ops.resolve import resolve_hits
from readserver_tpu_torch.ops.search import raise_if_refused, search_batch

_NOT_PORTED = "not ported yet; see ROADMAP.md, modules still to port"


@dataclass
class QueryResult:
    kmer: str
    count: int
    interval: tuple[int, int] | None = None
    hits: list[dict] = field(default_factory=list)      # read_id/sample_id/offset
    sample_hist: dict[str, int] | None = None
    hits_truncated: bool = False
    # exact-attribution contract: the histogram covers the FULL interval
    # (False only when the engine's max_sweep_rows safety cap cut it off,
    # or when running with exact_attribution disabled and count > max_hits)
    sample_hist_complete: bool = True


def rc_string(kmer: str) -> str:
    """Reverse complement of an ACGT query string."""
    return alphabet.decode(alphabet.revcomp(alphabet.encode(kmer)))


def fold_strand_results(
    kmer: str, fwd: QueryResult, rev: QueryResult | None
) -> QueryResult:
    """Combine forward + reverse-complement answers into one both-strands
    result (``rev is None`` for palindromic queries — one strand is the
    other, so folding twice would double count).

    Like the JAX package's, the folded result never carries
    ``sample_hist_complete`` over: it keeps the default ``True`` even when
    the sweep cap cut a strand off (ROADMAP.md §3 records this)."""
    fwd_hits = [{**h, "strand": "+"} for h in fwd.hits]
    if rev is None:
        return QueryResult(
            kmer=kmer,
            count=fwd.count,
            interval=fwd.interval,
            hits=fwd_hits,
            sample_hist=fwd.sample_hist,
            hits_truncated=fwd.hits_truncated,
        )
    hist = None
    if fwd.sample_hist is not None or rev.sample_hist is not None:
        hist = dict(fwd.sample_hist or {})
        for k, v in (rev.sample_hist or {}).items():
            hist[k] = hist.get(k, 0) + v
    return QueryResult(
        kmer=kmer,
        count=fwd.count + rev.count,
        interval=fwd.interval,
        hits=fwd_hits + [{**h, "strand": "-"} for h in rev.hits],
        sample_hist=hist,
        hits_truncated=fwd.hits_truncated or rev.hits_truncated,
    )


# sparse transfer compaction budget: entries kept on the fast path per
# padded-batch-width query (typical low-multiplicity workloads fit; denser
# batches fall back to dense device buffers, transferred only when needed)
COMPACT_PER_QUERY = 16


def _compact_cols(mask: torch.Tensor, cols, R: int):
    """Order-preserving compaction of ``cols`` where ``mask`` → fixed [R]
    buffers + the kept count (-1 signals overflow → dense fallback).  A
    cumsum plus a scatter; slot R is the overflow slot, cut off after."""
    m32 = mask.to(torch.int32)
    pos = torch.cumsum(m32, 0) - m32
    keep = mask & (pos < R)
    slot = torch.where(keep, pos, torch.full_like(pos, R))
    outs = [
        torch.full((R + 1,), -1, dtype=torch.int32, device=mask.device)
        .scatter(0, slot, c.to(torch.int32))[:R]
        for c in cols
    ]
    total = m32.sum()
    n = torch.where(total > R, torch.full_like(total, -1), total)
    return n.to(torch.int32), outs


def sparse_pack_device(
    count, complete, hist, rid, off, smp, nq, cpq, bad, l=None, u=None,
    trunc=None,
):
    """Device-side sparse pack of a query batch's answers into ONE small
    int32 buffer (one short device→host copy per batch):

      [count(W), complete(W), trunc(W)?, (l(W), u(W))?,
       n_hist, hist_idx(R), hist_val(R),
       (n_hits, hit_idx(R), read_id(R), offset(R), sample(R))?, bad]

    ``bad`` (int32 [1]) is the search's refused-query count.

    ``rid=None`` packs a histogram-only answer (the /samples shape).
    Returns ``(packed, hist, dense_hits)``: the dense device tensors back
    the rare overflow case (n == -1), copied only when needed."""
    W = count.shape[0]
    R = cpq * W
    dev = count.device
    segs = [count.to(torch.int32), complete.to(torch.int32)]
    if trunc is not None:
        # hist-only tier: whether a follow-up hits query would truncate
        segs.append(trunc.to(torch.int32))
    if l is not None:
        segs += [l.to(torch.int32), u.to(torch.int32)]
    NS = hist.shape[1]
    cells = torch.arange(W * NS, dtype=torch.int32, device=dev)
    n_hist, (hist_idx, hist_val) = _compact_cols(
        (hist.reshape(-1) > 0) & (cells // NS < nq),
        [cells, hist.reshape(-1)],
        R,
    )
    segs += [n_hist.reshape(1), hist_idx, hist_val]
    dense_hits = None
    if rid is not None:
        SH = rid.shape[1]
        lanes = torch.arange(W * SH, dtype=torch.int32, device=dev)
        n_hits, (hit_idx, hit_rid, hit_off, hit_smp) = _compact_cols(
            (rid.reshape(-1) >= 0) & (lanes // SH < nq),
            [lanes, rid.reshape(-1), off.reshape(-1), smp.reshape(-1)],
            R,
        )
        segs += [n_hits.reshape(1), hit_idx, hit_rid, hit_off, hit_smp]
        dense_hits = torch.cat([rid, off, smp], dim=1)
    segs.append(bad)
    return torch.cat(segs), hist, dense_hits


def assemble_sparse(
    kmers,
    nq,
    W,
    arr,
    NS,
    SH,
    cpq,
    sample_names,
    has_lu,
    has_hits,
    dense_hist_dev,
    dense_hits_dev,
    stats=None,
) -> list[QueryResult]:
    """Host-side assembly of the sparse packed buffer → QueryResults (NumPy;
    the JAX package's ``assemble_sparse``, with the dense fallbacks copied
    off the device by ``.cpu().numpy()``).

    ``stats`` (optional dict) accumulates transfer accounting: batches,
    sparse-path bytes, and dense-fallback events/bytes."""
    R = cpq * W
    if stats is not None:
        stats["batches"] += 1
        stats["sparse_bytes"] += int(arr.nbytes)
    p = W
    count_m = arr[:W].astype(np.int64)
    complete_m = arr[p : p + W].astype(bool)
    p += W
    trunc_m = None
    if not has_hits:  # hist tier packs the exact truncation flag instead
        trunc_m = arr[p : p + W].astype(bool)
        p += W
    l_m = u_m = None
    if has_lu:
        l_m = arr[p : p + W]
        u_m = arr[p + W : p + 2 * W]
        p += 2 * W
    n_hist = int(arr[p])
    hist_idx = arr[p + 1 : p + 1 + R]
    hist_val = arr[p + 1 + R : p + 1 + 2 * R]
    p += 1 + 2 * R
    hist_q: list[dict[str, int]] = [{} for _ in range(nq)]
    if n_hist >= 0:
        for j in range(n_hist):
            cell = int(hist_idx[j])
            hist_q[cell // NS][sample_names[cell % NS]] = int(hist_val[j])
    else:  # dense fallback: transfer just the histogram
        hist_m = dense_hist_dev.cpu().numpy()[:nq]
        if stats is not None:
            stats["hist_dense_fallbacks"] += 1
            stats["dense_bytes"] += int(hist_m.nbytes)
        for i in range(nq):
            nz = np.nonzero(hist_m[i])[0]
            hist_q[i] = {
                sample_names[int(s)]: int(hist_m[i][s]) for s in nz
            }
    hits_q: list[list[dict]] = [[] for _ in range(nq)]
    if has_hits:
        n_hits = int(arr[p])
        hit_idx = arr[p + 1 : p + 1 + R]
        hit_rid = arr[p + 1 + R : p + 1 + 2 * R]
        hit_off = arr[p + 1 + 2 * R : p + 1 + 3 * R]
        hit_smp = arr[p + 1 + 3 * R : p + 1 + 4 * R]
        if n_hits >= 0:
            for j in range(n_hits):
                q = int(hit_idx[j]) // SH
                hits_q[q].append(
                    dict(
                        read_id=int(hit_rid[j]),
                        sample_id=int(hit_smp[j]),
                        offset=int(hit_off[j]),
                    )
                )
        else:  # dense fallback: transfer just the hit tensor
            dh = dense_hits_dev.cpu().numpy()[:nq]
            if stats is not None:
                stats["hits_dense_fallbacks"] += 1
                stats["dense_bytes"] += int(dh.nbytes)
            rid_m = dh[:, :SH]
            off_m = dh[:, SH : 2 * SH]
            smp_m = dh[:, 2 * SH :]
            for i in range(nq):
                v = rid_m[i] >= 0
                hits_q[i] = [
                    dict(read_id=r, sample_id=s, offset=o)
                    for r, s, o in zip(
                        rid_m[i][v].tolist(),
                        smp_m[i][v].tolist(),
                        off_m[i][v].tolist(),
                    )
                ]
    out = []
    for i, km in enumerate(kmers):
        count = int(count_m[i])
        out.append(
            QueryResult(
                kmer=km,
                count=count,
                interval=(
                    (int(l_m[i]), int(u_m[i])) if has_lu else None
                ),
                hits=hits_q[i],
                sample_hist=hist_q[i],
                hits_truncated=(
                    count > len(hits_q[i])
                    if has_hits
                    else bool(trunc_m[i])
                ),
                sample_hist_complete=bool(complete_m[i]),
            )
        )
    return out


class QueryEngine:
    """Batched queries over a built index on one device: counts, hit sets
    and exact per-sample histograms.

    ``QueryEngine(packed, device="cuda")``.  A list of partitions (document
    sharding) and a mesh (interval sharding) are not ported yet.  The
    dispatcher and REST front read ``B``, ``H``, ``K``, ``cfg``,
    ``sample_names``, ``pack_stats``, ``tier_plan``, ``packed``, ``_ns``,
    ``_doc`` and ``_sharded`` (both False here).
    """

    COMPACT_PER_QUERY = COMPACT_PER_QUERY
    _doc = False
    _sharded = False

    def __init__(
        self,
        packed: PackedIndex,
        serve_config: ServeConfig | None = None,
        mesh=None,
        *,
        device,
    ):
        if isinstance(packed, (list, tuple)):
            raise NotImplementedError(f"document sharding: {_NOT_PORTED}")
        if mesh is not None:
            raise NotImplementedError(f"interval sharding: {_NOT_PORTED}")
        self.cfg = serve_config or ServeConfig()
        # sparse-pack transfer accounting (see assemble_sparse)
        self.pack_stats = {
            "batches": 0, "sparse_bytes": 0, "dense_bytes": 0,
            "hist_dense_fallbacks": 0, "hits_dense_fallbacks": 0,
        }
        self.device = torch.device(device)
        self.packed = packed
        self.K = packed.config.max_query_len
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        self.sample_names = packed.sample_names or ["sample_0"]
        self._ns = max(packed.num_samples, 1)
        frac = self.cfg.resolve_budget_frac
        self.row_budget = int(frac * self.B * self.H) if frac else None
        self.budget_bytes = (
            int(self.cfg.hbm_budget_gb * 2**30)
            if self.cfg.hbm_budget_gb is not None
            else device_budget_bytes(self.device)
        )
        self.tier_plan = plan_tiers(
            packed, self.budget_bytes, exclude=self.cfg.drop_tiers
        )
        if self.tier_plan.dropped:
            logging.getLogger("readserver_tpu_torch.engine").warning(
                "device budget %.2f GiB: shipping %s (%.2f GiB), "
                "dropping tiers %s",
                (self.budget_bytes or 0) / 2**30,
                sorted(self.tier_plan.keep) or ["base only"],
                self.tier_plan.total_bytes / 2**30,
                list(self.tier_plan.dropped),
            )
        # wall seconds of each start-up stage, each ended by a device sync
        self.startup_seconds: dict[str, float] = {}
        t0 = time.perf_counter()
        self.index = DeviceIndex.from_packed(
            packed, self.device, tiers=self.tier_plan.keep
        )
        self._mark("ship", t0)
        self.lut_p = (
            self.cfg.prefix_lut_order
            if self.cfg.prefix_lut_order is not None
            else default_lut_order(packed.n)
        )
        t0 = time.perf_counter()
        self.lut = (
            build_prefix_lut(self.index, self.lut_p) if self.lut_p else None
        )
        self._mark("lut", t0)
        self.has_pair = self.index.rank2_rows is not None

    def _mark(self, stage: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.startup_seconds[stage] = time.perf_counter() - t0

    # ------------------------------------------------------------- helpers

    def _search(self, codes, lengths, use_lut: bool, use_pair: bool, bad):
        """K-step search for a uniform full-length batch (``use_pair``),
        else the masked 1-step one; from the LUT when ``use_lut``.

        On the card the search never waits: it counts refused queries into
        ``bad`` (:meth:`_new_bad`), which rides at the end of the batch's
        one result copy, where :meth:`_fetch` raises on it.  On the CPU a
        refused query raises here."""
        lut, p = (self.lut, self.lut_p) if use_lut else (None, 0)
        return search_batch(self.index, codes, lengths, lut, p, use_pair, bad)

    def _new_bad(self) -> torch.Tensor:
        return torch.zeros(1, dtype=torch.int32, device=self.device)

    def _fetch(self, buf: torch.Tensor) -> np.ndarray:
        """The batch's ONE device→host copy of ``buf`` (flat int32), whose
        last word is the search's refused-query count; raises
        ``ValueError`` when that count is not 0, else → the other words."""
        arr = buf.cpu().numpy()
        raise_if_refused(int(arr[-1]), self.K)
        return arr[:-1]

    def _pad_encode(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray, int]:
        nq = len(kmers)
        if nq > self.B:
            raise ValueError(f"batch of {nq} exceeds configured {self.B}")
        # tiered widths: pad to the smallest configured width that fits
        width = self.B
        for w in sorted(self.cfg.small_batch_sizes):
            if nq <= w <= self.B:
                width = w
                break
        self.last_width = width
        # dummies match the longest real query, so a uniform-length batch
        # stays uniform after padding (keeps the k-step tiers usable) and
        # padding never disables the LUT path
        lmax = max((len(k) for k in kmers), default=self.K)
        padded = list(kmers) + ["A" * lmax] * (width - nq)
        codes, lengths = encode_query_batch(padded, self.K)
        # uniform-length batches slice to exactly L columns: the k-step
        # paths require every column to be a real character
        if nq and int(lengths.min()) == lmax and lmax < self.K:
            codes = np.ascontiguousarray(codes[:, self.K - lmax:])
        return codes, lengths, nq

    def _routes(self, codes, lengths, nq: int) -> tuple[bool, bool]:
        """(use_lut, use_pair) for a padded batch.  The k-step path needs a
        uniform batch spanning every column (guaranteed by _pad_encode's
        slicing for uniform lengths); its results are bit-identical to the
        1-step path."""
        use_lut = bool(
            self.lut is not None and int(lengths[:nq].min()) >= self.lut_p
        ) if nq else False
        use_pair = bool(
            self.has_pair and nq and int(lengths.min()) == codes.shape[1]
        )
        return use_lut, use_pair

    def _to_device(self, codes, lengths):
        """Host batch → device tensors.  On the card the copy is staged in
        pinned memory and does not wait for the card, so batches queue."""
        out = []
        for a in (codes, lengths):
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out.append(t)
        return tuple(out)

    def _pieces(self, codes_t, lengths_t, use_lut, use_pair, with_hits, bad):
        """Query-step pieces on the device: search interval, exact (or
        capped) histogram, and — when the endpoint needs them — resolved
        hits with their sample ids, -1 on lanes that hold no hit."""
        idx = self.index
        l, u = self._search(codes_t, lengths_t, use_lut, use_pair, bad)
        rid = off = smp = valid = None
        if with_hits:
            rid, off, smp, valid = resolve_hits(
                idx, l, u, self.H, row_budget=self.row_budget
            )
        if self.cfg.exact_attribution and self._ns == 1:
            # single-sample index: the exact per-sample histogram IS the
            # count — no interval sweep needed
            hist = (u - l)[:, None].to(torch.int32)
            complete = torch.ones(l.shape[0], dtype=torch.bool, device=l.device)
        elif self.cfg.exact_attribution:
            # the sweep window auto-sizes to 8 rows per query; the sweep
            # needs no host sync (K7 reads min(total, cap) on the card)
            W = codes_t.shape[0]
            hist, complete = exact_sample_histogram(
                idx, l, u,
                window=self.cfg.sweep_window or min(W * self.H, 8 * W),
                max_rows=self.cfg.max_sweep_rows,
            )
        else:
            if not with_hits:
                # hist-only serving without exact attribution still
                # resolves under the hit cap for the histogram
                rid2, _, valid = resolve_intervals(
                    idx, l, u, self.H, row_budget=self.row_budget
                )
            else:
                rid2 = rid
            hist = sample_histogram(idx, rid2, valid)
            # complete only when every interval row was actually resolved:
            # count fits the hit cap AND no lane was dropped by the budget
            resolved = valid.sum(dim=1)
            complete = ((u - l) <= self.H) & (resolved == (u - l))
        return l, u, hist, complete, rid, off, smp

    def _full(self, codes_t, lengths_t, use_lut, use_pair, with_hits, bad):
        """Dense per-batch buffer [W, 4+NS(+3H)] of (l, u, count, complete,
        hist, (read_id, offset, sample)) — the form a multi-partition front
        merges on the device; ``with_hits=False`` skips hit resolution and
        its columns."""
        l, u, hist, complete, rid, off, smp = self._pieces(
            codes_t, lengths_t, use_lut, use_pair, with_hits, bad
        )
        cols = [l[:, None], u[:, None], (u - l)[:, None],
                complete[:, None].to(torch.int32), hist.to(torch.int32)]
        if with_hits:
            cols += [rid, off, smp]
        return torch.cat(cols, dim=1)

    def _served(self, codes_t, lengths_t, nq, use_lut, use_pair, with_hits):
        """Sparse-packed serving buffer: one small copy to the host (the
        search's refused-query count at its end), the dense fallbacks
        riding along on the device."""
        bad = self._new_bad()
        l, u, hist, complete, rid, off, smp = self._pieces(
            codes_t, lengths_t, use_lut, use_pair, with_hits, bad
        )
        # hist-tier trunc flag reflects the per-query hit cap ONLY (not
        # resolve_intervals' whole-batch row budget)
        return sparse_pack_device(
            u - l, complete, hist, rid, off, smp, nq,
            self.COMPACT_PER_QUERY, bad, l=l, u=u,
            trunc=None if with_hits else (u - l) > self.H,
        )

    def _counted(self, codes, lengths, nq: int) -> torch.Tensor:
        """The count tier on the device → flat int32 [l(nq), u(nq), bad]:
        the buffer :meth:`_run` copies once."""
        bad = self._new_bad()
        use_lut, use_pair = self._routes(codes, lengths, nq)
        l, u = self._search(*self._to_device(codes, lengths), use_lut,
                            use_pair, bad)
        return torch.cat([l[:nq], u[:nq], bad])

    def _run(self, kmers: list[str]) -> dict[str, np.ndarray]:
        codes, lengths, nq = self._pad_encode(kmers)
        arr = self._fetch(self._counted(codes, lengths, nq))
        l, u = arr[:nq], arr[nq:]
        return dict(l=l, u=u, count=u - l)

    def _dispatch_single(self, codes, lengths, nq: int, mode="count", *,
                         bad):
        """Run the query program on the device; returns the dense buffer
        without transferring it: [W, 3] (l, u, count) for ``"count"``,
        [W, 4+NS] for ``"hist"``, [W, 4+NS+3H] for ``"full"``.  ``bad`` as
        in :meth:`_search`: the caller reads it with the buffer."""
        use_lut, use_pair = self._routes(codes, lengths, nq)
        codes_t, lengths_t = self._to_device(codes, lengths)
        if mode == "count":
            l, u = self._search(codes_t, lengths_t, use_lut, use_pair, bad)
            return torch.stack([l, u, u - l], dim=1)
        return self._full(codes_t, lengths_t, use_lut, use_pair,
                          mode == "full", bad)

    def _unpack_single(
        self, arr: np.ndarray, counts_only: bool = True
    ) -> dict[str, np.ndarray]:
        """Packed [nq, 4+NS+3H] (or [nq, 3]) buffer → the result dict."""
        if counts_only:
            return dict(l=arr[:, 0], u=arr[:, 1], count=arr[:, 2])
        ns, H = self._ns, self.H
        o = 4 + ns
        rid = arr[:, o : o + H]
        return dict(
            l=arr[:, 0],
            u=arr[:, 1],
            count=arr[:, 2],
            hist_complete=arr[:, 3].astype(bool),
            sample_hist=arr[:, 4:o],
            read_id=rid,
            offset=arr[:, o + H : o + 2 * H],
            sample=arr[:, o + 2 * H : o + 3 * H],
            valid=rid >= 0,
        )

    # ------------------------------------------------------------ public

    def warmup(self) -> None:
        """Run every answer tier once at every configured width and every
        warmup length, so a first served request pays no first-use cost
        (the kernel library's build included)."""
        widths = sorted(
            {w for w in self.cfg.small_batch_sizes if w < self.B}
            | {self.B}
        )
        lengths = sorted(
            {int(k) for k in self.cfg.warmup_query_lengths} | {self.K}
        )
        # short query (plain path) at the smallest width; each configured
        # uniform length at every width
        for q in [["A"]] + [
            ["A" * k] * w for w in widths for k in lengths
        ]:
            self.count_batch(q)
            self.query_batch(q)
            self.query_batch(q, include_hits=False)

    def _sample_of(self, rid: int) -> int:
        return int(self.packed.read_to_sample[rid])

    def _expand_rc(self, kmers: list[str]) -> tuple[list[str], dict[int, int]]:
        """→ (kmers + non-palindromic RCs appended, original→rc index map).

        Both-strands batches therefore hold up to 2× the queries; callers
        must stay within ``batch_size`` after expansion.
        """
        rcs = [rc_string(k) for k in kmers]
        exp = list(kmers)
        back: dict[int, int] = {}
        for i, (km, rc) in enumerate(zip(kmers, rcs)):
            if rc != km:
                back[i] = len(exp)
                exp.append(rc)
        return exp, back

    def count_batch(
        self, kmers: list[str], both_strands: bool = False
    ) -> list[QueryResult]:
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.count_batch(exp)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        out = self._run(kmers)
        return [
            QueryResult(
                kmer=km,
                count=int(out["count"][i]),
                interval=(int(out["l"][i]), int(out["u"][i])),
            )
            for i, km in enumerate(kmers)
        ]

    def query_batch(
        self,
        kmers: list[str],
        both_strands: bool = False,
        include_hits: bool = True,
    ) -> list[QueryResult]:
        """Full answers: counts + per-sample attribution, plus hit sets
        unless ``include_hits=False`` (the /samples shape — skipping hit
        resolution also skips shipping the hit tensor)."""
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.query_batch(exp, include_hits=include_hits)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        codes, lengths, nq = self._pad_encode(kmers)
        use_lut, use_pair = self._routes(codes, lengths, nq)
        codes_t, lengths_t = self._to_device(codes, lengths)
        packed_dev, hist_dev, hits_dev = self._served(
            codes_t, lengths_t, nq, use_lut, use_pair, include_hits
        )
        return assemble_sparse(
            kmers, nq, codes.shape[0], self._fetch(packed_dev),
            self._ns, self.H, self.COMPACT_PER_QUERY,
            self.sample_names, has_lu=True, has_hits=include_hits,
            dense_hist_dev=hist_dev, dense_hits_dev=hits_dev,
            stats=self.pack_stats,
        )

    def read_sequence(self, read_id: int) -> str:
        """Read text from the host-side cold store."""
        return alphabet.decode(self.packed.extract_read(read_id))

    def read_name(self, read_id: int) -> str:
        """Stored ingest name (FASTA/FASTQ header); synthesized when the
        artifact was built without names."""
        nm = self.packed.read_name(read_id)
        return nm if nm is not None else f"read_{read_id}"

    def read_meta(self, read_id: int) -> bytes | None:
        """Opaque per-read metadata bytes (None when absent)."""
        return self.packed.read_meta(read_id)
