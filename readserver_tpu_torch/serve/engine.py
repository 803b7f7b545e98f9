"""QueryEngine: artifact → device tensors → batched queries on one device.

The single-device engine of the JAX package's ``serve/engine.py``: plan
tiers for the device's memory, ship the ``DeviceIndex``, build the prefix
LUT, then per batch pad and encode on the host, search on the device (k-step
for uniform batches, masked 1-step otherwise) and bring back one buffer: (l,
u, count) for counts, or the sparse pack of counts, exact per-sample
histograms and resolved hits for full answers.

``MultiEngine`` serves a cohort's partitions time-multiplexed on that one
device: each partition's engine answers the whole batch, one merge on the
device sums counts, unions hit sets and adds histograms, and one small
buffer comes back to the host.
"""

from __future__ import annotations

import bisect
import dataclasses
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
from readserver_tpu_torch.ops.pack import dense, merge_pack, pack_answer
from readserver_tpu_torch.ops.resolve import resolve_hits
from readserver_tpu_torch.ops.search import raise_if_refused, search_batch

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


def _require_global_sample_space(partitions, names) -> None:
    """Partition merges (device-side column sums) are by sample ID, so every
    partition's sample names must be a prefix of the global name table.
    Independently-built artifacts that each call their local sample 0
    something different would otherwise have their counts silently added
    together under one label — refuse instead (build through the cohort
    API, which keeps the space global)."""
    for s, p in enumerate(partitions):
        for i, nm in enumerate(p.sample_names):
            if i < len(names) and nm != names[i]:
                raise ValueError(
                    f"partition {s} calls sample id {i} {nm!r} but the "
                    f"cohort calls it {names[i]!r}: partitions must share "
                    "the GLOBAL sample-id space (merges are by id) — "
                    "rebuild or append via the cohort API"
                )


def _global_sample_names(partitions) -> list[str]:
    """A cohort's sample names, as both JAX fronts take them: ``sample_i``
    for every id below the partitions' most samples, each named by the
    last partition that names it; the partitions must share that space
    (:func:`_require_global_sample_space`)."""
    ns = max(p.num_samples for p in partitions)
    names = [f"sample_{i}" for i in range(ns)]
    for p in partitions:
        for i, nm in enumerate(p.sample_names):
            if i < ns:
                names[i] = nm
    _require_global_sample_space(partitions, names)
    return names


def expand_rc(kmers: list[str]) -> tuple[list[str], dict[int, int]]:
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


def both_strands_batch(answer, kmers: list[str], **kw) -> list[QueryResult]:
    """``answer`` (an engine's one-strand ``count_batch`` or
    ``query_batch``) over ``kmers`` and their reverse complements in one
    batch, folded back to one both-strands result per query."""
    exp, back = expand_rc(kmers)
    res = answer(exp, **kw)
    return [
        fold_strand_results(km, res[i], res[back[i]] if i in back else None)
        for i, km in enumerate(kmers)
    ]


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
    has_count_hi=False,
    stats=None,
) -> list[QueryResult]:
    """Host-side assembly of the sparse packed buffer → QueryResults (NumPy;
    the JAX package's ``assemble_sparse``, with the dense fallbacks copied
    off the device by ``.cpu().numpy()``; a fallback may be a callable that
    assembles it, called only when the section overflowed).

    ``stats`` (optional dict) accumulates transfer accounting: batches,
    sparse-path bytes, and dense-fallback events/bytes."""
    R = cpq * W
    if stats is not None:
        stats["batches"] += 1
        stats["sparse_bytes"] += int(arr.nbytes)
    p = W
    count_m = arr[:W].astype(np.int64)
    if has_count_hi:  # recombine the int64 cross-partition count sum
        count_m = count_m + (arr[p : p + W].astype(np.int64) << 31)
        p += W
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
        hist_m = dense(dense_hist_dev).cpu().numpy()[:nq]
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
            dh = dense(dense_hits_dev).cpu().numpy()[:nq]
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


def _copy_out(buf: torch.Tensor):
    """Start the device→host copy of ``buf`` without waiting → ``(host
    tensor, event)``.  On the card the copy goes into pinned host memory,
    queued on the stream behind the work that made ``buf``, and the event
    is recorded right after it: waiting on the event waits for this copy
    only, not for the batches queued after it.  A CPU tensor needs no copy
    (event None)."""
    if buf.device.type != "cuda":
        return buf, None
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(buf.device))
    return host, done


class QueryEngine:
    """Batched queries over a built index on one device: counts, hit sets
    and exact per-sample histograms.

    Three deployment shapes, the JAX package's:

    * single device: ``QueryEngine(packed, device="cuda")``;
    * interval-sharded: ``QueryEngine(packed, ServeConfig(num_shards=S),
      make_mesh(num_shards=S, device="cuda"), device="cuda")``, with all S
      BWT-range shards resident on the one device (``parallel/sharded.py``;
      ``_sharded`` True, the index in ``sidx``);
    * document-sharded: ``QueryEngine([packed_1, ..., packed_S], cfg,
      make_mesh(num_shards=S, device="cuda"), device="cuda")``, a list of
      per-partition indexes (the reference's split-by-sample deployment:
      counts sum, hit sets union, read ids map by offsets;
      ``parallel/doc_sharded.py``; ``_doc`` True, the shards in ``didx``),
      all S on the one device.

    The sharded shapes also run over the ranks of a process group, with a
    mesh from ``parallel.multihost.make_global_mesh``: every rank builds
    the engine, rank 0 answers and broadcasts each batch tick, the others
    run :meth:`follow` (``_mh`` True).  :class:`MultiEngine` serves
    partitions time-multiplexed on one device instead.  The dispatcher and
    REST front read ``B``, ``H``, ``K``, ``cfg``, ``sample_names``,
    ``pack_stats``, ``tier_plan``, ``packed``, ``_ns``, ``_doc``,
    ``partitions`` (doc) and ``_sharded``.
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
        self.cfg = serve_config or ServeConfig()
        # sparse-pack transfer accounting (see assemble_sparse)
        self.pack_stats = {
            "batches": 0, "sparse_bytes": 0, "dense_bytes": 0,
            "hist_dense_fallbacks": 0, "hits_dense_fallbacks": 0,
        }
        self.device = torch.device(device)
        # wall seconds of each start-up stage, each ended by a device sync
        self.startup_seconds: dict[str, float] = {}
        if isinstance(packed, (list, tuple)):
            self._init_doc(list(packed), mesh)
            return
        self.packed = packed
        self.K = packed.config.max_query_len
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        self.sample_names = packed.sample_names or ["sample_0"]
        self._ns = max(packed.num_samples, 1)
        # a mesh with one shard and dp 1 serves the single-device path, as
        # in the JAX package
        self._sharded = mesh is not None and (
            self.cfg.num_shards > 1 or self.cfg.data_parallel > 1
        )
        if self._sharded:
            self._init_sharded(packed, mesh)
            return
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

    def _init_doc(self, partitions: list, mesh) -> None:
        """The document-sharded start-up (the JAX engine's): the read bases
        and the global sample names, the shards of this rank placed on its
        device with their prefix LUTs (the order from the largest shard's
        n), and the query function twice, with the LUTs and without (for
        queries shorter than the order)."""
        from readserver_tpu_torch.parallel import (
            build_doc_sharded,
            make_doc_query_fn,
            place_doc_sharded,
        )

        if not partitions:
            raise ValueError("no partitions")
        if mesh is None:
            raise ValueError("document sharding requires a mesh")
        if torch.device(mesh.device).type != self.device.type:
            raise ValueError(
                f"mesh is on {mesh.device}, the engine on {self.device}"
            )
        self._doc = True
        self.partitions = partitions
        self.packed = partitions[0]
        self._read_base = []
        base = 0
        for p in partitions:
            self._read_base.append(base)
            base += p.num_reads
        self.K = self.packed.config.max_query_len
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        self.sample_names = _global_sample_names(partitions)
        self._ns = max(len(self.sample_names), 1)
        self.mesh = dataclasses.replace(mesh, device=self.device)
        self._mh = int(mesh.ranks["dp"]) * int(mesh.ranks["shard"]) > 1
        self.tier_plan = None  # every shard ships the tiers all shards have
        self.lut_p = (
            self.cfg.prefix_lut_order
            if self.cfg.prefix_lut_order is not None
            else default_lut_order(max(p.n for p in partitions))
        )
        self.lut = None  # each shard's LUT is in didx
        t0 = time.perf_counter()
        self.didx = place_doc_sharded(
            build_doc_sharded(partitions, lut_p=self.lut_p), self.mesh
        )
        self._mark("ship", t0)
        # the k-step search where every shard has the pair table
        self.has_pair = all(p.rank2_blocks is not None for p in partitions)
        frac = self.cfg.resolve_budget_frac
        budget = int(frac * self.B * self.H) if frac else None
        ex = dict(
            max_hits=self.H,
            row_budget=budget,
            exact_hist=self.cfg.exact_attribution,
            exact_max_rows=self.cfg.max_sweep_rows,
        )
        self._doc_fn = make_doc_query_fn(self.didx, self.mesh, **ex)
        # the same shards with the LUTs off, for short queries
        self.didx_plain = dataclasses.replace(self.didx, luts=None, lut_p=0)
        self._doc_fn_plain = make_doc_query_fn(self.didx_plain, self.mesh,
                                               **ex)

    def _run_doc(self, kmers: list[str]) -> dict[str, np.ndarray]:
        """One batch through the doc-sharded program → the JAX engine's
        merged answers on the host: ``count`` int64, ``sample_hist``,
        ``hist_complete`` and [B, S·H] ``read_id``, ``offset``, ``valid``
        (shard-major), the first ``len(kmers)`` rows.  In a process group,
        a tick as in :meth:`_run_sharded`."""
        codes, lengths, nq = self._pad_encode(kmers)
        if self._mh:
            codes, lengths = self._send_tick(codes, lengths, nq)
        return self._doc_execute(codes, lengths, nq)

    def _doc_program(self, codes: np.ndarray, lengths: np.ndarray, nq: int,
                     bad) -> dict:
        """The doc program on the (broadcast) batch → its outputs on the
        device: the LUT when every query reaches its order, the k-step
        search for a uniform full-width batch; this rank's shards, one
        all-reduce and one gather.  Every branch derives from the batch,
        so every rank takes the same ones."""
        K = codes.shape[1]
        lmax = int(lengths.max()) if len(lengths) else K
        if int(lengths.min()) == lmax and lmax < K:
            codes = np.ascontiguousarray(codes[:, K - lmax:])
        use_lut = bool(
            self.lut_p and nq and int(lengths[:nq].min()) >= self.lut_p
        )
        kstep = bool(
            self.has_pair and nq and int(lengths.min()) == codes.shape[1]
        )
        fn, didx = ((self._doc_fn, self.didx) if use_lut
                    else (self._doc_fn_plain, self.didx_plain))
        return fn(didx, *self._to_device(codes, lengths), kstep=kstep,
                  bad=bad)

    def _doc_execute(self, codes: np.ndarray, lengths: np.ndarray,
                     nq: int) -> dict[str, np.ndarray]:
        """:meth:`_doc_program` on every rank, its outputs on the host as
        the JAX engine merges them."""
        bad = (self._new_bad()
               if self.device.type == "cuda" and not self._mh else None)
        out = {k: v.cpu().numpy()
               for k, v in self._doc_program(codes, lengths, nq, bad).items()}
        if bad is not None:
            raise_if_refused(int(bad.item()), self.K)
        # stacked per-shard hit tensors: [S, B, H] → [B, S*H]
        S = self.didx.num_shards
        merged = {k: out[k][:nq]
                  for k in ("count", "sample_hist", "hist_complete")}
        for k in ("read_id", "offset", "valid"):
            merged[k] = out[k].transpose(1, 0, 2).reshape(-1, S * self.H)[:nq]
        return merged

    def _doc_samples(self, rid_m: np.ndarray, val_m: np.ndarray):
        """Each valid hit's sample, found through its partition."""
        rid_safe = np.clip(rid_m, 0, None)
        base = np.asarray(self._read_base, dtype=np.int64)
        part = np.searchsorted(base, rid_safe, side="right") - 1
        sample_m = np.zeros(rid_m.shape, dtype=np.int64)
        for s, p in enumerate(self.partitions):
            msk = val_m & (part == s)
            if msk.any():
                sample_m[msk] = np.asarray(p.read_to_sample)[
                    rid_safe[msk] - base[s]
                ]
        return sample_m

    def _init_sharded(self, packed: PackedIndex, mesh) -> None:
        """The interval-sharded start-up (the JAX engine's): build the S
        shards on the host, place them on the device, build the prefix LUT
        through K11, and make the four query functions (k-step or 1-step,
        LUT or plain), each running the whole program per batch."""
        from readserver_tpu_torch.parallel import (
            build_prefix_lut_sharded,
            build_sharded,
            make_sharded_query_fn,
            place_sharded,
        )

        dp = max(self.cfg.data_parallel, 1)
        if int(mesh.shape["shard"]) != self.cfg.num_shards:
            raise ValueError(
                f"mesh has {mesh.shape['shard']} shards, the config "
                f"{self.cfg.num_shards}"
            )
        if torch.device(mesh.device).type != self.device.type:
            raise ValueError(
                f"mesh is on {mesh.device}, the engine on {self.device}"
            )
        self.mesh = dataclasses.replace(mesh, device=self.device)
        # a process group: rank 0 broadcasts each batch tick and every rank
        # runs the program together (the others in .follow())
        self._mh = int(mesh.ranks["dp"]) * int(mesh.ranks["shard"]) > 1
        # tiered widths must divide into the dp rows
        self._width_quantum = int(mesh.shape["dp"])
        self.tier_plan = None  # every tier the artifact carries ships
        t0 = time.perf_counter()
        host = build_sharded(packed, self.cfg.num_shards)
        self.startup_seconds["build_sharded"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.sidx = place_sharded(host, self.mesh)
        self._mark("ship", t0)
        self.lut_p = (
            self.cfg.prefix_lut_order
            if self.cfg.prefix_lut_order is not None
            else default_lut_order(packed.n)
        )
        t0 = time.perf_counter()
        self.lut = (
            build_prefix_lut_sharded(self.sidx, self.mesh, self.lut_p)
            if self.lut_p
            else None
        )
        self._mark("lut", t0)
        # the resolve budget: hit lanes compacted to frac * B * H before
        # the walk
        frac = self.cfg.resolve_budget_frac
        budget = max(int(frac * (self.B // dp) * self.H), 1) if frac else None
        ex = dict(
            exact_hist=self.cfg.exact_attribution,
            exact_max_rows=self.cfg.max_sweep_rows,
            resolve_budget=budget,
            walk_early_exit=True,
            owner_route=True,
            route_capacity=self.cfg.owner_route_capacity,
        )
        self._query_fn = make_sharded_query_fn(
            self.sidx, self.mesh, max_hits=self.H, lut_p=0, **ex
        )
        self._query_fn_1 = make_sharded_query_fn(
            self.sidx, self.mesh, max_hits=self.H, lut_p=0, kstep=1, **ex
        )
        self._query_fn_lut = self._query_fn_lut_1 = None
        if self.lut is not None:
            self._query_fn_lut = make_sharded_query_fn(
                self.sidx, self.mesh, max_hits=self.H, lut_p=self.lut_p, **ex
            )
            self._query_fn_lut_1 = make_sharded_query_fn(
                self.sidx, self.mesh, max_hits=self.H, lut_p=self.lut_p,
                kstep=1, **ex,
            )

    def _run_sharded(self, kmers: list[str]) -> dict[str, np.ndarray]:
        """One batch through the sharded program → its answers on the host
        (``l, u, count`` int64, ``read_id, offset`` int32, ``valid``,
        ``sample_hist``, ``hist_complete``), the first ``len(kmers)``
        rows, routed as the JAX engine does (:meth:`_sharded_program`).  In
        a process group, a tick: a fixed-shape header (width, nq, stop)
        broadcast from rank 0, then the width-shaped payload, then the
        program on every rank (:meth:`_mh_execute`)."""
        codes, lengths, nq = self._pad_encode(kmers)
        if self._mh:
            codes, lengths = self._send_tick(codes, lengths, nq)
            out = self._mh_execute(codes, lengths, nq)
            return {k: v[:nq] for k, v in out.items()}
        bad = self._new_bad() if self.device.type == "cuda" else None
        out = self._sharded_program(codes, lengths, nq, bad)
        host = {k: v[:nq].cpu().numpy() for k, v in out.items()}
        if bad is not None:
            raise_if_refused(int(bad.item()), self.K)
        return host

    def _send_tick(self, codes: np.ndarray, lengths: np.ndarray, nq: int):
        """Rank 0's half of a tick: the fixed-shape header (width, nq,
        stop), then the width-shaped payload → the broadcast batch."""
        from readserver_tpu_torch.parallel.multihost import broadcast

        broadcast(np.array([codes.shape[0], nq, 0], dtype=np.int64),
                  self.device)
        return (broadcast(codes, self.device),
                broadcast(lengths, self.device))

    def _mh_execute(self, codes: np.ndarray, lengths: np.ndarray,
                    nq: int) -> dict[str, np.ndarray]:
        """One tick on every rank, with the same (broadcast) batch: this
        rank's dp rows (a slice of the batch every rank holds, where the
        JAX engine gathers each host's share), the program, and the
        all-gather of every row's outputs.  Every branch derives from the
        broadcast batch, so every rank takes the same ones."""
        from readserver_tpu_torch.parallel.multihost import gather_results

        K = codes.shape[1]
        lmax = int(lengths.max()) if len(lengths) else K
        if int(lengths.min()) == lmax and lmax < K:
            codes = np.ascontiguousarray(codes[:, K - lmax:])
        B = codes.shape[0]
        rows = int(self.mesh.shape["dp"])
        if B % rows:
            raise ValueError(f"a batch of {B} does not split into {rows} "
                             f"dp rows")
        routes = self._sharded_routes(codes, lengths, nq)
        take = B // int(self.mesh.ranks["dp"])
        a = int(self.mesh.coords["dp"]) * take
        out = self._sharded_program(
            np.ascontiguousarray(codes[a : a + take]),
            np.ascontiguousarray(lengths[a : a + take]), nq, None, routes)
        return gather_results(out, self.mesh)

    def follow(self) -> None:
        """Follower loop for ranks other than 0: run broadcast ticks until
        rank 0 sends the stop flag (a collective that fails, a peer lost,
        raises out of it)."""
        from readserver_tpu_torch.parallel.multihost import broadcast

        while True:
            width, nq, stop = (int(x) for x in broadcast(
                np.zeros(3, dtype=np.int64), self.device))
            if stop:
                return
            codes = broadcast(np.zeros((width, self.K), dtype=np.int32),
                              self.device)
            lengths = broadcast(np.ones(width, dtype=np.int32), self.device)
            (self._doc_execute if self._doc else self._mh_execute)(
                codes, lengths, nq)

    def stop_followers(self) -> None:
        """Release the other ranks' :meth:`follow` loops."""
        if not getattr(self, "_mh", False):
            return
        from readserver_tpu_torch.parallel.multihost import broadcast

        broadcast(np.array([0, 0, 1], dtype=np.int64), self.device)

    def _sharded_routes(self, codes, lengths, nq: int) -> tuple[bool, bool]:
        """(use_lut, uniform) of a padded batch: the LUT when every query
        reaches its order, the k-step functions for a uniform full-width
        batch."""
        use_lut = bool(
            self.lut is not None and nq
            and int(lengths[:nq].min()) >= self.lut_p
        )
        return use_lut, bool(nq and int(lengths.min()) == codes.shape[1])

    def _sharded_program(self, codes, lengths, nq: int, bad, routes=None):
        """The sharded program on one padded batch → its outputs on the
        device, routed by :meth:`_sharded_routes` (``routes``: the whole
        batch's, where ``codes`` are this rank's dp rows of it)."""
        use_lut, uniform = routes or self._sharded_routes(codes, lengths, nq)
        if use_lut:
            fn = self._query_fn_lut if uniform else self._query_fn_lut_1
        else:
            fn = self._query_fn if uniform else self._query_fn_1
        return fn(self.sidx, self.lut if use_lut else None,
                  *self._to_device(codes, lengths), bad=bad)

    def _sharded_results(self, kmers, out) -> list[QueryResult]:
        """The JAX engine's assembly of a sharded batch's full answers:
        each hit's sample from the host's ``read_to_sample`` (a doc
        engine's through the hit's partition), hits truncated when the
        count exceeds the hits returned; ``interval`` None where the
        program has no global (l, u) (doc shards)."""
        rid_m, off_m, val_m = out["read_id"], out["offset"], out["valid"]
        if self._doc:
            sample_m = self._doc_samples(rid_m, val_m)
        else:
            sample_m = np.asarray(self.packed.read_to_sample)[
                np.clip(rid_m, 0, None)
            ]
        hist_m = out["sample_hist"]
        results = []
        for i, km in enumerate(kmers):
            count = int(out["count"][i])
            v = val_m[i]
            hits = [
                dict(read_id=r, sample_id=s, offset=o)
                for r, s, o in zip(
                    rid_m[i][v].tolist(),
                    sample_m[i][v].tolist(),
                    off_m[i][v].tolist(),
                )
            ]
            nz = np.nonzero(hist_m[i])[0]
            results.append(QueryResult(
                kmer=km,
                count=count,
                interval=((int(out["l"][i]), int(out["u"][i]))
                          if "l" in out else None),
                hits=hits,
                sample_hist={
                    self.sample_names[int(s)]: int(hist_m[i][s]) for s in nz
                },
                hits_truncated=count > len(hits),
                sample_hist_complete=bool(out["hist_complete"][i]),
            ))
        return results

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
        return self._collect(_copy_out(buf))

    def _collect(self, pending) -> np.ndarray:
        """Wait for a copy that :func:`_copy_out` started — for its event
        only, so device work queued after it runs on — then check the
        refused-query count as :meth:`_fetch` does."""
        host, done = pending
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        raise_if_refused(int(arr[-1]), self.K)
        return arr[:-1]

    def _pad_encode(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray, int]:
        nq = len(kmers)
        if nq > self.B:
            raise ValueError(f"batch of {nq} exceeds configured {self.B}")
        # tiered widths: pad to the smallest configured width that fits
        # and splits into the dp rows
        width = self.B
        quantum = getattr(self, "_width_quantum", 1)
        for w in sorted(self.cfg.small_batch_sizes):
            if nq <= w <= self.B and w % quantum == 0:
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
        # paths require every column to be a real character (a group's
        # tick broadcasts all K columns; each rank slices after it)
        if (not getattr(self, "_mh", False) and nq
                and int(lengths.min()) == lmax and lmax < self.K):
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
        return pack_answer(l, u, complete, hist, rid, off, smp, nq,
                           self.COMPACT_PER_QUERY, bad, self.H)

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
            self.count_batch(q)  # a doc engine's runs its whole program
            if self._sharded:
                self._run_sharded(q)
            elif not self._doc:
                self.query_batch(q)
                self.query_batch(q, include_hits=False)

    def _locate(self, rid: int) -> tuple[int, int]:
        """Global read id → (partition, local id) of a doc engine."""
        s = bisect.bisect_right(self._read_base, rid) - 1
        return s, rid - self._read_base[s]

    def _sample_of(self, rid: int) -> int:
        if self._doc:
            s, local = self._locate(rid)
            return int(self.partitions[s].read_to_sample[local])
        return int(self.packed.read_to_sample[rid])

    _expand_rc = staticmethod(expand_rc)

    def count_batch(
        self, kmers: list[str], both_strands: bool = False
    ) -> list[QueryResult]:
        if both_strands:
            return both_strands_batch(self.count_batch, kmers)
        if self._doc:
            # the whole doc program, as the JAX engine runs it; each shard
            # is its own BWT, so there is no global (l, u)
            out = self._run_doc(kmers)
            return [QueryResult(kmer=km, count=int(out["count"][i]))
                    for i, km in enumerate(kmers)]
        out = self._run_sharded(kmers) if self._sharded else self._run(kmers)
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
            return both_strands_batch(self.query_batch, kmers,
                                      include_hits=include_hits)
        if self._doc or self._sharded:
            # the whole sharded program runs for either tier, as in the
            # JAX engine
            run = self._run_doc if self._doc else self._run_sharded
            return self._sharded_results(kmers, run(kmers))
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
        """Read text from the host-side cold store (a doc engine's from
        the read's partition)."""
        if self._doc:
            s, local = self._locate(read_id)
            return alphabet.decode(self.partitions[s].extract_read(local))
        return alphabet.decode(self.packed.extract_read(read_id))

    def read_name(self, read_id: int) -> str:
        """Stored ingest name (FASTA/FASTQ header); synthesized when the
        artifact was built without names."""
        if self._doc:
            s, local = self._locate(read_id)
            nm = self.partitions[s].read_name(local)
        else:
            nm = self.packed.read_name(read_id)
        return nm if nm is not None else f"read_{read_id}"

    def read_meta(self, read_id: int) -> bytes | None:
        """Opaque per-read metadata bytes (None when absent)."""
        if self._doc:
            s, local = self._locate(read_id)
            return self.partitions[s].read_meta(local)
        return self.packed.read_meta(read_id)


class MultiEngine:
    """Time-multiplexed front over per-partition engines on ONE device (a
    cohort artifact's doc shards served where there are fewer devices than
    shards): each partition's :class:`QueryEngine` answers the full batch
    on the same device; counts sum (int64), hit sets union with global
    read-id offsets and histograms add by sample id in one merge on the
    device, then one small copy to the host — the JAX package's
    ``MultiEngine``, answer for answer.

    Duck-types ``QueryEngine`` for the dispatcher and REST front.  As in
    the JAX package it has no ``_sample_of`` (``/read`` answers ``"sample":
    None``), ``packed`` is partition 0 (``/info`` reports its
    ``n_symbols``), and every partition's engine plans its tiers against
    the whole device budget: a caller sharing the card passes
    ``hbm_budget_gb`` divided by the number of partitions.
    """

    # see module-level COMPACT_PER_QUERY; class attribute so tests can pin
    # the budget per engine class
    COMPACT_PER_QUERY = COMPACT_PER_QUERY
    _doc = True

    def __init__(self, partitions, serve_config: ServeConfig | None = None,
                 *, device):
        if not partitions:
            raise ValueError("no partitions")
        self.cfg = serve_config or ServeConfig()
        # sparse-pack transfer accounting (see assemble_sparse)
        self.pack_stats = {
            "batches": 0, "sparse_bytes": 0, "dense_bytes": 0,
            "hist_dense_fallbacks": 0, "hits_dense_fallbacks": 0,
        }
        self.partitions = list(partitions)
        self.packed = self.partitions[0]
        self.device = torch.device(device)
        self.engines = [QueryEngine(p, self.cfg, device=self.device)
                        for p in self.partitions]
        self._read_base = []
        base = 0
        for p in self.partitions:
            self._read_base.append(base)
            base += p.num_reads
        self.K = self.engines[0].K
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        self.sample_names = _global_sample_names(self.partitions)
        self._ns = len(self.sample_names)

    _new_bad = QueryEngine._new_bad
    _fetch = QueryEngine._fetch
    _collect = QueryEngine._collect
    _expand_rc = staticmethod(expand_rc)

    def _pad_encode(self, kmers: list[str]):
        return self.engines[0]._pad_encode(kmers)

    # ------------------------------------------------------- device merges

    def _merge_count(self, outs) -> torch.Tensor:
        """The count tier's sum over the partitions' [W, 3] buffers → int64
        [W]: each partition's count fits int32 (its n < 2^31), the cohort's
        sum need not."""
        return sum(o[:, 2].to(torch.int64) for o in outs)

    def _merge_full(self, outs, nq: int, with_hits: bool, bad):
        """The partitions' dense [W, 4+ns(+3H)] buffers merged and packed
        on the device (:func:`~readserver_tpu_torch.ops.pack.merge_pack`:
        counts add in int64, shipped as two int32 lanes; ``complete`` is
        the product of the partitions' flags; each partition's histogram
        adds into its first ``ns`` columns; read ids shift by the
        partition's first global id and hit lanes concatenate) →
        ``(packed, hist, dense_hits)``, ``bad`` the packed buffer's last
        word."""
        return merge_pack(outs, [e._ns for e in self.engines],
                          self._read_base, self._ns, self.H, nq,
                          self.COMPACT_PER_QUERY, bad, with_hits)

    def _counted(self, codes, lengths, nq: int) -> torch.Tensor:
        """The count tier on the device → flat int32 [count bits 0-30 (nq),
        bits 31+ (nq), bad], ``bad`` the sum of every partition's refused
        queries: the buffer :meth:`_assemble_counts` reads."""
        bad = self._new_bad()
        outs = [e._dispatch_single(codes, lengths, nq, "count", bad=bad)
                for e in self.engines]
        count = self._merge_count(outs)[:nq]
        return torch.cat([(count & 0x7FFFFFFF).to(torch.int32),
                          (count >> 31).to(torch.int32), bad])

    def _served(self, codes, lengths, nq: int, with_hits: bool):
        """Every partition's full (or histogram-only) program, then the
        merge → ``(packed, hist, dense_hits)`` on the device.  The
        histogram-only tier resolves no hits anywhere."""
        bad = self._new_bad()
        mode = "full" if with_hits else "hist"
        outs = [e._dispatch_single(codes, lengths, nq, mode, bad=bad)
                for e in self.engines]
        return self._merge_full(outs, nq, with_hits, bad)

    # --------------------------------------------------- dispatch, assemble
    # A dispatch queues a batch's device work and its copy to the host and
    # returns without waiting; an assembly waits for that copy's event only.
    # So the bulk paths queue batch i+1 before they assemble batch i, and
    # the card runs it while the host builds batch i's results.

    def _dispatch_counts(self, kmers: list[str]):
        codes, lengths, nq = self._pad_encode(kmers)
        return kmers, nq, _copy_out(self._counted(codes, lengths, nq))

    def _assemble_counts(self, kmers, nq, pending) -> list[QueryResult]:
        arr = self._collect(pending)
        counts = arr[:nq].astype(np.int64) + (arr[nq:].astype(np.int64) << 31)
        return [
            QueryResult(kmer=km, count=int(counts[i]))
            for i, km in enumerate(kmers)
        ]

    def _dispatch_merged(self, kmers: list[str], include_hits: bool = True):
        codes, lengths, nq = self._pad_encode(kmers)
        packed_dev, hist_dev, hits_dev = self._served(codes, lengths, nq,
                                                      include_hits)
        return kmers, nq, include_hits, (_copy_out(packed_dev), hist_dev,
                                         hits_dev)

    def _assemble_merged(
        self, kmers, nq, include_hits, merged
    ) -> list[QueryResult]:
        pending, dense_hist_dev, dense_hits_dev = merged
        arr = self._collect(pending)  # the one (small) copy
        NS, SH = self._ns, len(self.engines) * self.H
        cpq = self.COMPACT_PER_QUERY
        if include_hits:  # [count, count_hi, complete] + hist + hits
            W = (len(arr) - 2) // (3 + cpq * 6)
        else:  # [count, count_hi, complete, trunc] + hist sections
            W = (len(arr) - 1) // (4 + cpq * 2)
        return assemble_sparse(
            kmers, nq, W, arr, NS, SH, cpq, self.sample_names,
            has_lu=False, has_hits=include_hits,
            dense_hist_dev=dense_hist_dev, dense_hits_dev=dense_hits_dev,
            has_count_hi=True, stats=self.pack_stats,
        )

    # ------------------------------------------------------------ public

    def warmup(self) -> None:
        """Run the merged paths (count, full, histogram-only) once at every
        configured width and warmup length; the partitions' engines run as
        part of them."""
        widths = sorted(
            {w for w in self.cfg.small_batch_sizes if w < self.B}
            | {self.B}
        )
        lengths = sorted(
            {int(k) for k in self.cfg.warmup_query_lengths} | {self.K}
        )
        for kmers in [["A"]] + [
            ["A" * k] * w for w in widths for k in lengths
        ]:
            self.query_batch(kmers)
            self.query_batch(kmers, include_hits=False)
            self.count_batch(kmers)

    def _locate(self, rid: int) -> tuple[int, int]:
        """Global read id → (partition, local id)."""
        s = bisect.bisect_right(self._read_base, rid) - 1
        return s, rid - self._read_base[s]

    def count_batch(
        self, kmers: list[str], both_strands: bool = False
    ) -> list[QueryResult]:
        """Summed counts across partitions.  ``interval`` is None: each
        partition is its own BWT, so no single global (l, u) exists."""
        if both_strands:
            return both_strands_batch(self.count_batch, kmers)
        return self._assemble_counts(*self._dispatch_counts(kmers))

    def count_batches(
        self, batches: list[list[str]]
    ) -> list[list[QueryResult]]:
        """Bulk count tier, pipelined like :meth:`query_batches`."""
        results: list[list[QueryResult]] = []
        pend = None
        for kmers in batches:
            cur = self._dispatch_counts(kmers)
            if pend is not None:
                results.append(self._assemble_counts(*pend))
            pend = cur
        if pend is not None:
            results.append(self._assemble_counts(*pend))
        return results

    def query_batch(
        self,
        kmers: list[str],
        both_strands: bool = False,
        include_hits: bool = True,
    ) -> list[QueryResult]:
        if both_strands:
            return both_strands_batch(self.query_batch, kmers,
                                      include_hits=include_hits)
        return self._assemble_merged(*self._dispatch_merged(kmers,
                                                            include_hits))

    def query_batches(
        self, batches: list[list[str]], include_hits: bool = True
    ) -> list[list[QueryResult]]:
        """Bulk path: batch i+1's device work is queued before batch i is
        assembled on the host."""
        results: list[list[QueryResult]] = []
        pend = None
        for kmers in batches:
            cur = self._dispatch_merged(kmers, include_hits)
            if pend is not None:
                results.append(self._assemble_merged(*pend))
            pend = cur
        if pend is not None:
            results.append(self._assemble_merged(*pend))
        return results

    def read_sequence(self, read_id: int) -> str:
        """Read text from the partition's host-side cold store."""
        s, local = self._locate(read_id)
        return alphabet.decode(self.partitions[s].extract_read(local))

    def read_name(self, read_id: int) -> str:
        s, local = self._locate(read_id)
        nm = self.partitions[s].read_name(local)
        return nm if nm is not None else f"read_{read_id}"

    def read_meta(self, read_id: int) -> bytes | None:
        s, local = self._locate(read_id)
        return self.partitions[s].read_meta(local)
