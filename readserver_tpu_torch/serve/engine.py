"""QueryEngine: artifact → device tensors → batched count queries.

The single-device count slice of the JAX package's ``serve/engine.py``:
plan tiers for the device's memory, ship the ``DeviceIndex``, build the
prefix LUT, then per batch pad and encode on the host, search on the device
(k-step for uniform batches, masked 1-step otherwise) and bring back one
[nq, 3] buffer of (l, u, count).
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
    backward_search,
    backward_search_lut,
    backward_search_pair,
    build_prefix_lut,
    default_lut_order,
    encode_query_batch,
)

_NOT_PORTED = "not ported yet; see ROADMAP.md, modules still to port"


@dataclass
class QueryResult:
    kmer: str
    count: int
    interval: tuple[int, int] | None = None
    hits: list[dict] = field(default_factory=list)      # read_id/sample_id/offset
    sample_hist: dict[str, int] | None = None
    hits_truncated: bool = False
    sample_hist_complete: bool = True


def rc_string(kmer: str) -> str:
    """Reverse complement of an ACGT query string."""
    return alphabet.decode(alphabet.revcomp(alphabet.encode(kmer)))


def fold_strand_results(
    kmer: str, fwd: QueryResult, rev: QueryResult | None
) -> QueryResult:
    """Combine forward + reverse-complement answers into one both-strands
    result (``rev is None`` for palindromic queries — one strand is the
    other, so folding twice would double count)."""
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


class QueryEngine:
    """Batched count queries over a built index on one device.

    ``QueryEngine(packed, device="cuda")``.  A list of partitions (document
    sharding) and a mesh (interval sharding) are not ported yet.
    """

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
        self.device = torch.device(device)
        self.packed = packed
        self.K = packed.config.max_query_len
        self.B = self.cfg.batch_size
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

    def _search(self, codes, lengths, use_lut: bool, use_pair: bool):
        idx = self.index
        if use_pair:
            # uniform full-length batch: the k-step path
            return backward_search_pair(
                idx, codes, self.lut if use_lut else None,
                self.lut_p if use_lut else 0,
            )
        if use_lut:
            return backward_search_lut(idx, self.lut, self.lut_p, codes, lengths)
        return backward_search(idx, codes, lengths)

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

    def _run(self, kmers: list[str]) -> dict[str, np.ndarray]:
        codes, lengths, nq = self._pad_encode(kmers)
        out = self._dispatch_single(codes, lengths, nq)
        arr = out[:nq].cpu().numpy()  # the ONE device->host transfer
        return self._unpack_single(arr)

    def _dispatch_single(self, codes, lengths, nq: int):
        """Run the count program on the device; returns the [W, 3] int32
        (l, u, count) tensor without transferring it."""
        use_lut = bool(
            self.lut is not None and int(lengths[:nq].min()) >= self.lut_p
        ) if nq else False
        # k-step path requires a uniform batch spanning every column
        # (guaranteed by _pad_encode's slicing for uniform lengths);
        # results are bit-identical to the 1-step path
        use_pair = bool(
            self.has_pair and nq and int(lengths.min()) == codes.shape[1]
        )
        codes_t = torch.from_numpy(codes).to(self.device)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        l, u = self._search(codes_t, lengths_t, use_lut, use_pair)
        return torch.stack([l, u, u - l], dim=1)

    @staticmethod
    def _unpack_single(arr: np.ndarray) -> dict[str, np.ndarray]:
        """Packed [nq, 3] (l, u, count) buffer → the result dict."""
        return dict(l=arr[:, 0], u=arr[:, 1], count=arr[:, 2])

    # ------------------------------------------------------------ public

    def warmup(self) -> None:
        """Run the count path once at every configured width and every
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

    def query_batch(self, kmers, both_strands=False, include_hits=True):
        raise NotImplementedError(f"query_batch: {_NOT_PORTED}")
