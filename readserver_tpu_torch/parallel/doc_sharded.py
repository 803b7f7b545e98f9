"""Document sharding: per-read-subset sub-indexes, merged at the end of the
query (the JAX package's ``parallel/doc_sharded.py``).

Each doc shard is a complete FM-index over its own reads (a cohort's
partition, the reference's split-by-sample deployment).  The query program
is embarrassingly parallel: every shard runs the whole search and resolve
on the batch, with no per-step collectives; the counts and histograms sum
once at the end, the hit sets concatenate shard by shard, and read ids map
to the global space by per-shard offsets (the merged-index order of
``index/merge.py``, so the answers are a monolithic build's).

The JAX package stacks the shards into zero-padded arrays that one SPMD
program serves.  Here each shard stays its own :class:`DeviceIndex`, on the
device of the rank that holds it: all S on the device of a world of one,
or a contiguous run of S / R on each of R ranks of a ``torch.distributed``
group (``parallel/multihost.make_global_mesh``).  The decisions the JAX
program makes across shards are made the same way: the resolve tiers every
shard ships (dsa only when every shard has it with one ``dsa_bits``, the
fused walk when every shard has its rows and sampled pairs, the lf walk and
its mark table when every shard has ``lf``) and the statics (the most
samples, the longest read, shard 0's sample rate), which fix the walks'
step bounds and the histograms' width.  A rank's shards run one after the
other through the one-device kernels (K2; K5, K6 or the rank walks after
K14's row-budget compaction; K7 or K15), and its partial count, histogram
and completeness go into one int64 buffer that one all-reduce over the
rank's shard group sums (the JAX ``psum``s); the hit sets come back by one
gather over the same ranks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from readserver_tpu_torch.index.builder import PackedIndex
from readserver_tpu_torch.ops.lut import build_prefix_lut
from readserver_tpu_torch.ops.resolve import (
    exact_sample_histogram,
    resolve_intervals,
    sample_histogram,
)
from readserver_tpu_torch.ops.search import search_batch
from readserver_tpu_torch.ops.types import DeviceIndex

# the tiers a doc shard ships besides the ones its resolve takes: the
# k-step search's pair and triple tables
_SEARCH_TIERS = frozenset({"rank2", "rank3"})


@dataclass(frozen=True)
class DocShardedIndex:
    """S doc shards and what they share.

    ``partitions`` are the host indexes, ``tiers`` the optional tiers
    every shard ships, ``read_offsets`` int64 [S] each shard's first
    global read id; the statics are the JAX ``DocShardedIndex``'s.  Built
    by :func:`build_doc_sharded` on the host; :func:`place_doc_sharded`
    fills ``shards`` (this rank's run of shards, from ``first_shard``, as
    :class:`DeviceIndex` on its device) and ``luts`` (their prefix LUTs
    when ``lut_p``)."""

    partitions: tuple
    tiers: frozenset
    read_offsets: np.ndarray
    num_shards: int = 1
    num_samples: int = 1
    max_read_len: int = 256
    sample_rate: int = 0
    lut_p: int = 0
    dsa_bits: int = 0
    shards: tuple = ()
    luts: tuple | None = None
    first_shard: int = 0


def _shipped(p: PackedIndex) -> dict:
    """What ``DeviceIndex.from_packed(p)`` ships with every tier asked."""
    marks = p.mark_rank is not None and p.sample_rate > 0
    fused = p.fused_rows is not None and p.sample_rate > 0
    return dict(
        lf=p.lf is not None and marks,
        fused=fused,
        pairs=(marks or fused) and p.sample_pairs is not None,
        dsa=p.dsa is not None,
        dsa_bits=int(p.dsa_bits) if p.dsa is not None else 0,
        sample_rate=int(p.sample_rate) if (marks or fused) else 0,
    )


def build_doc_sharded(
    partitions: Sequence[PackedIndex], lut_p: int = 0
) -> DocShardedIndex:
    """Independent per-partition indexes → a doc-sharded index.

    Global read ids follow partition order, then within-partition order
    (the index/merge.py ordering).  ``lut_p > 0``: each shard gets its own
    prefix LUT (its p-mer intervals are in its own SA space), built where
    the shard is placed."""
    if not partitions:
        raise ValueError("no partitions")
    ship = [_shipped(p) for p in partitions]
    has_fr = all(s["lf"] for s in ship)
    # dsa packs (read_id << bits): the shards must agree on the bits
    bits = {s["dsa_bits"] for s in ship}
    has_dsa = all(s["dsa"] for s in ship) and len(bits) == 1
    has_fused = all(s["fused"] and s["pairs"] for s in ship)
    tiers = set(_SEARCH_TIERS)
    if has_fr:
        tiers |= {"marks", "lf"}
    if has_fused:
        tiers.add("fused")
    if has_dsa:
        tiers.add("dsa")
    read_offsets = np.zeros(len(partitions), dtype=np.int64)
    np.cumsum([p.num_reads for p in partitions[:-1]], out=read_offsets[1:])
    return DocShardedIndex(
        partitions=tuple(partitions),
        tiers=frozenset(tiers),
        read_offsets=read_offsets,
        num_shards=len(partitions),
        num_samples=max(max(p.num_samples for p in partitions), 1),
        max_read_len=max(
            int(p.read_lengths.max()) if p.num_reads else 1
            for p in partitions
        ),
        sample_rate=ship[0]["sample_rate"] if (has_fr or has_fused) else 0,
        lut_p=lut_p,
        dsa_bits=ship[0]["dsa_bits"] if has_dsa else 0,
    )


def place_doc_sharded(didx: DocShardedIndex, mesh) -> DocShardedIndex:
    """Ship this rank's run of shards (the mesh's ``first_shard`` and
    ``shards_per_rank``; all of them on a mesh of one rank) to the mesh's
    device, each with the shared tiers and statics, and build their prefix
    LUTs there (K1's level entry on the card)."""
    if int(mesh.shape["shard"]) != didx.num_shards:
        raise ValueError(
            f"mesh has {mesh.shape['shard']} shards, the index "
            f"{didx.num_shards}"
        )
    first, k = mesh.first_shard, mesh.shards_per_rank
    shards = []
    for p in didx.partitions[first : first + k]:
        d = DeviceIndex.from_packed(p, mesh.device, tiers=didx.tiers)
        shards.append(dataclasses.replace(
            d, num_samples=didx.num_samples, max_read_len=didx.max_read_len,
            sample_rate=didx.sample_rate, dsa_bits=didx.dsa_bits))
    luts = (tuple(build_prefix_lut(d, didx.lut_p) for d in shards)
            if didx.lut_p else None)
    return dataclasses.replace(didx, shards=tuple(shards), luts=luts,
                               first_shard=first)


def _doc_query_body(
    didx: DocShardedIndex, kmers, lengths, *, mesh, max_hits: int,
    row_budget, exact_hist: bool = False, exact_max_rows: int | None = None,
    kstep: bool = False, bad=None,
):
    """Each shard of this rank's run complete, then the one all-reduce and
    the one gather (see :func:`make_doc_query_fn`)."""
    from readserver_tpu_torch.parallel.multihost import all_reduce, gather_shards

    B = kmers.shape[0]
    H = max_hits
    NS = didx.num_samples
    dev = kmers.device
    # this rank's partials: count [B] | histogram [B, NS] | complete [B]
    part = torch.zeros(B * (NS + 2), dtype=torch.int64, device=dev)
    count, hist = part[:B], part[B : B * (NS + 1)].view(B, NS)
    complete = part[B * (NS + 1) :]
    lanes = []
    for j, local in enumerate(didx.shards):
        lut = didx.luts[j] if didx.lut_p else None
        l, u = search_batch(local, kmers, lengths, lut, didx.lut_p, kstep,
                            bad)
        rid, off, valid = resolve_intervals(local, l, u, H,
                                            row_budget=row_budget)
        # local → global read ids
        base = int(didx.read_offsets[didx.first_shard + j])
        rid_g = torch.where(valid, rid + base, torch.full_like(rid, -1))
        c = u - l
        count += c
        if exact_hist:
            # exact attribution (no hit cap): each shard sweeps its own
            # full intervals
            h, done = exact_sample_histogram(
                local, l, u, window=B * H, max_rows=exact_max_rows)
            complete += done.to(torch.int64)
        else:
            h = sample_histogram(local, rid, valid)
        hist += h
        lanes.append(torch.cat(
            [rid_g, off, valid.to(torch.int32), c[:, None]], dim=1))
    # the front-end merge, once: the JAX psums over 'shard'
    all_reduce(part, mesh.shard_group)
    # the hit sets, shard-major: [S, B, 3H + 1] int32
    hits = gather_shards(torch.stack(lanes), mesh)
    if exact_hist:
        hist_complete = complete == didx.num_shards
    else:
        # capped: only exact when every row fit the hit cap
        hist_complete = count <= H
    return dict(
        count=count,
        shard_count=hits[:, :, 3 * H].to(torch.int64),
        read_id=hits[:, :, :H],
        offset=hits[:, :, H : 2 * H],
        valid=hits[:, :, 2 * H : 3 * H].bool(),
        sample_hist=hist.to(torch.int32),
        hist_complete=hist_complete,
    )


def make_doc_query_fn(
    didx: DocShardedIndex, mesh, max_hits: int = 64, row_budget=None,
    exact_hist: bool = False, exact_max_rows: int | None = None,
):
    """The doc-sharded query function: ``fn(didx, kmers, lengths, *,
    kstep=False, bad=None)`` → the JAX program's outputs as tensors on the
    mesh's device: ``count`` int64 [B] (summed over every shard),
    ``shard_count`` int64 [S, B], ``read_id``, ``offset`` int32 and
    ``valid`` bool [S, B, max_hits] (global read ids, -1 off the valid
    lanes), ``sample_hist`` int32 [B, num_samples] and ``hist_complete``
    bool [B].

    Every rank passes the whole batch (``kmers`` int32 [B, K], ``lengths``
    [B], NumPy or tensors); each answers for its own shards, and one
    all-reduce and one gather over the mesh's shard group merge them (on
    a mesh of one rank, neither moves a byte).  ``kstep``: the k-step
    search for a uniform full-width batch (K2's, the same intervals as the
    JAX program's 1-step search); ``bad`` as in ``ops/search.search_batch``.
    """

    def fn(didx, kmers, lengths, *, kstep: bool = False, bad=None):
        kmers = torch.as_tensor(np.ascontiguousarray(kmers, dtype=np.int32)
                                if isinstance(kmers, np.ndarray) else kmers)
        lengths = torch.as_tensor(
            np.ascontiguousarray(lengths, dtype=np.int32)
            if isinstance(lengths, np.ndarray) else lengths)
        return _doc_query_body(
            didx, kmers.to(mesh.device), lengths.to(mesh.device), mesh=mesh,
            max_hits=max_hits, row_budget=row_budget, exact_hist=exact_hist,
            exact_max_rows=exact_max_rows, kstep=kstep, bad=bad)

    return fn
