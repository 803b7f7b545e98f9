"""Multi-process harness: one process a rank, one device a rank.

Each process joins the ``torch.distributed`` group, builds the SAME
deterministic index (the artifact is immutable and replicated, as in the
reference's shard deployment), ingests ITS OWN query stream (per-rank dp
ingest), and the group runs the interval-sharded query program together:
per-step all-reduces over each dp row's ranks, dp across the rows.

    # 2 ranks on the CPU (what tests/test_torch_multihost.py drives):
    for i in 0 1; do
      python -m readserver_tpu_torch.bench.multihost_bench \\
          --coordinator 127.0.0.1:29520 --num-processes 2 --process-id $i \\
          --backend gloo --device cpu --num-shards 2 &
    done; wait

Rank 0 prints one JSON line: global qps, per-rank batch, the all-reduces a
batch, and a parity verdict over EVERY rank's queries (gathered and held
against the oracle).  ``--serve-loop`` instead ticks forever printing
heartbeats (the fault-injection test kills a rank and watches the other
stop).  ``--dump DIR --case SPEC ...`` runs each case once and writes
every rank's answers (and rank 0's gathered ones, with the global batch)
to ``.npz`` files for a parity test.  A case is comma-separated
``key=value``: ``route`` (dsa, lf, slow: the index's tiers kept),
``kstep`` (1 or 3; 1 with mixed query lengths), ``lut`` (the prefix LUT's
order, 0 none), ``budget`` (the row budget, 0 none), ``exact`` (0 or 1).

``--doc-shards S`` runs the document-sharded program instead
(``parallel/doc_sharded.py``): the corpus split into S partitions (the
last takes the remainder, partition s sample s), a run of them on each
rank, and every rank the same whole batch; a case's ``route`` then strips
tiers from the partitions (``DOC_STRIP``: dsa, fused, lf, slow, and
mixed, where one shard lacks dsa).  With ``--index`` a cohort directory
(``build --doc-shards S``) serves as the partitions, and each rank also
times the program's two collectives at the served shapes: the gather of
its hit sets and the all-reduce of its partials (median of 10, host clock,
the device synchronised around each).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

ROUTE_STRIP = {
    "dsa": {},
    "lf": dict(dsa_chunk=None, dsa_bits=0),
    "slow": dict(dsa_chunk=None, dsa_bits=0, lf_chunk=None, mark_table=None,
                 spairs_chunk=None, sstarts=None, slens=None, sample_rate=0),
}
# the doc shards' routes: the PackedIndex fields each partition drops
# (shard index → fields where one shard differs)
_NO_DSA = dict(dsa=None, dsa_bits=0)
DOC_STRIP = {
    "dsa": {},
    "fused": dict(_NO_DSA, lf=None),
    "lf": dict(_NO_DSA, fused_rows=None),
    "slow": dict(_NO_DSA, lf=None, fused_rows=None, mark_rank=None,
                 sample_pairs=None, sample_rate=0),
    "mixed": {1: _NO_DSA},
}
MAX_HITS = 16


def parse_case(spec: str, routes=ROUTE_STRIP) -> dict:
    case = dict(route="dsa", kstep=3, lut=0, budget=0, exact=0)
    for item in filter(None, spec.split(",")):
        k, v = item.split("=")
        if k not in case:
            raise ValueError(f"unknown case key {k!r} in {spec!r}")
        case[k] = v if k == "route" else int(v)
    if case["route"] not in routes:
        raise ValueError(f"unknown route in {spec!r}")
    return case


def strip_route(parts: list, route: str) -> list:
    """The partitions with ``route``'s tiers dropped (``DOC_STRIP``)."""
    strip = DOC_STRIP[route]
    return [dataclasses.replace(
        p, **(strip.get(s, {}) if route == "mixed" else strip))
        for s, p in enumerate(parts)]


def doc_partitions(packed_of, reads, S: int, route: str) -> list:
    """The corpus in S doc partitions built by ``packed_of(reads,
    sample_ids)`` (partition s: sample s; the last takes the remainder),
    with ``route``'s tiers stripped."""
    per = len(reads) // S
    parts = []
    for s in range(S):
        chunk = reads[s * per : (s + 1) * per if s < S - 1 else len(reads)]
        parts.append(packed_of(chunk, np.full(len(chunk), s, dtype=np.int32)))
    return strip_route(parts, route)


def case_name(case: dict) -> str:
    return "_".join(f"{k}{v}" for k, v in case.items())


def rank_queries(corpus, B: int, k: int, rank: int, case: dict):
    """This rank's stream: B k-mers from seed 100 + rank; a 1-step case
    cuts each to a length in [max(lut, 2), k]."""
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.ops import encode_query_batch

    kms = simulate.sample_query_kmers(corpus, B, k, seed=100 + rank,
                                      miss_frac=0.2)
    if case["kstep"] == 1:
        lens = np.random.default_rng(200 + rank).integers(
            max(case["lut"], 2), k + 1, size=B)
        kms = [km[k - int(L):] for km, L in zip(kms, lens)]
    return kms, encode_query_batch(kms, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--index", default="",
                    help="serve this artifact (built from --config's "
                         "corpus) instead of building the index")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=64,
                    help="per-rank query batch size")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--heartbeat-timeout", type=int, default=10)
    ap.add_argument("--num-shards", type=int, default=0,
                    help="the mesh's shards (0: one)")
    ap.add_argument("--doc-shards", type=int, default=0,
                    help="dump the doc-sharded program's cases over this "
                         "many doc shards (with --dump)")
    ap.add_argument("--max-hits", type=int, default=MAX_HITS)
    ap.add_argument("--per-step", action="store_true",
                    help="the cross-rank program even with one rank a row")
    ap.add_argument("--serve-loop", action="store_true",
                    help="tick forever, one heartbeat line per step")
    ap.add_argument("--exact-hist", action="store_true",
                    help="exact per-sample attribution sweep")
    ap.add_argument("--strip-dsa", action="store_true",
                    help="drop the direct-resolve tier (the sampled-LF "
                         "walk's cross-rank collectives)")
    ap.add_argument("--dump", default="",
                    help="write each case's answers here as .npz")
    ap.add_argument("--case", action="append", default=[],
                    help="a case to run and dump (see the module doc)")
    args = ap.parse_args(argv)

    import torch

    from readserver_tpu_torch.parallel import multihost as mh

    device = mh.rank_device(args.device, args.process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mh.init_multihost(args.coordinator, args.num_processes, args.process_id,
                      heartbeat_timeout_s=args.heartbeat_timeout,
                      backend=args.backend)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()

    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.parallel import (
        build_prefix_lut_sharded,
        build_sharded,
        make_sharded_query_fn,
        place_sharded,
    )

    corpus = simulate.simulate_config(args.config, scale=args.scale)
    if args.doc_shards:
        return _dump_doc(args, corpus, device, rank)
    packed = (artifact.load_artifact(args.index, mmap=False) if args.index
              else build_index(corpus.reads, sample_ids=corpus.sample_ids))
    mesh = mh.make_global_mesh(args.num_shards or None, device=device,
                               per_step=args.per_step)
    host = build_sharded(packed, int(mesh.shape["shard"]))
    k = corpus.spec.kmer_len
    B = args.batch

    def run_case(case: dict):
        sidx = place_sharded(
            dataclasses.replace(host, **ROUTE_STRIP[case["route"]]), mesh)
        lut = (build_prefix_lut_sharded(sidx, mesh, case["lut"])
               if case["lut"] else None)
        qfn = make_sharded_query_fn(
            sidx, mesh, max_hits=MAX_HITS, lut_p=case["lut"],
            kstep=case["kstep"], exact_hist=bool(case["exact"]),
            resolve_budget=case["budget"] or None)
        kms, (codes, lengths) = rank_queries(corpus, B, k, rank, case)
        lc, ll = mh.host_local_queries(mesh, codes, lengths)
        return sidx, lut, qfn, kms, lc, ll

    if args.dump:
        for spec in args.case:
            case = parse_case(spec)
            sidx, lut, qfn, _, lc, ll = run_case(case)
            for key in mh.COLLECTIVES:
                mh.COLLECTIVES[key] = 0
            out = qfn(sidx, lut, lc, ll)
            reduces = mh.COLLECTIVES["all_reduce"]
            name = case_name(case)
            local = mh.local_slice(out)
            np.savez(f"{args.dump}/{name}_rank{rank}.npz",
                     all_reduce=reduces, rows=mesh.rows_per_rank,
                     lut=np.zeros(0) if lut is None else lut.cpu().numpy(),
                     **local)
            glob = mh.gather_results(
                {**out, "codes": lc, "lengths": ll}, mesh)
            if rank == 0:
                np.savez(f"{args.dump}/{name}_global.npz", **glob)
        dist.barrier()
        dist.destroy_process_group()
        return 0

    case = parse_case("route=lf" if args.strip_dsa else "")
    case["exact"] = int(args.exact_hist)
    sidx, lut, qfn, kms, lc, ll = run_case(case)
    out = qfn(sidx, lut, lc, ll)
    if args.serve_loop:
        t = 0
        while True:
            qfn(sidx, lut, lc, ll)
            t += 1
            print(f"tick {t} ok proc {rank}", flush=True)
            time.sleep(0.05)

    for key in mh.COLLECTIVES:
        mh.COLLECTIVES[key] = 0
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = qfn(sidx, lut, lc, ll)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    reduces = mh.COLLECTIVES["all_reduce"] / max(args.iters, 1)
    gathered = mh.gather_results({"l": out["l"], "u": out["u"]}, mesh)
    bad = 0
    if rank == 0:
        from readserver_tpu_torch.oracle import OracleFMIndex

        fm = OracleFMIndex(corpus.reads)
        for r in range(world):
            km_r, _ = rank_queries(corpus, B, k, r, case)
            for b, km in enumerate(km_r):
                got = (int(gathered["l"][r * B + b]),
                       int(gathered["u"][r * B + b]))
                bad += got != fm.backward_search(km)
        print(json.dumps({
            "metric": "multihost_sharded_queries_per_s",
            "value": round(B * world * args.iters / dt),
            "processes": world,
            "devices": world,
            "shards": int(mesh.shape["shard"]),
            "shard_ranks": int(mesh.ranks["shard"]),
            "dp": int(mesh.shape["dp"]),
            "per_process_batch": B,
            "all_reduces_per_batch": reduces,
            "parity_bad": bad,
            "parity_queries": B * world,
        }), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if rank == 0 and bad else 0


def _dump_doc(args, corpus, device, rank: int) -> int:
    """Each case of the doc-sharded program once over the group: every
    rank's collective counts (and, from a cohort directory, the
    collectives' times), and rank 0's answers with the batch."""
    import torch
    import torch.distributed as dist

    from readserver_tpu_torch.index import build_index
    from readserver_tpu_torch.index.cohort import load_cohort
    from readserver_tpu_torch.parallel import (
        build_doc_sharded,
        make_doc_query_fn,
        multihost as mh,
        place_doc_sharded,
    )

    S = args.doc_shards
    H = args.max_hits
    mesh = mh.make_global_mesh(S, device=device)
    k = corpus.spec.kmer_len
    for spec in args.case:
        case = parse_case(spec, DOC_STRIP)
        if args.index:
            parts = strip_route(load_cohort(args.index, mmap=False)[0],
                                case["route"])
        else:
            parts = doc_partitions(
                lambda r, ids: build_index(r, sample_ids=ids), corpus.reads,
                S, case["route"])
        didx = place_doc_sharded(
            build_doc_sharded(parts, lut_p=case["lut"]), mesh)
        fn = make_doc_query_fn(
            didx, mesh, max_hits=H, row_budget=case["budget"] or None,
            exact_hist=bool(case["exact"]))
        # the whole batch on every rank: the doc program is replicated
        _, (codes, lengths) = rank_queries(corpus, args.batch, k, 0, case)
        for key in mh.COLLECTIVES:
            mh.COLLECTIVES[key] = 0
        # the k-step search where every shard has the pair table
        kstep = case["kstep"] > 1 and all(p.rank2_blocks is not None
                                          for p in parts)
        out = fn(didx, codes, lengths, kstep=kstep)
        counted = dict(mh.COLLECTIVES)
        timed = {}
        if args.index:
            B, NS = codes.shape[0], didx.num_samples
            lanes = torch.zeros((len(didx.shards), B, 3 * H + 1),
                                dtype=torch.int32, device=device)
            part = torch.zeros(B * (NS + 2), dtype=torch.int64,
                               device=device)
            for what, op, nbytes in (
                    ("gather", lambda: mh.gather_shards(lanes, mesh),
                     lanes.nbytes * mesh.ranks["shard"]),
                    ("allreduce", lambda: mh.all_reduce(part,
                                                        mesh.shard_group),
                     part.nbytes)):
                took = []
                for _ in range(11):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    op()
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    took.append((time.perf_counter() - t0) * 1e3)
                timed[f"{what}_ms"] = float(np.median(took[1:]))
                timed[f"{what}_bytes"] = int(nbytes)
        name = case_name(case)
        np.savez(f"{args.dump}/{name}_rank{rank}.npz",
                 all_reduce=counted["all_reduce"], gather=counted["gather"],
                 shards=len(didx.shards), first=didx.first_shard, **timed)
        if rank == 0:
            np.savez(f"{args.dump}/{name}_global.npz", codes=codes,
                     lengths=lengths,
                     **{key: v.cpu().numpy() for key, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
