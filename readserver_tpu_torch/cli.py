"""CLI of the port: build an artifact, query or serve it on one device.

    python -m readserver_tpu_torch.cli build --config ecoli --out data/idx
    python -m readserver_tpu_torch.cli build --config cohort --doc-shards 4 \\
        --out data/pop
    python -m readserver_tpu_torch.cli query --index data/idx --kmer ACGTT \\
        --both-strands --hits --samples
    python -m readserver_tpu_torch.cli serve --index data/idx --port 8080 \\
        --batch 8192 --warmup-k 31
    python -m readserver_tpu_torch.cli serve --index data/idx --shards 4

Artifacts are the JAX package's on-disk format; either package's CLI can
build one and query the other's.  A cohort directory (``--doc-shards N``)
is served by ``MultiEngine``, every shard on the one device.  ``--shards
S`` serves one artifact in S BWT-interval shards, all resident on the one
device.  File ingest, document sharding across devices and multi-host
serving are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_build(args) -> int:
    import numpy as np

    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index

    t0 = time.time()
    corpus = simulate.simulate_config(args.config, scale=args.scale)
    sample_ids = corpus.sample_ids
    sample_names = [
        f"sample_{i:03d}" for i in range(int(np.max(sample_ids)) + 1)
    ]
    print(f"# {len(corpus.reads)} reads", file=sys.stderr)
    if args.doc_shards > 1:
        from readserver_tpu_torch.index.cohort import build_cohort

        build_cohort(
            corpus.reads, sample_ids, args.doc_shards, args.out,
            sample_names=sample_names,
        )
        print(
            f"# built cohort of {args.doc_shards} shards, {len(corpus.reads)}"
            f" reads in {time.time()-t0:.1f}s → {args.out}",
            file=sys.stderr,
        )
        return 0
    packed = build_index(
        corpus.reads, sample_ids=sample_ids, sample_names=sample_names
    )
    artifact.save_artifact(packed, args.out)
    print(
        f"# built n={packed.n} reads={packed.num_reads} "
        f"in {time.time()-t0:.1f}s → {args.out}",
        file=sys.stderr,
    )
    return 0


def _load_engine(index_path: str, batch_size: int, device: str,
                 warmup_k: tuple = (), num_shards: int = 1):
    """One artifact → a ``QueryEngine``, in ``num_shards`` BWT-interval
    shards when above 1; a cohort directory → a ``MultiEngine`` over its
    shards (``num_shards`` unused, as in the JAX package's CLI); all on
    ``device`` (there is no document sharding across devices yet; its
    answers are the same)."""
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.cohort import is_cohort, load_cohort
    from readserver_tpu_torch.serve import MultiEngine, QueryEngine

    if is_cohort(index_path):
        cfg = ServeConfig(batch_size=batch_size,
                          warmup_query_lengths=warmup_k)
        parts, _ = load_cohort(index_path, mmap=False)
        return MultiEngine(parts, cfg, device=device)
    packed = artifact.load_artifact(index_path, mmap=False)
    cfg = ServeConfig(batch_size=batch_size, num_shards=num_shards,
                      warmup_query_lengths=warmup_k)
    mesh = None
    if num_shards > 1:
        from readserver_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data_parallel=1, num_shards=num_shards,
                         device=device)
    return QueryEngine(packed, cfg, mesh, device=device)


def cmd_query(args) -> int:
    # sized to both strands: the reverse complements join the same batch
    width = max(len(args.kmer) * (2 if args.both_strands else 1), 16)
    engine = _load_engine(args.index, width, args.device,
                          num_shards=args.shards)
    if args.hits or args.samples:
        results = engine.query_batch(args.kmer, both_strands=args.both_strands)
    else:
        results = engine.count_batch(args.kmer, both_strands=args.both_strands)
    for r in results:
        out = {"kmer": r.kmer, "count": r.count}
        if args.hits:
            out["hits"] = r.hits
            out["hits_truncated"] = r.hits_truncated
        if args.samples:
            out["samples"] = r.sample_hist
        print(json.dumps(out))
    return 0


def _warmup_k(args) -> tuple:
    """--warmup-k "31,21" → uniform query lengths run at startup."""
    return tuple(int(x) for x in args.warmup_k.split(",") if x.strip())


def cmd_serve(args) -> int:
    import asyncio

    from readserver_tpu_torch.serve.http import serve_forever

    engine = _load_engine(args.index, args.batch, args.device,
                          warmup_k=_warmup_k(args), num_shards=args.shards)
    engine.warmup()
    try:
        asyncio.run(serve_forever(engine, args.host, args.port))
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="readserver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index artifact")
    b.add_argument("--config", default="tiny", help="simulated config name")
    b.add_argument("--scale", type=float, default=1.0)
    b.add_argument("--doc-shards", type=int, default=1,
                   help="build a document-sharded cohort artifact of N "
                        "independent sub-indexes (out-of-core path)")
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build)

    q = sub.add_parser("query", help="query an index artifact")
    q.add_argument("--index", required=True,
                   help="an artifact or a cohort directory")
    q.add_argument("--kmer", nargs="+", required=True)
    q.add_argument("--hits", action="store_true")
    q.add_argument("--samples", action="store_true")
    q.add_argument("--both-strands", action="store_true",
                   help="also search the reverse complement")
    q.add_argument("--shards", type=int, default=1,
                   help="BWT-interval shards, all on the one device")
    q.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cuda:1, cpu)")
    q.set_defaults(fn=cmd_query)

    s = sub.add_parser("serve", help="REST server over an index artifact")
    s.add_argument("--index", required=True,
                   help="an artifact or a cohort directory")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--batch", type=int, default=256)
    s.add_argument("--warmup-k", default="",
                   help="comma-separated uniform query lengths to run at "
                        "startup (e.g. 31)")
    s.add_argument("--shards", type=int, default=1,
                   help="BWT-interval shards, all on the one device")
    s.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cuda:1, cpu)")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
