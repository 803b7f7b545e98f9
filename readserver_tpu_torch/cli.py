"""CLI of the port: ingest and maintain artifacts on the host, query or
serve them on one device.

    python -m readserver_tpu_torch.cli build --config ecoli --out data/idx
    python -m readserver_tpu_torch.cli build --fastq reads.fq --out data/idx
    python -m readserver_tpu_torch.cli build --fasta reads.fa --doc-shards 4 \\
        --out data/pop
    python -m readserver_tpu_torch.cli append data/pop --fasta more.fa \\
        --sample donor_x
    python -m readserver_tpu_torch.cli compact data/pop --target-shards 2
    python -m readserver_tpu_torch.cli upgrade data/idx --kstep 3
    python -m readserver_tpu_torch.cli merge s1_idx s2_idx --out pop
    python -m readserver_tpu_torch.cli import-bwt --bwt pop.rlebwt --out idx
    python -m readserver_tpu_torch.cli simulate --config lambda --out r.fasta
    python -m readserver_tpu_torch.cli query --index data/idx --kmer ACGTT \\
        --both-strands --hits --samples
    python -m readserver_tpu_torch.cli serve --index data/idx --port 8080 \\
        --batch 8192 --warmup-k 31
    python -m readserver_tpu_torch.cli serve --index data/idx --shards 4
    python -m readserver_tpu_torch.cli query --index data/a,data/b \
        --kmer ACGTT --hits --samples
    python -m readserver_tpu_torch.cli serve --index data/pop \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0

Artifacts are the JAX package's on-disk format: the host commands (build,
append, compact, upgrade, merge, import-bwt, simulate) write the bytes the
JAX package's CLI writes from the same input, and touch no device.
``query`` and ``serve`` run on ``--device``, the card unless asked
otherwise.  A cohort directory (``--doc-shards N``) is served by
``MultiEngine``, every shard on the one device; comma-separated artifacts
(``--index a,b``) by the doc-sharded ``QueryEngine``, every shard on the
one device; ``--shards S`` serves one artifact in S BWT-interval shards,
all resident on the one device.  ``serve --coordinator`` serves over the
ranks of a process group, one device a rank: one artifact in ``--shards``
interval shards, or a cohort directory or ``a,b`` as doc shards, a run of
them on each rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from readserver_tpu_torch import trace


def _ingest_file(args) -> tuple[list, list]:
    """FASTA/FASTQ/BAM ingest (trim → N-split → min-len) → (reads, names)."""
    from readserver_tpu_torch.corpus import io as cio

    reads = []
    read_names = []
    if getattr(args, "bam", None):
        from readserver_tpu_torch.corpus import bam as cbam

        records = (
            (name, seq[: cio.mott_trim_len(quals, args.qual_trim)]
             if (args.qual_trim > 0 and quals is not None) else seq)
            for name, seq, quals in cbam.read_bam(args.bam)
        )
    elif args.fastq:
        records = (
            (name, seq[: cio.mott_trim_len(quals, args.qual_trim)]
             if args.qual_trim > 0 else seq)
            for name, seq, quals in cio.read_fastq_quals(args.fastq)
        )
    else:
        records = cio.read_fasta(args.fasta)
    for name, seq in records:
        segs = cio.normalize_read(seq, min_len=args.min_len)
        for j, s in enumerate(segs):
            reads.append(s)
            # N-split reads keep their ingest name, suffixed per segment
            read_names.append(name if len(segs) == 1 else f"{name}.{j}")
    return reads, read_names


def cmd_build(args) -> int:
    import numpy as np

    from readserver_tpu_torch.index import artifact, build_index

    t0 = time.time()
    sample_ids = None
    sample_names = None
    read_names = None
    if args.fastq or args.fasta or args.bam:
        reads, read_names = _ingest_file(args)
    else:
        from readserver_tpu_torch.corpus import simulate

        corpus = simulate.simulate_config(args.config, scale=args.scale)
        reads = corpus.reads
        sample_ids = corpus.sample_ids
        sample_names = [
            f"sample_{i:03d}" for i in range(int(np.max(sample_ids)) + 1)
        ]
    if args.rlo:
        from readserver_tpu_torch.corpus.io import rlo_order

        order = rlo_order(reads)
        reads = [reads[i] for i in order]
        if sample_ids is not None:
            sample_ids = np.asarray(sample_ids)[order]
        if read_names is not None:
            read_names = [read_names[i] for i in order]
    print(f"# {len(reads)} reads", file=sys.stderr)
    if args.doc_shards > 1:
        from readserver_tpu_torch.index.cohort import build_cohort

        build_cohort(
            reads, sample_ids, args.doc_shards, args.out,
            sample_names=sample_names, read_names=read_names,
        )
        print(
            f"# built cohort of {args.doc_shards} shards, "
            f"{len(reads)} reads in {time.time()-t0:.1f}s → {args.out}",
            file=sys.stderr,
        )
        return 0
    packed = build_index(
        reads, sample_ids=sample_ids, sample_names=sample_names,
        read_names=read_names,
    )
    artifact.save_artifact(packed, args.out)
    print(
        f"# built n={packed.n} reads={packed.num_reads} "
        f"in {time.time()-t0:.1f}s → {args.out}",
        file=sys.stderr,
    )
    return 0


def cmd_append(args) -> int:
    """Streaming ingest: add a read batch to an existing cohort artifact
    as a new doc shard — no rebuild (index/cohort.append_to_cohort)."""
    from readserver_tpu_torch.index.cohort import append_to_cohort, is_cohort

    if not is_cohort(args.cohort):
        print(
            f"error: {args.cohort} is not a cohort artifact; append "
            "requires one (rebuild with `build --doc-shards N`)",
            file=sys.stderr,
        )
        return 2
    t0 = time.time()
    if args.fastq or args.fasta or args.bam:
        reads, read_names = _ingest_file(args)
    else:
        from readserver_tpu_torch.corpus import simulate

        corpus = simulate.simulate_config(args.config, scale=args.scale)
        reads, read_names = corpus.reads, None
    append_to_cohort(
        args.cohort,
        reads,
        sample_names=[args.sample] if args.sample else None,
        read_names=read_names,
    )
    print(
        f"# appended {len(reads)} reads as a new shard in "
        f"{time.time()-t0:.1f}s → {args.cohort}",
        file=sys.stderr,
    )
    return 0


def cmd_upgrade(args) -> int:
    """Synthesize missing tiers into an existing artifact, in place —
    the anti-orphaning path (index/upgrade.py): a tier-set evolution
    costs one LF walk over the stored BWT, never an SA-IS rebuild."""
    from pathlib import Path

    from readserver_tpu_torch.index.cohort import COHORT_MANIFEST, is_cohort
    from readserver_tpu_torch.index.upgrade import upgrade_artifact

    t0 = time.time()
    kstep = args.kstep or None
    rate = args.sample_rate or None
    targets = [Path(args.index)]
    if is_cohort(args.index):
        manifest = json.loads(
            (Path(args.index) / COHORT_MANIFEST).read_text()
        )
        targets = [Path(args.index) / s for s in manifest["shards"]]
    total = []
    for tgt in targets:
        added = upgrade_artifact(tgt, kstep=kstep, sample_rate=rate)
        total += added
        print(
            f"# {tgt}: " + (f"added {', '.join(added)}" if added
                            else "already current"),
            file=sys.stderr,
        )
    print(
        f"# upgrade done ({len(total)} arrays added) in "
        f"{time.time()-t0:.1f}s",
        file=sys.stderr,
    )
    return 0


def cmd_compact(args) -> int:
    """Merge a cohort's doc shards down (interleave merge, read order and
    global sample space preserved) — undoes append fan-out."""
    from pathlib import Path

    from readserver_tpu_torch.index.cohort import (
        COHORT_MANIFEST,
        compact_cohort,
    )

    t0 = time.time()
    compact_cohort(args.cohort, target_shards=args.target_shards)
    manifest = json.loads(
        (Path(args.cohort) / COHORT_MANIFEST).read_text()
    )
    print(
        f"# compacted to {manifest['num_shards']} shards "
        f"({manifest['num_reads']} reads) in {time.time()-t0:.1f}s "
        f"→ {args.cohort}",
        file=sys.stderr,
    )
    return 0


def cmd_import_bwt(args) -> int:
    """Import a bare RLE-BWT file (e.g. built by reference-stack tools)
    into a full artifact; corpus + metadata reconstructed by inversion."""
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.from_bwt import index_from_bwt
    from readserver_tpu_torch.index.rle import read_rle_bwt

    t0 = time.time()
    bwt, num_reads = read_rle_bwt(args.bwt)
    packed = index_from_bwt(bwt)
    if packed.num_reads != num_reads:
        print(
            f"# warning: header said {num_reads} reads, BWT encodes "
            f"{packed.num_reads}",
            file=sys.stderr,
        )
    artifact.save_artifact(packed, args.out)
    print(
        f"# imported n={packed.n} reads={packed.num_reads} "
        f"in {time.time()-t0:.1f}s → {args.out}",
        file=sys.stderr,
    )
    return 0


def cmd_merge(args) -> int:
    """Merge per-sample artifacts into one population artifact
    (the reference's bwt-merge stage)."""
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.merge import (
        merge_indexes,
        merge_indexes_interleave,
    )

    t0 = time.time()
    parts = [artifact.load_artifact(p, mmap=False) for p in args.inputs]
    fn = merge_indexes if args.rebuild else merge_indexes_interleave
    merged = fn(parts)
    artifact.save_artifact(merged, args.out)
    print(
        f"# merged {len(parts)} indexes: n={merged.n} reads={merged.num_reads} "
        f"samples={merged.num_samples} in {time.time()-t0:.1f}s → {args.out}",
        file=sys.stderr,
    )
    return 0


def cmd_simulate(args) -> int:
    from readserver_tpu_torch import alphabet
    from readserver_tpu_torch.corpus import io as cio, simulate

    corpus = simulate.simulate_config(args.config, scale=args.scale)
    cio.write_fasta(
        args.out,
        (
            (f"read_{i}_s{corpus.sample_ids[i]}", alphabet.decode(r))
            for i, r in enumerate(corpus.reads)
        ),
    )
    print(f"# wrote {len(corpus.reads)} reads → {args.out}", file=sys.stderr)
    return 0


def _doc_partitions(index_path: str) -> list | None:
    """The doc shards ``index_path`` names: a cohort directory's, or the
    artifacts of a comma-separated list (the JAX CLI's ``--index a,b``);
    None for one artifact."""
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.cohort import is_cohort, load_cohort

    if is_cohort(index_path):
        return load_cohort(index_path, mmap=False)[0]
    paths = index_path.split(",")
    if len(paths) == 1:
        return None
    return [artifact.load_artifact(p, mmap=False) for p in paths]


def _load_engine(index_path: str, batch_size: int, device: str,
                 warmup_k: tuple = (), num_shards: int = 1):
    """One artifact → a ``QueryEngine``, in ``num_shards`` BWT-interval
    shards when above 1; several comma-separated artifacts → the
    doc-sharded ``QueryEngine``, every shard on ``device`` (a world of
    one); a cohort directory → a ``MultiEngine`` over its shards, as the
    JAX CLI serves a cohort on fewer devices than shards (this rank drives
    one).  ``num_shards`` is unused for doc shards, as in the JAX CLI."""
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.cohort import is_cohort
    from readserver_tpu_torch.parallel import make_mesh
    from readserver_tpu_torch.serve import MultiEngine, QueryEngine

    with trace.stage("setup.load") as st:
        parts = _doc_partitions(index_path)
        packed = (artifact.load_artifact(index_path, mmap=False)
                  if parts is None else None)
        if trace.ON:
            st.set(bytes=sum(f.stat().st_size for p in index_path.split(",")
                             for f in Path(p).rglob("*") if f.is_file()))
    if parts is not None:
        cfg = ServeConfig(batch_size=batch_size,
                          warmup_query_lengths=warmup_k)
        if is_cohort(index_path):
            return MultiEngine(parts, cfg, device=device)
        return QueryEngine(parts, cfg,
                           make_mesh(num_shards=len(parts), device=device),
                           device=device)
    cfg = ServeConfig(batch_size=batch_size, num_shards=num_shards,
                      warmup_query_lengths=warmup_k)
    mesh = None
    if num_shards > 1:
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


def _serve_group(args) -> int:
    """``serve --coordinator``: every rank of the group runs this command
    with its process id; each loads the artifact and builds the engine on
    its device, rank 0 fronts REST and broadcasts each batch tick, the
    others follow until it stops them.  One artifact serves in ``--shards``
    interval shards over the ranks; a cohort directory or a comma-separated
    list of artifacts serves as doc shards, a run of them on each rank."""
    import asyncio

    import torch

    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.parallel.multihost import (
        init_multihost,
        make_global_mesh,
        rank_device,
    )
    from readserver_tpu_torch.serve import QueryEngine
    from readserver_tpu_torch.serve.http import serve_forever

    device = rank_device(args.device, args.process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend=args.backend)
    parts = _doc_partitions(args.index)
    if parts is not None:
        mesh = make_global_mesh(len(parts), device=device)
        cfg = ServeConfig(batch_size=args.batch,
                          warmup_query_lengths=_warmup_k(args))
        engine = QueryEngine(parts, cfg, mesh, device=device)
    else:
        mesh = make_global_mesh(args.shards if args.shards > 1 else None,
                                device=device)
        cfg = ServeConfig(
            batch_size=args.batch,
            num_shards=int(mesh.shape["shard"]),
            data_parallel=int(mesh.shape["dp"]),
            warmup_query_lengths=_warmup_k(args),
        )
        engine = QueryEngine(artifact.load_artifact(args.index, mmap=False),
                             cfg, mesh, device=device)
    if args.process_id != 0:
        engine.follow()
        return 0
    engine.warmup()
    try:
        asyncio.run(serve_forever(engine, args.host, args.port))
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop_followers()
    return 0


def cmd_serve(args) -> int:
    import asyncio

    from readserver_tpu_torch.serve.http import serve_forever

    if args.coordinator:
        if args.trace_out:
            raise SystemExit("--trace-out records one process; a group's "
                             "ranks are not traced")
        return _serve_group(args)
    if args.trace_out:
        trace.enable()
    try:
        engine = _load_engine(args.index, args.batch, args.device,
                              warmup_k=_warmup_k(args),
                              num_shards=args.shards)
        engine.warmup()
        asyncio.run(serve_forever(engine, args.host, args.port))
    except KeyboardInterrupt:
        pass
    finally:
        if args.trace_out:
            trace.disable()
            trace.export_chrome(args.trace_out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="readserver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index artifact")
    b.add_argument("--config", default="tiny", help="simulated config name")
    b.add_argument("--scale", type=float, default=1.0)
    b.add_argument("--fastq", help="build from a FASTQ file instead")
    b.add_argument("--fasta", help="build from a FASTA file instead")
    b.add_argument("--bam", help="build from a BAM file instead "
                   "(primary records; reverse-strand un-flipped)")
    b.add_argument("--min-len", type=int, default=20)
    b.add_argument("--qual-trim", type=int, default=0,
                   help="Mott-style 3' quality trim threshold for FASTQ "
                        "ingest (phred; 0 = off)")
    b.add_argument("--rlo", action="store_true",
                   help="reverse-lexicographic read sort before indexing")
    b.add_argument("--doc-shards", type=int, default=1,
                   help="build a document-sharded cohort artifact of N "
                        "independent sub-indexes (out-of-core path)")
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build)

    ab = sub.add_parser(
        "append",
        help="append reads to a cohort artifact as a new doc shard "
             "(streaming ingest — no rebuild)",
    )
    ab.add_argument("cohort", help="existing cohort artifact directory")
    ab.add_argument("--fastq")
    ab.add_argument("--fasta")
    ab.add_argument("--bam")
    ab.add_argument("--config", default="tiny",
                    help="simulated config (when no file given)")
    ab.add_argument("--scale", type=float, default=1.0)
    ab.add_argument("--min-len", type=int, default=20)
    ab.add_argument("--qual-trim", type=int, default=0)
    ab.add_argument("--sample", default="",
                    help="sample name for the appended batch (one new "
                         "sample id; default autogenerated)")
    ab.set_defaults(fn=cmd_append)

    cp = sub.add_parser(
        "compact",
        help="merge a cohort's doc shards down (interleave merge)",
    )
    cp.add_argument("cohort", help="cohort artifact directory")
    cp.add_argument("--target-shards", type=int, default=1)
    cp.set_defaults(fn=cmd_compact)

    up = sub.add_parser(
        "upgrade",
        help="synthesize missing tiers into an existing artifact in "
             "place (no rebuild; cohorts upgrade shard by shard)",
    )
    up.add_argument("index", help="artifact or cohort directory")
    up.add_argument("--kstep", type=int, default=0,
                    help="deepest k-step tier to ensure (0 = auto by n)")
    up.add_argument("--sample-rate", type=int, default=0,
                    help="mark density for synthesized resolve tiers "
                         "(0 = the artifact's recorded rate)")
    up.set_defaults(fn=cmd_upgrade)

    q = sub.add_parser("query", help="query an index artifact")
    q.add_argument("--index", required=True,
                   help="an artifact, a cohort directory, or artifacts "
                        "separated by commas (doc shards)")
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

    ib = sub.add_parser("import-bwt", help="RLE-BWT file → index artifact")
    ib.add_argument("--bwt", required=True)
    ib.add_argument("--out", required=True)
    ib.set_defaults(fn=cmd_import_bwt)

    mg = sub.add_parser("merge", help="merge per-sample artifacts")
    mg.add_argument("inputs", nargs="+", help="input artifact paths")
    mg.add_argument("--out", required=True)
    mg.add_argument("--interleave", action="store_true",
                    help="(default; kept for compatibility) BWT interleave "
                         "merge — no suffix re-sort")
    mg.add_argument("--rebuild", action="store_true",
                    help="read-level rebuild merge instead of interleave "
                         "(re-sorts all suffixes; only for tiny inputs)")
    mg.set_defaults(fn=cmd_merge)

    s = sub.add_parser("serve", help="REST server over an index artifact")
    s.add_argument("--index", required=True,
                   help="an artifact, a cohort directory, or artifacts "
                        "separated by commas (doc shards)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--batch", type=int, default=256)
    s.add_argument("--warmup-k", default="",
                   help="comma-separated uniform query lengths to run at "
                        "startup (e.g. 31)")
    s.add_argument("--shards", type=int, default=1,
                   help="BWT-interval shards: all on the one device, or "
                        "with --coordinator spread over as many ranks as "
                        "divide both them and the group")
    s.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cuda:1, cpu; "
                        "in a group, cuda is the card process-id modulo "
                        "the host's cards)")
    s.add_argument("--coordinator", default="",
                   help="host:port of rank 0: serve as one rank of a "
                        "process group (rank 0 fronts REST)")
    s.add_argument("--num-processes", type=int, default=1)
    s.add_argument("--process-id", type=int, default=0)
    s.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="the group's backend: nccl (a GPU a rank) or gloo "
                        "(the CPU, or ranks sharing a card)")
    s.add_argument("--trace-out", default="",
                   help="record the server's spans from start-up on and "
                        "write them at exit to this path as Chrome-trace "
                        "JSON, on the clock of torch.profiler's traces "
                        "(one process; not with --coordinator)")

    s.set_defaults(fn=cmd_serve)

    m = sub.add_parser("simulate", help="write a simulated corpus as FASTA")
    m.add_argument("--config", default="tiny")
    m.add_argument("--scale", type=float, default=1.0)
    m.add_argument("--out", required=True)
    m.set_defaults(fn=cmd_simulate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
