"""CLI of the port: build an artifact, count k-mers on one device.

    python -m readserver_tpu_torch.cli build --config ecoli --out data/idx
    python -m readserver_tpu_torch.cli query --index data/idx --kmer ACGTT \\
        --both-strands

Artifacts are the JAX package's on-disk format; either package's CLI can
build one and query the other's.  ``query`` answers counts only; hits and
sample histograms are not ported yet (ROADMAP.md).
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


def _load_engine(index_path: str, batch_size: int, device: str):
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.serve import QueryEngine

    packed = artifact.load_artifact(index_path, mmap=False)
    return QueryEngine(
        packed, ServeConfig(batch_size=batch_size), device=device
    )


def cmd_query(args) -> int:
    width = max(len(args.kmer) * (2 if args.both_strands else 1), 16)
    engine = _load_engine(args.index, width, args.device)
    results = engine.count_batch(args.kmer, both_strands=args.both_strands)
    for r in results:
        print(json.dumps({"kmer": r.kmer, "count": r.count}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="readserver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index artifact")
    b.add_argument("--config", default="tiny", help="simulated config name")
    b.add_argument("--scale", type=float, default=1.0)
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build)

    q = sub.add_parser("query", help="count k-mers in an index artifact")
    q.add_argument("--index", required=True)
    q.add_argument("--kmer", nargs="+", required=True)
    q.add_argument("--both-strands", action="store_true",
                   help="also search the reverse complement")
    q.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cuda:1, cpu)")
    q.set_defaults(fn=cmd_query)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
