"""Out-of-core cohort build: read partitions → per-shard artifacts → one
cohort manifest.

Whole-human pools (~90 Gbp, SURVEY.md §7 "HBM budget") can never pass
through one in-core suffix sort (int32 SA-IS range, and one chip's HBM);
the reference solved the same problem operationally by building per-sample
BWTs and deploying them across backend servers (SURVEY.md §1 L5).  Here
the equivalent is a **cohort artifact**: a directory of independent
per-partition sub-index artifacts plus a manifest, built one partition at
a time (bounded peak memory), served document-sharded
(``parallel/doc_sharded.py``) with answers identical to a monolithic
build.

Build is stage-wise resumable (SURVEY.md §5 "Checkpoint / resume"): each
shard's artifact is written manifest-last, and a progress log records how
many reads each completed shard consumed, so an interrupted build restarts
at the first missing shard — including from a streaming read source.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np

from readserver_tpu_torch.config import IndexConfig
from readserver_tpu_torch.index import artifact
from readserver_tpu_torch.index.builder import PackedIndex, build_index

COHORT_MANIFEST = "cohort.json"
PROGRESS_LOG = "progress.jsonl"


def is_cohort(path: str | Path) -> bool:
    return (Path(path) / COHORT_MANIFEST).exists()


def partition_spans(
    read_lengths: Sequence[int], num_shards: int
) -> list[tuple[int, int]]:
    """Contiguous read spans with near-equal total bases per shard."""
    lengths = np.asarray(read_lengths, dtype=np.int64)
    m = len(lengths)
    if num_shards < 1 or num_shards > m:
        raise ValueError(f"num_shards must be in [1, {m}]")
    cum = np.concatenate([[0], np.cumsum(lengths)])
    total = int(cum[-1])
    spans, lo = [], 0
    for s in range(num_shards):
        target = total * (s + 1) // num_shards
        hi = int(np.searchsorted(cum, target, side="left"))
        hi = max(hi, lo + 1)  # every shard gets at least one read
        hi = min(hi, m - (num_shards - 1 - s))  # leave reads for the rest
        spans.append((lo, hi))
        lo = hi
    spans[-1] = (spans[-1][0], m)
    return spans


def _write_cohort_manifest(
    out: Path,
    shard_dirs: list[str],
    num_reads: int,
    num_samples: int,
    sample_names: list[str],
    config: IndexConfig,
) -> None:
    manifest = {
        "kind": "cohort",
        "format_version": config.format_version,
        # full build config recorded for inspection; shard 0's artifact
        # manifest stays the source of truth (shard_build_params)
        "config": json.loads(config.to_json()),
        "num_shards": len(shard_dirs),
        "shards": shard_dirs,
        "num_reads": num_reads,
        "num_samples": num_samples,
        "sample_names": sample_names,
    }
    tmp = out / (COHORT_MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.rename(out / COHORT_MANIFEST)  # manifest last: presence == complete


def shard_build_params(
    path: Path, manifest: dict
) -> tuple[IndexConfig, dict]:
    """Recover the cohort's build-time layout from shard 0's artifact
    manifest: the ``IndexConfig`` plus the tier kwargs (``sample_rate``,
    ``fast_resolve``, ``kstep``) that :func:`build_index` needs to produce
    a layout-identical shard.

    The cohort manifest itself does not carry the full build config in
    older artifacts (ADVICE r3, medium): appending with defaults to a
    cohort built with non-default ``sample_rate``/``block_size`` silently
    drifts shard layouts, and the doc-sharded mesh path then applies
    shard 0's parameters to all shards.  Shard 0's artifact manifest is
    the single source of truth for what was actually built."""
    sub = json.loads(
        (path / manifest["shards"][0] / artifact.MANIFEST_NAME).read_text()
    )
    cfg = IndexConfig(**sub["config"])
    arrays = set(sub.get("arrays", ()))
    rate = int(sub.get("sample_rate", 0))
    kw: dict = {"fast_resolve": rate > 0}
    if rate:
        kw["sample_rate"] = rate
    if "rank3_blocks" in arrays:
        kw["kstep"] = 3
    elif "rank2_blocks" in arrays:
        kw["kstep"] = 2
    else:
        kw["pair_rank"] = False
    return cfg, kw


def build_cohort(
    reads: Sequence[np.ndarray],
    sample_ids: np.ndarray | None,
    num_shards: int,
    out: str | Path,
    sample_names: Sequence[str] | None = None,
    config: IndexConfig | None = None,
    resume: bool = True,
    read_names: Sequence[str] | None = None,
    **build_kw,
) -> Path:
    """Partition an in-memory corpus and build/save each shard in turn.

    Peak memory is one shard's build, not the cohort's.  Existing complete
    shard artifacts are skipped when ``resume`` (idempotent restart).
    """
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    config = config or IndexConfig()
    m = len(reads)
    if sample_ids is None:
        sample_ids = np.zeros(m, dtype=np.int32)
    sample_ids = np.asarray(sample_ids, dtype=np.int32)
    num_samples = int(sample_ids.max()) + 1 if m else 0
    names = (
        list(sample_names)
        if sample_names is not None
        else [f"sample_{i}" for i in range(num_samples)]
    )
    spans = partition_spans([len(r) for r in reads], num_shards)
    shard_dirs = []
    for s, (lo, hi) in enumerate(spans):
        sub = out / f"shard_{s:04d}"
        shard_dirs.append(sub.name)
        if resume and artifact.artifact_exists(sub):
            continue
        packed = build_index(
            reads[lo:hi],
            sample_ids=sample_ids[lo:hi],
            config=config,
            sample_names=names,  # global sample-id space on every shard
            read_names=read_names[lo:hi] if read_names is not None else None,
            **build_kw,
        )
        # per-shard num_samples must span the GLOBAL sample space so the
        # doc-sharded histogram psum has a common width
        packed.num_samples = num_samples
        artifact.save_artifact(packed, sub)
    _write_cohort_manifest(out, shard_dirs, m, num_samples, names, config)
    return out


def build_cohort_stream(
    records: Iterable[tuple[np.ndarray, int]],
    out: str | Path,
    max_bases_per_shard: int,
    num_samples: int,
    sample_names: Sequence[str] | None = None,
    config: IndexConfig | None = None,
    resume: bool = True,
    **build_kw,
) -> Path:
    """Out-of-core build from a one-pass read stream.

    ``records`` yields ``(read_codes, sample_id)``; reads accumulate until
    ``max_bases_per_shard``, then the shard is built, saved, and freed.  A
    progress log maps completed shards to consumed-read counts, so resuming
    re-drives the same stream, skips the consumed prefix, and continues at
    the first unbuilt shard.
    """
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    config = config or IndexConfig()
    names = (
        list(sample_names)
        if sample_names is not None
        else [f"sample_{i}" for i in range(num_samples)]
    )
    log_path = out / PROGRESS_LOG

    skip_reads = 0
    next_shard = 0
    prior_dirs: list[str] = []
    if resume and log_path.exists():
        for line in log_path.read_text().splitlines():
            entry = json.loads(line)
            sub = out / entry["shard"]
            if artifact.artifact_exists(sub):
                skip_reads = entry["reads_consumed"]
                next_shard = entry["shard_index"] + 1
                # take names from the log, not f"shard_{s}": compaction
                # may have renamed completed shards (compactN_xxxx)
                prior_dirs.append(entry["shard"])
            else:
                break

    it: Iterator[tuple[np.ndarray, int]] = iter(records)
    consumed = 0
    for _ in range(skip_reads):
        next(it)
        consumed += 1

    shard_dirs = prior_dirs
    buf_reads: list[np.ndarray] = []
    buf_samples: list[int] = []
    buf_bases = 0
    total_reads = consumed

    def flush() -> None:
        nonlocal buf_reads, buf_samples, buf_bases, next_shard
        if not buf_reads:
            return
        # skip names held by compaction-kept shards (see append_to_cohort)
        while f"shard_{next_shard:04d}" in shard_dirs:
            next_shard += 1
        name = f"shard_{next_shard:04d}"
        packed = build_index(
            buf_reads,
            sample_ids=np.asarray(buf_samples, dtype=np.int32),
            config=config,
            sample_names=names,
            **build_kw,
        )
        packed.num_samples = num_samples
        artifact.save_artifact(packed, out / name)
        with open(log_path, "a") as fh:
            fh.write(
                json.dumps(
                    {
                        "shard": name,
                        "shard_index": next_shard,
                        "reads_consumed": total_reads,
                    }
                )
                + "\n"
            )
        shard_dirs.append(name)
        next_shard += 1
        buf_reads, buf_samples, buf_bases = [], [], 0

    for read, sid in it:
        buf_reads.append(read)
        buf_samples.append(int(sid))
        buf_bases += len(read)
        consumed += 1
        total_reads = consumed
        if buf_bases >= max_bases_per_shard:
            flush()
    flush()
    _write_cohort_manifest(
        out, shard_dirs, total_reads, num_samples, names, config
    )
    return out


def append_to_cohort(
    path: str | Path,
    reads: Sequence[np.ndarray],
    sample_ids: np.ndarray | None = None,
    sample_names: Sequence[str] | None = None,
    read_names: Sequence[str] | None = None,
    config: IndexConfig | None = None,
    max_bases_per_shard: int | None = None,
    **build_kw,
) -> Path:
    """Streaming ingest without a rebuild: new reads join an existing
    cohort as fresh doc shards appended at the end.

    This is the framework's answer to the reference's incremental-growth
    problem (ropebwt2-style BWT extension, SURVEY.md §2 "streaming
    ingest"): instead of extending a monolithic BWT in place — a
    sequential, pointer-chasing algorithm with no TPU mapping — the
    cohort gains an independent per-batch FM-index shard, and the
    document-sharded merge (``parallel/doc_sharded.py`` /
    ``serve.MultiEngine``) makes the union queryable immediately with
    answers identical to a from-scratch rebuild (counts sum; read ids
    offset by the cumulative base; histograms merge by sample name).

    Contract:
      * ``sample_ids`` are in the GLOBAL sample-id space.  ``None`` means
        "this batch is one new sample" (id = current ``num_samples``) —
        the common ingest shape (one FASTQ = one donor).
      * ``sample_names`` names any NEW ids past the existing space, in
        order; autogenerated when omitted.
      * Crash safety matches the builder: shard artifacts are written
        manifest-last, and the cohort manifest is atomically replaced
        only after every new shard is complete.  A crash mid-append
        leaves the prior cohort fully intact (orphan shard dirs are
        reused on retry).

    Periodic compaction (merging many small appended shards into one via
    ``index/merge.py``) is the operator's lever against per-query
    fan-out growth, exactly as the reference compacted per-sample BWTs.
    """
    out = Path(path)
    manifest = json.loads((out / COHORT_MANIFEST).read_text())
    if manifest.get("kind") != "cohort":
        raise ValueError(f"{out} is not a cohort artifact")
    built_cfg, built_kw = shard_build_params(out, manifest)
    if config is not None and config != built_cfg:
        raise ValueError(
            f"config mismatch: cohort shards were built with "
            f"{built_cfg.to_json()}, append got {config.to_json()}"
        )
    config = built_cfg
    # inherit the cohort's actual build-time tier kwargs so appended
    # shards can never drift from the existing ones (ADVICE r3) — also
    # when an (identical) config was passed explicitly
    for k, v in built_kw.items():
        build_kw.setdefault(k, v)
    if manifest["format_version"] != config.format_version:
        raise ValueError(
            f"format_version mismatch: cohort has "
            f"{manifest['format_version']}, config has "
            f"{config.format_version}"
        )
    m = len(reads)
    if m == 0:
        return out
    old_ns = int(manifest["num_samples"])
    if sample_ids is None:
        sample_ids = np.full(m, old_ns, dtype=np.int32)
    sample_ids = np.asarray(sample_ids, dtype=np.int32)
    if (sample_ids < 0).any():
        raise ValueError("negative sample id")
    new_ns = max(old_ns, int(sample_ids.max()) + 1)
    names = list(manifest["sample_names"])
    fresh = [f"sample_{i}" for i in range(old_ns, new_ns)]
    if sample_names is not None:
        if len(sample_names) != new_ns - old_ns:
            raise ValueError(
                f"sample_names must name the {new_ns - old_ns} new "
                f"sample ids, got {len(sample_names)}"
            )
        fresh = list(sample_names)
    names += fresh

    # split the batch into shard spans (one shard unless a cap is given)
    if max_bases_per_shard is None:
        spans = [(0, m)]
    else:
        spans, lo, acc = [], 0, 0
        for i, r in enumerate(reads):
            acc += len(r)
            if acc >= max_bases_per_shard and i + 1 > lo:
                spans.append((lo, i + 1))
                lo, acc = i + 1, 0
        if lo < m:
            spans.append((lo, m))

    next_shard = int(manifest["num_shards"])
    total_reads = int(manifest["num_reads"])
    shard_dirs = list(manifest["shards"])
    log_path = out / PROGRESS_LOG
    for lo, hi in spans:
        # count-derived names can collide with a shard_XXXX dir kept in
        # place by compaction (XXXX >= num_shards after singleton keeps);
        # skip names the manifest still references.  Dirs NOT in the
        # manifest are crash orphans and are deliberately overwritten.
        while f"shard_{next_shard:04d}" in shard_dirs:
            next_shard += 1
        name = f"shard_{next_shard:04d}"
        packed = build_index(
            list(reads[lo:hi]),
            sample_ids=sample_ids[lo:hi],
            config=config,
            sample_names=names,
            read_names=(
                list(read_names[lo:hi]) if read_names is not None else None
            ),
            **build_kw,
        )
        packed.num_samples = new_ns
        artifact.save_artifact(packed, out / name)
        total_reads += hi - lo
        with open(log_path, "a") as fh:
            fh.write(
                json.dumps(
                    {
                        "shard": name,
                        "shard_index": next_shard,
                        "reads_consumed": total_reads,
                        "appended": True,
                    }
                )
                + "\n"
            )
        shard_dirs.append(name)
        next_shard += 1
    _write_cohort_manifest(
        out, shard_dirs, total_reads, new_ns, names, config
    )
    return out


def compact_cohort(
    path: str | Path, target_shards: int = 1, mmap: bool = True
) -> Path:
    """Merge a cohort's shards down to ``target_shards`` via the
    interleave BWT merge (no suffix re-sort) — the operator's lever
    against per-query fan-out after repeated :func:`append_to_cohort`.

    Shards stay in read order (contiguous groups balanced by symbol
    count), so global read ids are unchanged; sample ids pass through the
    merge in the shared global space (``shared_samples=True``).  Answers
    are identical before and after by the interleave-merge invariant.
    The new manifest is atomically swapped in only after every merged
    shard artifact is complete; the superseded shard dirs are removed
    afterwards (a crash in between leaves harmless orphans).

    Peak host memory is one GROUP's decoded BWTs — compact pairwise
    (``target_shards = ceil(n/2)``) when shards are large.
    """
    from readserver_tpu_torch.index.merge import merge_indexes_interleave

    out = Path(path)
    parts, manifest = load_cohort(out, mmap=mmap)
    old_dirs = list(manifest["shards"])
    if target_shards >= len(parts):
        return out
    gen = 1 + max(
        [int(d.split("_")[0][len("compact"):] or 0)
         for d in old_dirs if d.startswith("compact")] or [0]
    )
    spans = partition_spans([p.n for p in parts], target_shards)
    config = parts[0].config
    new_dirs = []
    shard_reads = []
    for i, (lo, hi) in enumerate(spans):
        if hi - lo == 1:
            # singleton group: keep the existing shard dir in place — a
            # byte-identical re-save under a new name would be a full
            # artifact copy for no change (ADVICE r3)
            new_dirs.append(old_dirs[lo])
            shard_reads.append(parts[lo].num_reads)
            continue
        name = f"compact{gen}_{i:04d}"
        merged = merge_indexes_interleave(
            parts[lo:hi], config=config, shared_samples=True
        )
        merged.num_samples = int(manifest["num_samples"])
        artifact.save_artifact(merged, out / name)
        new_dirs.append(name)
        shard_reads.append(merged.num_reads)
    _write_cohort_manifest(
        out,
        new_dirs,
        int(manifest["num_reads"]),
        int(manifest["num_samples"]),
        list(manifest["sample_names"]),
        config,
    )
    import shutil

    for d in old_dirs:
        if d not in new_dirs:
            shutil.rmtree(out / d, ignore_errors=True)
    # rewrite the streaming-build progress log to match the new shard list
    # (stale entries pointing at removed dirs would make a later resumed
    # build_cohort_stream restart from read 0 and clobber the cohort —
    # ADVICE r3)
    log_path = out / PROGRESS_LOG
    if log_path.exists():
        consumed = 0
        lines = []
        for i, (name, nr) in enumerate(zip(new_dirs, shard_reads)):
            consumed += nr
            lines.append(
                json.dumps(
                    {
                        "shard": name,
                        "shard_index": i,
                        "reads_consumed": consumed,
                        "compacted": True,
                    }
                )
            )
        tmp = out / (PROGRESS_LOG + ".tmp")
        tmp.write_text("\n".join(lines) + "\n")
        tmp.rename(log_path)
    return out


def load_cohort(
    path: str | Path, mmap: bool = True
) -> tuple[list[PackedIndex], dict]:
    """Cohort dir → (per-shard PackedIndexes in shard order, manifest)."""
    path = Path(path)
    manifest = json.loads((path / COHORT_MANIFEST).read_text())
    if manifest.get("kind") != "cohort":
        raise ValueError(f"{path} is not a cohort artifact")
    parts = [
        artifact.load_artifact(path / sub, mmap=mmap)
        for sub in manifest["shards"]
    ]
    return parts, manifest
