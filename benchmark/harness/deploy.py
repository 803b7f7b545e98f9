"""A configuration's deployment: its reads, its artifact and its engine.

The reads come from the frozen generators (``harness/simulate.py``) and the
configuration's own corpus seed: the corpus is part of the deployment, as
a lab indexes a read set once and serves it.  The program's index builder makes
the artifact on the first run in a checkout, into ``benchmark/cache/``
under a key that changes with the configuration, the generators and the
program's index sources; later runs load it from there.  The engine is
made as the program's command line makes it for ``serve``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from harness import simulate
from harness.cell import BENCH_DIR, ROOT

CACHE_DIR = BENCH_DIR / "cache"
_KEYED_SOURCES = ("readserver_tpu_torch/index", "readserver_tpu_torch/native",
                  "readserver_tpu_torch/corpus", "readserver_tpu_torch/config.py",
                  "readserver_tpu_torch/alphabet.py")


def sample_names(config: dict) -> list[str]:
    """The names the build gives the samples (the command line's
    ``sample_000`` ... for a simulated corpus)."""
    return [f"sample_{i:03d}"
            for i in range(int(config["corpus"].get("num_samples", 1)))]


def reads_of(config: dict) -> tuple[np.ndarray, np.ndarray]:
    return simulate.simulate_corpus(config["corpus"])


def cache_key(config: dict, root: Path = ROOT) -> str:
    h = hashlib.sha256()
    h.update(json.dumps({k: config[k] for k in ("corpus", "deployment")},
                        sort_keys=True).encode())
    h.update((BENCH_DIR / "harness" / "simulate.py").read_bytes())
    for rel in _KEYED_SOURCES:
        p = root / rel
        for f in sorted(p.rglob("*.py")) if p.is_dir() else [p]:
            h.update(f.relative_to(root).as_posix().encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def artifact_path(config: dict, cache_dir: Path = CACHE_DIR,
                  root: Path = ROOT) -> Path:
    return Path(cache_dir) / f"{config['name']}-{cache_key(config, root)}"


def ensure_artifact(config: dict, reads: np.ndarray, sids: np.ndarray,
                    path: Path) -> bool:
    """Build the artifact at ``path`` unless it is there → whether it was
    built.  A build goes to a sibling directory first, renamed when whole,
    so a run cut mid-build leaves nothing that a later run would load."""
    if path.exists():
        return False
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.index.cohort import build_cohort

    tmp = path.with_name(path.name + ".building")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.parent.mkdir(parents=True, exist_ok=True)
    shards = int(config["deployment"].get("doc_shards", 1))
    names = sample_names(config)
    if shards > 1:
        build_cohort(list(reads), sids, shards, tmp, sample_names=names)
    else:
        packed = build_index(list(reads), sample_ids=sids, sample_names=names)
        artifact.save_artifact(packed, tmp)
        del packed
    tmp.rename(path)
    return True


def make_engine(config: dict, path: Path, device: str):
    """The engine ``serve --index <path> --batch B --warmup-k k`` makes;
    raises where its serving configuration is not the one the
    configuration's file states, field for field."""
    import dataclasses

    from readserver_tpu_torch.cli import _load_engine

    serve = config["serve"]
    engine = _load_engine(str(path), int(serve["batch_size"]), device,
                          warmup_k=tuple(serve["warmup_query_lengths"]))
    got = json.loads(json.dumps(dataclasses.asdict(engine.cfg)))
    if got != serve:
        diff = {k: (serve.get(k), got.get(k))
                for k in set(serve) | set(got) if serve.get(k) != got.get(k)}
        raise ValueError(f"engine serves another configuration than "
                         f"{config['name']} states (stated, served): {diff}")
    return engine
