"""Failure recovery and restart semantics of the port's engine, the cases
of ``tests/test_recovery.py``.

The index is immutable, so recovery is an artifact reload (the
reference's restart-on-crash model): an engine rebuilt from the same
artifact answers identically, and so does a re-deployment at another
shard count, a process group of 2 ranks included; an interrupted save and
a manifest of another format fail loudly; the dispatcher's canary goes
through the whole device path.  Answers are held against the JAX engine's
on the same artifact where the JAX package serves it (counts are
integers: tolerance 0).
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import artifact as jax_artifact
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.index import artifact as artifact_mod
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.parallel import make_mesh
from readserver_tpu_torch.serve import Dispatcher, QueryEngine

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def saved(tiny_corpus, tmp_path_factory):
    packed = build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)
    path = artifact_mod.save_artifact(
        packed, tmp_path_factory.mktemp("rec") / "idx"
    )
    return path, tiny_corpus


def _kmers(corpus, n, seed):
    return [alphabet.decode(np.asarray(km)) for km in
            sample_query_kmers(corpus, n, corpus.spec.kmer_len, seed=seed)]


def _answers(engine, kmers):
    return [(r.kmer, r.count) for r in engine.count_batch(kmers)]


def test_restart_from_artifact_identical(saved):
    path, corpus = saved
    kmers = _kmers(corpus, 16, 61)
    cfg = ServeConfig(batch_size=32)
    e1 = QueryEngine(artifact_mod.load_artifact(path), cfg, device="cpu")
    a1 = _answers(e1, kmers)
    del e1  # a crash: the engine dies, its device state is lost
    e2 = QueryEngine(artifact_mod.load_artifact(path), cfg, device="cpu")
    assert _answers(e2, kmers) == a1
    jeng = JaxQueryEngine(jax_artifact.load_artifact(path),
                          JaxServeConfig(batch_size=32))
    assert [(r.kmer, r.count) for r in jeng.count_batch(kmers)] == a1


def test_elastic_shard_count_change(saved, tmp_path):
    """The same artifact at 1, 2 and 4 shards on one device, and at 2
    shards over a group of 2 ranks (one shard a rank), answers alike."""
    path, corpus = saved
    kmers = _kmers(corpus, 8, 62)
    answers = []
    for shards in (1, 2, 4):  # re-deploy the artifact at other widths
        eng = QueryEngine(
            artifact_mod.load_artifact(path),
            ServeConfig(batch_size=32, num_shards=shards),
            make_mesh(num_shards=shards, device="cpu"), device="cpu")
        answers.append(_answers(eng, kmers))
    assert answers[0] == answers[1] == answers[2]
    # 2 ranks reload the artifact and answer their streams together
    from test_torch_multihost import _free_port

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "readserver_tpu_torch.bench.multihost_bench",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--backend", "gloo", "--device", "cpu",
         "--batch", "16", "--num-shards", "2", "--index", str(path),
         "--dump", str(tmp_path), "--case", "route=dsa,kstep=3,lut=0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for i in (1, 0)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    glob = np.load(tmp_path / "routedsa_kstep3_lut0_budget0_exact0_global.npz")
    group_kms = [alphabet.decode(row[row > 0].astype(np.uint8))
                 for row in glob["codes"]]
    one = QueryEngine(artifact_mod.load_artifact(path),
                      ServeConfig(batch_size=32), device="cpu")
    assert [r.count for r in one.count_batch(group_kms)] == \
        glob["count"].tolist()


def test_incomplete_save_detected(saved, tmp_path):
    path, _ = saved
    broken = tmp_path / "broken"
    broken.mkdir()
    # the arrays without the manifest: the manifest-last protocol means an
    # interrupted save leaves none, and loading must fail cleanly
    for f in path.glob("*.npy"):
        (broken / f.name).write_bytes(f.read_bytes())
    assert not artifact_mod.artifact_exists(broken)
    with pytest.raises(FileNotFoundError):
        artifact_mod.load_artifact(broken)


def test_manifest_version_mismatch(saved, tmp_path):
    path, _ = saved
    clone = tmp_path / "clone"
    clone.mkdir()
    for f in path.iterdir():
        (clone / f.name).write_bytes(f.read_bytes())
    mf = json.loads((clone / "manifest.json").read_text())
    mf["format_version"] = 999
    (clone / "manifest.json").write_text(json.dumps(mf))
    with pytest.raises(ValueError, match="format"):
        artifact_mod.load_artifact(clone)


def test_dispatcher_canary_health(saved):
    """The dispatcher's /health canary goes through the whole device path
    (the liveness probe), as the JAX dispatcher's does."""
    path, _ = saved
    eng = QueryEngine(artifact_mod.load_artifact(path),
                      ServeConfig(batch_size=8), device="cpu")

    async def go():
        d = Dispatcher(eng)
        await d.start()
        r = await d.submit("A", counts_only=True)
        await d.stop()
        return r

    r = asyncio.run(go())
    assert r.count >= 0
    assert r.count == eng.count_batch(["A"])[0].count
