"""The serving process's heap after warm-up: every engine kind (single
index, interval shards, doc shards, ``MultiEngine``) collects once and
freezes what set-up made into the collector's permanent generation as its
``warmup()`` ends (``serve/engine._settle_heap``).  The engine and its
device index leave the collector's generations, the answers stay bit for
bit what they were, a second warm-up does no harm, cycles made after it are
still freed, and a recording holds one ``setup.freeze`` span after
``setup.warmup``.

Imports no JAX: the port's own builder and simulator make the corpus.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import numpy as np
import pytest

from readserver_tpu_torch import trace
from readserver_tpu_torch.bench.multihost_bench import doc_partitions
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.parallel import make_mesh
from readserver_tpu_torch.serve import QueryEngine
from readserver_tpu_torch.serve.engine import MultiEngine
from torch_common import thaw_heap  # noqa: F401 (autouse)

CFG = dict(batch_size=64, small_batch_sizes=(8,))
SAMPLES = 4
KINDS = ("single", "interval", "doc", "multi")


@pytest.fixture(scope="module")
def corpus():
    c = simulate.simulate_config("tiny")
    reads = c.reads
    sample_ids = np.arange(len(reads), dtype=np.int32) % SAMPLES
    packed = build_index(reads, sample_ids=sample_ids)
    parts = doc_partitions(lambda r, ids: build_index(r, sample_ids=ids),
                           reads, SAMPLES, "dsa")
    kmers = ["".join("ACGT"[b - 1] for b in km) for km in
             simulate.sample_query_kmers(c, 24, c.spec.kmer_len, seed=5,
                                         miss_frac=0.25)]
    return packed, parts, kmers


def _engine(kind: str, corpus):
    packed, parts, _ = corpus
    if kind == "single":
        return QueryEngine(packed, ServeConfig(**CFG), device="cpu")
    if kind == "interval":
        return QueryEngine(packed, ServeConfig(num_shards=4, **CFG),
                           make_mesh(num_shards=4, device="cpu"),
                           device="cpu")
    if kind == "doc":
        return QueryEngine(parts, ServeConfig(**CFG),
                           make_mesh(num_shards=SAMPLES, device="cpu"),
                           device="cpu")
    return MultiEngine(parts, ServeConfig(**CFG), device="cpu")


def _device_indexes(kind: str, engine) -> list:
    if kind == "single":
        return [engine.index]
    if kind == "interval":
        return [engine.sidx]
    if kind == "doc":
        return [engine.didx, *engine.didx.shards]
    return [e.index for e in engine.engines]


def _answers(engine, kmers) -> list:
    """Counts, full answers (hits) and histograms, one strand and both."""
    runs = [engine.count_batch(kmers),
            engine.count_batch(kmers, both_strands=True),
            engine.query_batch(kmers),
            engine.query_batch(kmers, include_hits=False),
            engine.query_batch(kmers, both_strands=True)]
    return [[dataclasses.asdict(r) for r in run] for run in runs]


def _tracked(objs) -> bool:
    """Whether any of ``objs`` is in a generation the collector walks."""
    ids = {id(o) for o in objs}
    return any(id(o) in ids for o in gc.get_objects())


@pytest.mark.parametrize("kind", KINDS)
def test_warmup_freezes_the_engine(corpus, kind):
    engine = _engine(kind, corpus)
    held = [engine, *_device_indexes(kind, engine)]
    alive = len(gc.get_objects())
    assert _tracked(held)
    engine.warmup()
    assert gc.get_freeze_count() > alive // 2
    assert not _tracked(held)


@pytest.mark.parametrize("kind", KINDS)
def test_answers_equal_before_and_after_warmup(corpus, kind):
    _, _, kmers = corpus
    engine = _engine(kind, corpus)
    cold = _answers(engine, kmers)
    engine.warmup()
    warm = _answers(engine, kmers)
    assert warm == cold
    assert any(r["hits"] for r in warm[2])
    assert any(sum(r["sample_hist"].values()) for r in warm[3])


@pytest.mark.parametrize("kind", KINDS)
def test_second_warmup_does_no_harm(corpus, kind):
    _, _, kmers = corpus
    engine = _engine(kind, corpus)
    engine.warmup()
    first = gc.get_freeze_count()
    want = _answers(engine, kmers)
    engine.warmup()
    assert gc.get_freeze_count() >= first
    assert not _tracked([engine, *_device_indexes(kind, engine)])
    assert _answers(engine, kmers) == want


@pytest.mark.parametrize("kind", KINDS)
def test_collector_frees_cycles_made_after_warmup(corpus, kind):
    """Freezing stops the walk over set-up's objects, not the collector:
    a cycle made while serving is freed by the next full collection, and
    the warmed engine is freed by its last reference alone."""
    _, _, kmers = corpus
    engine = _engine(kind, corpus)
    engine.warmup()
    results = engine.query_batch(kmers)
    results.append(results)            # a cycle through the answers
    gone = weakref.ref(results[0])
    del results
    assert gone() is not None
    gc.collect()
    assert gone() is None
    ref = weakref.ref(engine)
    del engine
    assert ref() is None


@pytest.mark.parametrize("kind", KINDS)
def test_freeze_span_follows_warmup(corpus, kind):
    engine = _engine(kind, corpus)
    alive = len(gc.get_objects())
    trace.enable()
    try:
        engine.warmup()
    finally:
        trace.disable()
    spans = sorted(trace.spans(), key=lambda s: s.start)
    setup = [s for s in spans if s.name.startswith("setup.")]
    assert [s.name for s in setup] == ["setup.warmup", "setup.freeze"]
    warm, freeze = setup
    assert freeze.start >= warm.end and freeze.parent == warm.parent
    # most of what set-up left is frozen (a collection alone leaves a few
    # hundred immortal objects there); what warm-up still held as it froze
    # has since been freed
    assert freeze.attrs["frozen"] >= gc.get_freeze_count() > alive // 2
    assert freeze.attrs["collected"] >= 0
    # the one collection it makes is a full one, recorded inside it
    (full,) = [s for s in spans if s.name == "runtime.gc"
               and s.parent == freeze.id]
    assert freeze.start <= full.start <= full.end <= freeze.end
