"""The port's document sharding (``readserver_tpu_torch.parallel.doc_sharded``
and the doc-sharded ``QueryEngine``) against the JAX package's doc program
and doc engine on the same partitions and batch.

The partitions are the JAX ``tests/test_doc_sharded.py`` fixture's: the
tiny corpus in 4 partitions, the last the largest, partition s sample s.
Every output key of the query function (``count, shard_count, read_id,
offset, valid, sample_hist, hist_complete``) must equal the JAX program's
bit for bit, and every engine answer the JAX engine's (tolerance 0: all
are integers).  The JAX side runs on a 4-device mesh of the simulated CPU
devices of ``tests/conftest.py``; the port's on one CPU device (a world of
one) and, in ``test_ranks_match_jax_doc_program``, over groups of 2 and 4
gloo rank processes (``readserver_tpu_torch.bench.multihost_bench
--doc-shards``), each wait with a time limit.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import numpy as np
import pytest

from readserver_tpu import alphabet as jax_alphabet
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import encode_query_batch
from readserver_tpu.oracle import OracleFMIndex
from readserver_tpu.parallel import make_mesh as jax_make_mesh
from readserver_tpu.parallel.doc_sharded import (
    build_doc_sharded as jax_build_doc_sharded,
    make_doc_query_fn as jax_make_doc_query_fn,
    place_doc_sharded as jax_place_doc_sharded,
)
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch.bench.multihost_bench import (
    DOC_STRIP,
    case_name,
    doc_partitions,
    parse_case,
)
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.parallel import (
    build_doc_sharded,
    make_doc_query_fn,
    make_mesh,
    place_doc_sharded,
)
from readserver_tpu_torch.serve import QueryEngine
from torch_common import thaw_heap  # noqa: F401 (autouse)

MAX_HITS = 16  # the gloo worker's
SHARDS = 4
KEYS = ("count", "shard_count", "read_id", "offset", "valid", "sample_hist",
        "hist_complete")


def _parts(reads, route: str = "dsa"):
    return doc_partitions(lambda r, ids: build_index(r, sample_ids=ids),
                          reads, SHARDS, route)


@pytest.fixture(scope="module")
def setup(tiny_corpus):
    parts = _parts(tiny_corpus.reads)
    sample_of = np.concatenate(
        [np.full(p.num_reads, s, dtype=np.int32) for s, p in enumerate(parts)])
    return tiny_corpus, parts, OracleFMIndex(tiny_corpus.reads), sample_of


def _jax_mesh():
    return jax_make_mesh(data_parallel=1, num_shards=SHARDS,
                         devices=jax.devices()[:SHARDS])


def _both(parts, codes, lengths, lut_p=0, **kw):
    """(JAX answers, the port's) of the doc program on ``parts``, as
    NumPy dicts."""
    jm = _jax_mesh()
    jd = jax_place_doc_sharded(jax_build_doc_sharded(parts, lut_p=lut_p), jm)
    want = jax_make_doc_query_fn(jd, jm, **kw)(jd, codes, lengths)
    pm = make_mesh(num_shards=SHARDS, device="cpu")
    pd = place_doc_sharded(build_doc_sharded(parts, lut_p=lut_p), pm)
    got = make_doc_query_fn(pd, pm, **kw)(pd, codes, lengths)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _same(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _d(results) -> list[dict]:
    """Results of either package as plain dicts (the two QueryResult
    classes never compare equal)."""
    return [dataclasses.asdict(r) for r in results]


def _batch(corpus, n, seed, min_len=None, miss_frac=0.2):
    k = corpus.spec.kmer_len
    kms = sample_query_kmers(corpus, n, k, seed=seed, miss_frac=miss_frac)
    if min_len is not None:
        lens = np.random.default_rng(seed).integers(min_len, k + 1, size=n)
        kms = [km[k - int(L):] for km, L in zip(kms, lens)]
    return kms, encode_query_batch(kms, k)


# ------------------------------------ the three JAX tests, mirrored


@pytest.mark.parametrize("lut_p", [0, 5])
def test_doc_sharded_counts_and_hits(setup, lut_p):
    """``tests/test_doc_sharded.py``'s batch through both programs: every
    key equal, and the port's answers against the monolithic oracle."""
    corpus, parts, fm, sample_of = setup
    kms, (codes, lengths) = _batch(corpus, 32, seed=81)
    want, out = _both(parts, codes, lengths, lut_p, max_hits=32)
    _same(out, want)
    checked = 0
    for b, km in enumerate(kms):
        want_hits = fm.find_reads(km)
        assert out["count"][b] == len(want_hits)
        if (out["shard_count"][:, b] > 32).any():
            continue
        got = sorted((int(r), int(o)) for s in range(SHARDS)
                     for r, o, v in zip(out["read_id"][s, b],
                                        out["offset"][s, b],
                                        out["valid"][s, b]) if v)
        assert got == want_hits
        hist = np.bincount([sample_of[r] for r, _ in want_hits],
                           minlength=SHARDS)
        np.testing.assert_array_equal(out["sample_hist"][b], hist)
        checked += 1
    assert checked > 16


def test_doc_engine_end_to_end(setup):
    """The doc ``QueryEngine`` against the JAX doc engine: every answer,
    and read retrieval through the partitions, against the oracle."""
    corpus, parts, fm, sample_of = setup
    cfg = dict(batch_size=16, max_hits=32)
    jeng = JaxQueryEngine(parts, JaxServeConfig(**cfg), mesh=_jax_mesh())
    eng = QueryEngine(parts, ServeConfig(**cfg),
                      make_mesh(num_shards=SHARDS, device="cpu"),
                      device="cpu")
    eng.warmup()
    assert eng._doc and not eng._sharded and eng.lut_p == jeng.lut_p
    assert eng.sample_names == jeng.sample_names
    kms = [jax_alphabet.decode(km) for km in
           sample_query_kmers(corpus, 10, corpus.spec.kmer_len, seed=83)]
    got = eng.query_batch(kms)
    assert _d(got) == _d(jeng.query_batch(kms))
    for r in got:
        assert r.interval is None
        want = fm.find_reads(r.kmer)
        assert r.count == len(want)
        if r.hits_truncated:
            continue
        assert sorted((h["read_id"], h["offset"]) for h in r.hits) == want
        for h in r.hits:
            assert h["sample_id"] == sample_of[h["read_id"]]
            assert eng._sample_of(h["read_id"]) == jeng._sample_of(
                h["read_id"])
            seq = eng.read_sequence(h["read_id"])
            assert r.kmer in seq and seq == jeng.read_sequence(h["read_id"])
            assert eng.read_name(h["read_id"]) == jeng.read_name(h["read_id"])
            assert eng.read_meta(h["read_id"]) == jeng.read_meta(h["read_id"])


def test_doc_sharded_per_shard_counts_sum(setup):
    corpus, parts, _, _ = setup
    _, (codes, lengths) = _batch(corpus, 16, seed=82)
    want, out = _both(parts, codes, lengths, max_hits=32)
    _same(out, want)
    np.testing.assert_array_equal(out["shard_count"].sum(axis=0),
                                  out["count"])


# ------------------------------------------------- routes and tiers

ROUTE_CASES = [
    # route (DOC_STRIP), LUT order, row budget, exact attribution
    ("dsa", 5, 60, False),
    ("dsa", 0, 0, True),
    ("fused", 5, 60, False),
    ("fused", 0, 60, True),
    ("lf", 0, 60, False),
    ("lf", 5, 0, True),
    ("slow", 5, 60, False),
    ("slow", 0, 0, True),
    ("mixed", 0, 60, False),
    ("mixed", 5, 60, True),
]


@pytest.mark.parametrize("route, lut_p, budget, exact", ROUTE_CASES)
def test_doc_routes_match_jax(tiny_corpus, route, lut_p, budget, exact):
    """Every resolve route the shards' shared tiers choose, with the row
    budget and exact attribution on and off: ``mixed``'s shard 1 lacks
    dsa, so every shard walks (lf) under the budget, as in the JAX
    program; without LUT the batch has mixed lengths."""
    parts = _parts(tiny_corpus.reads, route)
    _, (codes, lengths) = _batch(tiny_corpus, 24, seed=len(route),
                                 min_len=None if lut_p else 3)
    want, got = _both(parts, codes, lengths, lut_p, max_hits=MAX_HITS,
                      row_budget=budget or None, exact_hist=exact)
    _same(got, want)
    assert want["valid"].any()
    if budget and route != "dsa":
        assert want["valid"].sum() <= budget * SHARDS


def test_doc_tiers_follow_the_jax_rules(tiny_corpus):
    """The tiers every shard ships are the JAX program's: no dsa where one
    shard lacks it, no mark table without lf (so the marks walk never
    serves a doc shard: stripping lf and fused leaves the slow walk)."""
    from readserver_tpu_torch.ops.resolve import walk_kind

    mesh = make_mesh(num_shards=SHARDS, device="cpu")
    kinds = {}
    for route in DOC_STRIP:
        d = place_doc_sharded(
            build_doc_sharded(_parts(tiny_corpus.reads, route)), mesh)
        kinds[route] = {walk_kind(s) for s in d.shards}
    assert kinds == {"dsa": {"dsa"}, "fused": {"fused"}, "lf": {"lf"},
                     "slow": {"slow"}, "mixed": {"lf"}}
    marks_only = [dataclasses.replace(p, lf=None, fused_rows=None)
                  for p in _parts(tiny_corpus.reads, "lf")]
    d = place_doc_sharded(build_doc_sharded(marks_only), mesh)
    assert {walk_kind(s) for s in d.shards} == {"slow"}
    assert d.sample_rate == 0


# ------------------------------------------------------------- engine

ENGINE_CFGS = {
    "exact": dict(batch_size=64, max_hits=MAX_HITS,
                  small_batch_sizes=(1, 16)),
    "capped, budget": dict(batch_size=64, max_hits=MAX_HITS,
                           small_batch_sizes=(1, 16),
                           exact_attribution=False, resolve_budget_frac=0.25,
                           prefix_lut_order=5),
}


@pytest.mark.parametrize("name", list(ENGINE_CFGS))
def test_doc_engine_matches_jax(tiny_corpus, name):
    """``count_batch`` and ``query_batch`` of both engines: uniform
    batches (the k-step search), short queries below the LUT order (the
    LUT-less program), mixed lengths, both strands, tiered widths; the
    fused route, whose walk takes the row budget."""
    parts = _parts(tiny_corpus.reads, "fused")
    cfg = ENGINE_CFGS[name]
    jeng = JaxQueryEngine(parts, JaxServeConfig(**cfg), mesh=_jax_mesh())
    eng = QueryEngine(parts, ServeConfig(**cfg),
                      make_mesh(num_shards=SHARDS, device="cpu"),
                      device="cpu")
    assert eng.lut_p == jeng.lut_p
    dec = jax_alphabet.decode
    uniform, _ = _batch(tiny_corpus, 30, seed=7)
    mixed, _ = _batch(tiny_corpus, 30, seed=8, min_len=2)
    short = [km[:3] for km in uniform[:5]]
    for kms in ([dec(k) for k in uniform], [dec(k) for k in mixed],
                [dec(k) for k in short], [dec(uniform[0])]):
        for both in (False, True):
            assert (_d(eng.count_batch(kms, both))
                    == _d(jeng.count_batch(kms, both)))
            assert (_d(eng.query_batch(kms, both))
                    == _d(jeng.query_batch(kms, both)))
            assert (_d(eng.query_batch(kms, both, include_hits=False))
                    == _d(jeng.query_batch(kms, both, include_hits=False)))


def test_doc_rest_matches_jax(setup):
    """``/info`` and ``/batch`` (and the read store) over both packages'
    doc engines: the same statuses and bodies, ``"sharding":
    "document"``."""
    from readserver_tpu.serve import Dispatcher as JaxDispatcher
    from readserver_tpu.serve.http import RestServer as JaxRestServer
    from readserver_tpu_torch.serve import Dispatcher
    from readserver_tpu_torch.serve.http import RestServer
    from test_torch_server import _same_answers

    corpus, parts, _, _ = setup
    cfg = dict(batch_size=64, max_hits=32, batch_deadline_ms=5.0,
               small_batch_sizes=(8,))
    jeng = JaxQueryEngine(parts, JaxServeConfig(**cfg), mesh=_jax_mesh())
    eng = QueryEngine(parts, ServeConfig(**cfg),
                      make_mesh(num_shards=SHARDS, device="cpu"),
                      device="cpu")
    kms = [jax_alphabet.decode(km) for km in
           sample_query_kmers(corpus, 6, corpus.spec.kmer_len, seed=44)]
    last = len(corpus.reads) - 1
    reqs = [("GET", p, None) for p in (
        "/info", "/read?id=3", f"/read?id={last}", f"/count?kmer={kms[0]}",
        f"/samples?kmer={kms[1]}&both_strands=1",
    )] + [("POST", "/batch", {"kmers": kms, "mode": mode,
                              "both_strands": True})
          for mode in ("count", "reads", "samples")]
    got = _same_answers(
        (corpus, (JaxRestServer, JaxDispatcher, jeng),
         (RestServer, Dispatcher, eng)), reqs)
    assert [s for s, _ in got] == [200] * len(reqs)
    assert got[0][1]["sharding"] == "document"
    assert got[0][1]["num_reads"] == len(corpus.reads)


def test_doc_and_multi_engines_agree(setup):
    """What ``chip_smoke.py`` phase 14 holds the doc engine to against the
    cohort front (``MultiEngine``): on both packages the two fronts give
    the same counts, hit lists, truncation flags, exact histograms and
    completeness flags, on both strands."""
    from readserver_tpu.serve import MultiEngine as JaxMultiEngine
    from readserver_tpu_torch.serve import MultiEngine

    corpus, parts, _, _ = setup
    cfg = dict(batch_size=64, max_hits=8)
    kms = [jax_alphabet.decode(km) for km in
           sample_query_kmers(corpus, 28, corpus.spec.kmer_len, seed=45)]
    kms += [km[:3] for km in kms[:4]]  # past the hit cap

    def key(results):
        return [(r.count, r.hits, r.hits_truncated, r.sample_hist,
                 r.sample_hist_complete) for r in results]

    jdoc = JaxQueryEngine(parts, JaxServeConfig(**cfg), mesh=_jax_mesh())
    jmulti = JaxMultiEngine(parts, JaxServeConfig(**cfg))
    doc = QueryEngine(parts, ServeConfig(**cfg),
                      make_mesh(num_shards=SHARDS, device="cpu"),
                      device="cpu")
    multi = MultiEngine(parts, ServeConfig(**cfg), device="cpu")
    for both in (False, True):
        want = key(jdoc.query_batch(kms, both))
        assert key(jmulti.query_batch(kms, both)) == want
        assert key(doc.query_batch(kms, both)) == want
        assert key(multi.query_batch(kms, both)) == want
    assert any(r.hits_truncated for r in doc.query_batch(kms))


# ------------------------------------------------------ across ranks

DOC_CASES = [
    "route=dsa,kstep=3,lut=5",
    "route=lf,kstep=1,lut=0,budget=40",
    "route=fused,kstep=3,lut=5,budget=40,exact=1",
    "route=mixed,kstep=1,lut=5,budget=40",
    "route=slow,kstep=3,lut=0,exact=1",
]
# ranks → the cases their group runs (4 shards: 2 a rank, or 1)
DOC_GROUPS = {2: DOC_CASES, 4: DOC_CASES[1:4]}
BATCH = 16


@pytest.fixture(scope="module")
def doc_dumps(tmp_path_factory):
    """Every group's dumped answers → {ranks: directory}."""
    from test_torch_multihost import _launch, _wait

    out, running = {}, []
    for n, cases in DOC_GROUPS.items():
        d = tmp_path_factory.mktemp(f"doc_{n}")

        def cmd(i, port, n=n, d=d, cases=cases):
            return [sys.executable, "-m",
                    "readserver_tpu_torch.bench.multihost_bench",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(n), "--process-id", str(i),
                    "--backend", "gloo", "--device", "cpu",
                    "--batch", str(BATCH), "--heartbeat-timeout", "30",
                    "--doc-shards", str(SHARDS), "--dump", str(d),
                    *[x for c in cases for x in ("--case", c)]]
        running.append((n, d, _launch(cmd, n)))
    for n, d, procs in running:
        outs = _wait(procs, timeout=240)
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"{n} ranks: {o[-3000:]}"
        out[n] = d
    return out


@pytest.mark.parametrize("ranks, spec", [
    pytest.param(n, c, id=f"{n}ranks-{case_name(parse_case(c, DOC_STRIP))}")
    for n, cases in DOC_GROUPS.items() for c in cases])
def test_ranks_match_jax_doc_program(doc_dumps, tiny_corpus, ranks, spec):
    """A group of gloo ranks, each holding a run of the 4 doc shards,
    answers as the JAX program on the whole batch, with exactly one
    all-reduce and one gather a batch on every rank."""
    case = parse_case(spec, DOC_STRIP)
    name = case_name(case)
    glob = dict(np.load(doc_dumps[ranks] / f"{name}_global.npz"))
    parts = _parts(tiny_corpus.reads, case["route"])
    want, _ = _both(parts, glob["codes"], glob["lengths"], case["lut"],
                    max_hits=MAX_HITS, row_budget=case["budget"] or None,
                    exact_hist=bool(case["exact"]))
    _same(glob, want)
    assert want["valid"].any()
    for r in range(ranks):
        local = np.load(doc_dumps[ranks] / f"{name}_rank{r}.npz")
        assert int(local["all_reduce"]) == 1 and int(local["gather"]) == 1
        assert int(local["shards"]) == SHARDS // ranks
        assert int(local["first"]) == r * SHARDS // ranks


def test_doc_engine_without_mesh_raises(setup):
    _, parts, _, _ = setup
    with pytest.raises(ValueError, match="requires a mesh"):
        QueryEngine(parts, device="cpu")
    with pytest.raises(ValueError, match="2 shards, the index 4"):
        place_doc_sharded(build_doc_sharded(parts),
                          make_mesh(num_shards=2, device="cpu"))

