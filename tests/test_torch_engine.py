"""Port's QueryEngine against the JAX package's QueryEngine on the same
PackedIndex: counts at tiered widths 1 and 256, uniform and mixed lengths
(k-step, LUT and plain routes), both strands; full answers (hits,
histogram-only, both strands) on a single-sample and a 128-sample corpus,
through each of the five walks, the dense fallback, the capped
histogram; read text, names and metadata — and the port's CLI."""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from readserver_tpu import alphabet as jax_alphabet
from readserver_tpu import cli as jax_cli
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import build_index
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import cli
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.ops.resolve import walk_kind
from readserver_tpu_torch.serve import QueryEngine, rc_string
from torch_common import thaw_heap  # noqa: F401 (autouse)

CFG = dict(batch_size=512, small_batch_sizes=(1, 256))


@pytest.fixture(scope="module")
def engines(small_corpus):
    packed = build_index(small_corpus.reads, sample_ids=small_corpus.sample_ids)
    jax_engine = JaxQueryEngine(packed, JaxServeConfig(**CFG))
    engine = QueryEngine(packed, ServeConfig(**CFG), device="cpu")
    return small_corpus, jax_engine, engine


def _kmers(corpus, n, k, seed, min_len=None, miss_frac=0.25):
    kms = sample_query_kmers(corpus, n, k, seed=seed, miss_frac=miss_frac)
    if min_len is not None:
        lens = np.random.default_rng(seed).integers(min_len, k + 1, size=n)
        kms = [km[: int(L)] for km, L in zip(kms, lens)]
    return ["".join("ACGT"[c - 1] for c in km) for km in kms]


def _same(got, want):
    assert [(r.kmer, r.count, r.interval) for r in got] == [
        (r.kmer, r.count, r.interval) for r in want
    ]


@pytest.mark.parametrize(
    "case, n, k, min_len, width",
    [
        ("one uniform", 1, 15, None, 1),
        ("256 uniform", 256, 15, None, 256),
        ("256 short uniform (< p)", 256, 6, None, 256),
        ("mixed >= p", 200, 15, 8, 256),
        ("mixed, some < p", 300, 15, 2, 512),
        ("one short", 1, 3, None, 1),
    ],
)
def test_count_batch_matches_jax(engines, case, n, k, min_len, width):
    corpus, jax_engine, engine = engines
    kms = _kmers(corpus, n, k, seed=len(case), min_len=min_len)
    got = engine.count_batch(kms)
    assert engine.last_width == width
    _same(got, jax_engine.count_batch(kms))


def test_both_strands_matches_jax(engines):
    corpus, jax_engine, engine = engines
    kms = _kmers(corpus, 120, 15, seed=5) + ["ACGT", "AATT"]  # palindromes
    got = engine.count_batch(kms, both_strands=True)
    _same(got, jax_engine.count_batch(kms, both_strands=True))
    fwd = engine.count_batch(kms)
    rev = engine.count_batch([rc_string(k) for k in kms])
    for g, f, r, km in zip(got, fwd, rev, kms):
        assert g.count == f.count + (0 if rc_string(km) == km else r.count)


def test_engine_plan_and_warmup(engines):
    _, jax_engine, engine = engines
    assert engine.budget_bytes is None  # no cap on the CPU
    assert engine.tier_plan.keep == jax_engine.tier_plan.keep
    assert engine.lut_p == jax_engine.lut_p
    assert engine.has_pair == jax_engine.has_pair
    engine.warmup()
    with pytest.raises(ValueError, match="exceeds"):
        engine.count_batch(["A"] * 513)


def test_unported_surfaces_raise(engines, small_corpus):
    """Document sharding (a list of partitions), once the surface still to
    port, answers as the JAX doc engine: without a mesh both packages
    refuse it, with one the answers are equal (the same partition twice:
    every count doubles); interval shards on a dp axis above 1 serve."""
    import jax

    from readserver_tpu.parallel import make_mesh as jax_make_mesh
    from readserver_tpu_torch.parallel import Mesh, make_mesh

    corpus, _, engine = engines
    assert not engine._doc and not engine._sharded
    parts = [engine.packed, engine.packed]
    with pytest.raises(ValueError, match="requires a mesh"):
        QueryEngine(parts, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        JaxQueryEngine(parts)
    doc = QueryEngine(parts, ServeConfig(**CFG),
                      make_mesh(num_shards=2, device="cpu"), device="cpu")
    jdoc = JaxQueryEngine(parts, JaxServeConfig(**CFG),
                          mesh=jax_make_mesh(data_parallel=1, num_shards=2,
                                             devices=jax.devices()[:2]))
    assert doc._doc and jdoc._doc
    kms = _kmers(corpus, 20, 15, seed=9, min_len=3)
    for both in (False, True):
        got = doc.query_batch(kms, both)
        assert ([dataclasses.asdict(r) for r in got]
                == [dataclasses.asdict(r) for r in jdoc.query_batch(kms,
                                                                  both)])
        assert [r.count for r in doc.count_batch(kms, both)] == [
            2 * r.count for r in engine.count_batch(kms, both)]
    dp2 = QueryEngine(engine.packed, ServeConfig(num_shards=2, data_parallel=2),
                      mesh=Mesh(shape={"dp": 2, "shard": 2}, device="cpu"),
                      device="cpu")
    kms = ["ACGTA", "TTGCA", "GATTACA"]
    assert ([r.count for r in dp2.count_batch(kms)]
            == [r.count for r in engine.count_batch(kms)])


def test_cli_build_and_query_match_jax_cli(tmp_path, capsys):
    out = tmp_path / "idx"
    assert cli.main(["build", "--config", "tiny", "--out", str(out)]) == 0
    kms = ["ACGTACGTAC", "GGGCCCAAAT", "TTTTT"]
    capsys.readouterr()
    assert cli.main(["query", "--index", str(out), "--device", "cpu",
                     "--both-strands", "--kmer", *kms]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert jax_cli.main(["query", "--index", str(out), "--both-strands",
                         "--kmer", *kms]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == want and [g["kmer"] for g in got] == kms


def test_cli_both_strands_beyond_16_kmers(tmp_path, capsys, engines):
    """The JAX CLI sizes its batch to the k-mers before the reverse
    complements are added, so more than 16 fail there; the port sizes it
    to both strands."""
    _, jax_engine, _ = engines
    out = tmp_path / "idx"
    cli.main(["build", "--config", "small", "--out", str(out)])
    kms = [f"ACGTACGTA{c}" for c in "ACGT" * 5]
    capsys.readouterr()
    assert cli.main(["query", "--index", str(out), "--device", "cpu",
                     "--both-strands", "--kmer", *kms]) == 0
    got = [json.loads(x)["count"] for x in capsys.readouterr().out.splitlines()]
    want = jax_engine.count_batch(kms, both_strands=True)
    assert got == [r.count for r in want]


# ------------------------------------------------------------ full answers


def _same_results(got, want):
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want
    ]


@pytest.fixture(scope="module")
def cohort_packed():
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    packed = build_index(
        corpus.reads, sample_ids=corpus.sample_ids,
        sample_names=[f"s{i:03d}" for i in range(128)],
    )
    return corpus, packed


def _pair(packed, **cfg):
    return (JaxQueryEngine(packed, JaxServeConfig(**cfg)),
            QueryEngine(packed, ServeConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("mode", ["hits", "hist", "both strands"])
def test_query_batch_single_sample_matches_jax(engines, mode):
    """One sample: the histogram is the count (the single-sample
    shortcut); hits resolve through dsa."""
    corpus, jax_engine, engine = engines
    assert engine._ns == 1 and engine.index.dsa is not None
    kms = _kmers(corpus, 200, 15, seed=21) + ["ACGTA", "AATT"]
    kw = dict(include_hits=mode != "hist", both_strands=mode == "both strands")
    got = engine.query_batch(kms, **kw)
    _same_results(got, jax_engine.query_batch(kms, **kw))
    assert any(r.hits for r in got) or mode == "hist"


# dropped tiers → the walk the engine then resolves and sweeps through.
# On the CPU no budget binds, so the planner keeps lf beside fused and lf
# serves (select_walk: dsa > lf > fused > marks > slow)
PLANS = {(): "dsa", ("dsa",): "lf", ("dsa", "lf"): "fused",
         ("dsa", "fused"): "lf", ("dsa", "fused", "lf"): "marks",
         ("dsa", "fused", "marks", "lf"): "slow"}


@pytest.mark.parametrize("tiers", list(PLANS))
@pytest.mark.parametrize("mode", ["hits", "hist", "both strands"])
def test_query_batch_cohort_matches_jax(cohort_packed, tiers, mode):
    """128 samples: exact per-sample histograms through the dsa walk, or
    through the walk the other plans leave (with the row-budget compaction)
    when dsa is dropped: lf, fused (the chr20 serving profile), marks (the
    whole-genome per-shard profile) and slow."""
    corpus, packed = cohort_packed
    # the plain slow sweep walks max_read_len steps a window: a small cap
    cap = dict(max_sweep_rows=4096) if PLANS[tiers] == "slow" else {}
    jax_engine, engine = _pair(
        packed, batch_size=256, small_batch_sizes=(16,), max_hits=8,
        drop_tiers=tiers, resolve_budget_frac=0.05, **cap,
    )
    assert walk_kind(engine.index) == PLANS[tiers]
    kms = [jax_alphabet.decode(k) for k in
           jax_simulate.sample_query_kmers(corpus, 100, 31, seed=22,
                                           miss_frac=0.1)]
    kms += ["ACGTAC", "GGATC", "TTAGA"]  # short: many hits, past the cap
    kw = dict(include_hits=mode != "hist", both_strands=mode == "both strands")
    got = engine.query_batch(kms, **kw)
    _same_results(got, jax_engine.query_batch(kms, **kw))
    assert any(len(r.sample_hist) > 1 for r in got)
    if mode == "hits" and tiers:  # the row budget dropped hits
        assert sum(len(r.hits) for r in got) < sum(
            min(r.count, 8) for r in got)


def test_query_batch_dense_fallback_matches_jax(cohort_packed):
    """Short k-mers hit far more than COMPACT_PER_QUERY lanes per query, so
    both the histogram and the hit pack overflow to the dense buffers."""
    corpus, packed = cohort_packed
    jax_engine, engine = _pair(packed, batch_size=64, small_batch_sizes=())
    kms = ["".join(p) for p in itertools.product("ACGT", repeat=3)]
    for include_hits in (True, False):
        got = engine.query_batch(kms, include_hits=include_hits)
        _same_results(got, jax_engine.query_batch(kms,
                                                  include_hits=include_hits))
    assert engine.pack_stats == jax_engine.pack_stats
    assert engine.pack_stats["hits_dense_fallbacks"] == 1
    assert engine.pack_stats["hist_dense_fallbacks"] == 2


@pytest.mark.parametrize("include_hits", [True, False])
def test_capped_histogram_matches_jax(cohort_packed, include_hits):
    """exact_attribution=False: the histogram covers the resolved (capped)
    hits, complete only when every interval row resolved."""
    corpus, packed = cohort_packed
    jax_engine, engine = _pair(packed, batch_size=64, max_hits=4,
                               exact_attribution=False, drop_tiers=("dsa",),
                               resolve_budget_frac=0.2)
    kms = [jax_alphabet.decode(k) for k in
           jax_simulate.sample_query_kmers(corpus, 40, 31, seed=23)]
    kms += ["ACGTAC", "GGATC"]
    got = engine.query_batch(kms, include_hits=include_hits)
    _same_results(got, jax_engine.query_batch(kms, include_hits=include_hits))
    assert not all(r.sample_hist_complete for r in got)


def test_sweep_cap_and_both_strands_fold_match_jax(cohort_packed):
    """A max_sweep_rows cap cuts the sweep off: complete=False one strand
    at a time; folded over both strands the flag reads True in both
    packages (the reference drops it; ROADMAP.md §3)."""
    corpus, packed = cohort_packed
    jax_engine, engine = _pair(packed, batch_size=16, small_batch_sizes=(),
                               max_sweep_rows=16, sweep_window=16)
    kms = ["ACGTAC", "GGATCC"]
    for both in (False, True):
        got = engine.query_batch(kms, include_hits=False, both_strands=both)
        _same_results(got, jax_engine.query_batch(
            kms, include_hits=False, both_strands=both))
        assert all(r.count > 16 for r in got)
        assert [r.sample_hist_complete for r in got] == [both, both]


@pytest.mark.parametrize("mode", ["count", "hist", "full"])
def test_dispatch_single_buffers_match_jax(cohort_packed, mode):
    """The dense per-batch buffers a multi-partition front merges: [W, 3],
    [W, 4+NS] or [W, 4+NS+3H], equal to the JAX engine's, and unpacked
    alike."""
    corpus, packed = cohort_packed
    jax_engine, engine = _pair(packed, batch_size=64, small_batch_sizes=(),
                               max_hits=8)
    kms = [jax_alphabet.decode(k) for k in
           jax_simulate.sample_query_kmers(corpus, 40, 31, seed=24)]
    kms += ["ACGTAC", "GGATC"]
    codes, lengths, nq = engine._pad_encode(kms)
    got = engine._dispatch_single(codes, lengths, nq, mode,
                                  bad=engine._new_bad()).numpy()
    want = np.asarray(jax_engine._dispatch_single(codes, lengths, nq, mode))
    np.testing.assert_array_equal(got, want)
    if mode != "hist":
        g = engine._unpack_single(got[:nq], counts_only=mode == "count")
        w = jax_engine._unpack_single(want[:nq], mode == "count")
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])


def test_refused_query_raises_in_the_engine(engines, monkeypatch):
    """A refused query (a code the encoder cannot produce, put in after it)
    raises ``ValueError`` on every answer tier; on the CPU at the search,
    with the counter left at 0 (the card's deferred count is in
    test_torch_kernels.py)."""
    _, _, engine = engines
    kms = ["ACGTACGTACGTAC"] * 3
    codes, lengths, nq = engine._pad_encode(kms)
    codes[1, 0] = 7
    bad = engine._new_bad()
    for mode in ("count", "hist", "full"):
        with pytest.raises(ValueError, match="1 queries hold a code"):
            engine._dispatch_single(codes, lengths, nq, mode, bad=bad)
    assert int(bad) == 0
    real = engine._pad_encode

    def pad_encode_one_bad(k):
        c, ln, n = real(k)
        c = c.copy()
        c[0, -1] = 0
        return c, ln, n

    monkeypatch.setattr(engine, "_pad_encode", pad_encode_one_bad)
    for call in (lambda: engine.count_batch(kms),
                 lambda: engine.query_batch(kms),
                 lambda: engine.query_batch(kms, include_hits=False)):
        with pytest.raises(ValueError, match="1 queries hold a code"):
            call()


def test_warmup_and_read_store_match_jax(tiny_corpus):
    reads = tiny_corpus.reads[:50]
    packed = build_index(
        reads, sample_ids=tiny_corpus.sample_ids[:50],
        read_names=[f"SRR000.{i}/1" for i in range(50)],
        read_meta=[f"flowcell=F{i % 3}".encode() for i in range(50)],
    )
    jax_engine, engine = _pair(packed, batch_size=16, max_hits=16,
                               small_batch_sizes=(4,))
    engine.warmup()
    for rid in (0, 7, 49):
        assert engine.read_sequence(rid) == jax_engine.read_sequence(rid)
        assert engine.read_name(rid) == jax_engine.read_name(rid)
        assert engine.read_meta(rid) == jax_engine.read_meta(rid)
        assert engine._sample_of(rid) == jax_engine._sample_of(rid)
    bare = QueryEngine(build_index(reads), device="cpu")
    assert bare.read_name(3) == "read_3" and bare.read_meta(3) is None
    assert bare.sample_names == ["sample_0"]


@pytest.mark.parametrize("flags", [["--hits"], ["--samples"],
                                   ["--hits", "--samples", "--both-strands"]])
def test_cli_query_hits_samples_match_jax_cli(tmp_path, capsys, flags):
    out = tmp_path / "idx"
    assert cli.main(["build", "--config", "tiny", "--out", str(out)]) == 0
    kms = ["ACGTACGTAC", "GGGCCCAAAT", "TTTTT", "ACGT"]
    capsys.readouterr()
    assert cli.main(["query", "--index", str(out), "--device", "cpu",
                     *flags, "--kmer", *kms]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert jax_cli.main(["query", "--index", str(out), *flags,
                         "--kmer", *kms]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == want and [g["kmer"] for g in got] == kms
    assert ("hits" in got[0]) == ("--hits" in flags)
