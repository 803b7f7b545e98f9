"""Port's cohort front (index/cohort.py and serve/engine.py ``MultiEngine``)
against the JAX package's on the same cohort directories: both packages'
``build_cohort`` write the same files and read each other's; the port's
``MultiEngine`` on the CPU gives the JAX ``MultiEngine``'s answers exactly
(counts, int64 sums past 2^31, hit sets with global read ids, histograms,
``hits_truncated``, the histogram tier's trunc flag,
``sample_hist_complete``, both strands, the dense fallbacks,
``pack_stats``, the pipelined bulk paths) and the monolithic engine's; and
the port's CLI builds and serves a cohort as the JAX CLI does."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from readserver_tpu import alphabet as jax_alphabet
from readserver_tpu import cli as jax_cli
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.index import build_index as jax_build_index
from readserver_tpu.index import cohort as jax_cohort
from readserver_tpu.serve import MultiEngine as JaxMultiEngine
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import cli
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.index import build_index, cohort
from readserver_tpu_torch.oracle import naive_count
from readserver_tpu_torch.serve import MultiEngine, QueryEngine
from readserver_tpu_torch.serve.engine import _copy_out
from torch_common import thaw_heap  # noqa: F401 (autouse)

SHARDS = 4


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_index(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "config":
            assert x.to_json() == y.to_json()
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _decode(kms):
    return [jax_alphabet.decode(k) for k in kms]


def _setup(corpus, names, root):
    """The corpus in SHARDS doc shards, built by each package → (corpus,
    port's partitions, JAX partitions, port's dir, JAX's dir)."""
    dirs = []
    for build in (cohort.build_cohort, jax_cohort.build_cohort):
        dirs.append(build(corpus.reads, corpus.sample_ids, SHARDS,
                          root / f"pop{len(dirs)}", sample_names=names))
    port = cohort.load_cohort(dirs[0], mmap=False)[0]
    orig = jax_cohort.load_cohort(dirs[1], mmap=False)[0]
    return corpus, port, orig, dirs[0], dirs[1]


@pytest.fixture(scope="module")
def tiny4(tiny_corpus, tmp_path_factory):
    """``cohort_setup`` of tests/test_cohort_build.py: tiny in 4 shards."""
    return _setup(tiny_corpus, None, tmp_path_factory.mktemp("tiny4"))


@pytest.fixture(scope="module")
def cohort4(tmp_path_factory):
    """The 128-sample cohort of tests/test_torch_engine.py in 4 shards."""
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    return _setup(corpus, [f"s{i:03d}" for i in range(128)],
                  tmp_path_factory.mktemp("cohort4"))


SETUPS = ["tiny4", "cohort4"]


def _kmers(corpus, n, seed):
    kms = _decode(jax_simulate.sample_query_kmers(
        corpus, n, corpus.spec.kmer_len, seed=seed, miss_frac=0.2))
    # short ones: many hits, past the cap, and below the LUT's order
    return kms + ["ACGTAC", "GGATC", "TTAG", "ACG"]


def _asdicts(results):
    return [dataclasses.asdict(r) for r in results]


def _pair(parts, orig, **cfg):
    return (MultiEngine(parts, ServeConfig(**cfg), device="cpu"),
            JaxMultiEngine(orig, JaxServeConfig(**cfg)))


CFG = dict(batch_size=128, max_hits=16, small_batch_sizes=(16,))


@pytest.fixture(scope="module")
def engines(request):
    """setup name → (corpus, port MultiEngine, JAX MultiEngine, port's
    monolithic QueryEngine), built once per module."""
    made = {}

    def get(name):
        if name not in made:
            corpus, parts, orig, _, _ = request.getfixturevalue(name)
            names = parts[0].sample_names
            mono = QueryEngine(
                build_index(corpus.reads, sample_ids=corpus.sample_ids,
                            sample_names=names),
                ServeConfig(**CFG), device="cpu")
            made[name] = (corpus, *_pair(parts, orig, **CFG), mono)
        return made[name]

    return get


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("setup", SETUPS)
def test_build_cohort_matches_jax(request, setup):
    """Both packages' ``build_cohort`` write the same manifest and shard
    files byte for byte, and each package's ``load_cohort`` reads the
    other's directory into the same partitions."""
    _, port, orig, port_dir, jax_dir = request.getfixturevalue(setup)
    assert cohort.is_cohort(port_dir) and jax_cohort.is_cohort(jax_dir)
    assert _files(port_dir) == _files(jax_dir)
    manifest = json.loads((port_dir / cohort.COHORT_MANIFEST).read_text())
    assert manifest["num_shards"] == SHARDS == len(port)
    for a, b in zip(port, orig):
        _same_index(a, b)
    for a, b in zip(cohort.load_cohort(jax_dir)[0],
                    jax_cohort.load_cohort(port_dir)[0]):
        _same_index(a, b)


def test_build_cohort_stream_matches_jax(tiny_corpus, tmp_path):
    """The one-pass streaming build: the same shards, progress log and
    manifest from both packages."""
    reads = tiny_corpus.reads
    budget = sum(len(r) for r in reads) // 5
    ns = int(np.max(tiny_corpus.sample_ids)) + 1
    for build, out in ((cohort.build_cohort_stream, tmp_path / "port"),
                       (jax_cohort.build_cohort_stream, tmp_path / "jax")):
        build(((r, int(s)) for r, s in zip(reads, tiny_corpus.sample_ids)),
              out, budget, ns)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    parts, manifest = cohort.load_cohort(tmp_path / "port")
    assert manifest["num_shards"] == len(parts) >= 5
    assert sum(p.num_reads for p in parts) == len(reads)


# ---------------------------------------------------------- full answers


MODES = {"hits": dict(), "hist": dict(include_hits=False),
         "hits, both strands": dict(both_strands=True),
         "hist, both strands": dict(include_hits=False, both_strands=True)}


@pytest.mark.parametrize("mode",
                         [*MODES, "count", "count, both strands"])
@pytest.mark.parametrize("setup", SETUPS)
def test_multi_engine_matches_jax_and_monolithic(engines, setup, mode):
    """Exact against the JAX MultiEngine; against the monolithic engine
    (``test_multi_engine_matches_monolithic``): equal counts and
    histograms, equal hit sets (global read ids) where neither truncates,
    and every hit's read text through the cohort's cold store."""
    corpus, port, jax_multi, mono = engines(setup)
    kms = _kmers(corpus, 40, seed=92)
    if mode.startswith("count"):
        kw = dict(both_strands="both" in mode)
        got = port.count_batch(kms, **kw)
        assert _asdicts(got) == _asdicts(jax_multi.count_batch(kms, **kw))
        assert [r.count for r in got] == [
            r.count for r in mono.count_batch(kms, **kw)]
        assert all(r.interval is None for r in got)
        return
    kw = MODES[mode]
    got = port.query_batch(kms, **kw)
    assert _asdicts(got) == _asdicts(jax_multi.query_batch(kms, **kw))
    key = lambda h: (h["read_id"], h["offset"], h.get("strand"))  # noqa: E731
    for rx, rm in zip(got, mono.query_batch(kms, **kw)):
        assert rx.count == rm.count
        assert rx.sample_hist == rm.sample_hist
        if not (rx.hits_truncated or rm.hits_truncated):
            assert sorted(map(key, rx.hits)) == sorted(map(key, rm.hits))
    hits = [h for r in got for h in r.hits]
    assert bool(hits) == ("hits" in mode)
    for h in hits[:50]:
        assert port.read_sequence(h["read_id"]) == jax_alphabet.decode(
            corpus.reads[h["read_id"]])
        assert h["sample_id"] == int(corpus.sample_ids[h["read_id"]])
    assert any(r.hits_truncated for r in got)
    if setup == "cohort4":
        assert any(len(r.sample_hist) > 1 for r in got)


@pytest.mark.parametrize("setup", SETUPS)
def test_hist_only_mode_matches_full(engines, setup):
    """The /samples tier gives the full tier's counts, histograms and
    complete flags, and no hits."""
    corpus, port, _, _ = engines(setup)
    kms = _kmers(corpus, 20, seed=55)
    full = port.query_batch(kms)
    hist = port.query_batch(kms, include_hits=False)
    assert any(r.sample_hist for r in full)
    for a, b in zip(full, hist):
        assert (a.count, a.sample_hist, a.sample_hist_complete) == (
            b.count, b.sample_hist, b.sample_hist_complete)
        assert b.hits == []


@pytest.mark.parametrize("setup", SETUPS)
def test_compact_overflow_fallback_and_pack_stats(request, engines, setup,
                                                  monkeypatch):
    """A sparse budget of 1 entry per query overflows to the dense device
    buffers: the answers stay those of the fitting budget and of the JAX
    package, and ``pack_stats`` counts the same batches, bytes and
    fallbacks as the JAX package's (``test_multi_engine_compact_overflow_
    fallback``, ``test_pack_stats_accounting``)."""
    corpus, port, _, _ = engines(setup)
    _, parts, orig, _, _ = request.getfixturevalue(setup)
    kms = _kmers(corpus, 12, seed=31)
    ref = {h: port.query_batch(kms, include_hits=h) for h in (True, False)}
    monkeypatch.setattr(MultiEngine, "COMPACT_PER_QUERY", 1)
    monkeypatch.setattr(JaxMultiEngine, "COMPACT_PER_QUERY", 1)
    tiny, jax_tiny = _pair(parts, orig, **CFG)
    for h in (True, False):
        got = tiny.query_batch(kms, include_hits=h)
        assert _asdicts(got) == _asdicts(ref[h])
        assert _asdicts(got) == _asdicts(jax_tiny.query_batch(
            kms, include_hits=h))
    assert tiny.pack_stats == jax_tiny.pack_stats
    s = tiny.pack_stats
    assert s["batches"] == 2 and s["dense_bytes"] > 0
    # one sample in tiny4: a histogram holds one entry a query and fits
    assert s["hits_dense_fallbacks"] == 1
    assert s["hist_dense_fallbacks"] == (2 if setup == "cohort4" else 0)
    assert port.pack_stats["hits_dense_fallbacks"] == 0


@pytest.mark.parametrize("setup", SETUPS)
def test_hist_tier_truncation_flag_exact(setup, request):
    """With a cap of 2, the histogram tier's ``hits_truncated`` says
    whether a follow-up hits query truncates: some partition's count > H,
    not count > partitions * H."""
    corpus, parts, orig, _, _ = request.getfixturevalue(setup)
    port, jax_multi = _pair(parts, orig, batch_size=32, max_hits=2)
    kms = _kmers(corpus, 10, seed=99)
    full = port.query_batch(kms)
    hist = port.query_batch(kms, include_hits=False)
    assert any(r.hits_truncated for r in full)
    if setup == "cohort4":  # a count past H, no partition's past it
        assert any(r.count > 2 and not r.hits_truncated for r in hist)
    assert [r.hits_truncated for r in full] == [r.hits_truncated for r in hist]
    assert _asdicts(hist) == _asdicts(jax_multi.query_batch(
        kms, include_hits=False))


@pytest.mark.parametrize("tier", ["count", "full", "hist"])
def test_merged_count_int64_no_wrap(tiny4, tier):
    """Per-partition counts of 2^31 - 5 (each fits int32) sum past 2^31 in
    the merge; the assembled count comes back exact, as in the JAX
    package (``test_merged_count_int64_no_wrap``)."""
    _, parts, orig, _, _ = tiny4
    port, jax_multi = _pair(parts, orig, batch_size=8, max_hits=4)
    W, H, nq = 8, 4, 3
    big = 2**31 - 5
    outs = []
    for e in port.engines:
        o = np.zeros((W, 4 + e._ns + 3 * H), dtype=np.int32)
        o[:, 2] = big
        o[:, 3] = 1
        o[:, 4 + e._ns :] = -1  # no hits
        outs.append(o)
    want = big * len(outs)
    assert want > 2**31
    touts = [torch.from_numpy(o) for o in outs]
    kmers = ["A" * 11] * nq
    if tier == "count":
        got = port._merge_count(touts)
        assert got.dtype == torch.int64 and got.tolist() == [want] * W
        ref = np.asarray(jax_multi._merge_count_jit(tuple(outs)))
        assert got.tolist() == ref.tolist()
        return
    bad = torch.zeros(1, dtype=torch.int32)
    with_hits = tier == "full"
    packed, h, d = port._merge_full(touts, nq, with_hits, bad)
    res = port._assemble_merged(kmers, nq, with_hits,
                                (_copy_out(packed), h, d))
    assert [r.count for r in res] == [want] * nq
    merged = jax_multi._merge_jit(tuple(outs), np.int32(nq),
                                  with_hits=with_hits)
    assert np.array_equal(packed.numpy()[:-1], np.asarray(merged[0]))
    assert _asdicts(res) == _asdicts(jax_multi._assemble_merged(
        kmers, nq, with_hits, merged))


@pytest.mark.parametrize("tier", ["count", "full", "hist"])
def test_pipelined_bulk_paths_match(engines, tier):
    """``count_batches`` and ``query_batches`` (batch i+1 queued before
    batch i is assembled) give the per-batch answers and the JAX
    package's bulk answers (``test_count_batches_pipelined_parity``)."""
    corpus, port, jax_multi, _ = engines("cohort4")
    kms = _kmers(corpus, 44, seed=77)
    batches = [kms[i : i + 16] for i in range(0, len(kms), 16)]
    if tier == "count":
        bulk, jax_bulk = port.count_batches(batches), jax_multi.count_batches(
            batches)
        one = [port.count_batch(b) for b in batches]
    else:
        h = tier == "full"
        bulk = port.query_batches(batches, include_hits=h)
        jax_bulk = jax_multi.query_batches(batches, include_hits=h)
        one = [port.query_batch(b, include_hits=h) for b in batches]
    assert [_asdicts(b) for b in bulk] == [_asdicts(b) for b in one]
    assert [_asdicts(b) for b in bulk] == [_asdicts(b) for b in jax_bulk]


def test_sweep_cap_matches_jax(cohort4):
    """``max_sweep_rows`` cuts the sweep off: incomplete histograms one
    strand at a time, folded over both strands the flag reads True in both
    packages (ROADMAP.md §3)."""
    _, parts, orig, _, _ = cohort4
    # the cap is per partition's batch: 4 rows stop every partition's
    # sweep inside the first query's interval
    port, jax_multi = _pair(parts, orig, batch_size=16, small_batch_sizes=(),
                            max_sweep_rows=4, sweep_window=4)
    kms = ["ACGTAC", "GGATCC"]
    for both in (False, True):
        got = port.query_batch(kms, include_hits=False, both_strands=both)
        assert _asdicts(got) == _asdicts(jax_multi.query_batch(
            kms, include_hits=False, both_strands=both))
        assert all(r.count > 16 for r in got)
        assert [r.sample_hist_complete for r in got] == [both, both]


def test_narrower_partition_sample_space_matches_jax(tiny_corpus):
    """A partition whose sample space is a prefix of the cohort's adds its
    histogram into the first columns only."""
    reads, n = tiny_corpus.reads, len(tiny_corpus.reads) // 2
    sids = np.arange(len(reads), dtype=np.int32) % 4
    a = jax_build_index(reads[:n], sample_ids=sids[:n] % 2,
                        sample_names=["w", "x"])
    b = jax_build_index(reads[n:], sample_ids=sids[n:],
                        sample_names=["w", "x", "y", "z"])
    port, jax_multi = _pair([a, b], [a, b], batch_size=32, max_hits=8)
    assert [e._ns for e in port.engines] == [2, 4] and port._ns == 4
    assert port.sample_names == ["w", "x", "y", "z"]
    kms = _kmers(tiny_corpus, 20, seed=4)
    got = port.query_batch(kms, include_hits=False)
    assert _asdicts(got) == _asdicts(jax_multi.query_batch(
        kms, include_hits=False))
    assert {s for r in got for s in r.sample_hist} == {"w", "x", "y", "z"}


def test_engines_reject_mismatched_sample_spaces(tiny_corpus):
    a = build_index(tiny_corpus.reads[:40], sample_names=["donor_a"])
    b = build_index(tiny_corpus.reads[40:80], sample_names=["donor_b"])
    with pytest.raises(ValueError, match="GLOBAL sample-id space") as got:
        MultiEngine([a, b], ServeConfig(batch_size=8), device="cpu")
    with pytest.raises(ValueError) as want:
        JaxMultiEngine([a, b], JaxServeConfig(batch_size=8))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no partitions"):
        MultiEngine([], device="cpu")


def test_refused_queries_raise_at_the_merged_copy(tiny4, monkeypatch):
    """The merged buffer's last word is the partitions' summed refused-
    query count, and the one copy raises on it; on the CPU each
    partition's search raises at once, on every tier."""
    _, parts, _, _, _ = tiny4
    port = MultiEngine(parts, ServeConfig(batch_size=16), device="cpu")
    outs = [torch.zeros((16, 4 + e._ns + 3 * port.H), dtype=torch.int32)
            for e in port.engines]
    for with_hits in (True, False):
        bad = torch.tensor([3], dtype=torch.int32)
        packed, h, d = port._merge_full(outs, 2, with_hits, bad)
        assert int(packed[-1]) == 3
        with pytest.raises(ValueError, match="3 queries hold a code"):
            port._assemble_merged(["A", "A"], 2, with_hits,
                                  (_copy_out(packed), h, d))
    kms = ["ACGTACGTACG"] * 3
    real = port._pad_encode

    def pad_encode_one_bad(k):
        c, ln, n = real(k)
        c = c.copy()
        c[0, -1] = 0
        return c, ln, n

    monkeypatch.setattr(port, "_pad_encode", pad_encode_one_bad)
    for call in (lambda: port.count_batch(kms),
                 lambda: port.query_batch(kms),
                 lambda: port.query_batch(kms, include_hits=False)):
        with pytest.raises(ValueError, match="1 queries hold a code"):
            call()


def test_warmup_read_store_and_quirks_match_jax(tiny_corpus, tmp_path):
    """Read text, names and metadata by global id through the partition
    that holds it; no ``_sample_of`` (so ``/read`` answers no sample) and
    ``packed`` = partition 0, as in the JAX package; and every partition's
    engine plans its tiers against the whole device budget."""
    reads = tiny_corpus.reads[:120]
    names = [f"SRR000.{i}/1" for i in range(len(reads))]
    out = tmp_path / "pop"
    cohort.build_cohort(reads, None, 3, out, read_names=names)
    parts, _ = cohort.load_cohort(out, mmap=False)
    cfg = dict(batch_size=16, max_hits=16, small_batch_sizes=(4,),
               hbm_budget_gb=0.0005)
    port, jax_multi = _pair(parts, jax_cohort.load_cohort(out)[0], **cfg)
    port.warmup()
    for rid in (0, 39, 40, 119):
        assert port.read_sequence(rid) == jax_multi.read_sequence(rid)
        assert port.read_sequence(rid) == jax_alphabet.decode(reads[rid])
        assert port.read_name(rid) == jax_multi.read_name(rid) == names[rid]
        assert port.read_meta(rid) == jax_multi.read_meta(rid)
        assert port._locate(rid) == jax_multi._locate(rid)
    with pytest.raises(IndexError):
        port.read_sequence(len(reads))
    assert not hasattr(port, "_sample_of")
    assert not hasattr(jax_multi, "_sample_of")
    assert port.packed is parts[0] and port._doc
    budget = int(0.0005 * 2**30)
    assert [e.budget_bytes for e in port.engines] == [budget] * 3
    assert [e.tier_plan.keep for e in port.engines] == [
        e.tier_plan.keep for e in jax_multi.engines]
    assert any(e.tier_plan.dropped for e in port.engines)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("flags", [[], ["--hits", "--samples",
                                        "--both-strands"]])
def test_cli_doc_shards_build_and_query(tiny_corpus, tmp_path, capsys, flags):
    """``build --doc-shards 3`` then ``query``: the port's CLI answers as
    the JAX CLI does on the same cohort directory, and the counts are the
    oracle's (``test_cli_doc_shards_build_and_query``)."""
    out = tmp_path / "pop"
    assert cli.main(["build", "--config", "tiny", "--doc-shards", "3",
                     "--out", str(out)]) == 0
    assert cohort.is_cohort(out)
    assert len(cohort.load_cohort(out)[0]) == 3
    kms = [jax_alphabet.decode(tiny_corpus.reads[0][:11]), "ACGTACGTAC",
           "GGGCCCAAAT", "ACGT"]
    capsys.readouterr()
    assert cli.main(["query", "--index", str(out), "--device", "cpu",
                     *flags, "--kmer", *kms]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert jax_cli.main(["query", "--index", str(out), *flags,
                         "--kmer", *kms]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == want and [g["kmer"] for g in got] == kms
    if not flags:
        assert [g["count"] for g in got] == [
            naive_count(tiny_corpus.reads, k) for k in kms]
