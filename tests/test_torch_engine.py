"""Port's QueryEngine count path against the JAX package's QueryEngine on
the same PackedIndex: tiered widths 1 and 256, uniform and mixed lengths
(k-step, LUT and plain routes), both strands — and the port's CLI."""

import json

import numpy as np
import pytest

from readserver_tpu import cli as jax_cli
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import build_index
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch import cli
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.serve import QueryEngine, rc_string

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
    _, _, engine = engines
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.query_batch(["ACGT"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QueryEngine([engine.packed, engine.packed], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QueryEngine(engine.packed, mesh=object(), device="cpu")


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
