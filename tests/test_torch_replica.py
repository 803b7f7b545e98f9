"""The m-fold replica of a packed index (``scripts/torch_build_replica.py``)
against the builders and engines it stands in for, on the tiny (and
small) corpus at m = 2 and 3.

Copy j of read i is read m·i + j, in sample j.  ``replicate_packed`` must
equal, array for array, the port's and the JAX package's ``build_index``
over the repeated reads; a CPU ``QueryEngine`` on it must answer count, ``/reads``
and ``/samples`` as the JAX ``QueryEngine`` answers on the JAX build; and
its answers must be the source's, each count m times and each hit set
mapped, copy j in sample j (``replica_answers``), also where the row
budget and the sweep cap cut.  Tolerance 0: every value is an integer.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import build_index as jax_build_index
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.serve import QueryEngine
from readserver_tpu_torch.serve.engine import expand_rc

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from torch_build_replica import (  # noqa: E402
    expand_hits,
    fold_strands,
    replica_answers,
    replicate_packed,
)

def _payload(corpus):
    n = len(corpus.reads)
    return dict(
        read_names=[f"r{i}" * (1 + i % 3) for i in range(n)],
        read_meta=[bytes([i % 251]) * (i % 4) for i in range(n)],
    )


def _repeated(corpus, m: int) -> tuple[list, dict]:
    """Every read m times, copy j of read i as read m·i + j in sample j,
    with its name and metadata."""
    pay = _payload(corpus)
    reads = [r for r in corpus.reads for _ in range(m)]
    rep = dict(
        sample_ids=np.tile(np.arange(m, dtype=np.int32), len(corpus.reads)),
        read_names=[x for x in pay["read_names"] for _ in range(m)],
        read_meta=[x for x in pay["read_meta"] for _ in range(m)],
    )
    return reads, rep


def _same_arrays(a, b) -> list[str]:
    """Names of the PackedIndex fields where ``a`` and ``b`` differ (the
    array's dtype included)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if (x is None or y is None or np.asarray(x).dtype
                    != np.asarray(y).dtype
                    or not np.array_equal(np.asarray(x), np.asarray(y))):
                bad.append(f.name)
        elif f.name == "config":
            if x.to_json() != y.to_json():
                bad.append(f.name)
        elif x != y:
            bad.append(f.name)
    return bad


@pytest.fixture(scope="module")
def sources(tiny_corpus):
    return build_index(tiny_corpus.reads, **_payload(tiny_corpus))


# the tiny corpus packs in 64 chunks of one block, the small one in 64 of
# several: both stitch the chunks' checkpoints
@pytest.mark.parametrize("m, corpus", [(2, "tiny_corpus"), (3, "tiny_corpus"),
                                       (2, "small_corpus"),
                                       (3, "small_corpus")])
def test_replica_equals_port_build(request, m, corpus):
    c = request.getfixturevalue(corpus)
    reads, rep = _repeated(c, m)
    want = build_index(reads, **rep)
    got = replicate_packed(build_index(c.reads, **_payload(c)), m)
    assert got.n == m * (len(c.reads) + sum(len(r) for r in c.reads))
    assert got.rank3_blocks is not None and got.num_samples == m
    assert _same_arrays(got, want) == []


@pytest.mark.parametrize("m", [2, 3])
def test_replica_equals_jax_build(tiny_corpus, sources, m):
    reads, rep = _repeated(tiny_corpus, m)
    want = jax_build_index(reads, **rep)
    assert _same_arrays(replicate_packed(sources, m), want) == []


def test_replica_refuses_what_it_cannot_derive(tiny_corpus, sources):
    with pytest.raises(ValueError, match="int32 build range"):
        replicate_packed(sources, (1 << 31) // sources.n + 1)
    with pytest.raises(ValueError, match="dsa"):
        replicate_packed(dataclasses.replace(sources, dsa=None), 2)
    two = build_index(tiny_corpus.reads, sample_ids=np.arange(
        len(tiny_corpus.reads)) % 2)
    with pytest.raises(ValueError, match="one sample"):
        replicate_packed(two, 2)


def _fields(results) -> list[dict]:
    """Answers of either package's engine, field by field."""
    return [dataclasses.asdict(r) for r in results]


def _kmers(corpus, n: int, seed: int) -> list[str]:
    kms = sample_query_kmers(corpus, n, corpus.spec.kmer_len, seed=seed,
                             miss_frac=0.2)
    return ["".join("ACGT"[c - 1] for c in km) for km in kms]


# the routes: dsa (no budget), fused and marks walks under a budget that
# cuts, the lf and slow walks; the sweep capped below the batch's rows
ROUTES = {
    "dsa": (),
    "fused": ("dsa",),
    "marks": ("dsa", "fused", "lf"),
    "lf": ("dsa", "fused"),
    "slow": ("dsa", "fused", "marks", "lf"),
}
CUT = dict(batch_size=128, small_batch_sizes=(), max_hits=16,
           resolve_budget_frac=0.3, max_sweep_rows=500, sweep_window=100)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("m", [2, 3])
def test_replica_engine_matches_jax(tiny_corpus, sources, m, route):
    reads, rep = _repeated(tiny_corpus, m)
    jax_eng = JaxQueryEngine(
        jax_build_index(reads, **rep),
        JaxServeConfig(**CUT, drop_tiers=ROUTES[route]))
    eng = QueryEngine(replicate_packed(sources, m),
                      ServeConfig(**CUT, drop_tiers=ROUTES[route]),
                      device="cpu")
    kms = _kmers(tiny_corpus, 48, seed=70 + m)
    assert _fields(eng.count_batch(kms, both_strands=True)) == _fields(
        jax_eng.count_batch(kms, both_strands=True))
    for hits in (True, False):
        assert _fields(eng.query_batch(kms, both_strands=True,
                                       include_hits=hits)) == _fields(
            jax_eng.query_batch(kms, both_strands=True, include_hits=hits))
    rid = int(eng.packed.num_reads) - 1
    assert (eng.read_sequence(rid), eng.read_name(rid), eng.read_meta(rid)) \
        == (jax_eng.read_sequence(rid), jax_eng.read_name(rid),
            jax_eng.read_meta(rid))


@pytest.mark.parametrize("cut", [True, False])
@pytest.mark.parametrize("route", ["dsa", "fused", "marks"])
@pytest.mark.parametrize("m", [2, 3])
def test_replica_answers_are_the_copies(tiny_corpus, m, route, cut):
    """Each count m times the source's and each hit set the mapped one, on
    one strand and both, with the replica engine's row budget (walk
    routes) and sweep cap cutting, or neither."""
    src = build_index(tiny_corpus.reads)
    one = QueryEngine(src, ServeConfig(
        batch_size=128, small_batch_sizes=(), max_hits=16,
        resolve_budget_frac=None, max_sweep_rows=None), device="cpu")
    cfg = ServeConfig(**(CUT if cut else dict(
        CUT, resolve_budget_frac=None, max_sweep_rows=None)),
        drop_tiers=ROUTES[route])
    eng = QueryEngine(replicate_packed(src, m), cfg, device="cpu")
    kms = _kmers(tiny_corpus, 48, seed=90 + m)
    exp, back = expand_rc(kms)
    window = cfg.sweep_window
    reach = (None if cfg.max_sweep_rows is None
             else -(-cfg.max_sweep_rows // window) * window)
    budget = eng.row_budget if route != "dsa" else None
    src_one = one.query_batch(exp)
    want = replica_answers(src_one, m, cfg.max_hits, eng.sample_names,
                           cfg.batch_size, budget, reach)
    got = eng.query_batch(exp)
    assert got == want
    assert sum(r.count for r in src_one) * m > CUT["max_sweep_rows"]
    # the cuts bind where they are set: hits dropped by the budget,
    # sweeps cut by the cap
    assert any(len(w.hits) < min(w.count, cfg.max_hits)
               for w in want) == (cut and route != "dsa")
    assert all(w.sample_hist_complete for w in want) != cut
    for g, r in zip(got, src_one):
        assert g.count == m * r.count
        assert g.hits == expand_hits(r.hits, m)[:len(g.hits)]
    hist_only = eng.query_batch(exp, include_hits=False)
    assert [(r.count, r.sample_hist, r.sample_hist_complete)
            for r in hist_only] == [
        (w.count, w.sample_hist, w.sample_hist_complete) for w in want]
    assert eng.query_batch(kms, both_strands=True) == fold_strands(
        kms, want, back)
    counted = eng.count_batch(exp)
    assert [(r.count, r.interval) for r in counted] == [
        (w.count, w.interval) for w in want]
