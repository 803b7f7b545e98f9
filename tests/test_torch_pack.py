"""The served answer's sparse pack (K8) and the cohort merge with its pack
(``ops/pack.py``): the plain forms against the JAX package's
``sparse_pack_device`` and ``MultiEngine._merge_full``, word for word.

The same seeded NumPy inputs go to both; the port's buffer carries the
search's refused-query count as its last word, which the JAX buffer does
not, so that word is dropped before the comparison.  Every layout of the
pack is covered (with and without ``l, u``, ``trunc``, ``count_hi`` and
hits; ``nq < W``; one and 128 samples; an overflow of either section,
where n is -1 and the first R kept entries fill the slots), and the merge
on the 128-sample cohort in 4 partitions (both tiers, the partitions'
narrower sample spaces, counts whose sum passes 2^31).  The kernels are
held against these plain forms on the card (tests/test_torch_kernels.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readserver_tpu import alphabet as jax_alphabet
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.index import build_index as jax_build_index
from readserver_tpu.index import cohort as jax_cohort
from readserver_tpu.serve import MultiEngine as JaxMultiEngine
from readserver_tpu.serve.engine import sparse_pack_device
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.index import build_index, cohort
from readserver_tpu_torch.ops import pack
from readserver_tpu_torch.serve import MultiEngine
from readserver_tpu_torch.serve.engine import _copy_out

CPQ = 16


def _answer(W, NS, H, density, seed):
    """Seeded inputs of one answer: l, u, complete, hist, rid, off, smp."""
    rng = np.random.default_rng(seed)
    l = rng.integers(0, 1 << 20, W).astype(np.int32)
    u = (l + rng.integers(0, 200, W)).astype(np.int32)
    comp = rng.random(W) < 0.8
    hist = np.where(rng.random((W, NS)) < density,
                    rng.integers(1, 50, (W, NS)), 0).astype(np.int32)
    rid = np.where(rng.random((W, H)) < density,
                   rng.integers(0, 1 << 24, (W, H)), -1).astype(np.int32)
    off = rng.integers(0, 150, (W, H)).astype(np.int32)
    smp = rng.integers(0, max(NS, 1), (W, H)).astype(np.int32)
    return l, u, comp, hist, rid, off, smp


def _both(l, u, comp, hist, rid, off, smp, nq, lu, trunc, hi, hits):
    """(the JAX buffer, the port's plain buffer without its last word, the
    port's dense fallbacks, JAX's) for one layout."""
    count = u - l
    kw = {}
    if lu:
        kw.update(l=l, u=u)
    if trunc:
        kw["trunc"] = count > 8
    if hi:
        kw["count_hi"] = (count >> 3).astype(np.int32)
    hit = (rid, off, smp) if hits else (None, None, None)
    want = sparse_pack_device(
        jnp.asarray(count), jnp.asarray(comp), jnp.asarray(hist),
        *(None if h is None else jnp.asarray(h) for h in hit), nq, CPQ,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    bad = torch.tensor([5], dtype=torch.int32)
    got = pack.sparse_pack_plain(
        torch.from_numpy(count), torch.from_numpy(comp),
        torch.from_numpy(hist),
        *(None if h is None else torch.from_numpy(h) for h in hit), nq, CPQ,
        bad, **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    assert int(got[0][-1]) == 5
    return want, got


LAYOUTS = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("lu, trunc, hi, hits", LAYOUTS, ids=[
    "-".join(n for n, on in zip(("lu", "trunc", "hi", "hits"), f) if on)
    or "bare" for f in LAYOUTS])
@pytest.mark.parametrize("W, NS, nq", [(64, 1, 64), (48, 128, 20)],
                         ids=["NS1", "NS128-nq<W"])
def test_sparse_pack_plain_matches_jax(lu, trunc, hi, hits, W, NS, nq):
    """Every layout, at one sample and 128, nq = W and nq < W: the packed
    buffers equal word for word, and the dense fallbacks."""
    cols = _answer(W, NS, 8, 0.05, seed=W + NS + 2 * lu + 3 * hits)
    want, got = _both(*cols, nq, lu, trunc, hi, hits)
    assert np.array_equal(got[0][:-1].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    if hits:
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    else:
        assert got[2] is None and want[2] is None


def _n_fields(buf, W, R, lu, trunc, hi, hits):
    """(n_hist, n_hits or None) of a packed buffer."""
    p = W * (2 + lu * 2 + trunc + hi)
    return int(buf[p]), (int(buf[p + 1 + 2 * R]) if hits else None)


@pytest.mark.parametrize("section", ["hist", "hits", "both"])
@pytest.mark.parametrize("nq", [40, 25])
def test_sparse_pack_plain_overflow_matches_jax(section, nq):
    """More than R = 16 W kept entries in a section: n is -1 and the first
    R kept entries in flat order fill the slots, as in JAX."""
    W, NS, H = 40, 128, 64
    dens = {"hist": (0.3, 0.01), "hits": (0.01, 0.5), "both": (0.4, 0.5)}
    cols = list(_answer(W, NS, H, dens[section][0], seed=nq))
    rid = _answer(W, NS, H, dens[section][1], seed=nq + 1)[4]
    cols[4] = rid
    want, got = _both(*cols, nq, True, False, False, True)
    buf = got[0][:-1].numpy()
    assert np.array_equal(buf, np.asarray(want[0]))
    n_hist, n_hits = _n_fields(buf, W, CPQ * W, True, False, False, True)
    assert (n_hist == -1) == (section != "hits")
    assert (n_hits == -1) == (section != "hist")


@pytest.mark.parametrize("with_hits", [True, False])
def test_pack_answer_plain_is_the_engines_pack(with_hits):
    """``pack_answer``'s plain form is ``sparse_pack_plain`` of u - l with
    l, u, and on the histogram tier the trunc flag of the hit cap."""
    l, u, comp, hist, rid, off, smp = (torch.from_numpy(x) for x in _answer(
        32, 3, 8, 0.2, seed=3))
    hit = (rid, off, smp) if with_hits else (None, None, None)
    bad = torch.zeros(1, dtype=torch.int32)
    got = pack.pack_answer(l, u, comp, hist, *hit, 30, CPQ, bad, 8)
    want = pack.sparse_pack_plain(
        u - l, comp, hist, *hit, 30, CPQ, bad, l=l, u=u,
        trunc=None if with_hits else (u - l) > 8)
    assert torch.equal(got[0], want[0])


NAMES = [f"s{i:03d}" for i in range(128)]


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The 128-sample cohort (tests/test_torch_cohort.py's) in 4 partitions,
    each package's: ``"cohort"``, the doc shards ``build_cohort`` writes
    (built by the JAX package, read by both), and ``"narrow"``, partition p
    holding the reads of samples 32p to 32p + 31 under the first 32 (p + 1)
    names of the cohort's, so their sample spaces are 32, 64, 96 and 128
    wide → name → (corpus, port's partitions, JAX's)."""
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    d = jax_cohort.build_cohort(
        corpus.reads, corpus.sample_ids, 4,
        tmp_path_factory.mktemp("pack") / "pop", sample_names=NAMES)
    out = {"cohort": (corpus, cohort.load_cohort(d, mmap=False)[0],
                      jax_cohort.load_cohort(d, mmap=False)[0])}
    ids = np.asarray(corpus.sample_ids)
    port, orig = [], []
    for p in range(4):
        sel = np.flatnonzero(ids // 32 == p)
        reads = [corpus.reads[i] for i in sel]
        for build, into in ((build_index, port), (jax_build_index, orig)):
            into.append(build(reads, sample_ids=ids[sel],
                              sample_names=NAMES[:32 * (p + 1)]))
    out["narrow"] = (corpus, port, orig)
    return out


def _merges(parts, orig, outs, nq, with_hits, H=8):
    """(port's MultiEngine, its merge, JAX's) of the same partition
    buffers."""
    port = MultiEngine(parts, ServeConfig(batch_size=64, max_hits=H),
                       device="cpu")
    jm = JaxMultiEngine(orig, JaxServeConfig(batch_size=64, max_hits=H))
    bad = torch.zeros(1, dtype=torch.int32)
    got = port._merge_full([torch.from_numpy(o) for o in outs], nq,
                           with_hits, bad)
    want = jm._merge_jit(tuple(outs), np.int32(nq), with_hits=with_hits)
    return port, got, want


@pytest.mark.parametrize("with_hits", [True, False], ids=["full", "hist"])
@pytest.mark.parametrize("nq", [64, 37])
@pytest.mark.parametrize("setup", ["cohort", "narrow"])
def test_merge_plain_matches_jax_on_served_buffers(cohorts, setup, with_hits,
                                                   nq):
    """The 4 partitions' own dense buffers of a served batch (the port's
    engines on the CPU), merged and packed by both packages: the buffers
    and the dense fallbacks equal."""
    corpus, parts, orig = cohorts[setup]
    port = MultiEngine(parts, ServeConfig(batch_size=64, max_hits=8),
                       device="cpu")
    assert port._ns == 128 and [e._ns for e in port.engines] == (
        [128] * 4 if setup == "cohort" else [32, 64, 96, 128])
    kms = [jax_alphabet.decode(k) for k in jax_simulate.sample_query_kmers(
        corpus, nq - 2, corpus.spec.kmer_len, seed=nq,
        miss_frac=0.2)] + ["ACGTAC", "GGATC"]
    codes, lengths, n = port._pad_encode(kms)
    bad = port._new_bad()
    mode = "full" if with_hits else "hist"
    outs = [e._dispatch_single(codes, lengths, n, mode, bad=bad).numpy()
            for e in port.engines]
    _, got, want = _merges(parts, orig, outs, n, with_hits)
    assert np.array_equal(got[0][:-1].numpy(), np.asarray(want[0]))
    assert np.array_equal(pack.dense(got[1]).numpy(), np.asarray(want[1]))
    if with_hits:
        assert np.array_equal(pack.dense(got[2]).numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("with_hits", [True, False], ids=["full", "hist"])
@pytest.mark.parametrize("case", ["past 2^31", "overflow"])
@pytest.mark.parametrize("setup", ["cohort", "narrow"])
def test_merge_plain_matches_jax_synthetic(cohorts, setup, with_hits, case):
    """Seeded partition buffers at the partitions' sample spaces: counts of
    2^31 - 5 each (their sum passes 2^31, shipped in two lanes), or dense
    enough that both sections overflow; the histogram tier's trunc flag
    from counts past H."""
    _, parts, orig = cohorts[setup]
    W, H = 64, 8
    rng = np.random.default_rng(len(case) + with_hits + len(setup))
    dens = 0.6 if case == "overflow" else 0.002
    ns = [MultiEngine(parts, ServeConfig(batch_size=64, max_hits=H),
                      device="cpu").engines[p]._ns for p in range(4)]
    outs = []
    for n in ns:
        o = np.zeros((W, 4 + n + (3 * H if with_hits else 0)), np.int32)
        o[:, 0] = rng.integers(0, 1000, W)
        o[:, 2] = (2**31 - 5 if case == "past 2^31"
                   else rng.integers(0, 2 * H, W))
        o[:, 3] = rng.random(W) < 0.8
        o[:, 4:4 + n] = np.where(rng.random((W, n)) < dens,
                                 rng.integers(1, 9, (W, n)), 0)
        if with_hits:
            o[:, 4 + n:4 + n + H] = np.where(
                rng.random((W, H)) < (0.9 if case == "overflow" else 0.1),
                rng.integers(0, 5000, (W, H)), -1)
            o[:, 4 + n + H:] = rng.integers(0, 90, (W, 2 * H))
        outs.append(o)
    port, got, want = _merges(parts, orig, outs, 50, with_hits, H)
    buf = got[0][:-1].numpy()
    assert np.array_equal(buf, np.asarray(want[0]))
    assert np.array_equal(pack.dense(got[1]).numpy(), np.asarray(want[1]))
    R = CPQ * W
    n_hist = int(buf[W * (3 + (not with_hits))])
    if case == "past 2^31":
        count = buf[:W].astype(np.int64) + (buf[W:2 * W].astype(np.int64)
                                            << 31)
        assert (count == 4 * (2**31 - 5)).all()
        assert n_hist >= 0
        res = port._assemble_merged(["A"] * 50, 50, with_hits,
                                    (_copy_out(got[0]), got[1], got[2]))
        assert [r.count for r in res] == [4 * (2**31 - 5)] * 50
    else:
        assert n_hist == -1
        if with_hits:
            assert int(buf[W * 3 + 1 + 2 * R]) == -1
