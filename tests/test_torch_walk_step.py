"""The cross-rank walks' steps (``ops/sharded.py``'s ``lf_walk_step`` and
``slow_walk_step``, their plain forms on the CPU) against the sequence the
cross-rank program ran before them: each step a masked lookup or rank of
the run (``lookup_partial_plain``, ``occ_partial_plain``), its all-reduce,
then torch updates of the walk's state on every rank.

The ranks are threads of this process, each holding its run of the shards
as ``place_sharded`` places it; an all-reduce is a barrier and a sum of the
ranks' tensors, in their own type.  Every answer is an integer, so the
tolerance is 0: read ids, offsets and samples equal on every rank, equal to
the old sequence, to the one-device plain walk and (through the JAX
package's own sharded walk on a mesh of the simulated CPU devices) to the
JAX ``do_walk``; the all-reduces a walk equal the old sequence's, with and
without ``walk_early_exit``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from readserver_tpu import parallel as jp
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import encode_query_batch
from readserver_tpu_torch import parallel as tp
from readserver_tpu_torch.ops import sharded as sops
from readserver_tpu_torch.parallel import sharded as psh

ROUTES = {
    "lf": dict(dsa_chunk=None, dsa_bits=0),
    "slow": dict(dsa_chunk=None, dsa_bits=0, lf_chunk=None, mark_table=None,
                 spairs_chunk=None, sstarts=None, slens=None, sample_rate=0),
}


class _Group:
    """R thread ranks' all-reduce: every rank hands in its tensor, rank 0
    sums them in their type, every rank copies the sum back."""

    def __init__(self, R: int) -> None:
        self.barrier = threading.Barrier(R, timeout=120)
        self.parts = [None] * R
        self.total = None

    def reduce(self, r: int, t: torch.Tensor) -> torch.Tensor:
        self.parts[r] = t.clone()
        self.barrier.wait()
        if r == 0:
            self.total = functools.reduce(torch.add, self.parts)
        self.barrier.wait()
        t.copy_(self.total)
        self.barrier.wait()
        return t


class _Rank:
    """A thread rank's handle on its group, standing as the mesh's shard
    group: calling it all-reduces, counted."""

    def __init__(self, group: _Group, r: int) -> None:
        self.group, self.r = group, r
        self.reduces = 0

    def __call__(self, t):
        self.reduces += 1
        return self.group.reduce(self.r, t)


@pytest.fixture(autouse=True)
def _thread_all_reduce(monkeypatch):
    """parallel/sharded's all-reduce through the thread rank's handle."""
    monkeypatch.setattr(psh, "all_reduce", lambda t, group: group(t))


def _mesh(rank: _Rank) -> SimpleNamespace:
    """What ``_Run`` and ``_query_ranks`` read of a mesh."""
    return SimpleNamespace(shard_group=rank, lead=rank.r == 0)


def _lookup_sequence_resolve(run, rows, valid, walk_early_exit):
    """The cross-rank LF and slow walks and the sample lookup as they ran
    before the walk steps: a masked lookup or rank of the run a step, its
    all-reduce, then the updates in torch (``parallel/sharded.py``,
    ``_walk_ranks`` and ``_sample_ranks``, with ``occ`` and ``lookup``
    through the plain partials)."""
    s = run.s
    m = s.num_reads
    neg = torch.full(rows.shape, -1, dtype=torch.int32)

    def lookup(what, x, y=None):
        return run.reduce(sops.lookup_partial_plain(s, what, x, y))

    if sops.walk_kind(s) == "lf":
        cur, done = rows, ~valid
        steps = torch.zeros(rows.shape, dtype=torch.int32)
        for _ in range(max(s.sample_rate, 1)):
            if walk_early_exit and bool(done.all()):
                break
            raw = lookup("lf", cur.contiguous()).to(torch.int32)
            val = (raw & 0x7FFFFFFF).to(torch.int64)
            is_term = (raw < 0) | (val < m)
            step_now = ~done & ~is_term
            cur = torch.where(step_now, val, cur)
            steps = steps + step_now.to(torch.int32)
            done = done | is_term
        R = rows.shape[0]
        both = lookup("lf_mark", cur.contiguous())
        raw, slot = both[:R].to(torch.int32), both[R:]
        is_marked = raw < 0
        val = (raw & 0x7FFFFFFF).to(torch.int64)
        cat = lookup("dollar_pair", val, slot)
        rid_d = cat[:R].to(torch.int32)
        pair = cat[R:].reshape(R, 2).to(torch.int32)
        read_id = torch.where(is_marked, pair[:, 0], rid_d)
        offset = torch.where(is_marked, pair[:, 1] + steps, steps)
        ok = valid & done
        rid, off = torch.where(ok, read_id, neg), torch.where(ok, offset, neg)
    else:
        cur, done = rows, ~valid
        drank = torch.full(rows.shape, -1, dtype=torch.int64)
        offset = neg.clone()
        for t in range(s.max_read_len):
            if walk_early_exit and bool(done.all()):
                break
            cur = cur.contiguous()
            c = lookup("sym", cur).to(torch.int32)
            o = run.reduce(sops.occ_plain(s, "rank", c, cur))
            hit = (c == 0) & ~done
            drank = torch.where(hit, o, drank)
            offset = torch.where(hit, torch.full_like(offset, t), offset)
            done = done | (c == 0)
            cur = torch.where(done, cur,
                              s.C.index_select(0, c.to(torch.int64)) + o)
        rid = lookup("dollar", drank.clamp(min=0)).to(torch.int32)
        ok = valid & done
        rid, off = torch.where(ok, rid, neg), torch.where(ok, offset, neg)
    return rid, off, lookup("sample", rid.to(torch.int64)).to(torch.int32)


def _on_ranks(runs, fn, *args):
    """fn(psh._Run of the rank, *args) on every rank's thread → [(result,
    all-reduces)]."""
    group = _Group(len(runs))
    ranks = [_Rank(group, r) for r in range(len(runs))]
    out = [None] * len(runs)
    errors = []

    def go(r):
        try:
            out[r] = fn(psh._Run(runs[r], _mesh(ranks[r])), *args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(len(runs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return [(o, rank.reduces) for o, rank in zip(out, ranks)]


@pytest.fixture(scope="module")
def packed(small_corpus):
    return build_index(small_corpus.reads, sample_ids=small_corpus.sample_ids)


_HOSTS: dict = {}  # S → the module's index built in S shards


def _placed_runs(packed, S: int, R: int, route: str):
    """R ranks' runs of an S-shard index on the CPU, and the whole index,
    with the route's tiers dropped."""
    if S not in _HOSTS:
        _HOSTS[S] = tp.build_sharded(packed, S)
    host = _HOSTS[S]

    def place(ranks, r):
        s = tp.place_sharded(host, tp.Mesh(
            shape={"dp": 1, "shard": S}, device=torch.device("cpu"),
            ranks={"dp": 1, "shard": ranks}, coords={"dp": 0, "shard": r}))
        return dataclasses.replace(s, **ROUTES[route])

    return [place(R, r) for r in range(R)], place(1, 0)


def _lanes(whole, runs, rng, n_random=600):
    """Rows: random positions, every $ row, each run's first and last rows
    and its neighbours, n - 1; a quarter of the random ones invalid (row
    0); → (rows int64, valid bool)."""
    n = whole.n
    sym = sops.sym_plain(whole, torch.arange(n, dtype=torch.int64))
    dollar = torch.nonzero(sym == 0).reshape(-1)
    edges = []
    for r in runs:
        a = int(r.starts[0])
        b = int(r.starts[-1] + r.lens[-1])
        edges += [a - 1, a, a + 1, b - 2, b - 1, b]
    edges = torch.tensor([e for e in edges if 0 <= e < n] + [0, n - 1])
    rand = torch.from_numpy(rng.integers(0, n, size=n_random))
    rows = torch.cat([rand, dollar, edges]).to(torch.int64)
    valid = torch.ones(rows.shape, dtype=torch.bool)
    valid[: n_random // 4] = False
    rows = torch.where(valid, rows, 0).contiguous()
    return rows, valid


# (S shards, R ranks): one rank's run of every shard, 2 ranks of 2 shards,
# 2 ranks of 1, and 4 ranks of 2 (an empty shard or two at the end)
LAYOUTS = [(4, 1), (4, 2), (2, 2), (8, 4)]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("S, R", LAYOUTS)
@pytest.mark.parametrize("early", [False, True])
def test_walk_steps_match_lookup_sequence(packed, route, S, R, early):
    """The walk steps over whole walks (the first step, $ rows, the runs'
    edges, invalid lanes) give every rank the read ids, offsets and samples
    of the old sequence, in as many all-reduces, with and without early
    exit; both equal the one-device plain walk."""
    runs, whole = _placed_runs(packed, S, R, route)
    rows, valid = _lanes(whole, runs, np.random.default_rng(S * 7 + R))
    new = _on_ranks(runs, psh._resolve_ranks, rows, valid, early)
    old = _on_ranks(runs, _lookup_sequence_resolve, rows, valid, early)
    rid, off = sops.walk_plain(whole, rows, valid)
    want = (rid, off, sops.sample_plain(whole, rid))
    for (got, n_new), (ref, n_old) in zip(new, old):
        assert n_new == n_old
        for g, r, w in zip(got, ref, want):
            assert g.dtype == torch.int32
            assert torch.equal(g, r) and torch.equal(g, w)
    assert (want[0] >= 0).sum() > 0 and (want[0] < 0).sum() > 0
    if not early:
        steps = (max(whole.sample_rate, 1) + 3 if route == "lf"
                 else 2 * whole.max_read_len + 2)
        assert new[0][1] == steps


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("early", [False, True])
def test_walk_steps_all_lanes_done(packed, route, early):
    """No valid lane: every read id and offset -1, samples of read 0, in the
    old sequence's all-reduces: under early exit only the terminal ones
    (the LF walk's two pairs, the slow walk's $-rank read) and the
    sample's."""
    runs, whole = _placed_runs(packed, 4, 2, route)
    rows = torch.zeros(50, dtype=torch.int64)
    valid = torch.zeros(50, dtype=torch.bool)
    new = _on_ranks(runs, psh._resolve_ranks, rows, valid, early)
    old = _on_ranks(runs, _lookup_sequence_resolve, rows, valid, early)
    for (got, n_new), (ref, n_old) in zip(new, old):
        assert n_new == n_old
        if early:
            assert n_new == (3 if route == "lf" else 2)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert (got[0] == -1).all() and (got[1] == -1).all()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("budget", [None, 40])
def test_walk_steps_match_jax_program(packed, small_corpus, route, budget):
    """Through the cross-rank program on 2 thread ranks of 2 shards (early
    exit on, as the engine runs it), a query batch's intervals, read ids,
    offsets, hit validity and histograms equal the JAX sharded program on
    a (1, 2) mesh of the simulated CPU devices, with and without the row
    budget."""
    runs, _ = _placed_runs(packed, 2, 2, route)
    K = 12
    kmers = sample_query_kmers(small_corpus, 24, K, seed=11, miss_frac=0.25)
    codes, lengths = encode_query_batch(kmers, K)
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    mesh = jp.make_mesh(data_parallel=1, num_shards=2,
                        devices=jax.devices()[:2])
    js = dataclasses.replace(jp.place_sharded(jp.build_sharded(packed, 2),
                                              mesh), **ROUTES[route])
    want = jp.make_sharded_query_fn(js, mesh, max_hits=16, kstep=1,
                                    resolve_budget=budget)(
        js, None, codes, lengths)

    def query(run):
        return psh._query_ranks(
            run.s, None, torch.from_numpy(codes), torch.from_numpy(lengths),
            mesh=SimpleNamespace(shard_group=run.group, lead=run.lead),
            max_hits=16, lut_p=0, kstep=1, resolve_budget=budget,
            walk_early_exit=True)

    for out, _ in _on_ranks(runs, query):
        for k in ("l", "u", "read_id", "offset", "valid", "sample_hist",
                  "hist_complete"):
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["valid"]).any()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("early", [False, True])
def test_one_step_call_between_all_reduces(packed, route, early, monkeypatch):
    """Between two of a walk's all-reduces the program calls one walk step
    and no lookup or rank of the old sequence (on the card: one launch)."""
    runs, whole = _placed_runs(packed, 4, 1, route)
    rows, valid = _lanes(whole, runs, np.random.default_rng(3))
    calls, marks = [], []
    for name in ("lf_walk_step", "slow_walk_step", "lookup_partial",
                 "occ_partial", "step_partial"):
        monkeypatch.setattr(sops, name, functools.partial(
            lambda f, n, *a, **k: (calls.append(n), f(*a, **k))[1],
            getattr(sops, name), name))
    monkeypatch.setattr(psh, "all_reduce",
                        lambda t, group: (marks.append(len(calls)), t)[1])
    run = psh._Run(runs[0], SimpleNamespace(shard_group=None, lead=True))
    psh._resolve_ranks(run, rows, valid, early)
    assert set(calls) == {f"{route}_walk_step"}
    assert list(np.diff([0, *marks])) == [1] * len(marks)
