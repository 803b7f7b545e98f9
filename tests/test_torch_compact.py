"""K14 (the row-budget compaction and its gather back) and K15 (the capped
histogram) on the CPU: their plain forms, in every mode the served paths
use, against the JAX package.

* the single-device ``resolve_intervals(row_budget=)`` and the hit step
  (``resolve_hits``: the gather's ``read_to_sample`` column) on every walk
  tier, against the JAX ``resolve_intervals`` (and the JAX engine's clipped
  ``read_to_sample`` gather);
* the plain forms in int32 and int64 with each gather column, against
  the port's own reference (``compact_rows`` and torch scatters): the JAX
  compaction is written inline in ``resolve_intervals`` and
  ``_query_body`` and cannot be called alone, so the int64 rows and the
  walk's sample column meet the JAX package only through the interval
  program below;
* K15's sample mode against the JAX ``sample_histogram`` over an identity
  ``read_to_sample``;
* the interval-sharded program with ``resolve_budget`` on the dsa, lf and
  slow routes, capped and exact, against the JAX ``make_sharded_query_fn``.

Intervals are the searches of seeded queries with edge cases written in:
empty (0, 0) intervals, intervals wider than the hit cap, a budget of 0
(1 in the interval program, whose JAX walks do not trace an empty one),
one past every lane, one that cuts a query in the middle.  Every output is
an integer: every comparison is exact.  The ctypes signatures of the
kernels are also held against the C sources.
"""

import dataclasses
import re
import types

import jax
import numpy as np
import pytest
import torch

from readserver_tpu import parallel as jp
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.index import build_index
from readserver_tpu.ops import DeviceIndex as JaxDeviceIndex
from readserver_tpu.ops import backward_search as jax_backward_search
from readserver_tpu.ops import encode_query_batch
from readserver_tpu.ops import resolve as jax_resolve
from readserver_tpu_torch import parallel as tp
from readserver_tpu_torch.kernels import build as kbuild
from readserver_tpu_torch.ops import DeviceIndex
from readserver_tpu_torch.ops import resolve
from torch_common import np_of, t32

H = 16
# walk tier → the tiers shipped (dsa ignores the budget, so it is not here)
WALK_TIERS = {"fused": {"fused"}, "marks": {"marks"}, "lf": {"marks", "lf"},
              "slow": set()}
BUDGETS = ["zero", "cuts a query", "every lane", "past every lane"]
# the packed index's tiers each interval route drops (chip_smoke.ROUTE_DROPS)
ROUTE_DROPS = {
    "dsa": {},
    "lf": dict(dsa=None, dsa_bits=0),
    "slow": dict(dsa=None, dsa_bits=0, lf=None, mark_rank=None,
                 sample_pairs=None, sample_rate=0),
}


@pytest.fixture(scope="module")
def cohort():
    corpus = jax_simulate.simulate_config("cohort", scale=0.004)
    packed = build_index(
        corpus.reads, sample_ids=corpus.sample_ids,
        sample_names=[f"s{i:03d}" for i in range(128)],
    )
    return corpus, packed


def _queries(corpus, n, seed):
    k = corpus.spec.kmer_len
    kms = jax_simulate.sample_query_kmers(corpus, n, k, seed=seed,
                                          miss_frac=0.2)
    return encode_query_batch(kms, k)


def _edge_intervals(corpus, packed, seed):
    """(l, u) int32 numpy [48]: searched intervals, with two (0, 0), two
    empties elsewhere, and three wider than H (inside the index)."""
    jdev = JaxDeviceIndex.from_packed(packed, tiers=set())
    codes, lengths = _queries(corpus, 48, seed)
    l, u = (np.array(x) for x in jax.jit(jax_backward_search)(jdev, codes,
                                                                lengths))
    l[[3, 17]] = u[[3, 17]] = 0
    u[[9, 30]] = l[[9, 30]]
    for b, w in ((5, 3 * H), (21, H + 1), (40, 2 * H + 5)):
        l[b] = min(l[b], packed.n - w)
        u[b] = l[b] + w
    return l, u


def _budget(l, u, case: str) -> int:
    c = np.clip(u.astype(np.int64) - l, 0, H)
    total = int(c.sum())
    if case in ("zero", "one lane"):
        return int(case == "one lane")
    if case == "cuts a query":
        b = int(np.flatnonzero(c >= 3)[len(np.flatnonzero(c >= 3)) // 2])
        return int(c[:b].sum()) + int(c[b]) // 2
    return total if case == "every lane" else total + 7


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


# ------------------------------------------- the ctypes signatures

_CTYPE = {"int": kbuild._I, "long long": kbuild._L,
          "unsigned long long": kbuild._U}


def _c_params(text: str) -> list:
    out = []
    for p in (x.strip() for x in text.split(",") if x.strip()):
        if "*" in p:
            out.append(kbuild._P)
        else:
            out.append(_CTYPE[" ".join(p.replace("const", "").split()[:-1])])
    return out


def test_signatures_match_sources():
    """Every bound entry point's argtypes are its C parameters, type for
    type and the stream included: ctypes passes an argument past the
    argtypes by its default conversion, which cuts a stream pointer to a C
    int (K14's and K15's entries lacked the stream's slot)."""
    src = "".join((kbuild._CSRC / s).read_text() for s in kbuild._SOURCES)
    macros = {m.group(1): m.group(2).replace("\\\n", " ") for m in re.finditer(
        r"#define (RS_\w+_PARAMS)\s+((?:.*\\\n)*.*)", src)}
    seen = set()
    for m in re.finditer(r'extern "C" int\s+(rs_\w+)\(([^)]*)\)', src):
        name, params = m.group(1), m.group(2)
        for k, v in macros.items():
            params = params.replace(k, v)
        assert kbuild.SIGNATURES[name] == _c_params(params), name
        seen.add(name)
    assert seen == set(kbuild.SIGNATURES)


# -------------------------------------------- one device, every walk


@pytest.mark.parametrize("case", BUDGETS)
@pytest.mark.parametrize("walk", sorted(WALK_TIERS))
def test_budget_resolve_matches_jax(cohort, walk, case):
    """``resolve_intervals(row_budget=)`` through ``compact_lanes`` and
    ``gather_lanes`` (their plain forms) equals the JAX ``resolve_intervals``
    on every walk tier."""
    corpus, packed = cohort
    l, u = _edge_intervals(corpus, packed, seed=3)
    R = _budget(l, u, case)
    tiers = WALK_TIERS[walk]
    jdev = JaxDeviceIndex.from_packed(packed, tiers=tiers)
    tdev = DeviceIndex.from_packed(packed, "cpu", tiers=tiers)
    assert resolve.walk_kind(tdev) == walk
    want = jax.jit(lambda d, l, u: jax_resolve.resolve_intervals(
        d, l, u, H, row_budget=R))(jdev, l, u)
    got = resolve.resolve_intervals(tdev, t32(l), t32(u), H, row_budget=R)
    _same(got, want)
    kept = int(np_of(got[2]).sum())
    assert kept == min(R, int(np.clip(u.astype(np.int64) - l, 0, H).sum()))


@pytest.mark.parametrize("case", BUDGETS)
@pytest.mark.parametrize("walk", sorted(WALK_TIERS))
def test_budget_hit_step_matches_jax(cohort, walk, case):
    """The hit step under a budget (the gather's ``read_to_sample``
    column: the sample of read clip(rid, 0, m - 1) on kept lanes, -1 on
    the rest) equals the JAX ``resolve_intervals`` and the JAX engine's
    clipped ``read_to_sample`` gather."""
    corpus, packed = cohort
    l, u = _edge_intervals(corpus, packed, seed=4)
    R = _budget(l, u, case)
    tiers = WALK_TIERS[walk]
    jdev = JaxDeviceIndex.from_packed(packed, tiers=tiers)
    tdev = DeviceIndex.from_packed(packed, "cpu", tiers=tiers)
    rid, off, valid = (np.asarray(x) for x in jax.jit(
        lambda d, l, u: jax_resolve.resolve_intervals(
            d, l, u, H, row_budget=R))(jdev, l, u))
    rts = np.asarray(packed.read_to_sample)
    smp = np.where(valid, rts[np.clip(rid, 0, packed.num_reads - 1)], -1)
    got = resolve.resolve_hits(tdev, t32(l), t32(u), H, row_budget=R)
    _same(got, (np.where(valid, rid, -1), np.where(valid, off, -1), smp,
                valid))


# ------------------------------- int64 rows, the sample column, K15


@pytest.mark.parametrize("case", BUDGETS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_compaction_plain_forms_match_reference(cohort, dtype, case):
    """``compact_lanes`` / ``gather_lanes`` (plain) in int32 and int64,
    with each third column, equal the port's reference for them
    (``compact_rows``' prefix-sum scatter and torch scatters back, the JAX
    compaction's ops in torch; the JAX compaction itself is inline in its
    callers): the budget's rows and flags, each lane's read id, offset,
    flag and sample (the walk's, 0 on dropped lanes; read_to_sample's,
    -1).  A budget of 0 in int64 meets only this reference."""
    corpus, packed = cohort
    l, u = _edge_intervals(corpus, packed, seed=5)
    base = (1 << 33) if dtype == torch.int64 else 0  # past int32
    tl = torch.from_numpy(l.astype(np.int64) + base).to(dtype)
    tu = torch.from_numpy(u.astype(np.int64) + base).to(dtype)
    tl[[3, 17]] = tu[[3, 17]] = 0
    R = _budget(l, u, case)
    B, F = l.shape[0], l.shape[0] * H
    rows, valid, _ = resolve.expand_intervals(tl, tu, H)
    want_rows, want_valid, orig, keep = resolve.compact_rows(rows, valid, R)
    got_rows, got_valid, prefix = resolve.compact_lanes(tl, tu, H, R)
    assert got_rows.dtype == dtype
    _same((got_rows, got_valid), (want_rows, want_valid))
    rng = np.random.default_rng(R)
    rid_c = torch.from_numpy(rng.integers(-1, packed.num_reads + 2, R)
                             .astype(np.int32))
    off_c = torch.from_numpy(rng.integers(-1, 90, R).astype(np.int32))
    smp_c = torch.from_numpy(rng.integers(0, 128, R).astype(np.int32))
    r2s = torch.from_numpy(np.asarray(packed.read_to_sample))
    full = torch.full((F + 1,), -1, dtype=torch.int32)
    want_rid = full.scatter(0, orig, rid_c)[:F].reshape(B, H)
    want_off = full.scatter(0, orig, off_c)[:F].reshape(B, H)
    kept = (valid & keep).reshape(B, H)
    _same(resolve.gather_lanes(tl, tu, H, R, prefix, rid_c, off_c),
          (want_rid, want_off, kept))
    want_smp = torch.zeros(F + 1, dtype=torch.int32).scatter(
        0, orig, smp_c)[:F].reshape(B, H)
    _same(resolve.gather_lanes(tl, tu, H, R, prefix, rid_c, off_c,
                               smp_c=smp_c),
          (want_rid, want_off, want_smp, kept))
    clip = r2s[want_rid.clamp(0, packed.num_reads - 1).long()]
    _same(resolve.gather_lanes(tl, tu, H, R, prefix, rid_c, off_c,
                               read_to_sample=r2s,
                               num_reads=packed.num_reads),
          (want_rid, want_off, torch.where(kept, clip, -1), kept))
    with pytest.raises(ValueError):
        resolve.gather_lanes(tl, tu, H, R, prefix, rid_c, off_c, smp_c=smp_c,
                             read_to_sample=r2s, num_reads=1)


@pytest.mark.parametrize("S", [1, 5, 128])
def test_lane_histogram_matches_jax(S):
    """K15's sample mode (plain) equals the JAX ``sample_histogram`` over an
    identity ``read_to_sample``: each valid lane counted under its own
    sample, invalid lanes (whatever their sample) with weight 0."""
    rng = np.random.default_rng(S)
    B = 40
    sample = rng.integers(0, S, (B, H)).astype(np.int32)
    valid = rng.random((B, H)) < 0.6
    valid[7] = False  # a query with no lane
    idx = types.SimpleNamespace(num_samples=S, num_reads=S,
                                read_to_sample=np.arange(S, dtype=np.int32))
    want = jax_resolve.sample_histogram(idx, sample, valid)
    got = resolve.lane_histogram(torch.from_numpy(sample),
                                 torch.from_numpy(valid), S)
    _same((got,), (want,))
    assert int(got.sum()) == int(valid.sum())


# ------------------------------------------- the interval programs


# the JAX program's walks do not trace an empty budget: one lane instead
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", ["one lane"] + BUDGETS[1:])
@pytest.mark.parametrize("route", sorted(ROUTE_DROPS))
def test_interval_budget_matches_jax(cohort, route, case, exact):
    """The one-device interval program with ``resolve_budget``: K14's int64
    compaction and its gather with the walk's samples, then K15's sample
    mode (capped) or the exact sweep, equals the JAX
    ``make_sharded_query_fn`` on 4 shards, every output bit for bit."""
    corpus, packed = cohort
    pk = dataclasses.replace(packed, **ROUTE_DROPS[route])
    codes, lengths = _queries(corpus, 24, seed=11)
    S = 4
    mesh_j = jp.make_mesh(data_parallel=1, num_shards=S,
                          devices=jax.devices()[:S])
    sj = jp.place_sharded(jp.build_sharded(pk, S), mesh_j)
    mesh_t = tp.make_mesh(num_shards=S, device="cpu")
    st = tp.place_sharded(tp.build_sharded(pk, S), mesh_t)
    # the budget from the searched intervals
    l, u = (np.asarray(x) for x in jax.jit(jax_backward_search)(
        JaxDeviceIndex.from_packed(pk, tiers=set()), codes, lengths))
    R = _budget(l, u, case)
    kw = dict(max_hits=H, resolve_budget=R, exact_hist=exact,
              walk_early_exit=True)
    want = jp.make_sharded_query_fn(sj, mesh_j, **kw)(sj, None, codes,
                                                      lengths)
    got = tp.make_sharded_query_fn(st, mesh_t, **kw)(
        st, None, torch.from_numpy(np.asarray(codes)),
        torch.from_numpy(np.asarray(lengths)))
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    c = np.clip(u.astype(np.int64) - l, 0, H)
    assert int(got["valid"].sum()) == min(R, int(c.sum()))
    if case in ("one lane", "cuts a query") and not exact:
        assert not got["hist_complete"].numpy()[c > 0].all()
