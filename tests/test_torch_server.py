"""Port's serving tier (serve/dispatcher.py, serve/http.py over the port's
QueryEngine and MultiEngine) against the JAX package's server on the same
artifact or cohort: for the same requests, the same status and the same
JSON body — plus the dispatcher's batching, error and mixed-tier
behaviour."""

import asyncio
import http.client
import json
from types import SimpleNamespace

import numpy as np
import pytest

from readserver_tpu import alphabet
from readserver_tpu.config import ServeConfig as JaxServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.index.cohort import build_cohort, load_cohort
from readserver_tpu.serve import Dispatcher as JaxDispatcher
from readserver_tpu.serve import MultiEngine as JaxMultiEngine
from readserver_tpu.serve import QueryEngine as JaxQueryEngine
from readserver_tpu.serve.http import RestServer as JaxRestServer
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.oracle import naive_count
from readserver_tpu_torch.index.cohort import load_cohort as port_load_cohort
from readserver_tpu_torch.serve import (
    Dispatcher,
    Metrics,
    MultiEngine,
    QueryEngine,
)
from readserver_tpu_torch.serve.http import RestServer

CFG = dict(batch_size=64, max_hits=32, batch_deadline_ms=5.0,
           small_batch_sizes=(8,))


@pytest.fixture(scope="module")
def servers(tiny_corpus):
    reads = tiny_corpus.reads
    names = [f"SRR000.{i}/1" for i in range(len(reads))]
    meta = [f"flowcell=F{i % 3}".encode() for i in range(len(reads))]
    packed = build_index(
        reads, sample_ids=np.arange(len(reads), dtype=np.int32) % 4,
        sample_names=["a", "b", "c", "d"], read_names=names, read_meta=meta,
    )
    jax_engine = JaxQueryEngine(packed, JaxServeConfig(**CFG))
    engine = QueryEngine(packed, ServeConfig(**CFG), device="cpu")
    return (tiny_corpus, (JaxRestServer, JaxDispatcher, jax_engine),
            (RestServer, Dispatcher, engine))


def _kmers(corpus, n, seed):
    kms = sample_query_kmers(corpus, n, corpus.spec.kmer_len, seed=seed)
    return [alphabet.decode(km) for km in kms]


def _exchange(side, requests):
    """Start ``side``'s REST server on a free port, send ``requests``
    (method, path, body) over one keep-alive connection, stop it; →
    [(status, json body)]."""
    server_cls, dispatcher_cls, engine = side

    async def go():
        server = server_cls(dispatcher_cls(engine), "127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]

        def client():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            out = []
            for method, path, body in requests:
                conn.request(method, path,
                             body=None if body is None else json.dumps(body))
                r = conn.getresponse()
                out.append((r.status, json.loads(r.read())))
            conn.close()
            return out

        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, client)
        finally:
            await server.stop()

    return asyncio.run(go())


def _same_answers(servers, requests):
    _, jax_side, port_side = servers
    got = _exchange(port_side, requests)
    want = _exchange(jax_side, requests)
    for req, g, w in zip(requests, got, want):
        assert g == w, req
    return got


def test_rest_get_endpoints_match_jax(servers):
    corpus = servers[0]
    km = _kmers(corpus, 4, seed=34)
    reqs = [("GET", p, None) for p in (
        f"/count?kmer={km[0]}",
        f"/count?kmer={km[1]}&both_strands=1",
        f"/reads?kmer={km[1]}&sequences=1",
        f"/reads?kmer={km[2]}&both_strands=1",
        "/reads?kmer=ACG",
        f"/samples?kmer={km[3]}",
        "/samples?kmer=ACG&both_strands=1",
        "/read?id=3",
        "/read?id=-1",
        "/read?id=999999",
        "/read?id=x",
        "/health",
        "/info",
        "/count",
        "/count?kmer=XYZ",
        "/nope",
    )]
    got = _same_answers(servers, reqs)
    assert [s for s, _ in got] == [200] * 8 + [404, 404, 400, 200, 200,
                                               400, 400, 404]
    assert got[4][1]["hits_truncated"] and len(got[4][1]["hits"]) == 32
    assert got[6][1]["samples_exact"] and len(got[6][1]["samples"]) == 4
    assert got[7][1]["name"] == "SRR000.3/1" and got[7][1]["sample"] == "d"


@pytest.mark.parametrize("mode", ["count", "reads", "samples"])
def test_rest_batch_post_matches_jax(servers, mode):
    corpus = servers[0]
    kms = _kmers(corpus, 12, seed=36) + ["ACGTA"]
    reqs = [
        ("POST", "/batch", {"kmers": kms, "mode": mode}),
        ("POST", "/batch", {"kmers": kms[:5], "mode": mode,
                            "both_strands": True, "sequences": True}),
        ("POST", "/batch", {"kmers": [], "mode": mode}),
        ("POST", "/batch", {"kmers": ["NOTDNA"], "mode": mode}),
        ("GET", f"/count?kmer={kms[0]}", None),
    ]
    got = _same_answers(servers, reqs)
    assert [s for s, _ in got] == [200, 200, 400, 400, 200]
    assert len(got[0][1]["results"]) == len(kms)
    for res in got[0][1]["results"]:
        assert res["count"] == naive_count(corpus.reads, res["kmer"])


def test_rest_stats_answers(servers):
    """/stats reports the port's dispatcher metrics and the engine's pack
    accounting."""
    *_, port_side = servers
    kms = _kmers(servers[0], 3, seed=37)
    got = _exchange(port_side, [("GET", f"/samples?kmer={k}", None)
                                for k in kms] + [("GET", "/stats", None)])
    status, snap = got[-1]
    assert status == 200 and snap["queries"] >= 3 and snap["errors"] == 0
    assert snap["pack"]["batches"] >= 3
    assert set(snap) >= {"qps", "p50_latency_ms", "mean_batch_fill", "pack"}


def test_dispatcher_batches_concurrent_queries(servers):
    corpus, _, (_, _, engine) = servers
    kmers = _kmers(corpus, 40, seed=33)

    async def go():
        d = Dispatcher(engine, Metrics())
        await d.start()
        results = await asyncio.gather(
            *[d.submit(km, counts_only=True) for km in kmers]
        )
        snap = d.metrics.snapshot()
        await d.stop()
        return results, snap

    results, snap = asyncio.run(go())
    for km, r in zip(kmers, results):
        assert r.count == naive_count(corpus.reads, km)
    assert snap["queries"] == 40 and snap["batches"] < 40
    assert snap["p50_latency_ms"] is not None


def test_dispatcher_mixed_tiers_match_engine(servers):
    """count, hist and full blocks that share a device batch each get the
    answers the engine gives them alone (a batch runs the strongest tier
    its blocks need, so the hist block's answers may carry hits too)."""
    corpus, _, (_, _, engine) = servers
    kms = _kmers(corpus, 30, seed=38)

    async def go():
        d = Dispatcher(engine)
        await d.start()
        out = await asyncio.gather(
            d.submit_many(kms[:10], mode="count"),
            d.submit_many(kms[10:20], mode="hist"),
            d.submit_many(kms[20:], mode="full", both_strands=True),
        )
        await d.stop()
        return out

    counts, hist, full = asyncio.run(go())
    assert [r.count for r in counts] == [
        r.count for r in engine.count_batch(kms[:10])]
    key = lambda r: (r.kmer, r.count, r.sample_hist, r.sample_hist_complete)  # noqa: E731
    assert [key(r) for r in hist] == [
        key(r) for r in engine.query_batch(kms[10:20], include_hits=False)]
    assert full == engine.query_batch(kms[20:], both_strands=True)


def test_dispatcher_propagates_errors(servers):
    *_, (_, _, engine) = servers

    async def go():
        d = Dispatcher(engine)
        await d.start()
        with pytest.raises(ValueError):
            await d.submit("NOTDNA", counts_only=True)
        with pytest.raises(ValueError, match="unknown mode"):
            await d.submit_many(["ACGT"], mode="nope")
        ok = await d.submit("ACGT", counts_only=True)
        errors = d.metrics.errors
        await d.stop()
        return ok, errors

    ok, errors = asyncio.run(go())
    assert ok.count >= 0 and errors == 1


@pytest.fixture(scope="module")
def cohort_servers(tiny_corpus, tmp_path_factory):
    """The tiny corpus in 4 doc shards, 4 samples and read names, served by
    each package's MultiEngine."""
    reads = tiny_corpus.reads
    out = build_cohort(
        reads, np.arange(len(reads), dtype=np.int32) % 4, 4,
        tmp_path_factory.mktemp("rest_cohort") / "pop",
        sample_names=["a", "b", "c", "d"],
        read_names=[f"SRR000.{i}/1" for i in range(len(reads))],
    )
    jax_engine = JaxMultiEngine(load_cohort(out, mmap=False)[0],
                                JaxServeConfig(**CFG))
    engine = MultiEngine(port_load_cohort(out, mmap=False)[0],
                         ServeConfig(**CFG), device="cpu")
    return (tiny_corpus, (JaxRestServer, JaxDispatcher, jax_engine),
            (RestServer, Dispatcher, engine))


def test_rest_on_a_cohort_matches_jax(cohort_servers):
    """Every endpoint over both packages' MultiEngine.  Pinned quirks of
    the JAX front that the port repeats: ``/read`` answers ``"sample":
    None`` (no ``_sample_of``), and ``/info`` reports partition 0's
    ``n_symbols`` beside the cohort's ``num_reads``."""
    corpus = cohort_servers[0]
    km = _kmers(corpus, 6, seed=40)
    engine = cohort_servers[2][2]
    last = len(corpus.reads) - 1
    reqs = [("GET", p, None) for p in (
        "/info",
        "/read?id=3",
        f"/read?id={last}",
        f"/read?id={last + 1}",
        f"/count?kmer={km[0]}",
        f"/count?kmer={km[1]}&both_strands=1",
        f"/reads?kmer={km[2]}&sequences=1",
        f"/reads?kmer={km[3]}&both_strands=1",
        "/reads?kmer=ACG",
        f"/samples?kmer={km[4]}",
        "/samples?kmer=ACG&both_strands=1",
        "/health",
    )] + [
        ("POST", "/batch", {"kmers": km, "mode": mode, "both_strands": True})
        for mode in ("count", "reads", "samples")
    ]
    got = _same_answers(cohort_servers, reqs)
    assert [s for s, _ in got] == [200, 200, 200, 404] + [200] * 11
    info = got[0][1]
    assert info["sharding"] == "document"
    assert info["n_symbols"] == engine.partitions[0].n < sum(
        p.n for p in engine.partitions)
    assert info["num_reads"] == len(corpus.reads)
    assert got[1][1] == {"read_id": 3, "name": "SRR000.3/1",
                         "sequence": alphabet.decode(corpus.reads[3]),
                         "sample": None}
    assert got[2][1]["name"] == f"SRR000.{last}/1"
    assert got[8][1]["hits_truncated"] and len(got[8][1]["hits"]) > 32
    assert len(got[10][1]["samples"]) == 4
    for res in got[12][1]["results"]:
        assert res["count"] >= naive_count(corpus.reads, res["kmer"])


def test_info_on_an_interval_sharded_engine_matches_jax():
    """``/info`` on an engine that reports interval sharding reads
    ``parallel.stats.query_psum_estimate``: the port carries that module
    now, so the answer is the JAX server's (it raised
    ``ModuleNotFoundError`` before)."""
    stub = SimpleNamespace(
        packed=SimpleNamespace(n=1000, num_reads=10), _doc=False,
        _sharded=True, sample_names=["a"], K=32, H=64, B=256, lut_p=8,
        tier_plan=None,
        sidx=SimpleNamespace(rank3_rows=object(), rank2_rows=None,
                             sample_rate=32, has_fast_resolve=True,
                             max_read_len=100, dsa_chunk=None, num_shards=4),
    )

    async def info(server_cls, dispatcher_cls):
        d = dispatcher_cls(stub)
        try:
            return await server_cls(d, "127.0.0.1", 0)._route("/info", {})
        finally:
            d._executor.shutdown()

    got = asyncio.run(info(RestServer, Dispatcher))
    assert got == asyncio.run(info(JaxRestServer, JaxDispatcher))
    body = json.loads(got.split(b"\r\n\r\n", 1)[1])
    assert body["psums_per_batch"]["total"] > 0 and body["num_shards"] == 4


def test_info_on_a_real_interval_sharded_engine_matches_jax(servers):
    """The second case: ``/info`` and the query endpoints of a real
    interval-sharded port engine (4 shards on the CPU) against the JAX
    server over its sharded engine (dp 2 x 4 shards)."""
    import jax

    from readserver_tpu.parallel import make_mesh as jax_make_mesh
    from readserver_tpu_torch.parallel import make_mesh
    from readserver_tpu_torch.parallel.stats import query_psum_estimate

    corpus, (jsrv, jdisp, jeng), (srv, disp, eng) = servers
    cfg = dict(CFG, num_shards=4)
    jax_side = (jsrv, jdisp, JaxQueryEngine(
        jeng.packed, JaxServeConfig(**cfg),
        mesh=jax_make_mesh(2, 4, devices=jax.devices()[:8])))
    port_side = (srv, disp, QueryEngine(
        eng.packed, ServeConfig(**cfg), make_mesh(num_shards=4, device="cpu"),
        device="cpu"))
    km = _kmers(corpus, 3, seed=17)
    requests = [("GET", "/info", None)] + [
        ("GET", f"{path}?kmer={k}{both}", None)
        for k in km for path in ("/count", "/reads", "/samples")
        for both in ("", "&both_strands=1")
    ] + [("GET", "/read?id=3", None)]
    got = _exchange(port_side, requests)
    assert got == _exchange(jax_side, requests)
    info = got[0][1]
    sidx = port_side[2].sidx
    assert info["sharding"] == "interval" and info["num_shards"] == 4
    assert info["psums_per_batch"] == query_psum_estimate(
        eng.K, lut_p=port_side[2].lut_p, kstep=3,
        sample_rate=sidx.sample_rate, fast_resolve=sidx.has_fast_resolve,
        max_read_len=sidx.max_read_len, direct_resolve=True)
    assert any(body.get("count") for _, body in got[1:])
