"""Minimal asyncio REST endpoint (stdlib-only) over the dispatcher.

API surface mirrors the reference server's query endpoints
(SURVEY.md §1 L4: k-mer → present?/count/reads/samples):

    GET  /count?kmer=ACGT...     → {"kmer": ..., "count": N}
    GET  /reads?kmer=...         → hits with read_id/name/sample/offset
                                   [&sequences=1 adds read text]
    GET  /samples?kmer=...       → per-sample hit counts (exact — not
                                   capped at max_hits)
    (&both_strands=1 on any of the above also searches the reverse
     complement; hits gain a "strand" tag)
    POST /batch                  → {"kmers": [...], "mode": "count"|
                                   "reads"|"samples", "both_strands": b}
                                   — one JSON body, one batched answer
                                   list (the wire-level batch the engine's
                                   device batching deserves)
    GET  /read?id=N              → name/sequence/sample/metadata by read
                                   id (the RocksDB Get of the reference)
    GET  /health                 → liveness (canary query through the device)
    GET  /stats                  → dispatcher metrics

JSON in/out.  HTTP/1.1 keep-alive: connections serve many requests.
"""

from __future__ import annotations

import asyncio
import base64
import json
from urllib.parse import parse_qs, urlparse

from readserver_tpu_torch.serve.dispatcher import Dispatcher

MAX_BODY = 8 << 20


def _resp(status: str, body: dict, keep: bool = True) -> bytes:
    payload = json.dumps(body).encode()
    conn = "keep-alive" if keep else "close"
    return (
        f"HTTP/1.1 {status}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(payload)}\r\n"
        f"Connection: {conn}\r\n\r\n"
    ).encode() + payload


class RestServer:
    def __init__(self, dispatcher: Dispatcher, host: str, port: int):
        self.dispatcher = dispatcher
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        await self.dispatcher.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.dispatcher.stop()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:  # keep-alive: serve requests until client closes
                request_line = await asyncio.wait_for(
                    reader.readline(), timeout=30
                )
                if not request_line.strip():
                    break
                clen, want_close = 0, False
                while True:
                    line = await asyncio.wait_for(reader.readline(), timeout=10)
                    if line in (b"\r\n", b"\n", b""):
                        break
                    low = line.decode("latin1").lower()
                    if low.startswith("content-length:"):
                        clen = int(low.split(":", 1)[1])
                    elif low.startswith("connection:") and "close" in low:
                        want_close = True
                parts = request_line.decode("latin1").split()
                if len(parts) < 2 or parts[0] not in ("GET", "POST"):
                    writer.write(_resp("405 Method Not Allowed",
                                       {"error": "GET/POST only"}, keep=False))
                    break
                body = b""
                if clen:
                    if clen > MAX_BODY:
                        writer.write(_resp("413 Payload Too Large",
                                           {"error": "body too large"},
                                           keep=False))
                        break
                    body = await asyncio.wait_for(
                        reader.readexactly(clen), timeout=30
                    )
                url = urlparse(parts[1])
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                writer.write(
                    await self._route(url.path, q, parts[0], body)
                )
                await writer.drain()
                if want_close:
                    break
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError):
            pass
        except Exception as e:
            try:
                writer.write(_resp("500 Internal Server Error",
                                   {"error": str(e)}, keep=False))
            except Exception:
                pass
        finally:
            try:
                await writer.drain()
                writer.close()
            except Exception:
                pass

    def _hit_payload(self, r, sequences: bool) -> list[dict]:
        eng = self.dispatcher.engine
        hits = [{**h, "name": eng.read_name(h["read_id"])} for h in r.hits]
        if sequences:
            hits = [
                {**h, "sequence": eng.read_sequence(h["read_id"])}
                for h in hits
            ]
        return hits

    def _result_payload(self, r, mode: str, sequences: bool) -> dict:
        if mode == "count":
            return {"kmer": r.kmer, "count": r.count}
        if mode == "samples":
            return {
                "kmer": r.kmer,
                "count": r.count,
                "samples": r.sample_hist,
                "samples_exact": r.sample_hist_complete,
                "hits_truncated": r.hits_truncated,
            }
        return {
            "kmer": r.kmer,
            "count": r.count,
            "hits": self._hit_payload(r, sequences),
            "hits_truncated": r.hits_truncated,
        }

    async def _route(
        self, path: str, q: dict[str, str], method: str = "GET",
        body: bytes = b"",
    ) -> bytes:
        if path == "/batch" and method == "POST":
            try:
                req = json.loads(body or b"{}")
                kmers = req.get("kmers", [])
                if not isinstance(kmers, list) or not kmers:
                    return _resp("400 Bad Request", {"error": "no kmers"})
                mode = req.get("mode", "count")
                if mode not in ("count", "reads", "samples"):
                    return _resp("400 Bad Request",
                                 {"error": f"bad mode {mode!r}"})
                results = await self.dispatcher.submit_many(
                    kmers,
                    mode={"count": "count", "samples": "hist"}.get(
                        mode, "full"
                    ),
                    both_strands=bool(req.get("both_strands")),
                )
                seqs = bool(req.get("sequences"))
                return _resp("200 OK", {
                    "results": [
                        self._result_payload(r, mode, seqs) for r in results
                    ]
                })
            except ValueError as e:
                return _resp("400 Bad Request", {"error": str(e)})
        if path == "/read":
            try:
                rid = int(q.get("id", ""))
            except ValueError:
                return _resp("400 Bad Request", {"error": "bad id"})
            if rid < 0:  # negative ids would alias via numpy indexing
                return _resp("404 Not Found", {"error": f"no read {rid}"})
            eng = self.dispatcher.engine
            try:
                seq = eng.read_sequence(rid)
            except (IndexError, ValueError):
                return _resp("404 Not Found", {"error": f"no read {rid}"})
            meta = eng.read_meta(rid)
            out = {
                "read_id": rid,
                "name": eng.read_name(rid),
                "sequence": seq,
                "sample": eng.sample_names[eng._sample_of(rid)]
                if hasattr(eng, "_sample_of")
                else None,
            }
            if meta is not None:
                out["meta_b64"] = base64.b64encode(meta).decode()
            return _resp("200 OK", out)
        if path == "/health":
            try:
                await self.dispatcher.submit("A", counts_only=True)
                return _resp("200 OK", {"status": "ok"})
            except Exception as e:
                return _resp("503 Service Unavailable", {"status": str(e)})
        if path == "/stats":
            snap = self.dispatcher.metrics.snapshot()
            pack = getattr(self.dispatcher.engine, "pack_stats", None)
            if pack is not None:
                # sparse-pack transfer accounting: dense-fallback
                # frequency quantifies the /samples-vs-/count p95 gap
                # (VERDICT r4 weak #4)
                snap["pack"] = dict(pack)
            return _resp("200 OK", snap)
        if path == "/info":
            eng = self.dispatcher.engine
            packed = eng.packed
            info = {
                "n_symbols": int(packed.n),
                "num_reads": int(packed.num_reads)
                if not eng._doc
                else sum(p.num_reads for p in eng.partitions),
                "num_samples": len(eng.sample_names),
                "max_query_len": eng.K,
                "max_hits": eng.H,
                "batch_size": eng.B,
                "sharding": (
                    "document"
                    if eng._doc
                    else ("interval" if eng._sharded else "single")
                ),
            }
            if getattr(eng, "tier_plan", None) is not None:
                info["tiers_kept"] = sorted(eng.tier_plan.keep)
                info["tiers_dropped"] = list(eng.tier_plan.dropped)
                info["hbm_bytes"] = int(eng.tier_plan.total_bytes)
            if getattr(eng, "_sharded", False) and not eng._doc:
                # the observable collective budget (parallel/stats.py):
                # per-batch psum counts the compiled step schedule pays
                from readserver_tpu_torch.parallel.stats import query_psum_estimate

                sidx = eng.sidx
                kstep = (
                    3 if sidx.rank3_rows is not None
                    else 2 if sidx.rank2_rows is not None
                    else 1
                )
                info["psums_per_batch"] = query_psum_estimate(
                    eng.K,
                    lut_p=eng.lut_p or 0,
                    kstep=kstep,
                    sample_rate=sidx.sample_rate,
                    fast_resolve=sidx.has_fast_resolve,
                    max_read_len=sidx.max_read_len,
                    direct_resolve=sidx.dsa_chunk is not None,
                )
                info["num_shards"] = int(sidx.num_shards)
            return _resp("200 OK", info)
        if path in ("/count", "/reads", "/samples"):
            kmer = q.get("kmer", "")
            if not kmer:
                return _resp("400 Bad Request", {"error": "missing kmer"})
            both = q.get("both_strands") == "1"
            mode = path.lstrip("/")
            try:
                r = await self.dispatcher.submit(
                    kmer,
                    mode={"count": "count", "samples": "hist"}.get(
                        mode, "full"
                    ),
                    both_strands=both,
                )
                return _resp(
                    "200 OK",
                    self._result_payload(
                        r, mode, q.get("sequences") == "1"
                    ),
                )
            except ValueError as e:
                return _resp("400 Bad Request", {"error": str(e)})
        return _resp("404 Not Found", {"error": f"no route {path}"})


async def serve_forever(engine, host: str, port: int) -> None:
    from readserver_tpu_torch.serve.dispatcher import Dispatcher

    server = RestServer(Dispatcher(engine), host, port)
    await server.start()
    print(f"readserver_tpu_torch serving on http://{host}:{port}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop()
