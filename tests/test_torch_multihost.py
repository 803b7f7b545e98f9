"""The port's interval shards across the ranks of a process group
(``readserver_tpu_torch.parallel.multihost``, the cross-rank program of
``parallel/sharded.py``) against the JAX package's sharded program.

The ranks are real processes, subprocesses of this test that import only
the port and join a ``gloo`` group on the CPU
(``readserver_tpu_torch.bench.multihost_bench``).  Each group runs every
case once and writes each rank's answers, and rank 0's gathered ones with
the global batch, to ``.npz`` files; the test holds them against the JAX
``make_sharded_query_fn`` on a ``make_mesh(dp, shard)`` of the simulated
CPU devices of ``tests/conftest.py``, on the same global batch.  Every
answer (``l, u, count, read_id, offset, valid, sample_hist,
hist_complete``) and the prefix LUT must equal the JAX program's bit for
bit (tolerance 0: all are integers), and each batch's all-reduces must be
``parallel/stats.query_psum_estimate``'s psums.

Each rank's wait has a time limit (``communicate(timeout=...)``); a group
that does not finish in it is killed and the test fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from readserver_tpu import parallel as jp
from readserver_tpu.corpus import simulate as jax_simulate
from readserver_tpu.index.builder import build_index
from readserver_tpu_torch.parallel.stats import query_psum_estimate

REPO = Path(__file__).resolve().parent.parent
WORKER = [sys.executable, "-m", "readserver_tpu_torch.bench.multihost_bench"]
BATCH = 16       # per rank
MAX_HITS = 16    # the worker's
KEYS = ("l", "u", "count", "read_id", "offset", "valid", "sample_hist",
        "hist_complete")
# a case: route (the tiers kept), k-step, LUT order, row budget, exact sweep
CASES = [
    "route=dsa,kstep=1,lut=0",
    "route=dsa,kstep=3,lut=0",
    "route=lf,kstep=1,lut=4",
    "route=lf,kstep=3,lut=4,budget=40",
    "route=slow,kstep=3,lut=0",
    "route=slow,kstep=1,lut=4,budget=40,exact=1",
    "route=lf,kstep=3,lut=0,exact=1",
    "route=dsa,kstep=3,lut=4,budget=40,exact=1",
]
# (ranks, worker flags, JAX mesh (dp, shard), cases): the shard axis over
# 2 ranks; dp over 2 ranks (one rank a row, forced through the per-step
# program); both over 4 ranks; and 2 shards a rank
GROUPS = {
    "1x2": (2, ["--num-shards", "2"], (1, 2), CASES),
    "2x1": (2, ["--per-step"], (2, 1), CASES[:3] + CASES[5:6]),
    "2x2": (4, ["--num-shards", "2"], (2, 2), CASES),
    "1x4": (2, ["--num-shards", "4"], (1, 4),
            CASES[1:2] + CASES[3:4] + CASES[5:6]),
}
ROUTE_STRIP = {
    "dsa": {},
    "lf": dict(dsa_chunk=None, dsa_bits=0),
    "slow": dict(dsa_chunk=None, dsa_bits=0, lf_chunk=None, mark_table=None,
                 spairs_chunk=None, sstarts=None, slens=None, sample_rate=0),
}


def _ephemeral_low() -> int:
    """The first port of the kernel's ephemeral range (Linux's default
    32768 where the range cannot be read)."""
    try:
        text = Path("/proc/sys/net/ipv4/ip_local_port_range").read_text()
        return int(text.split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port() -> int:
    """A TCP port that binds now and lies below the ephemeral range.

    A rank binds its port seconds after this check.  A port from
    ``bind(("127.0.0.1", 0))`` is ephemeral: in between, any socket that
    another test's process, or a gloo pair of this very group, binds to
    port 0 or connects out can be handed the same port, and the rank then
    fails to bind it, or another test's server answers on it.  The kernel
    hands out no port below the range that way.
    """
    hi = _ephemeral_low()
    lo = max(1024, hi - 16384)
    rng = random.SystemRandom()
    for _ in range(256):
        port = rng.randrange(lo, hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in [{lo}, {hi})")


def _env() -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(cmd_of, nproc: int):
    """Start ranks nproc-1 .. 0 of ``cmd_of(rank, port)``."""
    port = _free_port()
    return [
        subprocess.Popen(cmd_of(i, port), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=_env(),
                         cwd=REPO)
        for i in reversed(range(nproc))
    ][::-1]


def _wait(procs, timeout: float) -> list[str]:
    """Every rank's output; kills the group past ``timeout`` seconds."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _worker(nproc: int, flags: list[str]):
    def cmd(i, port):
        return WORKER + [
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nproc), "--process-id", str(i),
            "--backend", "gloo", "--device", "cpu", "--batch", str(BATCH),
            "--heartbeat-timeout", "30", *flags]
    return cmd


def case_name(spec: str) -> str:
    case = dict(route="dsa", kstep=3, lut=0, budget=0, exact=0)
    for item in spec.split(","):
        k, v = item.split("=")
        case[k] = v if k == "route" else int(v)
    return "_".join(f"{k}{v}" for k, v in case.items()), case


@pytest.fixture(scope="module")
def packed(tiny_corpus):
    return build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Every group's dumped answers → {group: directory}."""
    out = {}
    running = []
    for g, (nproc, flags, _, cases) in GROUPS.items():
        d = tmp_path_factory.mktemp(f"mh_{g}")
        case_flags = [x for c in cases for x in ("--case", c)]
        running.append((g, d, _launch(
            _worker(nproc, [*flags, "--dump", str(d), *case_flags]), nproc)))
    for g, d, procs in running:
        outs = _wait(procs, timeout=300)
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"group {g}: {o[-3000:]}"
        out[g] = d
    return out


_JAX_CACHE: dict = {}


def jax_answers(packed, dp: int, shards: int, case: dict, codes, lengths):
    mesh = jp.make_mesh(data_parallel=dp, num_shards=shards,
                        devices=jax.devices()[: dp * shards])
    key = (dp, shards, case["route"])
    if key not in _JAX_CACHE:
        s = jp.place_sharded(jp.build_sharded(packed, shards), mesh)
        _JAX_CACHE[key] = dataclasses.replace(s, **ROUTE_STRIP[case["route"]])
    s = _JAX_CACHE[key]
    p = case["lut"]
    lut = jp.build_prefix_lut_sharded(s, mesh, p) if p else None
    fn = jp.make_sharded_query_fn(
        s, mesh, max_hits=MAX_HITS, lut_p=p, kstep=case["kstep"],
        exact_hist=bool(case["exact"]), resolve_budget=case["budget"] or None)
    out = fn(s, lut, codes, lengths)
    return ({k: np.asarray(v) for k, v in out.items()},
            None if lut is None else np.asarray(lut))


def _params():
    return [pytest.param(g, spec, id=f"{g}-{case_name(spec)[0]}")
            for g, (_, _, _, cases) in GROUPS.items() for spec in cases]


@pytest.mark.parametrize("group, spec", _params())
def test_ranks_match_jax_sharded_program(dumps, packed, group, spec):
    """Every rank's rows and rank 0's gathered batch equal the JAX program
    on the same (dp, shard) mesh: search (k-step 1 and 3, from C and the
    LUT), every resolve route, the budget compaction and the exact sweep;
    and every rank's prefix LUT equals the JAX one."""
    nproc, _, (dp, shards), _ = GROUPS[group]
    name, case = case_name(spec)
    glob = dict(np.load(dumps[group] / f"{name}_global.npz"))
    B = glob["codes"].shape[0]
    assert B == nproc * BATCH
    want, want_lut = jax_answers(packed, dp, shards, case, glob["codes"],
                                 glob["lengths"])
    for k in KEYS:
        assert glob[k].dtype == want[k].dtype, (k, glob[k].dtype)
        np.testing.assert_array_equal(glob[k], want[k], err_msg=k)
    ranks_per_row = nproc // dp
    for r in range(nproc):
        local = np.load(dumps[group] / f"{name}_rank{r}.npz")
        row = r // ranks_per_row
        b = B // dp
        for k in KEYS:
            np.testing.assert_array_equal(
                local[k], want[k][row * b : (row + 1) * b],
                err_msg=f"rank {r} {k}")
        if want_lut is not None:
            np.testing.assert_array_equal(local["lut"], want_lut)
    assert want["count"].max() > 0 and glob["valid"].any()


def _count_params():
    return [pytest.param(g, spec, id=f"{g}-{case_name(spec)[0]}")
            for g, (_, _, _, cases) in GROUPS.items() for spec in cases
            if "exact=1" not in spec]


@pytest.mark.parametrize("group, spec", _count_params())
def test_all_reduces_match_psum_estimate(dumps, packed, group, spec):
    """A batch's all-reduces (each rank's count over its dp rows) are the
    JAX program's psums, ``query_psum_estimate``, on every route."""
    nproc = GROUPS[group][0]
    name, case = case_name(spec)
    kstep = case["kstep"]
    K = jax_simulate.CONFIGS["tiny"].kmer_len
    want = query_psum_estimate(
        K, lut_p=case["lut"], kstep=kstep, sample_rate=packed.sample_rate,
        fast_resolve=case["route"] != "slow",
        max_read_len=int(packed.read_lengths.max()),
        direct_resolve=case["route"] == "dsa")["total"]
    for r in range(nproc):
        local = np.load(dumps[group] / f"{name}_rank{r}.npz")
        assert int(local["all_reduce"]) == want * int(local["rows"]), r


def test_parity_run_against_oracle():
    """The worker's own run: 2 ranks, 2 shards, the lf walk and the exact
    sweep; rank 0's parity over both ranks' queries against the oracle."""
    procs = _launch(_worker(2, ["--num-shards", "2", "--iters", "2",
                                "--strip-dsa", "--exact-hist"]), 2)
    outs = _wait(procs, timeout=240)
    assert [p.returncode for p in procs] == [0, 0], outs
    res = json.loads([ln for ln in outs[0].splitlines()
                      if ln.startswith("{")][-1])
    assert res["parity_bad"] == 0 and res["parity_queries"] == 2 * BATCH
    assert res["shards"] == 2 and res["shard_ranks"] == 2 and res["dp"] == 1


def _answers(group_port: int, kms: list[str], path: str) -> list:
    got = []
    for km in kms:
        url = f"http://127.0.0.1:{group_port}/{path}?kmer={km}&both_strands=1"
        with urllib.request.urlopen(url, timeout=60) as r:
            got.append(json.loads(r.read()))
    return got


def test_serve_coordinator_answers_over_rest(tmp_path, tiny_corpus):
    """Two ``cli serve --coordinator`` ranks (2 shards, one a rank): rank 0
    answers ``/count``, ``/reads`` and ``/samples`` as a one-process
    engine on the same shards answers; SIGINT on rank 0 stops the
    follower, and both exit 0."""
    from readserver_tpu_torch import alphabet
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index import build_index as port_build
    from readserver_tpu_torch.parallel import make_mesh
    from readserver_tpu_torch.serve import Dispatcher, QueryEngine
    from readserver_tpu_torch.serve.http import RestServer

    c = tiny_corpus
    idx = tmp_path / "idx"
    packed = port_build(c.reads, sample_ids=c.sample_ids)
    artifact.save_artifact(packed, idx)
    rest = _free_port()

    def cmd(i, port):
        return [sys.executable, "-m", "readserver_tpu_torch.cli", "serve",
                "--index", str(idx), "--port", str(rest), "--batch", "16",
                "--shards", "2", "--device", "cpu", "--backend", "gloo",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(i)]

    procs = _launch(cmd, 2)
    try:
        # two ranks import torch, join the group, build and warm the
        # engine: seconds alone, minutes beside a loaded test run's workers
        deadline = time.time() + 300
        up = False
        while time.time() < deadline and not up:
            assert all(p.poll() is None for p in procs), _wait(procs, 5)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rest}/health", timeout=2) as r:
                    up = r.status == 200
            except OSError:
                time.sleep(0.3)
        assert up, "the REST front never came up"
        kms = [alphabet.decode(np.asarray(km)) for km in
               jax_simulate.sample_query_kmers(c, 6, c.spec.kmer_len,
                                               seed=51, miss_frac=0.3)]
        served = {p: _answers(rest, kms, p)
                  for p in ("count", "reads", "samples")}
        with urllib.request.urlopen(f"http://127.0.0.1:{rest}/info",
                                    timeout=10) as r:
            info = json.loads(r.read())
        procs[0].send_signal(signal.SIGINT)
        outs = _wait(procs, timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert info["sharding"] == "interval" and info["num_shards"] == 2

    one = QueryEngine(packed, ServeConfig(batch_size=16, num_shards=2),
                      make_mesh(num_shards=2, device="cpu"), device="cpu")
    pay = RestServer(Dispatcher(one), "127.0.0.1", 0)._result_payload
    for mode, got in served.items():
        for k, body in zip(kms, got):
            r = (one.count_batch([k], both_strands=True)[0] if mode == "count"
                 else one.query_batch([k], both_strands=True)[0])
            assert body == json.loads(json.dumps(pay(r, mode, False))), (
                mode, k)
    assert sum(r["count"] for r in served["count"]) > 0


def test_fault_injection_sigkill_and_relaunch():
    """Kill a rank mid-serve: the survivor raises within the group timeout
    (its collective cannot complete) and answers nothing more; a relaunched
    group answers with full parity, as the healthy run does."""
    procs = _launch(_worker(2, ["--num-shards", "2", "--serve-loop",
                                "--heartbeat-timeout", "20"]), 2)
    fd = procs[0].stdout.fileno()
    os.set_blocking(fd, False)
    buf = ""

    def drain() -> str:
        out = b""
        while True:
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                break
            if not chunk:
                break
            out += chunk
        return out.decode(errors="replace")

    try:
        deadline = time.time() + 120
        while buf.count(" ok ") < 3 and time.time() < deadline:
            buf += drain()
            time.sleep(0.1)
        assert buf.count(" ok ") >= 3, f"never served: {buf[-2000:]}"
        os.kill(procs[1].pid, signal.SIGKILL)
        procs[1].wait(timeout=30)
        procs[0].wait(timeout=60)  # raises out of its collective
        buf += drain()
        assert procs[0].returncode != 0, buf[-2000:]
        ticks = buf.count(" ok ")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert ticks >= 3
    procs = _launch(_worker(2, ["--num-shards", "2", "--iters", "2"]), 2)
    outs = _wait(procs, timeout=240)
    assert [p.returncode for p in procs] == [0, 0], outs
    res = json.loads([ln for ln in outs[0].splitlines()
                      if ln.startswith("{")][-1])
    assert res["parity_bad"] == 0
