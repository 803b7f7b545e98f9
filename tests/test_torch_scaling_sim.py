"""The port's ``bench/scaling_sim.py`` against the JAX package's module.

Both run their stand-in corpus (``wg`` at scale 2e-6, 64 queries) at every
``(dp, shard)`` factorisation of the 8 virtual CPU devices that
``tests/conftest.py`` sets up.  Per width the two report the same mesh,
parity, k-step tier and psums a batch; the port's cross-rank forms count
all-reduces equal to the estimate of their route, and its answers equal
the JAX program's at every width.
"""

import contextlib
import io
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from readserver_tpu.bench import scaling_sim as jax_sim
from readserver_tpu_torch.bench import scaling_sim

N = 8
WIDTHS = scaling_sim.widths(N)


@pytest.fixture(scope="module")
def reports():
    """(the JAX module's JSON object, the port's) over 8 devices."""
    assert len(jax.devices()) == N
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_sim.main() == 0
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    return want, scaling_sim.run(N, "cpu")


def test_widths_are_the_factorisations():
    assert WIDTHS == [1, 2, 4, 8]
    assert scaling_sim.widths(6) == [1, 2]
    assert scaling_sim.widths(1) == [1]


@pytest.mark.parametrize("i", range(len(WIDTHS)), ids=[
    f"shards{s}" for s in WIDTHS])
def test_width_matches_jax_module(reports, i):
    """Per width: dp, shards, parity, kstep and the psums a batch equal the
    JAX module's."""
    want, got = reports
    w, g = want["scaling_sim"][i], got["scaling_sim"][i]
    for key in ("dp", "shards", "parity", "kstep", "psums_per_batch"):
        assert g[key] == w[key], key
    assert got["devices"] == want["devices"] == N and got["device"] == "cpu"


@pytest.mark.parametrize("i", range(len(WIDTHS)), ids=[
    f"shards{s}" for s in WIDTHS])
def test_all_reduces_match_estimate(reports, i):
    """Each cross-rank route's all-reduces are its estimate once a dp row;
    the walk route's are the psums a batch both modules report."""
    _, got = reports
    g = got["scaling_sim"][i]
    for route, a in g["all_reduces"].items():
        assert a["counted"] == a["estimate"], route
    assert g["all_reduces"]["lf"]["counted"] == (
        g["dp"] * g["psums_per_batch"]["total"])
    # the stand-in ships the direct-resolve tier: its route's resolve is
    # 2 all-reduces, not the walk's sample_rate + 3
    assert g["all_reduces"]["dsa"]["counted"] == g["dp"] * (
        g["psums_per_batch"]["search"] + 2)


@pytest.mark.parametrize("shards", WIDTHS)
def test_answers_match_jax_program(shards):
    """The port's query fn at each width (one device, every shard on it)
    answers as the JAX ``make_sharded_query_fn`` on a mesh of 8 // shards
    dp rows and ``shards`` devices, on the module's corpus and queries."""
    import torch

    from readserver_tpu import parallel as jpar
    from readserver_tpu.corpus import simulate
    from readserver_tpu.index.builder import build_index
    from readserver_tpu.ops import encode_query_batch
    from readserver_tpu_torch import parallel as tpar

    corpus = simulate.simulate_config("wg", scale=2e-6)
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    k = corpus.spec.kmer_len
    kmers = simulate.sample_query_kmers(corpus, 64, k, seed=91, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    dp, p = N // shards, min(6, k)
    jmesh = jpar.make_mesh(data_parallel=dp, num_shards=shards)
    jidx = jpar.place_sharded(jpar.build_sharded(packed, shards), jmesh)
    jout = jpar.make_sharded_query_fn(jidx, jmesh, max_hits=32, lut_p=p)(
        jidx, jpar.build_prefix_lut_sharded(jidx, jmesh, p), codes, lengths)
    mesh = tpar.make_mesh(dp, shards, device="cpu")
    tidx = tpar.place_sharded(tpar.build_sharded(packed, shards), mesh)
    tout = tpar.make_sharded_query_fn(tidx, mesh, max_hits=32, lut_p=p)(
        tidx, tpar.build_prefix_lut_sharded(tidx, mesh, p),
        torch.from_numpy(codes), torch.from_numpy(lengths))
    for key in scaling_sim.KEYS:
        assert np.array_equal(np.asarray(tout[key]), np.asarray(jout[key])), key


def test_cli_on_the_host():
    """``python -m readserver_tpu_torch.bench.scaling_sim --device cpu``:
    one JSON line, exit 0; with no card, the card's run refuses."""
    run = subprocess.run(
        [sys.executable, "-m", "readserver_tpu_torch.bench.scaling_sim",
         "--device", "cpu", "--devices", "4"],
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert [(w["dp"], w["shards"]) for w in res["scaling_sim"]] == [
        (4, 1), (2, 2), (1, 4)]
    assert all(w["parity"] == "exact" for w in res["scaling_sim"])
    import torch

    if not torch.cuda.is_available():
        card = subprocess.run(
            [sys.executable, "-m", "readserver_tpu_torch.bench.scaling_sim"],
            capture_output=True, text=True, timeout=300)
        assert card.returncode != 0 and not card.stdout.strip()
