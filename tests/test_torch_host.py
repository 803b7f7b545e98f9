"""Port's host layer: it imports without jax, its copied modules stay equal
to the JAX package's (the package name aside), and both packages build,
save and load the same artifacts."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from readserver_tpu.index import artifact as jax_artifact
from readserver_tpu.index import budget as jax_budget
from readserver_tpu.index import build_index as jax_build_index
from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import artifact, budget, build_index

REPO = Path(__file__).resolve().parents[1]

# host modules the port carries as copies: numpy/C++ only, and importing
# the originals would import jax (readserver_tpu/__init__.py)
COPIED = [
    "alphabet.py",
    "config.py",
    "native/__init__.py",
    "native/build.py",
    "index/__init__.py",
    "index/packing.py",
    "index/builder.py",
    "index/artifact.py",
    "index/cohort.py",
    "index/merge.py",
    "index/from_bwt.py",
    "index/rle.py",
    "index/upgrade.py",
    "parallel/stats.py",
    "corpus/__init__.py",
    "corpus/io.py",
    "corpus/bam.py",
    "corpus/simulate.py",
    "oracle/__init__.py",
    "oracle/fm.py",
    "oracle/naive.py",
    "serve/metrics.py",
    "serve/dispatcher.py",
    "serve/http.py",
]
# budget.py differs from here on: the device budget reads torch, not jax
BUDGET_TAIL = {"orig": "# nameplate HBM per chip", "port": "def device_budget_bytes("}

JAX_IMPORT = re.compile(
    r"^\s*(import jax|from jax|from readserver_tpu[. ]"
    r"|import readserver_tpu(\.|\s|$))"
)


def _ported(src: str) -> str:
    return re.sub(r"\breadserver_tpu\b", "readserver_tpu_torch", src)


def _sources(rel: str) -> tuple[str, str]:
    return (
        (REPO / "readserver_tpu" / rel).read_text(),
        (REPO / "readserver_tpu_torch" / rel).read_text(),
    )


# The port's dispatcher carries the span recorder's sites: every line it
# adds names the tracer, but for these, written out whole, which the spans
# reshaped (the fold's ``return [...]`` became an assignment, a span and a
# return).  The comparison drops the tracer's lines from the port and these
# from both files; whatever else differs fails as before.
TRACER_LINE = re.compile(r"\btrace\.|\bimport trace$")
RESHAPED = {
    "serve/dispatcher.py": (
        "            return [",
        "            folded = [",
        "            return folded",
    ),
}


def _untraced(orig: str, port: str, reshaped: tuple) -> tuple[str, str]:
    for line in reshaped:
        assert (orig + port).splitlines().count(line) == 1, line
    keep = lambda src, traced: "\n".join(  # noqa: E731
        x for x in src.splitlines()
        if x not in reshaped and not (traced and TRACER_LINE.search(x)))
    return keep(orig, False), keep(port, True)


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_equals_original(rel):
    orig, port = _sources(rel)
    if rel in RESHAPED:
        assert not TRACER_LINE.search(orig)
        orig, port = _untraced(orig, port, RESHAPED[rel])
    assert port == _ported(orig), (
        f"readserver_tpu_torch/{rel} drifted from readserver_tpu/{rel}: "
        "change both, or neither"
    )


# build scripts the port carries as copies, each re-invoking itself
SCRIPTS = ["build_wg.py", "build_cohort_big.py"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_copy_equals_original(name):
    orig = (REPO / "scripts" / name).read_text()
    port = (REPO / "scripts" / f"torch_{name}").read_text()
    assert port == _ported(orig), (
        f"scripts/torch_{name} drifted from scripts/{name}: change both, "
        "or neither"
    )


def test_budget_copy_equals_original_but_device_budget():
    orig, port = _sources("index/budget.py")
    head = port[: port.index(BUDGET_TAIL["port"])]
    assert head == _ported(orig[: orig.index(BUDGET_TAIL["orig"])])
    assert "jax" not in port[port.index(BUDGET_TAIL["port"]) :]


def test_no_jax_import_lines():
    files = sorted((REPO / "readserver_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len([f for f in files if f.parent.name == "scripts"]) >= 2
    bad = [
        f"{f.relative_to(REPO)}:{n}"
        for f in files
        for n, line in enumerate(f.read_text().splitlines(), 1)
        if JAX_IMPORT.match(line)
    ]
    assert len(files) > 20 and not bad, bad


def test_port_imports_and_counts_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import readserver_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    readserver_tpu_torch.__path__, "readserver_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] == "readserver_tpu"]
from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.oracle import naive_count
from readserver_tpu_torch.serve import QueryEngine
corpus = simulate.simulate_config("tiny")
engine = QueryEngine(build_index(corpus.reads[:200]), device="cpu")
kms = ["".join("ACGT"[c - 1] for c in r[5:16]) for r in corpus.reads[:8]]
got = [r.count for r in engine.count_batch(kms)]
assert got == [naive_count(corpus.reads[:200], k) for k in kms], got
from readserver_tpu_torch.oracle import naive_find_reads
for r in engine.query_batch(kms):
    hits = sorted((h["read_id"], h["offset"]) for h in r.hits)
    assert hits == naive_find_reads(corpus.reads[:200], r.kmer), r.kmer
# the CLI's host commands: build from a FASTA, then upgrade a stripped copy
import json, shutil, tempfile
from pathlib import Path
from readserver_tpu_torch import alphabet, cli
from readserver_tpu_torch.corpus import io as cio
from readserver_tpu_torch.index import artifact
tmp = Path(tempfile.mkdtemp())
cio.write_fasta(tmp / "r.fa", ((f"r{i}", alphabet.decode(r))
                               for i, r in enumerate(corpus.reads[:200])))
assert cli.main(["build", "--fasta", str(tmp / "r.fa"),
                 "--out", str(tmp / "idx")]) == 0
full = artifact.load_artifact(tmp / "idx", mmap=False)
manifest = json.loads((tmp / "idx" / "manifest.json").read_text())
for name in ("dsa", "fused_rows"):
    (tmp / "idx" / f"{name}.npy").unlink()
manifest["arrays"] = [a for a in manifest["arrays"]
                      if a not in ("dsa", "fused_rows")]
manifest["dsa_bits"] = 0
(tmp / "idx" / "manifest.json").write_text(json.dumps(manifest))
assert cli.main(["upgrade", str(tmp / "idx"), "--kstep", "3"]) == 0
up = artifact.load_artifact(tmp / "idx", mmap=False)
assert (up.dsa == full.dsa).all() and (up.fused_rows == full.fused_rows).all()
shutil.rmtree(tmp)
assert not [m for m, mod in sys.modules.items() if mod is not None
            and m.split(".")[0] in ("jax", "readserver_tpu")]
print("imported", len(names), "modules; counts", got)
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.fixture(scope="module")
def built(small_corpus):
    corpus = simulate.simulate_config("small")
    names = ["s0"]
    port = build_index(corpus.reads, sample_ids=corpus.sample_ids,
                       sample_names=names)
    orig = jax_build_index(small_corpus.reads,
                           sample_ids=small_corpus.sample_ids,
                           sample_names=names)
    return port, orig


def test_simulate_matches_jax(small_corpus):
    corpus = simulate.simulate_config("small")
    assert dataclasses.asdict(corpus.spec) == dataclasses.asdict(small_corpus.spec)
    assert all(np.array_equal(a, b) for a, b in zip(corpus.reads, small_corpus.reads))
    assert np.array_equal(corpus.sample_ids, small_corpus.sample_ids)


def _assert_same_index(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "config":
            assert x.to_json() == y.to_json()
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def test_build_index_matches_jax(built):
    port, orig = built
    assert port.rank3_blocks is not None and port.dsa is not None
    _assert_same_index(port, orig)


def test_artifacts_load_across_packages(built, tmp_path):
    port, orig = built
    artifact.save_artifact(port, tmp_path / "from_port")
    jax_artifact.save_artifact(orig, tmp_path / "from_jax")
    _assert_same_index(jax_artifact.load_artifact(tmp_path / "from_port"), orig)
    _assert_same_index(artifact.load_artifact(tmp_path / "from_jax"), port)


@pytest.mark.parametrize("budget_gib", [None, 0.001, 0.01, 1.0])
def test_plan_tiers_matches_jax(built, budget_gib):
    port, orig = built
    b = None if budget_gib is None else int(budget_gib * 2**30)
    got = dataclasses.asdict(budget.plan_tiers(port, b))
    assert got == dataclasses.asdict(jax_budget.plan_tiers(orig, b))


def test_device_budget_is_none_on_cpu():
    assert budget.device_budget_bytes("cpu") is None
    assert budget.device_budget_bytes() is None


@pytest.mark.parametrize("kw", [
    dict(K=31),
    dict(K=31, lut_p=12, kstep=3, direct_resolve=True),
    dict(K=32, lut_p=11, kstep=2, sample_rate=32, fast_resolve=True),
    dict(K=20, kstep=1, max_read_len=100),
    dict(K=25, lut_p=8, kstep=3, sample_rate=16, fast_resolve=True),
])
def test_psum_estimate_matches_jax(kw):
    """The port's copy of parallel/stats.py (imported by /info for an
    interval-sharded engine) counts the JAX package's step schedules."""
    from readserver_tpu.parallel.stats import query_psum_estimate as want
    from readserver_tpu_torch.parallel.stats import query_psum_estimate

    assert query_psum_estimate(**kw) == want(**kw)
