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
    "corpus/simulate.py",
    "oracle/__init__.py",
    "oracle/fm.py",
    "oracle/naive.py",
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


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_equals_original(rel):
    orig, port = _sources(rel)
    assert port == _ported(orig), (
        f"readserver_tpu_torch/{rel} drifted from readserver_tpu/{rel}: "
        "change both, or neither"
    )


def test_budget_copy_equals_original_but_device_budget():
    orig, port = _sources("index/budget.py")
    head = port[: port.index(BUDGET_TAIL["port"])]
    assert head == _ported(orig[: orig.index(BUDGET_TAIL["orig"])])
    assert "jax" not in port[port.index(BUDGET_TAIL["port"]) :]


def test_no_jax_import_lines():
    files = sorted((REPO / "readserver_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
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
