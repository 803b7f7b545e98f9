#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds (on the cell's first run in the
checkout) or loads the cell's deployment, serves closed-loop clients
through ``readserver_tpu_torch``'s dispatcher for ``--seconds``, then
judges a seed-drawn share of the answers against the NumPy reference.
The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, ``build_s`` (the seconds spent building the artifact
on the checkout's first run, else 0; not part of ``setup_s``), and last
``compared``: each number judged with its limit, also the last lines on
standard error.

It needs as many CUDA cards as the cell names, and exits with another
code than 0, printing no result, where they are missing, where the
program is missing, and where JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "readserver_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), whole,
    is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.cell import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); {have} found")
        return 3
    import readserver_tpu_torch  # noqa: F401  (the program under test)

    from harness.runner import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, log=_log)
    bad = forbidden_modules()
    if bad:
        _log(f"loaded in this process, and the port must load none: {bad}")
        return 4
    _log(_power())
    for name, num in result["compared"].items():
        kind, limit = next((k, v) for k, v in num.items() if k != "value")
        _log(f"{name} {num['value']} ({kind.replace('_', ' ')} {limit})")
    _log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


def _power() -> str:
    """The card's name and power limit, for the record."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return "card: " + out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi unavailable ({e})"


if __name__ == "__main__":
    sys.exit(main())
