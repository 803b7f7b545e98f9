#!/usr/bin/env python3
"""Where the one-launch pack (K8 and the cohort merge, ``csrc/pack.cu``)
spends its time, block by block, on one card.

    python3 scripts/torch_pack_trace.py [CHECKOUT ...]

Makes a traced copy of each checkout's ``csrc/pack.cu`` (the trace
points below put in at the kernel's steps; a step it cannot find stops
the script), builds it alone with the entry that points its trace at a
buffer into the checkout's ``build/pack_trace/`` (nvcc, a few seconds),
binds it in place of the library's two pack entries, and runs the four
cases of ``scripts/torch_pack_ab.py`` (the same seeded sets at the
served shapes), each set's output held equal to the plain form.  The
traced copy has thread 0 of each block keep its SM's clock at each step
of the kernel and its global time at entry and exit; for each case, over
the 16 sets:

* the kernel's span (first entry to last exit, global time) and the
  spread of the blocks' entries (the dispatch);
* each step's cycles, median and largest over the blocks: the first
  tile's claim, its loads and scan, the steps to its exclusive prefix
  (the look-back, and whatever the build does while it waits), its kept
  entries' stores, then the block's further tiles and its last claim,
  what the block does after its tiles, the wait for the sections'
  totals, the -1 tail; and the same for the block that exited last (the
  trace's own check of a global word costs the four steps of a tile
  about one L2 read each);
* the blocks, and the tiles a block took; the traced launch's grid and
  registers a thread as the profiler records them (the trace may change
  the registers, and so the blocks an SM holds: compare the library's in
  ``scripts/torch_pack_ab.py``'s output).

Each checkout runs in its own process.  Imports torch, never jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
STEPS = ("claim", "loads + scan", "to the prefix", "kept stores",
         "more tiles + last claim", "segments after the tiles",
         "totals wait", "-1 tail")
WORDS = 16  # trace words a block

# The trace: thread 0 of each block keeps its SM's clock at each step of
# the kernel (words 0-8; the claim and the steps of a tile for its first
# tile), its global time at entry and exit (9, 10), its SM (11) and the
# tiles it took (12), 16 words a block; and the entry that points it at a
# buffer (null: keep none).
TRACE_SRC = r"""
__device__ unsigned long long* trace_buf;

__device__ __forceinline__ void trace(int k, unsigned long long v) {
  if (trace_buf != nullptr && threadIdx.x == 0) {
    trace_buf[16ULL * blockIdx.x + k] = v;
  }
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
#define RS_TRACE(k) trace(k, clock64())
#define RS_TRACE_FIRST(k)                                               \
  if (trace_buf != nullptr && trace_buf[16ULL * blockIdx.x + (k)] == 0) \
  trace(k, clock64())
#define RS_TRACE_EDGE(k) (trace(k, global_ns()), trace(11, sm_id()))
#define RS_TRACE_TILE() \
  if (trace_buf != nullptr && threadIdx.x == 0) ++trace_buf[16ULL * blockIdx.x + 12]
"""
TRACE_ENTRY = r"""
extern "C" int rs_pack_trace_to(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(trace_buf, &buf, sizeof buf));
}
"""
# (a line of pack.cu's kernel, the same line with its trace points): each
# line is found once, or the copy is not made
POINTS = (
    ("  bool segments = true;  // this block's segments still to write\n",
     "  bool segments = true;\n  RS_TRACE_EDGE(9);\n  RS_TRACE(0);\n"),
    ("    const int tile = claimed;\n",
     "    const int tile = claimed;\n    RS_TRACE_FIRST(1);\n"),
    ("    if (tile >= T) break;\n",
     "    if (tile >= T) break;\n    RS_TRACE_TILE();\n"),
    ("    const uint32_t agg = (total & 0xFFFF) + (total >> 16);\n",
     "    const uint32_t agg = (total & 0xFFFF) + (total >> 16);\n"
     "    RS_TRACE_FIRST(2);\n"),
    ("    // the tile's kept entries below slot R, side by side\n",
     "    RS_TRACE_FIRST(3);\n"),
    ("  }\n  if (segments) write_segments(src, out, L);\n",
     "    RS_TRACE_FIRST(4);\n  }\n  RS_TRACE(5);\n"
     "  if (segments) write_segments(src, out, L);\n  RS_TRACE(6);\n"),
    ("  const int th = static_cast<int>(totals[0]);\n",
     "  RS_TRACE(7);\n  const int th = static_cast<int>(totals[0]);\n"),
    ("    out[L.bad] = bad[0];\n  }\n",
     "    out[L.bad] = bad[0];\n  }\n  RS_TRACE(8);\n"
     "  RS_TRACE_EDGE(10);\n"),
)


def traced_source(src: str) -> str:
    """pack.cu with the trace before its kernel (in pack.cu's anonymous
    namespace) and the trace points in it, and the trace's entry at the
    end."""
    kernel = src.index("// The whole pack in one launch")
    out = src[:kernel] + TRACE_SRC + "\n" + src[kernel:]
    for line, traced in POINTS:
        if out.count(line) != 1:
            raise SystemExit(f"pack.cu has {out.count(line)} of the traced "
                             f"line {line!r}: the trace no longer fits it")
        out = out.replace(line, traced)
    return out + TRACE_ENTRY


def build_traced(checkout: Path) -> ctypes.CDLL:
    """A traced copy of the checkout's pack.cu built alone, bound."""
    from readserver_tpu_torch.kernels import build as kbuild

    src = checkout / "readserver_tpu_torch" / "csrc" / "pack.cu"
    text = traced_source(src.read_text())
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    out = checkout / "build" / "pack_trace" / f"libpack_trace_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        unit = out.with_suffix(".cu")
        unit.write_text(text)
        subprocess.run(
            [kbuild._nvcc(), *kbuild.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", str(unit), "-o", str(out)],
            check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("rs_sparse_pack", "rs_merge_pack"):
        fn = getattr(lib, name)
        fn.argtypes = kbuild.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.rs_pack_trace_to.argtypes = [ctypes.c_void_p]
    lib.rs_pack_trace_to.restype = ctypes.c_int
    return lib


def summarize(traces: list) -> dict:
    """Per-call traces (int64 [blocks, WORDS]) → the case's readings."""
    spans, spreads, ns_per_cycle = [], [], []
    steps, last = [], []
    blocks, tiles = [], []
    for t in traces:
        t = t[t[:, 9] > 0]
        entry, exit_ = t[:, 9], t[:, 10]
        spans.append(int(exit_.max() - entry.min()))
        spreads.append(int(entry.max() - entry.min()))
        cycles = t[:, 8] - t[:, 0]
        ok = cycles > 0
        ns_per_cycle.append(float(np.median((exit_ - entry)[ok]
                                            / cycles[ok])))
        d = np.diff(t[:, 0:9], axis=1)
        # a block that took no tile has no steps 2-4 (their clocks are 0)
        d[t[:, 2] == 0, 1:4] = 0
        d[t[:, 2] == 0, 4] = t[t[:, 2] == 0, 5] - t[t[:, 2] == 0, 1]
        d[t[:, 2] == 0, 0] = t[t[:, 2] == 0, 1] - t[t[:, 2] == 0, 0]
        steps.append(d)
        last.append(d[int(np.argmax(exit_))])
        blocks.append(len(t))
        tiles.append(t[:, 12])
    d = np.concatenate(steps)
    return {
        "span_ns": float(np.median(spans)),
        "entry_spread_ns": float(np.median(spreads)),
        "ns_per_cycle": float(np.median(ns_per_cycle)),
        "blocks": int(np.median(blocks)),
        "tiles_a_block_max": int(max(int(x.max()) for x in tiles)),
        "median_cycles": {s: float(np.median(d[:, i]))
                          for i, s in enumerate(STEPS)},
        "max_cycles": {s: float(d[:, i].max()) for i, s in enumerate(STEPS)},
        "last_block_cycles": {s: float(np.median([x[i] for x in last]))
                              for i, s in enumerate(STEPS)},
    }


def child(checkout: str) -> dict:
    root = Path(checkout)
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(REPO / "scripts"))
    import torch
    import torch_pack_ab as ab
    from readserver_tpu_torch.ops import pack

    lib = build_traced(root)
    pack.SPARSE_PACK._fn = lib.rs_sparse_pack
    pack.MERGE_PACK._fn = lib.rs_merge_pack
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    ns, bases = [128] * 4, [0, 600_000, 1_200_000, 1_800_000]
    cases = {
        "K8 /reads": (ab.answer_sets(rng, 8192, 1, 64, 0.85, 0.145, dev),
                      lambda x: pack.pack_answer(*x, 8192, ab.CPQ, bad,
                                                 64)[0],
                      lambda x: pack.pack_answer_plain(*x, 8192, ab.CPQ,
                                                       bad, 64)[0]),
        "K8 /samples": (ab.answer_sets(rng, 8192, 128, 0, 0.018, 0, dev),
                        lambda x: pack.pack_answer(*x, 8192, ab.CPQ, bad,
                                                   64)[0],
                        lambda x: pack.pack_answer_plain(*x, 8192, ab.CPQ,
                                                         bad, 64)[0]),
    }
    for name, hits in (("merge /reads", True), ("merge /samples", False)):
        cases[name] = (
            ab.merge_sets(rng, 4096, ns, 64, hits, 0.005, 0.01, dev),
            lambda x, h=hits: pack.merge_pack(x, ns, bases, 128, 64, 4096,
                                              ab.CPQ, bad, h)[0],
            lambda x, h=hits: pack.merge_pack_plain(x, ns, bases, 128, 64,
                                                    4096, ab.CPQ, bad,
                                                    h)[0])
    buf = torch.zeros(WORDS * 8192, dtype=torch.int64, device=dev)
    res = {"checkout": checkout, "card": torch.cuda.get_device_name(0)}
    for name, (sets, kern, plain) in cases.items():
        for x in sets:
            if not torch.equal(kern(x), plain(x)):
                raise SystemExit(f"{checkout}: {name} differs from its "
                                 "plain form")
        for x in sets:  # warm
            kern(x)
        torch.cuda.synchronize()
        lib.rs_pack_trace_to(buf.data_ptr())
        traces = []
        for x in sets:
            buf.zero_()
            torch.cuda.synchronize()
            kern(x)
            torch.cuda.synchronize()
            traces.append(buf.view(-1, WORDS).cpu().numpy())
        lib.rs_pack_trace_to(None)
        torch.cuda.synchronize()
        res[name] = summarize(traces)
        res[name]["launch"] = ab.launches(lambda: kern(sets[0]))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="*", help="checkouts' roots "
                    "(default: this one)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for root in [str(Path(c).resolve()) for c in args.checkouts] or [
            str(REPO)]:
        proc = subprocess.run([sys.executable, __file__, "--child", root],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        res = json.loads(line)
        print(f"# {Path(root).name} | {card}")
        for name in ("K8 /reads", "K8 /samples", "merge /reads",
                     "merge /samples"):
            r = res[name]
            k = r["ns_per_cycle"]
            print(f"# {name}: span {r['span_ns'] / 1e3:.2f} us, entries "
                  f"spread {r['entry_spread_ns'] / 1e3:.2f} us, "
                  f"{r['blocks']} blocks, <= {r['tiles_a_block_max']} tiles "
                  f"a block, launch {r['launch']}; ns a step, median / max "
                  f"/ last block: "
                  + "; ".join(
                      f"{s} {r['median_cycles'][s] * k:.0f} / "
                      f"{r['max_cycles'][s] * k:.0f} / "
                      f"{r['last_block_cycles'][s] * k:.0f}" for s in STEPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
