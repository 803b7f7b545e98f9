"""In-place artifact upgrade: synthesize missing tiers, never rebuild.

A format/tier evolution must not orphan an expensive artifact (a chr20-
scale build is hours of SA-IS; the reference's stable on-disk ``.bwt``
format never paid rebuild-on-upgrade): every optional tier the current
builder emits is derivable from the base arrays alone —

* the BWT itself is stored 4-bit in ``sym4``;
* plain LF comes from the BWT + C (one counting pass);
* per-SA-row ``(read, offset)`` attribution comes from the lockstep LF
  walk (``from_bwt.rows_from_lf``, O(n) gathers, no suffix array);
* the k-step search planes are functions of (BWT, LF).

``upgrade_artifact`` computes exactly the missing arrays, writes only
those files, and atomically extends the manifest; a sample_rate-change
rewrite goes to rate-versioned filenames flipped via the manifest's
"files" mapping, so at EVERY crash point the live artifact is either
fully old-rate or fully new-rate — never a mix.  The result is
bit-identical to a from-scratch build at the same config (tested in
``tests/test_upgrade.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from readserver_tpu_torch.index import artifact, packing
from readserver_tpu_torch.index.builder import (
    TRIPLE_TIER_MAX_N,
    resolve_tiers_from_rows,
)

# the optional tiers the current builder emits, grouped by what it takes
# to synthesize them
RESOLVE_TIERS = ("lf", "mark_rank", "sample_pairs", "dsa", "fused_rows")
PAIR_TIERS = ("rank2_blocks", "C2")
TRIPLE_TIERS = ("rank3_blocks", "C3")


def plan_upgrade(
    path: str | Path, kstep: int | None = None, fast_resolve: bool = True
) -> list[str]:
    """Arrays an upgrade would add (empty = artifact is current)."""
    manifest = json.loads(
        (Path(path) / artifact.MANIFEST_NAME).read_text()
    )
    present = set(manifest["arrays"])
    n = int(manifest["n"])
    if kstep is None:
        kstep = 3 if n <= TRIPLE_TIER_MAX_N else 2
    want: list[str] = []
    if fast_resolve:
        want += [t for t in RESOLVE_TIERS if t not in present]
    if kstep >= 2:
        want += [t for t in PAIR_TIERS if t not in present]
    if kstep >= 3:
        want += [t for t in TRIPLE_TIERS if t not in present]
    return want


def upgrade_artifact(
    path: str | Path,
    kstep: int | None = None,
    sample_rate: int | None = None,
    fast_resolve: bool = True,
) -> list[str]:
    """Add every missing tier to an existing artifact dir, in place.

    ``sample_rate`` defaults to the artifact's recorded rate (or 32 when
    it was built without fast resolve).  Returns the added array names.
    """
    path = Path(path)
    manifest = json.loads((path / artifact.MANIFEST_NAME).read_text())
    missing = plan_upgrade(path, kstep=kstep, fast_resolve=fast_resolve)
    packed = artifact.load_artifact(path, mmap=True)
    config = packed.config
    rate = sample_rate or packed.sample_rate or 32
    # a rate change makes the EXISTING resolve tiers (mark sign bits,
    # mark_rank, sample_pairs, fused mark planes) inconsistent with the
    # new ones — the resolve walks bound their step count by sample_rate,
    # so mixing densities returns garbage hits.  Rewrite the whole
    # resolve tier set at the new rate instead.
    if (
        fast_resolve
        and packed.sample_rate
        and rate != packed.sample_rate
    ):
        missing = sorted(set(missing) | set(RESOLVE_TIERS))
    if not missing:
        return []

    bwt = packing.unpack_sym4(np.asarray(packed.sym4), packed.n)
    C = np.asarray(packed.C)
    from readserver_tpu_torch.index.from_bwt import plain_lf, rows_from_lf

    if packed.lf is not None:
        # stored lf carries mark sign bits; strip to the plain mapping
        lf0 = (np.asarray(packed.lf) & np.int32(0x7FFFFFFF)).astype(
            np.int32
        )
    else:
        lf0 = plain_lf(bwt, C)

    new: dict[str, np.ndarray] = {}
    meta_updates: dict[str, int] = {}
    if any(t in missing for t in RESOLVE_TIERS):
        read_of, offsets = rows_from_lf(
            lf0, np.asarray(packed.read_lengths)
        )
        tiers = resolve_tiers_from_rows(
            read_of,
            offsets,
            np.asarray(packed.read_lengths),
            lf0,
            bwt,
            config,
            rate,
        )
        del read_of, offsets
        for t in RESOLVE_TIERS:
            if t in missing:
                new[t] = tiers[t]
        meta_updates["sample_rate"] = rate
        meta_updates["dsa_bits"] = tiers["dsa_bits"]
    if any(t in missing for t in PAIR_TIERS):
        rank_blocks = np.asarray(packed.rank_blocks)
        pair = packing.pair_codes_from_lf(bwt, lf0)
        new["rank2_blocks"], _ = packing.pack_plane_blocks(pair, 16, config)
        new["C2"] = packing.pair_C2(rank_blocks, C, config)
        del pair
    if any(t in missing for t in TRIPLE_TIERS):
        rank_blocks = np.asarray(packed.rank_blocks)
        triple = packing.triple_codes_from_lf(bwt, lf0)
        new["rank3_blocks"], _ = packing.pack_plane_blocks(
            triple, 64, config
        )
        new["C3"] = packing.kgram_starts(rank_blocks, C, config, 3)
        del triple

    # Crash safety (ADVICE r4, medium): additive arrays are unreferenced
    # until the manifest flips, so they write to their default filenames
    # directly.  REWRITES of live arrays (the sample_rate-change path)
    # must never overwrite the referenced file — mark sign bits at the
    # new rate next to mark_rank/sample_pairs at the old rate is exactly
    # the mixed-density garbage-hits state the module warns about, and it
    # is undetectable at load time.  They write to rate-versioned files
    # and the manifest's "files" mapping flips to them atomically with
    # the manifest rename; the superseded files are deleted only after.
    files: dict[str, str] = dict(manifest.get("files", {}))
    present = set(manifest["arrays"])
    stale: list[Path] = []
    for name, arr in new.items():
        if name in present:
            fname = f"{name}.r{rate}.npy"
            old = files.get(name, f"{name}.npy")
            if old == fname:  # same versioned name: write aside + rename
                tmp_a = path / (fname + ".tmp.npy")
                np.save(tmp_a, arr)
                tmp_a.rename(path / fname)
                continue
            np.save(path / fname, arr)
            files[name] = fname
            stale.append(path / old)
        else:
            np.save(path / f"{name}.npy", arr)
    # dedupe: a rate-change rewrite touches arrays already listed
    manifest["arrays"] = list(
        dict.fromkeys(list(manifest["arrays"]) + sorted(new))
    )
    if files:
        manifest["files"] = files
    manifest.update(meta_updates)
    tmp = path / (artifact.MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.rename(path / artifact.MANIFEST_NAME)
    for p in stale:  # best-effort space reclaim, post-flip
        try:
            p.unlink()
        except OSError:
            pass
    return sorted(new)
