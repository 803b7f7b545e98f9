"""Pure-Python BAM ingest: BGZF + BAM record reader and fixture writer.

The reference's preprocessing pipeline starts from aligned archives
(SURVEY.md §1 L0: "FASTQ/CRAM in → cleaned … read sets out"); this module
closes that ingest stage for the self-contained member of the family.
BAM is fully specified by the public SAM/BAM format spec (htslib
SAMv1.pdf): a BGZF-framed stream of binary alignment records.  CRAM
proper needs reference-based decode and stays out of scope while the
reference mount is empty (SURVEY.md §0); BAM needs no external reference.

Extraction semantics (matching the reference pipeline's intent):

* secondary (0x100) and supplementary (0x800) alignments are skipped —
  they would duplicate the primary read's bases in the index;
* reverse-strand alignments (0x10) are reverse-complemented back to the
  original read orientation (aligners store the reference-forward
  sequence; the index wants the as-sequenced read);
* qualities are returned phred+33 so `mott_trim_len` applies unchanged.

Reading relies on `gzip`'s concatenated-member support (BGZF blocks are
valid gzip members; the 28-byte EOF block decodes to b"").  Writing emits
spec-correct BGZF: one deflate-raw payload per block wrapped in a gzip
header carrying the BC extra subfield with the total block size, then the
fixed EOF block — so fixtures written here are readable by any BAM tool.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Iterable, Iterator

# 4-bit seq codes, SAM spec table "=ACMGRSVTWYHKDBN"
_NIB = "=ACMGRSVTWYHKDBN"
_NIB_OF = {c: i for i, c in enumerate(_NIB)}
_COMP = str.maketrans("ACGTMRWSYKVHDBN", "TGCAKYWSRMBDHVN")

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(payload: bytes) -> bytes:
    """One spec-correct BGZF block framing ``payload`` (≤ 64 KiB)."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    bsize = len(data) + 25 + 1  # header(12) + XLEN extra(6) + data + crc/isize(8)
    if bsize > 0x10000:
        raise ValueError("BGZF block overflow — shrink the payload slice")
    head = struct.pack(
        "<4BIBBH2BHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,              # mtime, xfl, os=unknown
        6,                       # XLEN
        0x42, 0x43, 2,           # 'B','C', subfield length 2
        bsize - 1,               # BSIZE - 1
    )
    tail = struct.pack("<2I", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return head + data + tail


class _BgzfWriter:
    def __init__(self, fh, block: int = 0xFF00):
        self._fh = fh
        self._buf = bytearray()
        self._block = block

    def write(self, b: bytes) -> None:
        self._buf += b
        while len(self._buf) >= self._block:
            self._fh.write(_bgzf_block(bytes(self._buf[: self._block])))
            del self._buf[: self._block]

    def close(self) -> None:
        if self._buf:
            self._fh.write(_bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)


def write_bam(
    path: str | Path,
    records: Iterable[tuple[str, str, str | None] | tuple],
    refs: list[tuple[str, int]] | None = None,
) -> None:
    """Fixture writer: ``records`` yields ``(name, seq, qual)`` or
    ``(name, seq, qual, flag, ref_id, pos)``.  ``seq`` is the ORIGINAL
    read orientation; reverse-flagged records are stored reference-
    forward (reverse-complemented + reversed quals), exactly the state
    :func:`read_bam` undoes."""
    refs = refs or []
    with open(path, "wb") as raw:
        w = _BgzfWriter(raw)
        text = b"@HD\tVN:1.6\n" + b"".join(
            f"@SQ\tSN:{nm}\tLN:{ln}\n".encode() for nm, ln in refs
        )
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        w.write(struct.pack("<i", len(refs)))
        for nm, ln in refs:
            nb = nm.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
        for rec in records:
            name, seq, qual = rec[0], rec[1], rec[2]
            flag = rec[3] if len(rec) > 3 else FLAG_UNMAPPED
            ref_id = rec[4] if len(rec) > 4 else -1
            pos = rec[5] if len(rec) > 5 else -1
            if flag & FLAG_REVERSE:
                seq = seq.translate(_COMP)[::-1]
                qual = qual[::-1] if qual is not None else None
            nb = name.encode() + b"\x00"
            ls = len(seq)
            nibs = bytearray((ls + 1) // 2)
            for i, c in enumerate(seq):
                v = _NIB_OF.get(c.upper(), 15)
                nibs[i // 2] |= v << (4 if i % 2 == 0 else 0)
            q = (
                bytes(0xFF for _ in range(ls))
                if qual is None
                else bytes(min(max(ord(c) - 33, 0), 93) for c in qual)
            )
            body = (
                struct.pack(
                    "<iiBBHHHiiii",
                    ref_id, pos,
                    len(nb), 0, 4680,  # mapq 0, bin: spec's reg2bin(-1,0)
                    0, flag,           # n_cigar 0
                    ls, -1, -1, 0,
                )
                + nb + bytes(nibs) + q
            )
            w.write(struct.pack("<i", len(body)) + body)
        w.close()


class _Stream:
    """Buffered exact-read helper over the decompressed BGZF stream."""

    def __init__(self, fh):
        self._fh = fh

    def read(self, n: int) -> bytes:
        out = self._fh.read(n)
        while len(out) < n:
            more = self._fh.read(n - len(out))
            if not more:
                if out:
                    raise EOFError("truncated BAM stream")
                return b""
            out += more
        return out


def read_bam(
    path: str | Path,
    skip_flags: int = FLAG_SECONDARY | FLAG_SUPPLEMENTARY,
    keep_duplicates: bool = True,
) -> Iterator[tuple[str, str, str | None]]:
    """Yield ``(name, seq, qual)`` per primary record, in original read
    orientation (reverse-strand alignments un-flipped).  ``qual`` is
    phred+33 or None when absent.  ``skip_flags`` drops any record whose
    flag intersects it; pass ``keep_duplicates=False`` to also drop
    0x400-marked PCR duplicates."""
    if not keep_duplicates:
        skip_flags |= FLAG_DUP
    with gzip.open(path, "rb") as fh:
        s = _Stream(fh)
        magic = s.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"not a BAM file (magic {magic!r})")
        (l_text,) = struct.unpack("<i", s.read(4))
        s.read(l_text)
        (n_ref,) = struct.unpack("<i", s.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", s.read(4))
            s.read(l_name + 4)
        while True:
            head = s.read(4)
            if not head:
                return
            (block_size,) = struct.unpack("<i", head)
            body = s.read(block_size)
            (
                _ref, _pos, l_name, _mapq, _bin, n_cigar, flag, l_seq,
                _nref, _npos, _tlen,
            ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
            if flag & skip_flags:
                continue
            off = 32
            name = body[off : off + l_name - 1].decode()
            off += l_name + 4 * n_cigar
            nseq = (l_seq + 1) // 2
            nibs = body[off : off + nseq]
            off += nseq
            quals = body[off : off + l_seq]
            chars = []
            for i in range(l_seq):
                b = nibs[i // 2]
                chars.append(_NIB[(b >> 4) if i % 2 == 0 else (b & 0xF)])
            seq = "".join(chars)
            qual = (
                None
                if (l_seq == 0 or quals[0] == 0xFF)
                else "".join(chr(q + 33) for q in quals)
            )
            if flag & FLAG_REVERSE:
                seq = seq.translate(_COMP)[::-1]
                qual = qual[::-1] if qual is not None else None
            yield name, seq, qual
