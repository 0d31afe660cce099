"""State-integrity primitives: the checksummed record codec, load-time
corruption screening, and content digests (state-integrity PR tentpole).

The HA stack (PRs 5/6/11) made every mutation journal-first, but the
journal bytes themselves were trusted blindly: one corrupted mid-file
record silently truncated every acknowledged bind behind it. This module
is the shared trust boundary all durable record streams go through:

* **Codec** — :func:`seal` stamps a record with a CRC32 over its
  canonical JSON (sorted keys, compact separators, ``crc`` excluded);
  :func:`verify` recomputes it. Every journal-store ``append``/
  ``rewrite`` seals, every ``load`` verifies — the koordlint
  ``store-integrity`` pass enforces that any class exposing the store
  protocol participates (or carries a written exemption).
* **Screening** — :func:`screen_records` classifies a loaded stream:
  a torn FINAL entry is a crash mid-append (unacknowledged — dropped,
  as before); an unverifiable MID-STREAM record is media corruption and
  is QUARANTINED (counted, surfaced, every verifiable record after it
  kept); duplicated seqs (a crash-retried append) are deduplicated; a
  seq GAP (a write hole) is counted and degrades the ``journal_integrity``
  health row without losing any surviving record.
* **Digests** — :func:`payload_digest` (canonical-JSON CRC, used by the
  checkpoint recovery image) and :func:`array_digest` (shape/dtype/bytes
  CRC over array pytrees, used by the resident-state scrubber and the
  recovery cross-check).

Legacy tolerance: records without a ``crc`` field (pre-codec journals)
load read-only — they are counted (``legacy``) but never quarantined, so
an in-place upgrade replays old journals unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

#: reserved codec field on every sealed record
CRC_FIELD = "crc"


def _canonical_payload(record: dict) -> bytes:
    """Canonical byte form the CRC covers: sorted-key compact JSON of
    everything except the ``crc`` field itself. Canonicalization (not
    the store's wire form) makes the checksum stable across a JSON
    round-trip and across dict insertion orders."""
    return json.dumps(
        {k: v for k, v in record.items() if k != CRC_FIELD},
        sort_keys=True,
        separators=(",", ":"),
    ).encode("utf-8")


def record_crc(record: dict) -> str:
    return format(zlib.crc32(_canonical_payload(record)) & 0xFFFFFFFF, "08x")


def seal(record: dict) -> dict:
    """Copy of ``record`` stamped with its content CRC. Idempotent: a
    record already carrying a correct ``crc`` re-seals to itself (a
    rewrite of loaded records must not re-checksum drifted content —
    an UNVERIFIABLE record never reaches a rewrite; screening dropped
    it at load)."""
    out = dict(record)
    out[CRC_FIELD] = record_crc(out)
    return out


def verify(record: dict) -> Optional[bool]:
    """True/False for a sealed record; None for a legacy (pre-codec)
    record carrying no ``crc`` field."""
    stamped = record.get(CRC_FIELD)
    if stamped is None:
        return None
    return stamped == record_crc(record)


def seal_records(records: Iterable[dict]) -> List[dict]:
    return [seal(r) for r in records]


# ---------------------------------------------------------------------------
# Load-time screening
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IntegrityReport:
    """What one store load found: the degraded/ok evidence behind the
    ``journal_integrity`` health row, the
    ``journal_corrupt_records_total{store}`` counter and ``fsck``."""

    store: str = ""
    total: int = 0          #: entries seen (parse failures included)
    kept: int = 0           #: records that survived screening
    legacy: int = 0         #: kept records with no crc (pre-codec)
    corrupt: int = 0        #: quarantined entries (parse/CRC failures)
    dup_seq: int = 0        #: crash-retry duplicates deduplicated
    seq_gaps: int = 0       #: write holes (missing seq numbers)
    torn_tail: bool = False  #: unparseable FINAL entry (crash mid-append)
    #: human-readable description per quarantined entry, in stream order
    quarantined: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """Clean load: nothing quarantined, no write holes. A torn tail
        and legacy records are NOT integrity failures (the former is an
        unacknowledged append, the latter a tolerated old format)."""
        return self.corrupt == 0 and self.seq_gaps == 0

    def detail(self) -> str:
        return (
            f"corrupt={self.corrupt} seq_gaps={self.seq_gaps} "
            f"dup_seq={self.dup_seq} legacy={self.legacy} "
            f"kept={self.kept}/{self.total}"
        )

    def merge(self, other: "IntegrityReport") -> None:
        self.total += other.total
        self.kept += other.kept
        self.legacy += other.legacy
        self.corrupt += other.corrupt
        self.dup_seq += other.dup_seq
        self.seq_gaps += other.seq_gaps
        self.torn_tail = self.torn_tail or other.torn_tail
        self.quarantined.extend(other.quarantined)


def screen_records(
    entries: Sequence[Tuple[Optional[dict], Optional[str]]],
    store: str = "",
    known_missing_seqs: Optional[Iterable[int]] = None,
) -> Tuple[List[dict], List[Tuple[int, Optional[str]]], IntegrityReport]:
    """Screen one loaded record stream.

    ``entries`` is the stream in storage order: ``(record, raw)`` pairs
    where ``record`` is None for an entry that failed to parse and
    ``raw`` is the storage form to quarantine (None for in-memory
    stores). Returns ``(kept, quarantine, report)`` — ``kept`` the
    surviving records in order, ``quarantine`` the ``(position, raw)``
    entries a sidecar should absorb.

    Classification rules (the tentpole's core distinction):

    * an unparseable FINAL entry is a torn tail — a crash mid-append
      whose bytes were never acknowledged; dropped, not corruption;
    * any other unverifiable entry (parse failure mid-stream, or a CRC
      mismatch anywhere) is media corruption — quarantined, counted,
      and every verifiable record after it is KEPT;
    * a repeated seq with identical payload is a crash-retried append —
      deduplicated to the first copy; a repeated seq with DIFFERENT
      payload quarantines the later copy;
    * a missing seq (gap) is a write hole — counted; nothing to
      quarantine, but the load is not clean.

    ``known_missing_seqs`` names seqs whose absence is ALREADY explained
    (a store's previously quarantined records) — they close their hole
    in the gap math instead of double-reporting one corruption as a
    corrupt record AND a write hole.
    """
    rep = IntegrityReport(store=store, total=len(entries))
    kept: List[dict] = []
    quarantine: List[Tuple[int, Optional[str]]] = []
    last = len(entries) - 1
    #: seq -> record payload for gap/dup math; quarantined and
    #: previously-quarantined seqs participate (their absence from the
    #: KEPT stream is explained corruption, not a write hole) but never
    #: reach `kept`
    seen_seq: dict = {}
    for s in known_missing_seqs or ():
        if isinstance(s, int):
            seen_seq.setdefault(s, None)
    #: quarantined entries whose seq is UNKNOWABLE (unparseable bytes):
    #: each physically occupied a seq, so each explains one hole — the
    #: gap math must not report the same corruption twice (once as a
    #: corrupt record, again as a write hole)
    no_seq_quarantined = 0
    for pos, (record, raw) in enumerate(entries):
        if record is None:
            if pos == last:
                rep.torn_tail = True
                continue
            rep.corrupt += 1
            rep.quarantined.append(f"entry {pos}: unparseable mid-stream")
            quarantine.append((pos, raw))
            no_seq_quarantined += 1
            continue
        ok = verify(record)
        if ok is False:
            rep.corrupt += 1
            rep.quarantined.append(
                f"entry {pos}: crc mismatch "
                f"(op={record.get('op', '?')} seq={record.get('seq', '?')})"
            )
            quarantine.append((pos, raw))
            if isinstance(record.get("seq"), int):
                seen_seq.setdefault(record["seq"], None)
            continue
        if ok is None:
            rep.legacy += 1
        if record.get("op") == "seq_tombstone":
            # a repair tool's marker: these seqs are EXPLAINED missing
            # (their records were quarantined and rewritten away) — they
            # close their holes in the gap math
            for s in record.get("seqs", ()):
                if isinstance(s, int):
                    seen_seq.setdefault(s, None)
        seq = record.get("seq")
        if isinstance(seq, int):
            prev = seen_seq.get(seq)
            if seq in seen_seq and prev is None:
                # seq known only as quarantined/missing: this verifiable
                # copy stands alone (no payload to compare) — keep it
                seen_seq[seq] = record
                kept.append(record)
                continue
            if prev is not None:
                if _canonical_payload(prev) == _canonical_payload(record):
                    rep.dup_seq += 1
                    continue
                rep.corrupt += 1
                rep.quarantined.append(
                    f"entry {pos}: seq {seq} duplicated with divergent "
                    "payload"
                )
                quarantine.append((pos, raw))
                continue
            seen_seq[seq] = record
        kept.append(record)
    seqs = sorted(s for s in seen_seq if isinstance(s, int))
    for a, b in zip(seqs, seqs[1:]):
        if b > a + 1:
            rep.seq_gaps += b - a - 1
    rep.seq_gaps = max(0, rep.seq_gaps - no_seq_quarantined)
    rep.kept = len(kept)
    return kept, quarantine, rep


# ---------------------------------------------------------------------------
# Content digests
# ---------------------------------------------------------------------------


def payload_digest(obj) -> str:
    """Digest of an arbitrary JSON-serializable payload (the checkpoint
    recovery image): canonical-JSON CRC32 hex. Cheap enough to compute
    on every compaction, strong enough to catch a partially-applied or
    bit-rotted image that still parses."""
    return format(
        zlib.crc32(
            json.dumps(obj, sort_keys=True, separators=(",", ":")).encode(
                "utf-8"
            )
        )
        & 0xFFFFFFFF,
        "08x",
    )


def array_digest(arrays: Iterable) -> str:
    """Digest over an ordered collection of arrays (shape + dtype +
    bytes): the bit-exact fingerprint the anti-entropy scrubber and the
    recovery cross-check compare between the device-resident tables and
    a fresh host lowering."""
    import numpy as np

    crc = 0
    for a in arrays:
        if a is None:
            crc = zlib.crc32(b"none", crc)
            continue
        host = np.ascontiguousarray(np.asarray(a))
        crc = zlib.crc32(str((host.shape, host.dtype.str)).encode(), crc)
        crc = zlib.crc32(host.tobytes(), crc)
    return format(crc & 0xFFFFFFFF, "08x")
