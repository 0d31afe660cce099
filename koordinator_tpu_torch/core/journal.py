"""Durable write-ahead bind journal + leader fencing epochs (HA tentpole).

The robustness PR made a *process* crash-safe within one commit (the
transactional ``_ReserveJournal`` rolls a half-applied chunk back); this
module makes the *scheduler role* crash-safe across processes:

* :class:`BindJournal` — an append-only write-ahead log of commit
  intents, acknowledged binds and forgets. The contract is **journal
  before mutate**: a chunk whose intent record cannot be written is
  rejected before any snapshot mutation, and a bind is *acknowledged*
  only once its record is durably appended — so a takeover can rebuild
  exactly the acknowledged world from the statehub resync plus a journal
  replay (``runtime/recovery.py``), with zero lost acknowledged bindings
  and zero duplicate placements.
* :class:`EpochFence` — the monotonic fencing authority (the lease
  record's epoch in a multi-process deployment; one shared object
  in-process). Every leadership grant carries an epoch; the commit and
  snapshot-channel boundaries check the caller's epoch against the
  current grant, so a deposed leader's in-flight commit raises
  :class:`StaleEpochError` instead of double-placing pods. The journal
  itself enforces the same monotonicity at the storage boundary — a
  write stamped with an epoch older than one already journaled is
  refused, the classic fencing-token-on-shared-store discipline.

Failure domain (ROADMAP rule): the named chaos point
``journal.write_fail`` fires inside :meth:`BindJournal._append`; callers
see :class:`JournalWriteError` and reject the chunk un-mutated. A second
point, ``journal.compact_crash``, fires inside :meth:`BindJournal.compact`
and simulates a process death mid-compaction: the live log stays intact
(the rewrite is tmp-file + atomic rename), only a torn temp file is left
behind, and a fresh store open repairs/ignores it.

Horizontal partitioning (PR 6): a :class:`BindJournal` can be scoped to
one **shard** (``shard=``) — every record is stamped with the shard id
and the journal's epoch monotonicity then *is* the shard's fencing
history, independent of every other shard's. :class:`ClaimTable` is the
cross-shard arbiter: before a shard's pump may schedule a pod that was
fanned out to several shards, it must win the pod's claim record —
first-writer-wins, epoch-fenced per shard — so two shards can never
bind the same pod.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..chaos import NULL_INJECTOR
from . import integrity


class FencingError(RuntimeError):
    """Base for leadership-fencing violations."""


class StaleEpochError(FencingError):
    """The caller's fencing epoch is no longer the current grant — its
    leadership was superseded (or locally revoked) and the guarded
    mutation must not proceed."""

    def __init__(self, epoch: int, current: int, what: str = "epoch"):
        super().__init__(
            f"stale leadership {what}: held {epoch}, current {current}"
        )
        self.epoch = epoch
        self.current = current


class JournalWriteError(RuntimeError):
    """A journal append failed (storage error or injected fault). The
    guarded mutation must not proceed — journal before mutate."""


class EpochFence:
    """Thread-safe monotonic fencing authority.

    ``advance()`` models a fresh leadership grant (the lease takeover
    bumping the record's epoch); ``adopt(epoch)`` mirrors an externally
    observed grant and refuses to move backwards; ``check(epoch)``
    raises :class:`StaleEpochError` when the caller's grant is no longer
    current (``epoch < 0`` is the locally-revoked sentinel a deposed
    scheduler stamps on itself — it always fails the check).
    """

    def __init__(self, start: int = 0):
        self._epoch = int(start)
        self._lock = threading.Lock()

    def advance(self) -> int:
        with self._lock:
            self._epoch += 1
            return self._epoch

    def adopt(self, epoch: int) -> int:
        with self._lock:
            if epoch < self._epoch:
                raise StaleEpochError(epoch, self._epoch, what="grant")
            self._epoch = int(epoch)
            return self._epoch

    def current(self) -> int:
        with self._lock:
            return self._epoch

    def check(self, epoch: int) -> None:
        with self._lock:
            if epoch < 0 or epoch != self._epoch:
                raise StaleEpochError(epoch, self._epoch)


# ---------------------------------------------------------------------------
# Journal stores: same record API over an in-memory list (tests, sim) and
# an append-only JSONL file (real durability across a process crash).
# ---------------------------------------------------------------------------


def _fold_integrity(store, rep, new_desc) -> None:
    """Fold one load's NEW findings into the store's cumulative report
    and its wired ``journal_corrupt_records_total{store}`` counter.
    ``new_desc`` lists descriptions of the NEWLY quarantined entries
    only. Findings that persist in the stream across loads (write
    holes, crash-retry duplicates) count via high-water deltas — one
    event, one increment, however many loads re-observe it."""
    newly_corrupt = len(new_desc)
    new_gaps = max(0, rep.seq_gaps - store._gap_high)
    store._gap_high = max(store._gap_high, rep.seq_gaps)
    new_dups = max(0, rep.dup_seq - store._dup_high)
    store._dup_high = max(store._dup_high, rep.dup_seq)
    store.last_integrity = rep
    total = store.integrity_total
    total.corrupt += newly_corrupt
    total.seq_gaps += new_gaps
    total.dup_seq += new_dups
    total.legacy = rep.legacy
    # kept/total mirror the LATEST load (cumulative counts above carry
    # the history; the size fields answer "what does the store hold now")
    total.kept = rep.kept
    total.total = rep.total
    total.torn_tail |= rep.torn_tail
    total.quarantined.extend(new_desc)
    fresh = newly_corrupt + new_gaps
    if fresh and store.corrupt_counter is not None:
        store.corrupt_counter.inc(float(fresh))


class MemoryJournalStore:
    """Record list in memory — survives a *simulated* crash (the store
    object outlives the scheduler it journals for), not a real one.

    ``lock`` serializes multi-writer access at the STORE: several
    BindJournal instances legitimately share one store (the standby-
    forget pattern journals through a fresh view of the owner's store),
    and each instance's own lock cannot order their writes against a
    compaction rewrite.

    State-integrity PR: every append/rewrite SEALS its record with the
    shared CRC codec (:mod:`..core.integrity`) and every load screens —
    an unverifiable record (the ``journal.corrupt_record`` chaos point's
    simulated media fault) is moved into :attr:`quarantined`, counted,
    and every verifiable record after it is kept."""

    def __init__(self, name: str = "memory") -> None:
        self.lock = threading.RLock()
        self.name = name
        self._records: List[dict] = []
        #: corrupt records screened out of the live stream, in detection
        #: order — the in-memory analog of the file store's sidecar
        self.quarantined: List[dict] = []
        #: optional ``journal_corrupt_records_total{store}`` child
        #: counter, incremented once per NEWLY detected corrupt record
        #: or write hole
        self.corrupt_counter = None
        #: last load's screening report / cumulative new findings
        self.last_integrity = integrity.IntegrityReport(store=name)
        self.integrity_total = integrity.IntegrityReport(store=name)
        self._gap_high = 0
        self._dup_high = 0
        #: seqs of quarantined records still relevant to the CURRENT
        #: stream's numbering (cleared on rewrite — a compaction
        #: renumbers, and a stale low anchor would fabricate holes)
        self._known_missing: set = set()

    def append(self, record: dict) -> None:
        self._records.append(integrity.seal(record))

    def load(self) -> List[dict]:
        with self.lock:
            kept, quarantine, rep = integrity.screen_records(
                [(dict(r), None) for r in self._records],
                store=self.name,
                # seqs of records already MOVED to the quarantine ledger
                # (this stream numbering's — see rewrite): their absence
                # is explained corruption, not a write hole
                known_missing_seqs=self._known_missing,
            )
            if quarantine:
                # quarantine is a MOVE: the corrupt record leaves the
                # live stream (so repeated loads do not re-count it) and
                # lands in the sidecar list for forensics/fsck
                bad = {pos for pos, _raw in quarantine}
                for pos in sorted(bad):
                    moved = self._records[pos]
                    self.quarantined.append(moved)
                    if isinstance(moved.get("seq"), int):
                        self._known_missing.add(moved["seq"])
                self._records = [
                    r
                    for pos, r in enumerate(self._records)
                    if pos not in bad
                ]
            _fold_integrity(self, rep, list(rep.quarantined))
            return kept

    def rewrite(self, records: Sequence[dict]) -> None:
        self._records = integrity.seal_records(records)
        # a rewrite renumbers the stream: stale gap/dup high-waters and
        # quarantined-seq anchors from the OLD numbering would fabricate
        # phantom write holes (and then mask real ones)
        self._gap_high = 0
        self._dup_high = 0
        self._known_missing.clear()

    def load_tail(self) -> Optional[List[dict]]:
        """Bounded-RTO read path: the verified records from the LAST
        checkpoint onward, or None when there is no usable checkpoint
        anchor OR the tail is not clean (caller falls back to
        :meth:`load`, which owns quarantine/counter/health accounting —
        the fast path must never swallow a corrupt acked record
        silently)."""
        with self.lock:
            start = None
            for i in range(len(self._records) - 1, -1, -1):
                if self._records[i].get("op") == "checkpoint":
                    start = i
                    break
            if start is None or start == 0:
                return None
            kept, quarantine, rep = integrity.screen_records(
                [(dict(r), None) for r in self._records[start:]],
                store=self.name,
            )
            if quarantine or not rep.ok:
                return None
            if kept and kept[0].get("op") == "checkpoint":
                return kept
            return None

    def corrupt_last_record(self) -> None:
        """Chaos helper (``journal.corrupt_record``): flip the payload of
        the most recent record WITHOUT re-sealing — the simulated media
        fault the load-time screen must quarantine."""
        if self._records:
            self._records[-1]["__bitrot__"] = 1


class FileJournalStore:
    """Append-only JSON-lines file. Each record is one line, flushed on
    append (``fsync=True`` additionally forces it to stable storage —
    the real durability point; default off because per-record fsync
    dominates commit latency and tests/benches exercise replay, not
    media failure). ``load`` tolerates a torn final line: a crash mid-
    append leaves a partial record, which is exactly an unacknowledged
    write and is discarded.

    State-integrity PR: appends/rewrites SEAL each record with the
    shared CRC codec and ``load`` screens — an unverifiable MID-FILE
    line (media corruption, not a torn tail) is QUARANTINED into the
    ``<path>.quarantine`` sidecar, counted
    (``journal_corrupt_records_total{store}``), and every verifiable
    line after it is kept instead of silently truncated. Records
    without a ``crc`` field (pre-codec journals) load read-only."""

    def __init__(self, path: str, fsync: bool = False,
                 name: Optional[str] = None):
        self.path = path
        self.fsync = fsync
        self.name = name if name is not None else os.path.basename(path)
        #: same multi-writer contract as MemoryJournalStore.lock
        self.lock = threading.RLock()
        #: same integrity surface as MemoryJournalStore
        self.corrupt_counter = None
        self.last_integrity = integrity.IntegrityReport(store=self.name)
        self.integrity_total = integrity.IntegrityReport(store=self.name)
        self._gap_high = 0
        self._dup_high = 0
        #: line positions already quarantined (the sidecar write and the
        #: counter must fire once per corrupt line, not once per load —
        #: the file is append-only between rewrites, so positions are
        #: stable; reset on rewrite/repair)
        self._quarantined_pos: set = set()
        # a crash mid-compaction leaves a stale (possibly torn) temp file
        # behind; the atomic-rename discipline means it was never the
        # journal — drop it so it cannot shadow a later rewrite
        try:
            os.unlink(path + ".tmp")
        except FileNotFoundError:
            pass
        self._repair_torn_tail()
        self._f = open(path, "a", encoding="utf-8")

    def _repair_torn_tail(self) -> None:
        """Truncate a partial final line left by a crash mid-append —
        BEFORE the append handle opens. Without this the next append
        would merge into the partial line, making one unparseable record
        that load() stops at, silently discarding every post-restart
        append behind it. The truncated bytes were never acknowledged."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(size - 1)
                if f.read(1) == b"\n":
                    return
                f.seek(0)
                data = f.read(size)
                cut = data.rfind(b"\n") + 1  # 0 when no newline at all
                f.truncate(cut)
        except FileNotFoundError:
            pass

    def append(self, record: dict) -> None:
        self._f.write(
            json.dumps(integrity.seal(record), separators=(",", ":")) + "\n"
        )
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def load(self) -> List[dict]:
        with self.lock:
            entries: List[tuple] = []
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    for line in f:
                        stripped = line.strip()
                        if not stripped:
                            continue
                        try:
                            entries.append((json.loads(stripped), stripped))
                        except json.JSONDecodeError:
                            # screen_records decides: torn tail when
                            # final, quarantined corruption otherwise
                            entries.append((None, stripped))
            except FileNotFoundError:
                return []
            kept, quarantine, rep = integrity.screen_records(
                entries, store=self.name
            )
            # quarantine and rep.quarantined are parallel: select the
            # entries not seen before (positions are stable between
            # rewrites in an append-only file), so the sidecar write,
            # the counter and the cumulative descriptions each fire
            # once per corrupt line
            fresh_idx = [
                i
                for i, (pos, _raw) in enumerate(quarantine)
                if pos not in self._quarantined_pos
            ]
            if fresh_idx:
                with open(
                    self.path + ".quarantine", "a", encoding="utf-8"
                ) as q:
                    for i in fresh_idx:
                        q.write((quarantine[i][1] or "") + "\n")
                self._quarantined_pos.update(
                    quarantine[i][0] for i in fresh_idx
                )
            _fold_integrity(
                self, rep, [rep.quarantined[i] for i in fresh_idx]
            )
            return kept

    def rewrite(self, records: Sequence[dict]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for r in records:
                f.write(
                    json.dumps(integrity.seal(r), separators=(",", ":"))
                    + "\n"
                )
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        # a rewrite re-numbers the file: stale quarantine positions must
        # not mask corruption at re-used positions, and stale gap/dup
        # high-waters would fabricate (or absorb) write holes
        self._quarantined_pos.clear()
        self._gap_high = 0
        self._dup_high = 0

    def load_tail(self) -> Optional[List[dict]]:
        """Bounded-RTO read path (same contract as
        ``MemoryJournalStore.load_tail``): split lines cheaply, find the
        LAST line carrying a checkpoint marker by substring probe, and
        json-parse + CRC-verify only from there — recovery work scales
        with (live set + tail), not journal length. None when no usable
        anchor exists (caller falls back to the full :meth:`load`)."""
        with self.lock:
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    lines = [
                        ln.strip() for ln in f if ln.strip()
                    ]
            except FileNotFoundError:
                return None
            start = None
            for i in range(len(lines) - 1, -1, -1):
                if '"op":"checkpoint"' in lines[i]:
                    start = i
                    break
            if start is None or start == 0:
                return None
            entries: List[tuple] = []
            for raw in lines[start:]:
                try:
                    entries.append((json.loads(raw), raw))
                except json.JSONDecodeError:
                    entries.append((None, raw))
            kept, quarantine, rep = integrity.screen_records(
                entries, store=self.name
            )
            if quarantine or not rep.ok:
                # an unclean tail must go through the full load, which
                # owns quarantine/counter/health accounting — the fast
                # path never swallows a corrupt acked record silently
                return None
            if kept and kept[0].get("op") == "checkpoint":
                return kept
            return None

    def corrupt_last_record(self) -> None:
        """Chaos helper (``journal.corrupt_record``): flip one byte in
        the MIDDLE of the last line — a complete, newline-terminated,
        CRC-failing record (media corruption), distinct from a torn
        tail."""
        with self.lock, open(self.path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < 3:
                return
            f.seek(0)
            raw = f.read(size)
            cut = raw.rstrip(b"\n").rfind(b"\n") + 1
            line = raw[cut:].rstrip(b"\n")
            if not line:
                return
            mid = cut + len(line) // 2
            f.seek(mid)
            byte = raw[mid:mid + 1]
            f.write(b"#" if byte != b"#" else b"@")
            f.flush()

    def simulate_torn_rewrite(self, record: dict) -> None:
        """Chaos helper (``journal.compact_crash``): model a process
        death mid-rewrite — half of the checkpoint line reaches the temp
        file, the live log is untouched, and the dying process never got
        to the atomic rename. The next open must ignore the orphan."""
        line = json.dumps(record, separators=(",", ":"))
        with open(self.path + ".tmp", "w", encoding="utf-8") as f:
            f.write(line[: max(1, len(line) // 2)])
            f.flush()

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# Replay view
# ---------------------------------------------------------------------------


@dataclass
class JournalReplay:
    """What a takeover rebuilds from the log: the acknowledged live set
    (binds minus forgets; an intent without a matching bind/abort —
    a crash mid-commit — contributes nothing, because the dying
    process's host mutations died with it)."""

    #: uid -> bind entry dict (node/req/est/prod/nom/conf), last write wins
    live: Dict[str, dict] = field(default_factory=dict)
    epoch_high: int = 0
    seq_high: int = 0
    binds: int = 0
    forgets: int = 0
    intents: int = 0
    aborts: int = 0
    #: intents never closed by a bind/abort (crash-mid-commit windows)
    open_intents: int = 0
    #: state-integrity PR: True when the replay fast-forwarded from a
    #: digest-verified checkpoint recovery image (bounded RTO — the
    #: pre-checkpoint history was neither parsed into the live set nor
    #: re-applied); the count of records actually APPLIED is
    #: ``applied`` (the RTO-bearing number the recovery bench sweeps)
    used_checkpoint: bool = False
    applied: int = 0
    #: checkpoint images REJECTED (image digest mismatch, or the
    #: ``checkpoint.digest_mismatch`` chaos point) — each rejection
    #: falls the replay back toward full history
    checkpoint_fallbacks: int = 0
    #: corrupt records the store quarantined across its lifetime (the
    #: zero-lost-ack soak reads it off the replay it already holds)
    corrupt_records: int = 0
    seq_gaps: int = 0


class BindJournal:
    """Write-ahead bind journal over a pluggable store.

    Record ops (one JSON object per record, ``seq`` strictly increasing):

    ``intent``      — a chunk commit is about to mutate host state:
                      ``planned`` carries the nominated (uid, node) pairs.
    ``bind``        — the chunk's Reserve+Permit held: ``binds`` carries
                      one entry per acknowledged pod with everything
                      ``restore_assumed`` needs to re-install the charge.
    ``abort``       — the chunk rolled back (the in-memory journal undid
                      the mutations); the preceding intent is void.
    ``forget``      — pods released (completion/eviction); replay drops
                      them from the live set.
    ``checkpoint``  — compaction marker carrying the full live set;
                      replay restarts from it.

    Every append is stamped with the writer's fencing epoch and refused
    (:class:`StaleEpochError`) when an append from a NEWER epoch has
    already landed — the journal is the fencing backstop at the storage
    boundary even when the in-process fence was bypassed.
    """

    def __init__(
        self,
        store=None,
        chaos=None,
        writes_counter=None,
        failures_counter=None,
        shard: Optional[int] = None,
        health=None,
    ):
        self.store = store if store is not None else MemoryJournalStore()
        self.chaos = chaos or NULL_INJECTOR
        #: optional ``journal_writes_total{op}`` / failure counters
        self.writes_counter = writes_counter
        self.failures_counter = failures_counter
        #: optional HealthRegistry: corruption detected at any load
        #: flips the ``journal_integrity`` row to degraded (a state, not
        #: an event — it stays degraded while quarantined records exist)
        self.health = health
        #: (corrupt, seq_gaps) high-water a successful verified recovery
        #: has absorbed: the journal_integrity row re-promotes to ok once
        #: a recovery proved the surviving records reconstruct a
        #: consistent world (degraded is a state, not a tombstone)
        self._integrity_resolved = (0, 0)
        #: shard this journal is scoped to (None = unsharded deployment);
        #: stamped on every record so a mixed-store forensic read can
        #: attribute writers, and epoch monotonicity is then per-shard
        #: by construction (one journal per shard)
        self.shard = shard
        self._lock = threading.Lock()
        tail, _bounded = self._load_for_replay()
        self._seq = max((r.get("seq", 0) for r in tail), default=0)
        self._epoch_high = max(
            (self._record_epoch_high(r) for r in tail), default=0
        )
        #: appends since the last checkpoint — drives maybe_compact
        #: without an O(records) store read per cycle
        self._since_checkpoint = sum(
            1
            for r in tail
            if r.get("op") not in ("checkpoint", "checkpoint_intent")
        )
        self._note_integrity()

    @staticmethod
    def _record_epoch_high(rec: dict) -> int:
        """A record's epoch evidence: its own stamp, plus — for a
        checkpoint recovery image — the journal epoch high it archived
        (the bounded tail load must not weaken fencing just because the
        pre-checkpoint history was never parsed)."""
        high = int(rec.get("epoch", 0))
        if rec.get("op") == "checkpoint":
            high = max(
                high, int((rec.get("extras") or {}).get("epoch_high", 0))
            )
        return high

    def _load_for_replay(self):
        """(records, bounded): the store's checkpoint-anchored tail when
        available — recovery work scales with (live set + tail), not
        journal length — else the full screened load."""
        tail_fn = getattr(self.store, "load_tail", None)
        if tail_fn is not None:
            tail = tail_fn()
            if tail:
                return tail, True
        return self.store.load(), False

    @property
    def epoch_high(self) -> int:
        with self._lock:
            return self._epoch_high

    # ---- integrity surface (state-integrity PR) ----

    def integrity_report(self):
        """The store's cumulative screening report (None for custom
        stores that predate the codec)."""
        return getattr(self.store, "integrity_total", None)

    def _note_integrity(self) -> None:
        """Reflect the store's cumulative integrity state onto the
        wired ``journal_integrity`` health row (called after every
        store load this journal performs)."""
        if self.health is None:
            return
        rep = self.integrity_report()
        if rep is None:
            return
        resolved = (
            rep.corrupt <= self._integrity_resolved[0]
            and rep.seq_gaps <= self._integrity_resolved[1]
        )
        if rep.ok:
            detail = f"store={rep.store} clean"
        elif resolved:
            detail = (
                f"store={rep.store} recovered past quarantine: "
                f"{rep.detail()}"
            )
        else:
            detail = f"store={rep.store} degraded: {rep.detail()}"
        self.health.set("journal_integrity", rep.ok or resolved, detail)

    def mark_integrity_recovered(self) -> None:
        """A verified recovery absorbed everything quarantined so far:
        re-promote the journal_integrity row (new corruption beyond this
        high-water degrades it again)."""
        rep = self.integrity_report()
        if rep is not None:
            self._integrity_resolved = (rep.corrupt, rep.seq_gaps)
        self._note_integrity()

    def _store_lock(self):
        """The store's multi-writer lock (stores without one — custom
        backends — fall back to no cross-instance ordering, same as
        before the lock existed)."""
        lock = getattr(self.store, "lock", None)
        return lock if lock is not None else contextlib.nullcontext()

    # ---- append side ----

    def _append(self, op: str, epoch: int, cycle: int, **fields) -> dict:
        try:
            if self.chaos.fire("journal.write_fail"):
                raise JournalWriteError(
                    f"injected journal write failure at op={op}"
                )
            with self._lock:
                if epoch is None:
                    # fence-exempt record (forgets): a release reflects
                    # an apiserver-observed deletion, authoritative
                    # regardless of who leads — stamp the current high
                    epoch = self._epoch_high
                if epoch < self._epoch_high:
                    raise StaleEpochError(
                        epoch, self._epoch_high, what="journal epoch"
                    )
                self._epoch_high = max(self._epoch_high, epoch)
                if self._seq > 0 and self.chaos.fire("journal.seq_gap"):
                    # corruption fault domain: a WRITE HOLE — a seq
                    # number consumed but its record never reaching the
                    # store (lost sector). Load-time screening counts
                    # the gap and degrades journal_integrity; no record
                    # (and no acknowledged state) is behind it. Guarded
                    # to an ESTABLISHED stream: a hole before the first
                    # record is indistinguishable from a compacted
                    # prefix, so injecting there would be undetectable
                    # by design.
                    self._seq += 1
                self._seq += 1
                rec = {
                    "seq": self._seq,
                    "epoch": int(epoch),
                    "cycle": int(cycle),
                    "op": op,
                    **fields,
                }
                if self.shard is not None:
                    rec["shard"] = int(self.shard)
                try:
                    with self._store_lock():
                        self.store.append(rec)
                except OSError as exc:
                    # roll the seq back: the record never landed, and a
                    # permanent hole here would read as a write hole at
                    # every future load (seq-gap screening is exact)
                    self._seq -= 1
                    raise JournalWriteError(
                        f"journal append failed: {exc!r}"
                    ) from exc
                if op == "intent" and self.chaos.fire(
                    "journal.corrupt_record"
                ):
                    # corruption fault domain: the record's bytes rot on
                    # media AFTER the append was acknowledged. Applied
                    # to the intent op (which contributes nothing to
                    # replay) so the soak can assert the quarantine
                    # machinery keeps every verifiable record AFTER the
                    # corrupt one — the silent-truncation bug this PR
                    # removes — while the zero-lost-ack ledger stays
                    # assertable.
                    bitrot = getattr(
                        self.store, "corrupt_last_record", None
                    )
                    if bitrot is not None:
                        with self._store_lock():
                            bitrot()
                self._since_checkpoint += 1
        except (JournalWriteError, StaleEpochError):
            if self.failures_counter is not None:
                self.failures_counter.inc()
            raise
        if self.writes_counter is not None:
            self.writes_counter.labels(op=op).inc()
        return rec

    def append_intent(
        self,
        epoch: int,
        cycle: int,
        planned: Sequence[Tuple[str, str]],
    ) -> dict:
        return self._append(
            "intent",
            epoch,
            cycle,
            planned=[[uid, node] for uid, node in planned],
        )

    def append_bind(
        self, epoch: int, cycle: int, entries: Sequence[dict]
    ) -> dict:
        """``entries``: per-pod dicts with keys ``uid``, ``node``,
        ``req`` (list), ``est`` (list), ``prod`` (bool), ``nom``
        (bind-nominal CPU milli), ``conf`` (confirmed flag); optionally
        ``numa``/``dev`` exact holds, ``quota`` leaf, and ``lc`` — the
        pod's compact lifecycle-trace context (original submit stamp +
        shard-hop count), carried durably so a takeover's replay can
        bridge the pod's timeline across a dead incarnation
        (fleet-tracing PR; consumed by ``runtime.recovery``)."""
        return self._append(
            "bind", epoch, cycle, binds=[dict(e) for e in entries]
        )

    def append_abort(self, epoch: int, cycle: int, reason: str = "") -> dict:
        return self._append("abort", epoch, cycle, reason=reason)

    def append_forget(
        self, epoch: Optional[int], cycle: int, uids: Sequence[str]
    ) -> dict:
        """``epoch=None`` marks the record fence-exempt: forgets mirror
        apiserver deletions, which a STANDBY must also journal (its
        informers keep observing completions during a leaderless gap —
        dropping them would let the next takeover's replay resurrect
        dead pods' charges)."""
        return self._append("forget", epoch, cycle, uids=list(uids))

    # ---- replay / compaction ----

    @staticmethod
    def _checkpoint_image_ok(rec: dict) -> bool:
        """A checkpoint record's recovery image is trustworthy when its
        content digest verifies (legacy checkpoints without one are
        trusted — the line-level CRC still covered them if sealed)."""
        stamped = rec.get("image_digest")
        if stamped is None:
            return True
        return stamped == integrity.payload_digest(
            {"live": rec.get("live", {}), "extras": rec.get("extras", {})}
        )

    def replay(self, use_checkpoint: bool = True) -> JournalReplay:
        """Rebuild the acknowledged live set.

        ``use_checkpoint=True`` (default) fast-forwards from the LAST
        digest-verified checkpoint recovery image and applies only the
        tail behind it — recovery work bounded by (live set + tail), not
        journal length. A checkpoint whose image digest fails is
        REJECTED (counted in ``checkpoint_fallbacks``) and the replay
        falls back to the next older verified image, or to full history.
        ``use_checkpoint=False`` forces the full-history walk (the
        recovery path's explicit fallback arm)."""
        rep = JournalReplay()
        records = None
        start = 0
        if use_checkpoint:
            tail_fn = getattr(self.store, "load_tail", None)
            if tail_fn is not None:
                tail = tail_fn()
                if tail and self._checkpoint_image_ok(tail[0]):
                    # bounded-RTO path: the pre-checkpoint prefix was
                    # never even parsed — recovery work is O(live+tail)
                    records = sorted(
                        tail, key=lambda r: r.get("seq", 0)
                    )
                    rep.used_checkpoint = True
        if records is None:
            records = sorted(
                self.store.load(), key=lambda r: r.get("seq", 0)
            )
            if use_checkpoint:
                for i in range(len(records) - 1, -1, -1):
                    if records[i].get("op") != "checkpoint":
                        continue
                    if self._checkpoint_image_ok(records[i]):
                        start = i
                        rep.used_checkpoint = True
                        break
                    # rejected images stay inside the applied window,
                    # where the walk below counts each exactly once
        # epoch/seq highs cover the WHOLE stream — fencing must not
        # weaken because a checkpoint bounded the applied window (a
        # checkpoint image archives the journal epoch high it covered)
        for rec in records:
            rep.epoch_high = max(
                rep.epoch_high, self._record_epoch_high(rec)
            )
            rep.seq_high = max(rep.seq_high, rec.get("seq", 0))
        open_intent = False
        for rec in records[start:]:
            op = rec.get("op")
            rep.applied += 1
            if op == "checkpoint":
                if not self._checkpoint_image_ok(rec):
                    # a rotted image inside the applied window: never
                    # reset the live set from untrusted bytes — skip it
                    # and keep folding the surrounding history
                    rep.checkpoint_fallbacks += 1
                    continue
                rep.live = {
                    uid: dict(e) for uid, e in rec.get("live", {}).items()
                }
                open_intent = False
            elif op == "intent":
                if open_intent:
                    rep.open_intents += 1
                rep.intents += 1
                open_intent = True
            elif op == "bind":
                rep.binds += 1
                open_intent = False
                for e in rec.get("binds", ()):
                    rep.live[e["uid"]] = dict(e)
            elif op == "abort":
                rep.aborts += 1
                open_intent = False
            elif op == "forget":
                rep.forgets += 1
                for uid in rec.get("uids", ()):
                    rep.live.pop(uid, None)
        if open_intent:
            rep.open_intents += 1
        integ = self.integrity_report()
        if integ is not None:
            rep.corrupt_records = integ.corrupt
            rep.seq_gaps = integ.seq_gaps
        self._note_integrity()
        return rep

    def _checkpoint_record(
        self, rep: JournalReplay, epoch: Optional[int], extras: dict
    ) -> dict:
        """One checkpoint RECOVERY IMAGE (state-integrity PR): the exact
        live set (bind entries already carry numa/dev holds, quota leaf
        and lc context), the journal's epoch high, caller extras (e.g.
        per-shard claim epoch-highs), and a content digest recovery
        verifies before trusting the image."""
        self._seq = max(self._seq, rep.seq_high) + 1
        live = {u: dict(e) for u, e in rep.live.items()}
        extras = dict(extras)
        extras.setdefault("epoch_high", int(self._epoch_high))
        checkpoint = {
            "seq": self._seq,
            "epoch": int(self._epoch_high if epoch is None else epoch),
            "cycle": -1,
            "op": "checkpoint",
            "live": live,
            "extras": extras,
        }
        checkpoint["image_digest"] = integrity.payload_digest(
            {"live": live, "extras": extras}
        )
        if self.shard is not None:
            checkpoint["shard"] = int(self.shard)
        return checkpoint

    def append_checkpoint(
        self, epoch: Optional[int] = None, extras: Optional[dict] = None
    ) -> JournalReplay:
        """Append a checkpoint recovery image WITHOUT dropping history
        (bounded-RTO acceleration): replay fast-forwards from it, but a
        digest mismatch can still fall back to the full journal — the
        belt :meth:`compact` cannot offer once it erased the prefix.
        Epoch-fenced like compaction."""
        with self._lock, self._store_lock():
            rep = self.replay()
            if epoch is not None and epoch < self._epoch_high:
                raise StaleEpochError(
                    epoch, self._epoch_high, what="checkpoint epoch"
                )
            checkpoint = self._checkpoint_record(rep, epoch, extras or {})
            try:
                self.store.append(checkpoint)
            except OSError as exc:
                self._seq -= 1
                raise JournalWriteError(
                    f"checkpoint append failed: {exc!r}"
                ) from exc
            self._since_checkpoint = 0
        if self.writes_counter is not None:
            self.writes_counter.labels(op="checkpoint").inc()
        return rep

    def compact(
        self, epoch: Optional[int] = None, extras: Optional[dict] = None
    ) -> JournalReplay:
        """Collapse the log to one checkpoint carrying the current live
        set (after a successful recovery, from the scheduler run loop via
        :meth:`maybe_compact`, or on a maintenance sweep so the log does
        not grow with cluster lifetime). A compaction stamped with an
        epoch older than one already journaled is refused — a deposed
        leader must not rewrite the log its successor is appending to.

        Intent-before-commit (state-integrity PR): a ``checkpoint_intent``
        record lands in the LIVE log before the rewrite, so a crash
        mid-rewrite leaves evidence of the attempt (replay treats the
        intent as a no-op); the checkpoint itself is a digest-stamped
        recovery image (:meth:`_checkpoint_record`).

        Failure domain: the ``journal.compact_crash`` chaos point models
        a process death mid-rewrite. The live log is untouched (the
        rewrite is tmp-file + atomic rename, so a crash before the
        rename loses only the unacknowledged checkpoint); callers see
        :class:`JournalWriteError` and the next open repairs/ignores the
        torn temp file."""
        with self._lock, self._store_lock():
            # replay INSIDE both locks: another BindJournal instance over
            # the same store (the standby-forget pattern) may append
            # between an outside-the-lock replay and the rewrite — the
            # rewrite would silently erase its acknowledged record. The
            # store lock orders this read-rewrite against those appends,
            # and the seq fixup keeps the checkpoint sorting after
            # records this instance never issued itself.
            rep = self.replay()
            if epoch is not None and epoch < self._epoch_high:
                raise StaleEpochError(
                    epoch, self._epoch_high, what="compaction epoch"
                )
            try:
                self.store.append(
                    {
                        "seq": max(self._seq, rep.seq_high) + 1,
                        "epoch": int(
                            self._epoch_high if epoch is None else epoch
                        ),
                        "cycle": -1,
                        "op": "checkpoint_intent",
                    }
                )
                self._seq = max(self._seq, rep.seq_high) + 1
            except OSError as exc:
                raise JournalWriteError(
                    f"checkpoint intent append failed: {exc!r}"
                ) from exc
            checkpoint = self._checkpoint_record(rep, epoch, extras or {})
            if self.chaos.fire("journal.compact_crash"):
                torn = getattr(self.store, "simulate_torn_rewrite", None)
                if torn is not None:
                    torn(checkpoint)
                raise JournalWriteError(
                    "injected crash mid-compaction (torn rewrite)"
                )
            try:
                self.store.rewrite([checkpoint])
            except OSError as exc:
                raise JournalWriteError(
                    f"journal compaction failed: {exc!r}"
                ) from exc
            self._since_checkpoint = 0
        return rep

    def maybe_compact(
        self,
        epoch: Optional[int] = None,
        min_records: int = 512,
        min_bytes: Optional[int] = None,
    ) -> Optional[JournalReplay]:
        """Threshold-gated :meth:`compact` for the scheduler run loop
        (ROADMAP queued follow-on): compacts when at least
        ``min_records`` records landed since the last checkpoint, or —
        for stores that report a size — when the log file exceeds
        ``min_bytes``. Returns the replay when compaction ran, None when
        below threshold."""
        with self._lock:
            due = self._since_checkpoint >= max(1, int(min_records))
            if not due and min_bytes is not None:
                size_fn = getattr(self.store, "size_bytes", None)
                due = size_fn is not None and size_fn() >= min_bytes
        if not due:
            return None
        return self.compact(epoch)

    def records(self) -> List[dict]:
        return self.store.load()


# ---------------------------------------------------------------------------
# Cross-shard single-winner claims
# ---------------------------------------------------------------------------


class ClaimConflictError(RuntimeError):
    """The pod's claim is already held by a different shard — the caller
    must not schedule it (the winner shard will)."""


class ClaimTable:
    """Single-winner pod→shard claim arbiter (horizontal partitioning).

    A pending pod whose feasible nodes span shards may be fanned out to
    several shards' queues; before a shard's pump feeds the pod it must
    :meth:`claim` it. The first claim wins and is durably recorded
    (``op="claim"`` over the same store API the journals use), every
    later claim from another shard loses (returns False), and a repeat
    claim by the winner is idempotent — so two shards can never bind the
    same pod. Claims are epoch-fenced **per shard**: a claim stamped
    with an epoch older than the shard's highest already-claimed epoch
    is refused outright (:class:`StaleEpochError`) — a deposed shard
    owner cannot grab new work on its way down.

    Cross-shard gangs (elastic-topology PR) add a TWO-PHASE protocol on
    top: :meth:`gang_prepare` takes all-or-nothing HOLDS on every member
    of a gang whose feasible nodes span shards (a hold makes rival
    claims lose like a claim does, but the holder shard's own feed-time
    :meth:`claim` still succeeds); :meth:`gang_commit` converts the
    holds into ordinary claims once every member bound, and
    :meth:`gang_abort` drops them entirely — no tombstone, because an
    aborted member was never placed and MUST stay claimable for the
    retry. Crash semantics: a ``gang_hold`` record with no matching
    ``gang_commit`` is discarded on reload — a claim phase that died
    mid-flight leaves ZERO holds behind.

    Elastic topology (same PR): :meth:`rehome` re-points claims across
    a shard split/merge — bound pods' claims follow their node to the
    child shard; claims won by a RETIRED shard with no known
    destination are voided (the pod re-claims at its next feed, which
    is safe: single-winner arbitration still decides exactly one
    feeder). Tombstones need no re-homing — they are shard-less by
    construction (a settled uid loses everywhere)."""

    def __init__(self, store=None, clock=_time.time, shard_live=None):
        self.store = store if store is not None else MemoryJournalStore()
        self.clock = clock
        #: optional predicate ``shard_id -> bool`` (the topology's
        #: ``is_active``): when wired, a claim held by a RETIRED shard
        #: self-heals to the live claimant — the closing stitch for the
        #: window between a topology commit and its claim re-home (a
        #: crash there would otherwise strand queued pods on a winner
        #: cell that can never schedule them). Safe because a retired
        #: cell is not electable and its fence was advanced: nothing
        #: can bind under it.
        self.shard_live = shard_live
        self._lock = threading.Lock()
        self._seq = 0
        #: uid -> winning shard
        self._winners: Dict[str, int] = {}
        #: uid -> (gang id, holder shard): two-phase gang HOLDS — not
        #: yet claims, but rival shards' claims lose against them
        self._holds: Dict[str, Tuple[str, int]] = {}  # guarded-by: self._lock
        #: gang id -> {uid: holder shard} for commit/abort bookkeeping
        self._gangs: Dict[str, Dict[str, int]] = {}  # guarded-by: self._lock
        #: released (GC'd) uid -> settle timestamp — tombstones, NOT
        #: free slots: a release happens at pod deletion, but a
        #: fanned-out copy of the pod can still sit in some backlogged
        #: shard's queue; letting that copy re-claim a freed uid would
        #: re-schedule a dead pod. :meth:`gc_tombstones` compacts
        #: tombstones OLDER than a retention window (rides the shard
        #: journal's run-loop compaction) — inside the window a
        #: post-release claim still loses.
        self._settled: Dict[str, float] = {}
        #: shard -> highest epoch ever used to claim
        self._epoch_high: Dict[int, int] = {}
        for rec in sorted(self.store.load(), key=lambda r: r.get("seq", 0)):
            op = rec.get("op")
            self._seq = max(self._seq, rec.get("seq", 0))
            if op == "claim":
                uid, shard = rec.get("uid"), int(rec.get("shard", -1))
                epoch = int(rec.get("epoch", 0))
                if uid not in self._settled:
                    held = self._winners.get(uid)
                    if held is None or (
                        self.shard_live is not None
                        and not self.shard_live(held)
                    ):
                        # first claim wins — unless the first winner's
                        # cell has since retired, in which case the
                        # later self-healed claim record is the truth
                        self._winners[uid] = shard
                self._epoch_high[shard] = max(
                    self._epoch_high.get(shard, 0), epoch
                )
            elif op == "claim_release":
                self._winners.pop(rec.get("uid"), None)
                self._settled[rec.get("uid")] = float(rec.get("ts", 0.0))
            elif op == "claim_epoch_high":
                # tombstone-GC checkpoint: per-shard epoch highs survive
                # even when every claim record of a shard was compacted
                # away (fencing must not weaken across a GC + reload)
                for shard_s, epoch in (rec.get("highs") or {}).items():
                    shard_i = int(shard_s)
                    self._epoch_high[shard_i] = max(
                        self._epoch_high.get(shard_i, 0), int(epoch)
                    )
            elif op == "gang_hold":
                gang = rec.get("gang")
                members = {
                    u: int(s) for u, s in (rec.get("members") or {}).items()
                }
                self._gangs[gang] = members
                for u, s in members.items():
                    self._holds[u] = (gang, s)
                for shard_s, epoch in (rec.get("epochs") or {}).items():
                    shard_i = int(shard_s)
                    self._epoch_high[shard_i] = max(
                        self._epoch_high.get(shard_i, 0), int(epoch)
                    )
            elif op == "gang_commit":
                members = self._gangs.pop(rec.get("gang"), {})
                for u, s in members.items():
                    self._holds.pop(u, None)
                    if u not in self._settled:
                        self._winners.setdefault(u, s)
            elif op == "gang_abort":
                for u in self._gangs.pop(rec.get("gang"), {}):
                    self._holds.pop(u, None)
            elif op == "claim_void":
                for u in rec.get("uids", ()):
                    self._winners.pop(u, None)
                    hold = self._holds.pop(u, None)
                    if hold is not None and hold[0] in self._gangs:
                        self._gangs[hold[0]].pop(u, None)
            elif op == "claim_rehome":
                moves = {
                    u: int(s) for u, s in (rec.get("moves") or {}).items()
                }
                void = {int(s) for s in rec.get("void", ())}
                self._apply_rehome_locked(moves, void)
        # crash semantics: a gang whose hold record was never closed by a
        # commit/abort belongs to a claim phase that DIED mid-flight —
        # its holds evaporate here, leaving every member claimable again
        for gang in list(self._gangs):
            for u in self._gangs.pop(gang):
                self._holds.pop(u, None)

    def claim(self, uid: str, shard: int, epoch: int) -> bool:
        """True when ``shard`` owns (or now wins) the pod's claim; False
        when another shard already won. Raises :class:`StaleEpochError`
        when ``epoch`` is older than the shard's claim-epoch high — the
        fencing check every claim flows through."""
        with self._lock:
            high = self._epoch_high.get(shard, 0)
            if epoch < 0 or epoch < high:
                raise StaleEpochError(epoch, high, what="claim epoch")
            if uid in self._settled:
                # the pod was decided AND GC'd — a claim now can only be
                # a stale fanned-out queue copy; losing it (False) makes
                # the caller drop the pod, which is correct: it is gone
                return False
            hold = self._holds.get(uid)
            if hold is not None:
                # a two-phase gang hold stands in for the claim until the
                # gang commits: the holder shard's own feed proceeds, any
                # rival loses (the gang decides the pod's fate, not the
                # fan-out race)
                return hold[1] == shard
            held = self._winners.get(uid)
            if held is not None:
                if held == shard:
                    return True
                if self.shard_live is None or self.shard_live(held):
                    return False
                # orphaned claim: its winner cell RETIRED (a crash
                # between a topology commit and the claim re-home
                # leaves exactly these) — self-heal to the live
                # claimant instead of dropping the pod forever
            self._seq += 1
            rec = {
                "seq": self._seq,
                "op": "claim",
                "uid": uid,
                "shard": int(shard),
                "epoch": int(epoch),
            }
            try:
                self.store.append(rec)
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"claim append failed: {exc!r}"
                ) from exc
            self._winners[uid] = int(shard)
            self._epoch_high[shard] = max(high, epoch)
            return True

    def winner(self, uid: str) -> Optional[int]:
        with self._lock:
            return self._winners.get(uid)

    def release(self, uid: str) -> None:
        """Settle a claim at pod GC: the winner mapping is dropped but
        the uid is TOMBSTONED, not freed — a stale fanned-out copy of
        the pod may still sit in a backlogged shard's queue, and letting
        it re-claim the uid would re-schedule a dead pod. A release is
        recorded so a reload keeps the tombstone. A uid that was never
        claimed needs no tombstone: fan-out copies must claim before
        binding, and only a bound pod can complete — so no stale copy of
        an unclaimed pod can exist."""
        with self._lock:
            if self._winners.pop(uid, None) is None:
                return
            ts = float(self.clock())
            self._settled[uid] = ts
            self._seq += 1
            try:
                self.store.append(
                    {
                        "seq": self._seq,
                        "op": "claim_release",
                        "uid": uid,
                        "ts": ts,
                    }
                )
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"claim release append failed: {exc!r}"
                ) from exc

    # ---- two-phase cross-shard gang claims (elastic-topology PR) ----

    def gang_prepare(
        self,
        gang: str,
        members: Dict[str, int],
        epochs: Dict[int, int],
        now: Optional[float] = None,
    ) -> bool:
        """Phase 1: take holds on EVERY member or none. ``members`` maps
        uid → the shard that will schedule it; ``epochs`` carries each
        involved shard's held fencing epoch (checked against the shard's
        claim-epoch high exactly like :meth:`claim` — a deposed owner
        cannot anchor a gang on its way down). Returns False — with zero
        holds taken — when any member is settled, already claimed by a
        shard other than its planned one, or held by another gang."""
        with self._lock:
            for shard in sorted(set(members.values())):
                epoch = int(epochs.get(shard, -1))
                high = self._epoch_high.get(shard, 0)
                if epoch < 0 or epoch < high:
                    raise StaleEpochError(
                        epoch, high, what="gang claim epoch"
                    )
            for uid, shard in members.items():
                if uid in self._settled:
                    return False
                hold = self._holds.get(uid)
                if hold is not None and hold != (gang, shard):
                    return False
                won = self._winners.get(uid)
                if won is not None and won != shard:
                    return False
            self._seq += 1
            rec = {
                "seq": self._seq,
                "op": "gang_hold",
                "gang": gang,
                "members": {u: int(s) for u, s in members.items()},
                "epochs": {str(s): int(e) for s, e in epochs.items()},
                "ts": float(self.clock() if now is None else now),
            }
            try:
                self.store.append(rec)
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"gang hold append failed: {exc!r}"
                ) from exc
            self._gangs[gang] = {u: int(s) for u, s in members.items()}
            for uid, shard in members.items():
                self._holds[uid] = (gang, int(shard))
            for shard, epoch in epochs.items():
                self._epoch_high[shard] = max(
                    self._epoch_high.get(int(shard), 0), int(epoch)
                )
            return True

    def gang_commit(self, gang: str) -> None:
        """Phase 2 success: every member bound — holds become ordinary
        claims (so pod-GC release/tombstone semantics apply from here)."""
        with self._lock:
            members = self._gangs.pop(gang, None)
            if members is None:
                return
            self._seq += 1
            try:
                self.store.append(
                    {"seq": self._seq, "op": "gang_commit", "gang": gang}
                )
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"gang commit append failed: {exc!r}"
                ) from exc
            for uid, shard in members.items():
                self._holds.pop(uid, None)
                if uid not in self._settled:
                    self._winners.setdefault(uid, shard)

    def gang_abort(self, gang: str) -> None:
        """Phase 2 failure: drop every hold ENTIRELY — no claim, no
        tombstone. The members were never placed, so they must stay
        claimable for whatever retry/re-route comes next; a tombstone
        here would brick them forever (zero-zombie-holds contract)."""
        with self._lock:
            members = self._gangs.pop(gang, None)
            if members is None:
                return
            self._seq += 1
            try:
                self.store.append(
                    {"seq": self._seq, "op": "gang_abort", "gang": gang}
                )
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"gang abort append failed: {exc!r}"
                ) from exc
            for uid in members:
                self._holds.pop(uid, None)

    def gang_holds(self, gang: Optional[str] = None) -> int:
        """Live (uncommitted, unaborted) hold count — the zero-zombie
        assertion surface."""
        with self._lock:
            if gang is not None:
                return len(self._gangs.get(gang, {}))
            return len(self._holds)

    # ---- topology re-home (shard split/merge) ----

    def _apply_rehome_locked(
        self, moves: Dict[str, int], void: set
    ) -> None:
        for uid, dest in moves.items():
            if uid in self._winners:
                self._winners[uid] = int(dest)
            if uid in self._holds:
                gang, _s = self._holds[uid]
                self._holds[uid] = (gang, int(dest))
                if gang in self._gangs and uid in self._gangs[gang]:
                    self._gangs[gang][uid] = int(dest)
        if void:
            for uid, shard in list(self._winners.items()):
                if shard in void and uid not in moves:
                    del self._winners[uid]
            for uid, (gang, shard) in list(self._holds.items()):
                if shard in void and uid not in moves:
                    del self._holds[uid]
                    if gang in self._gangs:
                        self._gangs[gang].pop(uid, None)

    def void_claims(self, uids: Sequence[str]) -> None:
        """Drop any claim/hold records for these uids WITHOUT a
        tombstone (overload-control PR, gang-abort hygiene): a topology
        transition between ``gang_prepare`` and the abort can VOID a
        queued member's hold (``rehome``), after which its feed
        re-claims as an ordinary winner — ``gang_abort`` only drops
        holds, so that re-established claim would otherwise pin the
        aborted member to one shard forever (its resubmitted copy,
        routed anywhere else, loses every claim and is never fed).
        No-op (and no journal record) when nothing is held."""
        with self._lock:
            hit = [
                u
                for u in uids
                if u in self._winners or u in self._holds
            ]
            if not hit:
                return
            self._seq += 1
            rec = {"seq": self._seq, "op": "claim_void", "uids": hit}
            try:
                self.store.append(rec)
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"claim void append failed: {exc!r}"
                ) from exc
            for u in hit:
                self._winners.pop(u, None)
                hold = self._holds.pop(u, None)
                if hold is not None and hold[0] in self._gangs:
                    self._gangs[hold[0]].pop(u, None)

    def rehome(
        self, moves: Dict[str, int], void_shards: Sequence[int] = ()
    ) -> None:
        """Shard split/merge commit: re-point claims to the shards that
        now own their pods. ``moves`` maps uid → destination shard (the
        child owning the pod's node, from the journal re-home);
        ``void_shards`` names the RETIRED shard ids — any remaining
        claim won by one of them (a queued, not-yet-bound pod) is voided
        so the pod can re-claim wherever the new topology routes it.
        One journaled record, so a reload replays the same state."""
        with self._lock:
            self._seq += 1
            rec = {
                "seq": self._seq,
                "op": "claim_rehome",
                "moves": {u: int(s) for u, s in moves.items()},
                "void": [int(s) for s in void_shards],
            }
            try:
                self.store.append(rec)
            except OSError as exc:
                self._seq -= 1  # no record landed: no write hole
                raise JournalWriteError(
                    f"claim rehome append failed: {exc!r}"
                ) from exc
            self._apply_rehome_locked(
                {u: int(s) for u, s in moves.items()},
                {int(s) for s in void_shards},
            )

    def tombstones_live(self) -> int:
        """Settled uids currently retained (the ``claim_tombstones_live``
        gauge's source)."""
        with self._lock:
            return len(self._settled)

    def gc_tombstones(
        self, retention_s: float, now: Optional[float] = None
    ) -> int:
        """Compact tombstones settled more than ``retention_s`` ago
        (queued PR 6 follow-on, driven by the shard journal's run-loop
        compaction). INSIDE the retention window a tombstone survives
        compaction — a post-GC claim on such a uid still loses — so the
        window must exceed the longest a fanned-out queue copy can
        plausibly outlive its pod's GC. The store is rewritten to the
        minimal equivalent log: one per-shard epoch-high checkpoint
        (fencing survives even when a shard's every claim record is
        dropped), the live claims, and the retained tombstones. Returns
        the number of tombstones still live."""
        if now is None:
            now = float(self.clock())
        cutoff = now - retention_s
        with self._lock:
            expired = [
                uid for uid, ts in self._settled.items() if ts <= cutoff
            ]
            if not expired:
                return len(self._settled)
            for uid in expired:
                del self._settled[uid]
            records: List[dict] = []
            self._seq += 1
            records.append(
                {
                    "seq": self._seq,
                    "op": "claim_epoch_high",
                    "highs": {
                        str(s): int(e) for s, e in self._epoch_high.items()
                    },
                }
            )
            for uid, shard in self._winners.items():
                self._seq += 1
                records.append(
                    {
                        "seq": self._seq,
                        "op": "claim",
                        "uid": uid,
                        "shard": int(shard),
                        "epoch": int(self._epoch_high.get(shard, 0)),
                    }
                )
            for uid, ts in self._settled.items():
                self._seq += 1
                records.append(
                    {
                        "seq": self._seq,
                        "op": "claim_release",
                        "uid": uid,
                        "ts": float(ts),
                    }
                )
            for gang, members in self._gangs.items():
                # live two-phase holds survive the rewrite — they are
                # open state, not history (an in-flight gang's claim
                # phase must not evaporate under a tombstone sweep)
                self._seq += 1
                records.append(
                    {
                        "seq": self._seq,
                        "op": "gang_hold",
                        "gang": gang,
                        "members": {
                            u: int(s) for u, s in members.items()
                        },
                        "epochs": {},
                        "ts": float(now),
                    }
                )
            try:
                self.store.rewrite(records)
            except OSError as exc:
                raise JournalWriteError(
                    f"claim tombstone GC failed: {exc!r}"
                ) from exc
            return len(self._settled)
