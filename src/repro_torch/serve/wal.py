"""Durability for serving sessions: write-ahead update log + snapshots
(the JAX package's ``repro.serve.wal``, record for record).

The recovery contract (DESIGN.md §9): a tenant's state is a deterministic
function of (initial relations, the ordered raw update batches).  So the
pool logs every epoch's RAW batches to an append-only WAL *before* the
device applies them, snapshots the session every ``snapshot_every`` epochs
(``GraphSession.snapshot`` riding ``repro_torch.checkpoint``), and
truncates the WAL through the snapshot's epoch.  A killed worker then
restores the last intact snapshot and replays the surviving WAL records
through the normal ``session.update`` path — normalize nets each replayed
batch against the restored state exactly as the original run did, so the
recovered state is bit-exact, including a record logged but never applied
(its replay IS the apply).

WAL records are one JSON line each: the payload (epoch + base64 row/weight
bytes per relation) is CRC32-guarded, and replay stops at the first torn
or corrupt line — the half-written tail of a crash mid-append loses only
the epoch that never returned to its client.  ``truncate_through`` is an
atomic rewrite (tmp + rename), so a crash mid-truncation leaves either the
old or the new log, never a prefix.

The record encoding is the JAX package's byte for byte, and snapshots are
in its format, so either package's :class:`Durability` recovers a
directory the other one wrote.
"""
from __future__ import annotations

import base64
import json
import os
import sys
import time
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.errors import SnapshotError, WalError

Batches = Dict[str, Tuple[np.ndarray, np.ndarray]]


class WriteAheadLog:
    """Append-only epoch log of raw (pre-normalize) update batches."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "ab")
        self._last_offset: Optional[int] = None

    @staticmethod
    def _encode(epoch: int, batches: Batches) -> bytes:
        rels = {}
        for rel in sorted(batches):
            rows, w = batches[rel]
            rows = np.ascontiguousarray(rows, np.int32)
            w = np.ascontiguousarray(w, np.int32)
            rels[rel] = {
                "shape": list(rows.shape),
                "rows": base64.b64encode(rows.tobytes()).decode(),
                "w": base64.b64encode(w.tobytes()).decode()}
        body = json.dumps({"e": int(epoch), "rels": rels}, sort_keys=True)
        crc = zlib.crc32(body.encode())
        return (json.dumps({"b": body, "crc": crc}) + "\n").encode()

    def append(self, epoch: int, batches: Batches) -> None:
        """Durably log one epoch's raw batches (fsync'd by default) —
        called BEFORE the device applies them.

        Raises :class:`WalError` on any I/O failure; the byte offset at
        entry is remembered so ``abort_last`` can truncate away a record
        whose epoch never applied (otherwise recovery would replay it).
        """
        try:
            # record the offset BEFORE the fault point: a failed append
            # must abort back to this record's start, never the previous
            self._last_offset = self._f.tell()
            faults.fire("wal.append")
            self._f.write(self._encode(epoch, batches))
            self._f.flush()
            faults.fire("wal.fsync")
            if self.fsync:
                os.fsync(self._f.fileno())
        except WalError:
            raise
        except (OSError, faults.FaultInjected) as exc:
            raise WalError(f"WAL append failed for epoch {epoch}: {exc}") \
                from exc

    def abort_last(self) -> bool:
        """Truncate the file back to just before the last ``append`` —
        used when the device apply of that epoch failed for good, so a
        later recovery does not replay a batch the live run rejected."""
        if self._last_offset is None:
            return False
        off, self._last_offset = self._last_offset, None
        try:
            self._f.flush()
            self._f.truncate(off)
            self._f.seek(off)
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError as exc:
            raise WalError(f"WAL abort_last failed: {exc}") from exc
        return True

    @staticmethod
    def _decode(line: bytes) -> Optional[Tuple[int, Batches]]:
        try:
            rec = json.loads(line)
            body = rec["b"]
            if zlib.crc32(body.encode()) != rec["crc"]:
                return None
            payload = json.loads(body)
            batches = {}
            for rel, d in payload["rels"].items():
                shape = tuple(d["shape"])
                rows = np.frombuffer(base64.b64decode(d["rows"]),
                                     np.int32).reshape(shape).copy()
                w = np.frombuffer(base64.b64decode(d["w"]),
                                  np.int32).copy()
                if w.shape[0] != shape[0]:
                    return None
                batches[rel] = (rows, w)
            return int(payload["e"]), batches
        except (KeyError, ValueError, TypeError):
            return None

    def replay(self) -> Iterator[Tuple[int, Batches]]:
        """Yield ``(epoch, batches)`` in log order, stopping at the first
        torn/corrupt record (crash mid-append tolerance)."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            for line in f:
                rec = self._decode(line)
                if rec is None:
                    return
                yield rec

    def truncate_through(self, epoch: int) -> None:
        """Atomically drop every record with epoch <= ``epoch`` (the
        snapshot just made them redundant); later records survive
        byte-identical."""
        keep = []
        with open(self.path, "rb") as f:
            for line in f:
                rec = self._decode(line)
                if rec is None:
                    break
                if rec[0] > epoch:
                    keep.append(line)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.writelines(keep)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def num_records(self) -> int:
        return sum(1 for _ in self.replay())

    @classmethod
    def verify(cls, path: str) -> Dict[str, object]:
        """Classify a WAL file without mutating it.

        Returns a dict with ``status`` one of:

        - ``"clean"``       — every line decodes and CRC-checks;
        - ``"torn_tail"``   — exactly the LAST line is bad (the expected
          crash-mid-append shape; replay loses only that epoch);
        - ``"corrupt_midfile"`` — a bad line is followed by more lines.
          Replay still stops at the first bad record (the suffix may
          depend on state from the lost record), but this shape means
          real data loss beyond a torn tail, so recovery reports it.

        Plus ``records`` (count of valid prefix records), ``lost``
        (lines after the first bad one, incl. it), and ``first_epoch``/
        ``last_epoch`` of the valid prefix (None when empty).
        """
        out: Dict[str, object] = {
            "path": path, "status": "clean", "records": 0,
            "lost": 0, "first_epoch": None, "last_epoch": None}
        if not os.path.exists(path):
            return out
        lines = []
        with open(path, "rb") as f:
            lines = f.readlines()
        bad_at = None
        for i, line in enumerate(lines):
            rec = cls._decode(line)
            if rec is None:
                bad_at = i
                break
            out["records"] = int(out["records"]) + 1
            if out["first_epoch"] is None:
                out["first_epoch"] = rec[0]
            out["last_epoch"] = rec[0]
        if bad_at is not None:
            out["lost"] = len(lines) - bad_at
            out["status"] = ("torn_tail" if bad_at == len(lines) - 1
                             else "corrupt_midfile")
        return out

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class Durability:
    """Snapshot + WAL recovery manager for ONE serving session.

    Protocol per epoch (the pool's apply stage drives it):

    1. ``log(raw_batches)`` — durably append the epoch's raw batches;
    2. device apply (``session.update``);
    3. ``maybe_snapshot()`` — every ``snapshot_every`` epochs, snapshot
       the session (atomic-rename checkpoint) and truncate the WAL
       through the snapshot's epoch, bounding crash replay work to
       ``snapshot_every`` epochs.

    ``recover()`` restores the newest intact snapshot (if any) and
    replays surviving WAL records IN ORDER through ``session.update`` —
    deterministic normalize makes the result bit-exact with the
    uninterrupted run.  ``restore_s`` and ``replay_s`` time the two
    steps of the last ``recover()`` and ``snapshot_s`` the last
    snapshot's gather, on the host clock, each ended by a wait for the
    session's device.

    On a mesh of ranks (a mesh session whose mesh has ``ranks > 1``)
    rank 0 owns ``directory``, the WAL and the checkpoint manager, and
    no other rank needs the directory to exist: ``log`` appends on rank
    0 and returns the epoch on the others; ``maybe_snapshot`` and
    ``recover`` are collectives that every rank calls at the same epochs
    (rank 0 writes the gathered snapshot, its outcome is broadcast, and a
    failed write raises on every rank; rank 0 reads the newest snapshot
    and the surviving records, restores across the mesh and broadcasts
    the records, which every rank replays).
    """

    def __init__(self, directory: str, session, snapshot_every: int = 8,
                 keep_last: int = 3, fsync: bool = True):
        from repro_torch.checkpoint import CheckpointManager
        mesh = getattr(session, "mesh", None)
        self.mesh = mesh if mesh is not None and mesh.ranks > 1 else None
        self.root = self.mesh is None or self.mesh.rank == 0
        self.directory = directory
        self.session = session
        self.snapshot_every = int(snapshot_every)
        self.manager = self.wal = None
        if self.root:
            self.manager = CheckpointManager(
                os.path.join(directory, "ckpt"), keep_last=keep_last)
            self.wal = WriteAheadLog(os.path.join(directory, "wal.log"),
                                     fsync=fsync)
        self.snapshots = 0
        self.replayed = 0
        self.restore_s = 0.0
        self.replay_s = 0.0
        self.snapshot_s = 0.0
        self._last_snapshot_epoch = -1
        self.wal_report: Optional[Dict[str, object]] = None

    def _share(self, obj):
        """Rank 0's ``obj`` on every rank (``obj`` itself in one
        process)."""
        if self.mesh is None:
            return obj
        from repro_torch.core.exchange import broadcast_object
        return broadcast_object(obj, self.mesh)

    def recover(self) -> bool:
        """Restore snapshot + replay WAL onto ``self.session``; returns
        True when any durable state was recovered.

        The WAL is ``verify``-classified first: a torn tail is the
        expected crash shape (silently dropped — that epoch never
        returned to its client); mid-file corruption is remembered in
        ``self.wal_report`` so callers can surface the loss, and replay
        still stops at the first bad record.
        """
        got = None
        if self.root:
            self.wal_report = WriteAheadLog.verify(self.wal.path)
        self._sync()
        t0 = time.perf_counter()
        if self.root:
            got = self.manager.restore_latest_raw()
        found = self._share(got is not None)
        if found:
            leaves, extra = (got[0], got[1]["extra"]) if self.root \
                else (None, None)
            self.session.restore(leaves, extra)
            self._last_snapshot_epoch = self.session.epoch
        self._sync()
        t1 = time.perf_counter()
        self.restore_s = t1 - t0
        base = self.session.epoch
        records, gap = [], None
        if self.root:
            at = base
            for epoch, batches in self.wal.replay():
                if epoch <= base:
                    continue  # already inside the snapshot
                if epoch != at + 1:
                    gap = (f"WAL gap: next record is epoch {epoch} but the "
                           f"session is at {at}")
                    break
                records.append(batches)
                at = epoch
        report, records, gap = self._share((self.wal_report, records, gap))
        self.wal_report = report
        for batches in records:
            self.session.update(batches)
            self.replayed += 1
        if gap is not None:
            raise WalError(gap)
        self._sync()
        self.replay_s = time.perf_counter() - t1
        return found or self.replayed > 0

    def _sync(self) -> None:
        """Wait for the session's card, so that the host clock brackets
        the work queued there (nothing to wait for on the CPU)."""
        device = getattr(self.session, "device", None)
        if device is not None and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)

    def log(self, raw_batches: Batches) -> int:
        """Append the NEXT epoch's raw batches (on rank 0 of a mesh of
        ranks); returns its epoch number."""
        epoch = self.session.epoch + 1
        if self.root:
            self.wal.append(epoch, raw_batches)
        return epoch

    def due(self, epoch: int, force: bool = False) -> bool:
        """Whether a snapshot at ``epoch`` is on the cadence (or
        ``force``) and not taken yet."""
        return (force or (self.snapshot_every > 0 and epoch > 0
                          and epoch % self.snapshot_every == 0)) \
            and epoch != self._last_snapshot_epoch

    def maybe_snapshot(self, force: bool = False) -> bool:
        """Snapshot + WAL truncation on the cadence (or ``force``)."""
        epoch = self.session.epoch
        if not self.due(epoch, force):
            return False
        if self.mesh is None:
            try:
                faults.fire("snapshot.write")
                leaves, meta = self._snapshot()
                self.manager.save(leaves, step=epoch, extra=meta)
            except SnapshotError:
                raise
            except (OSError, faults.FaultInjected) as exc:
                raise SnapshotError(
                    f"snapshot at epoch {epoch} failed: {exc}") from exc
            self.wal.truncate_through(epoch)
        else:
            # every rank takes part in the gather; rank 0 alone writes,
            # and every rank learns the outcome
            got = self._snapshot()
            err = None
            if self.root:
                try:
                    faults.fire("snapshot.write")
                    self.manager.save(got[0], step=epoch, extra=got[1])
                    self.wal.truncate_through(epoch)
                except (OSError, faults.FaultInjected) as exc:
                    err = f"snapshot at epoch {epoch} failed: {exc}"
            del got
            err = self._share(err)
            if err is not None:
                raise SnapshotError(err)
        self._last_snapshot_epoch = epoch
        self.snapshots += 1
        return True

    def _snapshot(self):
        self._sync()
        t0 = time.perf_counter()
        got = self.session.snapshot()
        self._sync()
        self.snapshot_s = time.perf_counter() - t0
        return got

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()


def main(argv=None) -> int:
    """``python -m repro_torch.serve.wal verify <dir-or-file>`` — classify a
    WAL (clean / torn_tail / corrupt_midfile).  Exit 0 for clean or a
    torn tail (the tolerated crash shape), 2 for mid-file corruption."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2 or argv[0] != "verify":
        print("usage: python -m repro_torch.serve.wal verify <dir-or-file>",
              file=sys.stderr)
        return 64
    path = argv[1]
    if os.path.isdir(path):
        path = os.path.join(path, "wal.log")
    rep = WriteAheadLog.verify(path)
    print(json.dumps(rep, sort_keys=True))
    return 2 if rep["status"] == "corrupt_midfile" else 0


if __name__ == "__main__":
    raise SystemExit(main())
