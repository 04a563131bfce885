"""Cold-data archive: TTL-driven partition archival to Parquet (port of
`galaxysql_tpu/storage/archive.py`).

The archive is host work, as in the reference, and `pyarrow` stays optional as
there: without it `archive_older_than` raises `NotSupportedError` and
`scan_archive` yields nothing.  `scan_archive` yields its batches on the instance's
device.


Reference analog: the OSS/ORC cold-storage path (SURVEY.md §2.6 archive,
`OSSTableScanExec`, §2.10 local-partition rotation): rows older than a TTL cutoff move
out of the hot MVCC store into columnar files (Parquet via pyarrow standing in for
ORC-on-OSS), and scans transparently union hot + archived data.  Archived rows are
immutable; DML against them is rejected by absence (they no longer exist in the hot
store).  Dictionary-encoded string lanes are decoded to Arrow dictionary columns, so
archive files are self-describing and readable by any Parquet tool.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Column, ColumnBatch, as_tensor
from galaxysql_tpu_torch.storage.zonemap import sargs_refuted
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

try:
    import pyarrow as pa
    import pyarrow.parquet as pq
    PARQUET_AVAILABLE = True
except ImportError:  # pragma: no cover
    PARQUET_AVAILABLE = False


_MANIFEST_SCHEMA = """
CREATE TABLE IF NOT EXISTS archive_files (
    path TEXT PRIMARY KEY, table_key TEXT, archive_ts INTEGER, state TEXT,
    arc_txn INTEGER DEFAULT 0);
"""


class ArchiveManager:
    """Per-instance archive registry backed by the metadb manifest.

    Crash-safe flow: write parquet -> manifest PENDING -> delete hot rows ->
    manifest LIVE.  Boot recovery (`attach`): LIVE entries load into the registry;
    PENDING entries mean the hot rows were never deleted, so the orphan file is
    dropped and the next TTL run re-archives."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        # key -> [(path, archive_ts)]
        self._files: Dict[str, List] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.metadb = None
        self._decoded: Dict[str, object] = {}  # path -> pyarrow table (immutable)
        self._file_stats: Dict[str, dict] = {}  # path -> column min-max (immutable)
        self.pruned_files = 0  # observable SARG skip counter
        self.rf_pruned_files = 0  # files skipped by runtime-filter ranges

    def attach(self, metadb):
        """Bind the metadb manifest + recover registry state (boot path)."""
        self.metadb = metadb
        with metadb._lock:
            metadb._conn.executescript(_MANIFEST_SCHEMA)
            cols = [r[1] for r in metadb._conn.execute(
                "PRAGMA table_info(archive_files)")]
            if "arc_txn" not in cols:  # migrate pre-arc_txn manifests
                metadb._conn.execute("ALTER TABLE archive_files "
                                     "ADD COLUMN arc_txn INTEGER DEFAULT 0")
            metadb._conn.commit()
        with self._lock:
            self._files.clear()
        for path, key, ats, state, arc_txn in metadb.query(
                "SELECT path, table_key, archive_ts, state, arc_txn "
                "FROM archive_files"):
            if state == "LIVE" and os.path.exists(path):
                with self._lock:
                    self._files.setdefault(key, []).append((path, ats))
                continue
            # PENDING: decided by the archive txn's commit point in the tx log
            # (recover_persisted re-commits/rolls back the hot-store stamps the
            # same way, so file and store stay consistent)
            log = metadb.tx_log_get(arc_txn) if arc_txn else None
            if log is not None and log[0] in ("COMMITTED", "DONE") and \
                    os.path.exists(path):
                metadb.execute("UPDATE archive_files SET state='LIVE' "
                               "WHERE path=?", (path,))
                with self._lock:
                    self._files.setdefault(key, []).append((path, ats))
            else:
                # no commit point — or a commit point whose file did not survive
                # the crash (parquet unsynced at power loss): discard the file
                # and force the txn ABORTED so recover_persisted (which runs
                # after attach) rolls the hot-row stamps back instead of
                # re-committing a delete whose archive copy no longer exists
                if arc_txn and log is not None and log[0] in ("COMMITTED",):
                    metadb.tx_log_put(arc_txn, "ABORTED")
                try:
                    os.unlink(path)
                except OSError:
                    pass
                metadb.execute("DELETE FROM archive_files WHERE path=?", (path,))

    def _dir_for(self, key: str) -> str:
        base = self.directory
        if base is None:
            import tempfile
            base = tempfile.mkdtemp(prefix="galaxysql_archive_")
            self.directory = base
        d = os.path.join(base, key.replace(".", os.sep))
        os.makedirs(d, exist_ok=True)
        return d

    def files_for(self, key: str, snapshot_ts: Optional[int] = None) -> List[str]:
        """Files whose archival committed at-or-before the snapshot (a transaction
        whose snapshot predates an archival still sees those rows HOT)."""
        with self._lock:
            entries = list(self._files.get(key, []))
        if snapshot_ts is None:
            return [p for p, _ in entries]
        return [p for p, ats in entries if ats <= snapshot_ts]

    def archive_older_than(self, instance, schema: str, table: str,
                           ttl_column: str, cutoff_days: int,
                           snapshot_ts: Optional[int] = None) -> int:
        """Move rows with ttl_column < cutoff (epoch days) into a parquet file.

        Returns rows archived.  The move is archive-write-then-delete: a crash
        between the two leaves rows duplicated in archive + hot, resolved by the
        idempotent re-run (delete again) — never lost."""
        if not PARQUET_AVAILABLE:
            raise errors.NotSupportedError("pyarrow is required for archiving")
        key = instance.store_key(schema, table)
        store = instance.store(schema, table)
        tm = store.table
        cm = tm.column(ttl_column)
        if not cm.dtype.clazz == dt.TypeClass.DATE:
            raise errors.TddlError("TTL column must be a DATE")
        from galaxysql_tpu_torch.storage.table_store import INFINITY_TS
        ts = snapshot_ts or instance.tso.next_timestamp()
        total = 0
        # One file per partition, archived as a mini 2PC with the hot store as the
        # participant and the parquet file as the other, so the slow encode runs
        # WITHOUT the partition lock while staying race-free against session DML
        # (this job runs on the scheduler thread):
        #   1. under lock: select expired rows, stamp a provisional write intent
        #      (-arc_txn) on them, copy their lanes.  The intent makes concurrent
        #      DML on those rows a write conflict (sessions re-check under the
        #      lock); readers still see them hot.
        #   2. no lock: encode + write the parquet, manifest PENDING (+arc_txn),
        #      then log the commit point (tx_log COMMITTED @ archive_ts).
        #   3. commit the intent to archive_ts via StoreParticipant (bumps the
        #      table version -> invalidates device-cached ts lanes), THEN flip
        #      the manifest LIVE — readers never observe a row hot and archived.
        # Crash recovery: before the commit point, recover_persisted rolls the
        # -arc_txn stamps back and attach() discards the PENDING file; after it,
        # recover_persisted re-commits the stamps at archive_ts and attach()
        # promotes the PENDING file to LIVE — both sides always agree with the
        # logged decision.
        from galaxysql_tpu_torch.txn.xa import StoreParticipant
        for p in store.partitions:
            arc_txn = instance.tso.next_timestamp()
            with p.lock:
                vis = p.visible_mask(ts)
                # NULL TTL values never expire.  Rows with ANY pending end stamp
                # (provisional -txn delete, or a delete committed after our
                # snapshot) stay hot: archiving them and then having the delete
                # resolve the other way would resurrect/duplicate the row.
                old = (vis & (p.end_ts == INFINITY_TS) & p.valid[cm.name]
                       & (p.lanes[cm.name] < cutoff_days))
                ids = np.nonzero(old)[0]
                if not ids.size:
                    continue
                p.end_ts[ids] = -arc_txn
                snap = {c.name: (p.lanes[c.name][ids].copy(),
                                 p.valid[c.name][ids].copy())
                        for c in tm.columns}
            sp = StoreParticipant(store, arc_txn)
            sp.deleted.append((p.pid, ids,
                               np.full(ids.size, INFINITY_TS, dtype=np.int64)))
            try:
                arrays = {}
                for c in tm.columns:
                    lane, valid = snap[c.name]
                    if c.dtype.is_string:
                        d = tm.dictionaries[c.name.lower()]
                        values = [d.values[code]
                                  if ok and 0 <= code < len(d.values) else None
                                  for code, ok in zip(lane.tolist(),
                                                      valid.tolist())]
                        arrays[c.name] = pa.array(values, type=pa.string())
                    else:
                        arrays[c.name] = pa.array(
                            [v if ok else None
                             for v, ok in zip(lane.tolist(), valid.tolist())])
                with self._lock:
                    self._seq += 1
                    path = os.path.join(
                        self._dir_for(key), f"archive_{ts}_{self._seq}.parquet")
                pq.write_table(pa.table(arrays), path)
                fd = os.open(path, os.O_RDONLY)  # durable BEFORE the commit point
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
                archive_ts = instance.tso.next_timestamp()
                if self.metadb is not None:
                    self.metadb.execute(
                        "INSERT OR REPLACE INTO archive_files VALUES (?,?,?,?,?)",
                        (path, key, archive_ts, "PENDING", arc_txn))
                    # commit point: from here the archival is decided
                    self.metadb.tx_log_put(arc_txn, "COMMITTED", archive_ts)
            except Exception:
                sp.rollback()  # release the write intent; rows stay hot
                if self.metadb is not None:
                    self.metadb.tx_log_put(arc_txn, "ABORTED")
                try:  # drop the partial parquet: nothing references it
                    os.unlink(path)
                except (OSError, UnboundLocalError):
                    pass
                raise
            sp.commit(archive_ts)
            tm.stats.row_count = store.row_count()
            instance.catalog.version += 1
            if self.metadb is not None:
                self.metadb.execute("UPDATE archive_files SET state='LIVE' "
                                    "WHERE path=?", (path,))
                self.metadb.tx_log_put(arc_txn, "DONE", archive_ts)
            with self._lock:
                self._files.setdefault(key, []).append((path, archive_ts))
            total += ids.size
        return total

    def file_refuted(self, path: str, sargs) -> bool:
        """True when parquet column min-max stats prove NO row can satisfy
        the conjunctive sargs [(column, op, lane_value)] — the SARG/min-max
        file skip of the reference's columnar scans (OSSTableScanExec.java:
        45-61).  Evaluation itself lives in `storage/zonemap.sargs_refuted`,
        shared with the HTAP replica's stripe zone maps; this method only
        builds + caches the per-file stats from parquet metadata."""
        if not sargs:
            return False
        with self._lock:
            stats = self._file_stats.get(path)
        if stats is None:
            stats = {}
            try:
                md = pq.ParquetFile(path).metadata
                for rg in range(md.num_row_groups):
                    row = md.row_group(rg)
                    for ci in range(row.num_columns):
                        col = row.column(ci)
                        st = col.statistics
                        if st is None or not st.has_min_max:
                            continue
                        name = col.path_in_schema
                        lo, hi = st.min, st.max
                        if not isinstance(lo, (int, float)):
                            continue
                        old_st = stats.get(name)
                        if old_st is None:
                            stats[name] = (lo, hi)
                        else:
                            stats[name] = (min(old_st[0], lo), max(old_st[1], hi))
            except Exception:
                stats = {}
            with self._lock:
                self._file_stats[path] = stats
        return sargs_refuted(stats, sargs)

    def scan_archive(self, instance, schema: str, table: str,
                     columns: List[str],
                     snapshot_ts: Optional[int] = None,
                     sargs=None, rf_sargs=None,
                     rf_pruned_cb=None) -> Iterator[ColumnBatch]:
        """Yield archived rows as ColumnBatches on the instance's device (strings
        re-encoded against the table's live dictionaries so joins/filters stay in
        code space).  Decoded parquet tables cache by path (archive files are
        immutable).

        `rf_sargs` are runtime-filter min/max ranges (join build sides):
        files they refute are skipped through the same min-max machinery,
        counted separately (`rf_pruned_files` + the per-file callback) so the
        pruning win is observable apart from WHERE-derived sargs."""
        if not PARQUET_AVAILABLE:
            return
        key = instance.store_key(schema, table)
        files = self.files_for(key, snapshot_ts)
        if not files:
            return
        tm = instance.catalog.table(schema, table)
        for path in files:
            if sargs and self.file_refuted(path, sargs):
                self.pruned_files += 1
                continue
            if rf_sargs and self.file_refuted(path, rf_sargs):
                # NOT pruned_files: that counter keeps meaning WHERE-derived
                # sarg refutation only, so dashboards can tell the two apart
                self.rf_pruned_files += 1
                if rf_pruned_cb is not None:
                    rf_pruned_cb(path)
                continue
            with self._lock:
                t = self._decoded.get(path)
            if t is None:
                t = pq.read_table(path)
                with self._lock:
                    if len(self._decoded) > 64:
                        self._decoded.clear()
                    self._decoded[path] = t
            t = t.select(list(columns))
            cols = {}
            for name in columns:
                cm = tm.column(name)
                arr = t.column(name)
                pylist = arr.to_pylist()
                valid = np.array([v is not None for v in pylist], dtype=np.bool_)
                if cm.dtype.is_string:
                    d = tm.dictionaries[name.lower()]
                    lane = np.fromiter(
                        (d.encode_one(v) if v is not None else 0 for v in pylist),
                        dtype=np.int32, count=len(pylist))
                else:
                    lane = np.array([v if v is not None else 0 for v in pylist],
                                    dtype=cm.dtype.lane)
                dev = instance.device
                cols[name] = Column(as_tensor(lane, dev),
                                    None if valid.all() else as_tensor(valid, dev),
                                    cm.dtype, tm.dictionaries.get(name.lower()))
            yield ColumnBatch(cols, None)
