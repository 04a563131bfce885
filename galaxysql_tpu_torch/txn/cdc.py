"""CDC: an ordered global change log keyed by commit TSO (port of
`galaxysql_tpu/txn/cdc.py`).

Every committed row change is logged as a logical event in the metadb's
`binlog_events` table, at its commit timestamp: autocommit writes at the
statement's timestamp, a transaction's events buffered on it and written by
`flush_txn` with its commit timestamp (a rollback drops them), a batched DML
flush's events in one metadb transaction (`write_events`).  Consumers read them
with `SHOW BINLOG EVENTS`, COM_BINLOG_DUMP (`net/server.py`) or `events_after_seq`;
`replay()` applies a stream onto another instance and is idempotent across a
consumer crash (the applied seq watermark persists in the target's metadb).

An event's payload is `json.dumps({"columns", "rows"})` of the rows in the Python
domain (strings decoded from the dictionary, decimals as floats, dates as text,
NULL as None), byte for byte the reference's for the same rows, so a binlog
crosses between the packages both ways.

One change against the reference: `_replay_delete` matches an event's rows to the
target's through the partition's sorted key index (`Partition.key_index`, the point
path's) when the match is one primary-key column of an integer, decimal, date or
string type; otherwise it runs the reference's loop over every visible row.  Both
delete the same rows (`tests/test_torch_cdc.py`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from galaxysql_tpu_torch.chunk.batch import Column
from galaxysql_tpu_torch.plan.rules import _lane_encode
from galaxysql_tpu_torch.storage.table_store import visible_rows
from galaxysql_tpu_torch.types import datatype as dt
from galaxysql_tpu_torch.utils import errors

CDC_SCHEMA = """
CREATE TABLE IF NOT EXISTS binlog_events (
    seq INTEGER PRIMARY KEY AUTOINCREMENT, commit_ts INTEGER,
    schema_name TEXT, table_name TEXT, kind TEXT, payload TEXT);
"""

_WATERMARK_KEY = "cdc.applied_watermark"

def _decode_rows(tm, lanes: Dict[str, np.ndarray],
                 valid: Dict[str, np.ndarray]) -> Tuple[List[str], List[tuple]]:
    """Lane-domain row slices -> (columns, Python-domain rows)."""
    cols = tm.column_names()
    out_cols = [Column(lanes[c], valid[c], tm.column(c).dtype,
                       tm.dictionaries.get(c.lower())).to_pylist() for c in cols]
    return cols, list(zip(*out_cols)) if out_cols else []


class CdcManager:
    """Change-log writer and reader over the instance's metadb."""

    def __init__(self, instance):
        self.instance = instance
        instance.metadb._conn.executescript(CDC_SCHEMA)

    def enabled(self, session=None) -> bool:
        v = self.instance.config.get("ENABLE_CDC",
                                     session.vars if session else None)
        return bool(v) if v is not None else True

    # -- capture ------------------------------------------------------------

    def capture_rows(self, tm, store, pid: int, row_ids: np.ndarray,
                     kind: str, ts: int, txn=None, session=None, sink=None):
        """Log `kind` (insert|delete) for the given partition rows.

        Inside a transaction the event buffers on the txn and is written at
        commit with the commit TSO (rollback drops it); autocommit writes it now
        with the statement timestamp.  A `sink` list collects the event instead:
        the batched DML flush writes every member's events in one metadb
        transaction (`write_events`)."""
        if not self.enabled(session) or row_ids.size == 0:
            return
        p = store.partitions[pid]
        lanes = {c: p.lanes[c][row_ids] for c in tm.column_names()}
        valid = {c: p.valid[c][row_ids] for c in tm.column_names()}
        cols, rows = _decode_rows(tm, lanes, valid)
        ev = (tm.schema.lower(), tm.name.lower(), kind,
              json.dumps({"columns": cols, "rows": rows}))
        if sink is not None:
            sink.append(ev)
        elif txn is not None:
            txn.cdc_events.append(ev)
        else:
            self._write(ts, [ev])

    def capture_range(self, tm, store, pid: int, start: int, n: int,
                      ts: int, txn=None, session=None, sink=None):
        """Insert event for freshly appended rows [start, start+n)."""
        if n <= 0:
            return
        self.capture_rows(tm, store, pid, np.arange(start, start + n),
                          "insert", ts, txn, session, sink=sink)

    def write_events(self, commit_ts: int, events: List[tuple]):
        """Write collected events in one metadb transaction (one binlog write per
        DML batch flush, not per member)."""
        if events:
            self._write(commit_ts, events)

    def flush_txn(self, txn, commit_ts: int):
        evs = getattr(txn, "cdc_events", None)
        if evs:
            self._write(commit_ts, evs)
            txn.cdc_events = []

    def _write(self, commit_ts: int, events: List[tuple]):
        db = self.instance.metadb
        with db._lock:
            db._conn.executemany(
                "INSERT INTO binlog_events "
                "(commit_ts, schema_name, table_name, kind, payload) "
                "VALUES (?,?,?,?,?)",
                [(commit_ts, schema, table, kind, payload)
                 for schema, table, kind, payload in events])
            db._conn.commit()

    # -- read side ----------------------------------------------------------

    def events(self, since_ts: int = 0, limit: int = 10000) -> List[Tuple]:
        return self.instance.metadb.query(
            "SELECT seq, commit_ts, schema_name, table_name, kind, payload "
            "FROM binlog_events WHERE commit_ts > ? ORDER BY seq LIMIT ?",
            (since_ts, limit))

    def events_after_seq(self, seq: int = 0, limit: int = 10000) -> List[Tuple]:
        """Pages by seq: a commit-ts resume would skip the rest of a commit whose
        events straddle a page boundary (one transaction's events share one
        commit ts)."""
        return self.instance.metadb.query(
            "SELECT seq, commit_ts, schema_name, table_name, kind, payload "
            "FROM binlog_events WHERE seq > ? ORDER BY seq LIMIT ?",
            (seq, limit))

    def purge(self, before_ts: int):
        self.instance.metadb.execute(
            "DELETE FROM binlog_events WHERE commit_ts < ?", (before_ts,))


def replay(events: List[Tuple], target, stop_after: Optional[int] = None) -> int:
    """Apply a change stream onto `target` (an Instance) in seq order.

    Idempotent across crashes: the applied seq watermark persists in the target's
    metadb, so redelivered events at or below it are skipped.  Returns the number of
    events applied; `stop_after` stops after that many (a consumer crash)."""
    raw = target.metadb.kv_get(_WATERMARK_KEY)
    watermark = int(raw) if raw else 0
    applied = 0
    for seq, commit_ts, schema, table, kind, payload in events:
        if seq <= watermark:
            continue
        if stop_after is not None and applied >= stop_after:
            break
        d = json.loads(payload)
        tm = target.catalog.table(schema, table)
        store = target.store(schema, table)
        if kind == "insert":
            data = {c: [r[i] for r in d["rows"]]
                    for i, c in enumerate(d["columns"])}
            store.insert_pylists(data, commit_ts)
        elif kind == "delete":
            _replay_delete(tm, store, d, commit_ts)
        else:
            raise errors.TddlError(f"unknown binlog event kind {kind!r}")
        tm.bump_version()
        target.catalog.version += 1
        target.metadb.kv_put(_WATERMARK_KEY, str(seq))
        applied += 1
    return applied


# column classes whose lane encoding of a decoded value gives back the stored lane,
# so the key index finds exactly the rows whose decoded value equals it
_INDEXABLE = {dt.TypeClass.INT: int, dt.TypeClass.UINT: int,
              dt.TypeClass.DECIMAL: float, dt.TypeClass.DATE: str,
              dt.TypeClass.STRING: str}


def _replay_delete(tm, store, d: dict, commit_ts: int):
    """Delete the rows visible at `commit_ts` that match the event's row images on
    the primary key (every column without one), as the reference does: by their
    decoded values' text."""
    cols = d["columns"]
    match_cols = tm.primary_key or cols
    ix = {c: i for i, c in enumerate(cols)}
    want = set()
    for r in d["rows"]:
        want.add(tuple(str(r[ix[c]]) for c in match_cols))
    if len(match_cols) == 1 and tm.primary_key and \
            _delete_by_key_index(tm, store, match_cols[0],
                                 [r[ix[match_cols[0]]] for r in d["rows"]],
                                 {w[0] for w in want}, commit_ts):
        return
    for p in store.partitions:
        if p.num_rows == 0:
            continue
        vis = p.visible_mask(commit_ts)
        ids = np.nonzero(vis)[0]
        if ids.size == 0:
            continue
        keys = []
        for c in match_cols:
            cm = tm.column(c)
            keys.append([str(v) for v in Column(
                p.lanes[cm.name][ids], p.valid[cm.name][ids], cm.dtype,
                tm.dictionaries.get(cm.name.lower())).to_pylist()])
        hit = np.array([tuple(k[i] for k in keys) in want
                        for i in range(ids.size)], dtype=bool)
        if hit.any():
            p.delete_rows(ids[hit], commit_ts)


def _delete_by_key_index(tm, store, col: str, values: list, want: set,
                         commit_ts: int) -> bool:
    """The key-index form of `_replay_delete` for one key column: each wanted value
    encoded into the lane domain, looked up in every partition's sorted key index
    (and its unsorted appended tail), the candidates kept where valid, visible at
    `commit_ts` and equal to a wanted value by text.  False (nothing deleted) when
    the column or a value does not allow it; the caller then runs the loop."""
    cm = tm.column(col)
    pytype = _INDEXABLE.get(cm.dtype.clazz)
    if pytype is None or not all(type(v) is pytype for v in values):
        return False
    lanes = []
    for v in values:
        lane = _lane_encode(tm, cm.name, v)
        if lane is None:
            return False
        if not (cm.dtype.is_string and lane < 0):  # -1: absent from the dictionary
            lanes.append(lane)
    dictionary = tm.dictionaries.get(cm.name.lower())
    hits = []
    for p in store.partitions:
        with p.lock:
            ids = p.key_candidates_many(cm.name, np.asarray(lanes, dtype=cm.dtype.lane))
            ids = ids[p.valid[cm.name][ids] &
                      visible_rows(p.begin_ts[ids], p.end_ts[ids], commit_ts, 0)]
            if ids.size == 0:
                continue
            text = [str(v) for v in Column(
                p.lanes[cm.name][ids], p.valid[cm.name][ids], cm.dtype,
                dictionary).to_pylist()]
            hit = np.array([t in want for t in text], dtype=bool)
            if hit.any():
                hits.append((p, ids[hit]))
    for p, ids in hits:
        p.delete_rows(ids, commit_ts)
    return True
