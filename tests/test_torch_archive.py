"""The TTL Parquet archive (`storage/archive.py`) through the JAX package and the port
on the CPU: the reference's own cases (`tests/test_archive.py`), each run as a
scenario through both packages, whose observations (rows, rows archived, files and
manifest states, pruned files) must be equal.  Scans union the hot rows with the
archived ones; the write-then-delete order with its commit point in the transaction
log survives a crash between the two; Parquet min-max statistics skip whole files.
`pyarrow` is optional in the port as in the reference: without it
`archive_older_than` raises `NotSupportedError` and `scan_archive` yields nothing."""

import os
import types

import numpy as np
import pytest
import torch

from galaxysql_tpu.server.instance import Instance as JaxInstance
from galaxysql_tpu.server.session import Session as JaxSession
from galaxysql_tpu.storage import archive as jax_archive
from galaxysql_tpu.types import temporal
from galaxysql_tpu.utils import errors as jax_errors
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
from galaxysql_tpu_torch.storage import archive
from galaxysql_tpu_torch.utils import errors

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def _jax_instance(data_dir=None):
    ji = JaxInstance(data_dir=data_dir, boot=False)
    ji.config.set_instance("ENABLE_COMPILE_CACHE", False)
    ji.boot()
    return ji


JAX = types.SimpleNamespace(name="jax", new=_jax_instance, Session=JaxSession,
                            archive=jax_archive, errors=jax_errors)
PORT = types.SimpleNamespace(name="port",
                             new=lambda d=None: Instance(data_dir=d, device="cpu"),
                             Session=Session, archive=archive, errors=errors)


def _same(scenario, tmp_path):
    want = scenario(JAX, tmp_path / "jax")
    got = scenario(PORT, tmp_path / "port")
    assert got == want
    return got


def _session(pkg, tmp):
    inst = pkg.new()
    inst.archive.directory = str(tmp / "arch")
    s = pkg.Session(inst)
    s.execute("CREATE DATABASE c; USE c")
    return s


def _load(s, n=1000):
    s.execute("CREATE TABLE ev (id BIGINT, d DATE, tag VARCHAR(8), v BIGINT) "
              "PARTITION BY HASH(id) PARTITIONS 4")
    base = temporal.parse_date("2020-01-01")
    store = s.instance.store("c", "ev")
    store.insert_arrays({
        "id": np.arange(n),
        "d": base + np.arange(n) % 400,  # dates spread over 400 days
        "tag": ["a" if i % 2 else "b" for i in range(n)],
        "v": np.arange(n) * 10,
    }, s.instance.tso.next_timestamp())
    s.execute("ANALYZE TABLE ev")
    return store, base


@pytest.fixture()
def pq():
    """`pyarrow.parquet`: archiving needs it (the case without it patches it away)."""
    return pytest.importorskip("pyarrow.parquet")


def test_archive_and_transparent_scan(tmp_path, pq):
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        store, base = _load(s)
        before = s.execute("SELECT count(*), sum(v) FROM ev").rows
        n = s.instance.archive.archive_older_than(s.instance, "c", "ev", "d",
                                                  base + 200)
        assert n > 0 and store.row_count() == 1000 - n  # the hot store shrank
        files = s.instance.archive.files_for("c.ev")
        assert files and os.path.getsize(files[0]) > 0
        after = s.execute("SELECT count(*), sum(v) FROM ev").rows
        assert after == before  # hot and cold rows union
        r1 = s.execute("SELECT count(*) FROM ev WHERE tag = 'a'").rows
        assert r1 == [(500,)]
        assert any("scan-archive" in t for t in s.last_trace)
        r2 = s.execute("SELECT tag, count(*), min(d), max(v) FROM ev "
                       "GROUP BY tag ORDER BY tag").rows
        r3 = s.execute("SELECT e.id, f.v FROM ev e JOIN ev f ON e.id = f.id + 1 "
                       "WHERE e.id < 5 ORDER BY e.id").rows
        return n, len(files), after, r1, r2, r3
    _same(scenario, tmp_path)


def test_archive_idempotent_rerun(tmp_path, pq):
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        _store, base = _load(s, n=200)
        am = s.instance.archive
        n1 = am.archive_older_than(s.instance, "c", "ev", "d", base + 100)
        n2 = am.archive_older_than(s.instance, "c", "ev", "d", base + 100)
        assert n1 > 0 and n2 == 0  # nothing left to archive
        rows = s.execute("SELECT count(*) FROM ev").rows
        assert rows == [(200,)]
        return n1, n2, rows
    _same(scenario, tmp_path)


def test_archive_readable_by_parquet_tools(tmp_path, pq):
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        _store, base = _load(s, n=100)
        s.instance.archive.archive_older_than(s.instance, "c", "ev", "d", base + 1000)
        tabs = [pq.read_table(f) for f in s.instance.archive.files_for("c.ev")]
        assert sum(t.num_rows for t in tabs) == 100
        for t in tabs:
            assert set(t.column_names) == {"id", "d", "tag", "v"}
        # one file a partition, each holding the same rows in both packages
        return sorted(sorted(zip(*[t.column(c).to_pylist()
                                   for c in ("id", "d", "tag", "v")]))
                      for t in tabs)
    _same(scenario, tmp_path)


def test_registry_survives_restart(tmp_path, pq):
    def scenario(pkg, tmp):
        d = str(tmp / "data")
        inst = pkg.new(d)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute("CREATE TABLE ev (id BIGINT, d DATE)")
        base = temporal.parse_date("2020-01-01")
        inst.store("c", "ev").insert_arrays(
            {"id": np.arange(100), "d": base + np.arange(100)},
            inst.tso.next_timestamp())
        n = inst.archive.archive_older_than(inst, "c", "ev", "d", base + 50)
        assert n == 50
        inst.save()
        s.close()
        inst2 = pkg.new(d)
        s2 = pkg.Session(inst2, "c")
        rows = s2.execute("SELECT count(*), min(d), max(d) FROM ev").rows
        assert rows[0][0] == 100 and inst2.archive.files_for("c.ev")
        hot = inst2.store("c", "ev").row_count()
        s2.close()
        return n, rows, hot
    _same(scenario, tmp_path)


def test_pending_with_commit_point_promotes_on_boot(tmp_path, pq):
    """A crash between the commit point in the transaction log and the LIVE flip of
    the manifest: boot promotes the PENDING file and re-commits the hot rows' stamps."""
    def scenario(pkg, tmp):
        d = str(tmp / "data")
        inst = pkg.new(d)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute("CREATE TABLE ev (id BIGINT, d DATE)")
        base = temporal.parse_date("2020-01-01")
        inst.store("c", "ev").insert_arrays(
            {"id": np.arange(100), "d": base + np.arange(100)},
            inst.tso.next_timestamp())
        assert inst.archive.archive_older_than(inst, "c", "ev", "d", base + 50) == 50
        rows = inst.metadb.query("SELECT path, arc_txn, archive_ts FROM archive_files")
        for path, arc_txn, ats in rows:
            inst.metadb.execute(
                "UPDATE archive_files SET state='PENDING' WHERE path=?", (path,))
            inst.metadb.tx_log_put(arc_txn, "COMMITTED", ats)
            for p in inst.store("c", "ev").partitions:
                p.end_ts[p.end_ts == ats] = -arc_txn
        inst.save()
        s.close()
        inst2 = pkg.new(d)
        s2 = pkg.Session(inst2, "c")
        count = s2.execute("SELECT count(*) FROM ev").rows
        assert count == [(100,)]  # no lost row, no duplicate
        states = {st for (st,) in inst2.metadb.query("SELECT state FROM archive_files")}
        assert states == {"LIVE"}
        s2.close()
        return count, states, len(rows)
    _same(scenario, tmp_path)


def test_pending_without_commit_point_is_discarded_on_boot(tmp_path, pq):
    """The other side of the crash window: no commit point, so boot drops the file
    and rolls the hot rows' intent back; every row is hot again, once."""
    def scenario(pkg, tmp):
        d = str(tmp / "data")
        inst = pkg.new(d)
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE c; USE c")
        s.execute("CREATE TABLE ev (id BIGINT, d DATE)")
        base = temporal.parse_date("2020-01-01")
        inst.store("c", "ev").insert_arrays(
            {"id": np.arange(100), "d": base + np.arange(100)},
            inst.tso.next_timestamp())
        assert inst.archive.archive_older_than(inst, "c", "ev", "d", base + 50) == 50
        rows = inst.metadb.query("SELECT path, arc_txn, archive_ts FROM archive_files")
        for path, arc_txn, ats in rows:
            inst.metadb.execute(
                "UPDATE archive_files SET state='PENDING' WHERE path=?", (path,))
            inst.metadb.execute("DELETE FROM global_tx_log WHERE txn_id=?", (arc_txn,))
            for p in inst.store("c", "ev").partitions:
                p.end_ts[p.end_ts == ats] = -arc_txn
        inst.save()
        s.close()
        inst2 = pkg.new(d)
        s2 = pkg.Session(inst2, "c")
        count = s2.execute("SELECT count(*) FROM ev").rows
        files = inst2.archive.files_for("c.ev")
        hot = inst2.store("c", "ev").row_count()
        assert count == [(100,)] and files == [] and hot == 100
        assert not any(os.path.exists(p) for p, _a, _t in rows)
        s2.close()
        return count, hot, len(files)
    _same(scenario, tmp_path)


def test_snapshot_never_double_counts(tmp_path, pq):
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        inst = s.instance
        s.execute("CREATE TABLE sn (id BIGINT, d DATE)")
        base = temporal.parse_date("2020-01-01")
        inst.store("c", "sn").insert_arrays(
            {"id": np.arange(10), "d": base + np.arange(10)}, inst.tso.next_timestamp())
        s.execute("BEGIN")  # the snapshot predates the archival
        out = [s.execute("SELECT count(*) FROM sn").rows]
        s2 = pkg.Session(inst, "c")
        inst.archive.archive_older_than(inst, "c", "sn", "d", base + 100)
        out.append(s.execute("SELECT count(*) FROM sn").rows)  # hot copies, no archive
        s.execute("COMMIT")
        out.append(s.execute("SELECT count(*) FROM sn").rows)
        assert out == [[(10,)]] * 3
        s2.close()
        return out
    _same(scenario, tmp_path)


def test_null_ttl_never_archives(tmp_path, pq):
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        inst = s.instance
        s.execute("CREATE TABLE nl (id BIGINT, d DATE)")
        s.execute("INSERT INTO nl VALUES (1, '2000-01-01'), (2, NULL)")
        n = inst.archive.archive_older_than(inst, "c", "nl", "d",
                                            temporal.parse_date("2020-01-01"))
        assert n == 1  # only the dated row: NULL never expires
        rows = s.execute("SELECT count(*) FROM nl WHERE d IS NULL").rows
        assert rows == [(1,)]
        return n, rows, s.execute("SELECT id, d FROM nl ORDER BY id").rows
    _same(scenario, tmp_path)


def test_minmax_stats_skip_refuted_files(tmp_path, pq):
    """Parquet min-max statistics prune whole archive files against a scan's SARGs
    (`storage/zonemap.sargs_refuted`); pruning never changes results."""
    def scenario(pkg, tmp):
        inst = pkg.new()
        inst.archive.directory = str(tmp / "arch")
        s = pkg.Session(inst)
        s.execute("CREATE DATABASE ar")
        s.execute("USE ar")
        s.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, d DATE, v BIGINT)")
        today = temporal.days_from_civil(2026, 7, 29)
        store = inst.store("ar", "ev")
        for base, age in ((0, 400), (100, 800)):
            store.insert_pylists(
                {"id": list(range(base, base + 100)),
                 "d": [temporal.format_date(today - age)] * 100,
                 "v": [base] * 100},
                inst.tso.next_timestamp())
            assert inst.archive.archive_older_than(inst, "ar", "ev", "d",
                                                   today - age + 1) == 100
        am = inst.archive
        before = am.pruned_files
        r = s.execute("SELECT count(*) FROM ev WHERE id >= 150").rows
        assert r == [(50,)] and am.pruned_files > before
        pruned = am.pruned_files - before
        everything = s.execute("SELECT count(*), sum(v) FROM ev").rows
        assert everything[0][0] == 200
        s.close()
        return r, pruned, everything
    _same(scenario, tmp_path)


def test_point_and_batched_paths_defer_to_the_planned_path(tmp_path, pq):
    """A table with archived rows: the point fast path and the DML batch plans step
    aside (cold rows live outside the key index), so a point select of an archived
    key still answers, through the planned path with the archive's batches."""
    def scenario(pkg, tmp):
        s = _session(pkg, tmp)
        inst = s.instance
        s.execute("CREATE TABLE kv (id BIGINT PRIMARY KEY, d DATE, v BIGINT)")
        base = temporal.parse_date("2020-01-01")
        inst.store("c", "kv").insert_arrays(
            {"id": np.arange(50), "d": base + np.arange(50), "v": np.arange(50) * 3},
            inst.tso.next_timestamp())
        out = [s.execute("SELECT v FROM kv WHERE id = 7").rows]  # registers a plan
        s.execute("UPDATE kv SET v = 1 WHERE id = 40")  # registers a DML plan
        inst.archive.archive_older_than(inst, "c", "kv", "d", base + 20)
        out += [s.execute(f"SELECT v FROM kv WHERE id = {k}").rows for k in (7, 30)]
        assert not any(t.startswith("point-plan") for t in s.last_trace)
        s.execute("UPDATE kv SET v = 2 WHERE id = 41")
        out.append(s.execute("SELECT id, v FROM kv WHERE id >= 40 ORDER BY id").rows)
        out.append(s.execute("SELECT count(*) FROM kv").rows)
        assert out[1:3] == [[(21,)], [(90,)]] and out[-1] == [(50,)]
        return out
    _same(scenario, tmp_path)


def test_without_pyarrow_the_reference_behaviour(tmp_path, monkeypatch):
    """The card's host has no `pyarrow`: `archive_older_than` raises the reference's
    `NotSupportedError`, a scan yields no archived batch, and queries keep to the hot
    rows."""
    def scenario(pkg, tmp):
        monkeypatch.setattr(pkg.archive, "PARQUET_AVAILABLE", False)
        s = _session(pkg, tmp)
        _store, base = _load(s, n=100)
        with pytest.raises(pkg.errors.NotSupportedError) as e:
            s.instance.archive.archive_older_than(s.instance, "c", "ev", "d", base + 50)
        batches = list(s.instance.archive.scan_archive(s.instance, "c", "ev", ["id"]))
        return str(e.value), len(batches), s.execute("SELECT count(*) FROM ev").rows
    _same(scenario, tmp_path)
