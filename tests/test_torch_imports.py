"""The port stands alone: in a fresh interpreter (this test process has jax loaded by
conftest), importing every module of `galaxysql_tpu_torch` and `chip_smoke` pulls in
neither `jax` nor any module of `galaxysql_tpu`, and neither does a booted port worker
process; no file of the port names them in an import, lazy ones included; and where
CUDA is absent the CUDA entry points (the instance, the worker, `chip_smoke.py`)
refuse to run rather than fall back to the CPU."""

import ast
import os
import select
import shutil
import subprocess
import sys
import tempfile

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import galaxysql_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib" or
             k.startswith("jaxlib.") or k == "galaxysql_tpu" or
             k.startswith("galaxysql_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_fresh_interpreter_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 40  # every module of the port was imported


_PLANE_PROBE = r"""
import sys
from galaxysql_tpu_torch.meta import statement_summary
from galaxysql_tpu_torch.server import (admission, flight_recorder, scheduler, slo,
                                        web)
from galaxysql_tpu_torch.utils import ccl, locks, metric_history
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
s = Session(Instance(device="cpu"))
s.execute("CREATE DATABASE d; USE d; CREATE TABLE t (a INT PRIMARY KEY)")
s.execute("SELECT count(*) FROM t")
assert s.instance.slo_tick(force=True)
web.WebConsole(s.instance).resource("/health")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "galaxysql_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_operations_plane_modules_load_no_jax_and_no_reference_package():
    """The operations plane's modules, imported and driven (a query, an SLO tick,
    the web console's health resource) in a fresh interpreter, load neither jax
    nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PLANE_PROBE], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


_PLACEMENT_PROBE = r"""
import sys
from galaxysql_tpu_torch.ddl import rebalance, repartition
from galaxysql_tpu_torch.meta import sequence
from galaxysql_tpu_torch.server import balancer, placement, router
from galaxysql_tpu_torch.utils import fastchecker
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import Session
inst = Instance(device="cpu")
s = Session(inst)
s.execute("CREATE DATABASE d; USE d; CREATE TABLE t (a BIGINT PRIMARY KEY, b BIGINT) "
          "PARTITION BY HASH(a) PARTITIONS 2")
s.execute("INSERT INTO t VALUES (1, 1), (2, 2), (3, 3)")
s.execute("ALTER TABLE t SPLIT PARTITION p0 INTO 2")
s.execute("ALTER TABLE t PARTITION BY HASH(b) PARTITIONS 3")
assert s.execute("CHECK TABLE t").rows[0][3] == "OK"
assert s.execute("SELECT NEXTVAL('q')").rows == [(1,)]
s.execute("REBALANCE TABLE t DRY RUN")
peer = Instance(device="cpu")
Session(peer).execute("CREATE DATABASE d; USE d; CREATE TABLE t (a BIGINT PRIMARY KEY)")
fr = router.FrontRouter(inst)
fr.add_peer(router.InprocPeer(peer))
router.RouterSession(fr, schema="d").execute("SELECT count(*) FROM t")
s.execute("SHOW COORDINATORS")
s.execute("SHOW REBALANCE")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "galaxysql_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_placement_modules_load_no_jax_and_no_reference_package():
    """The placement slice's modules, imported and driven (a split, a repartition,
    CHECK TABLE, NEXTVAL, a balancer pass, a routed statement, SHOW COORDINATORS
    and SHOW REBALANCE) in a fresh interpreter, load neither jax nor the JAX
    package."""
    out = subprocess.run([sys.executable, "-c", _PLACEMENT_PROBE], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_lint_loads_no_jax_and_no_reference_package():
    """`python -m galaxysql_tpu_torch.devtools.lint`, run over the port's tree in a
    fresh interpreter, exits 0 and imports neither jax nor the JAX package."""
    cmd = [sys.executable, "-X", "importtime", "-m", "galaxysql_tpu_torch.devtools.lint"]
    out = subprocess.run(cmd, cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
    modules = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines()
               if ln.startswith("import time:")]
    assert any(m.endswith("galaxysql_tpu_torch.devtools.checkers.jit_discipline")
               for m in modules)
    bad = sorted({m for m in modules if m.split(".")[0] in ("jax", "jaxlib")
                  or m == "galaxysql_tpu" or m.startswith("galaxysql_tpu.")})
    assert not bad


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(ROOT, "galaxysql_tpu_torch")):
        out.extend(os.path.join(base, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_no_port_file_names_jax_or_the_reference_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "galaxysql_tpu"):
                    offenders.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not offenders


def test_cuda_instance_refuses_without_cuda():
    import torch
    from galaxysql_tpu_torch.server.instance import Instance
    if torch.cuda.is_available():
        assert Instance().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        Instance()
    with pytest.raises(RuntimeError):
        Instance(device="cuda")


_WORKER_INIT = ("CREATE DATABASE w; USE w; CREATE TABLE t (a BIGINT PRIMARY KEY, "
                "b VARCHAR(8)); INSERT INTO t VALUES (1, 'x'), (2, NULL)")


def test_booted_worker_loads_no_jax_and_no_reference_package():
    """`python -m galaxysql_tpu_torch.net.worker --device cpu`, booted and serving a
    fragment, a query and a branch write: `-X importtime` lists every module the
    process imported, and none is jax or of the JAX package."""
    from galaxysql_tpu_torch.net.dn import WorkerClient
    cmd = [sys.executable, "-X", "importtime", "-m", "galaxysql_tpu_torch.net.worker",
           "--port", "0", "--device", "cpu", "--init-sql", _WORKER_INIT]
    env = _clean_env()
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryFile(mode="w+") as err:
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=err, text=True)
        try:
            ready, _, _ = select.select([p.stdout], [], [], 120)
            line = p.stdout.readline() if ready else ""
            assert line.startswith("WORKER_READY"), line
            c = WorkerClient("127.0.0.1", int(line.split()[1]), timeout=60)
            _c, _t, data, valid = c.exec_plan({"schema": "w", "table": "t",
                                               "columns": ["a", "b"]})
            assert data["a"].tolist() == [1, 2] and valid["b"].tolist() == [True, False]
            assert c.execute("SELECT count(*) FROM t", "w")[2]
            c.request({"op": "dml", "xid": "g1", "schema": "w", "uid": "u1",
                       "sql": "INSERT INTO t VALUES (3, 'y')"})
            assert c.request({"op": "xa_rollback", "xid": "g1"})[0]["ok"]
            # the SLO plane's health pull runs the worker's metric history,
            # admission governor and SLO engine
            health = c.sync_action("health", {})
            assert health["ok"] and health["samples"] >= 1
            c.close()
        finally:
            p.kill()
            p.wait()
        err.seek(0)
        modules = [ln.rsplit("|", 1)[-1].strip() for ln in err
                   if ln.startswith("import time:")]
    assert any(m.endswith("galaxysql_tpu_torch.net.worker") or m == "torch"
               for m in modules)
    bad = sorted({m for m in modules if m.split(".")[0] in ("jax", "jaxlib")
                  or m == "galaxysql_tpu" or m.startswith("galaxysql_tpu.")})
    assert not bad


def test_worker_without_cuda_exits_non_zero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the worker runs on it")
    out = subprocess.run([sys.executable, "-m", "galaxysql_tpu_torch.net.worker",
                          "--port", "0"], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "WORKER_READY" not in out.stdout
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke runs for real there")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
