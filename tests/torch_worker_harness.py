"""Worker subprocesses for the port's worker tests (`test_torch_workers.py`,
`test_torch_worker_faults.py`): a JAX-package worker (`python -m
galaxysql_tpu.net.worker --platform cpu`) or a port worker (`python -m
galaxysql_tpu_torch.net.worker --device cpu`) with the same arguments, its
`WORKER_READY` line read within a bound, and killed on `close()`."""

import os
import select
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_S = 120.0  # a worker that prints no WORKER_READY by then failed to start
PACKAGES = ("jax", "torch")


def _readline(stream, timeout_s: float) -> str:
    deadline = time.time() + timeout_s
    while True:
        left = deadline - time.time()
        if left <= 0:
            return ""
        ready, _, _ = select.select([stream], [], [], left)
        if ready:
            return stream.readline()


class WorkerProc:
    """One worker process of package `pkg` ("jax" or "torch").  `restart()` keeps
    the port, so attached WorkerClients reconnect to the new process."""

    def __init__(self, pkg: str, init_sql: str = "", data_dir=None,
                 wait: bool = True):
        self.pkg = pkg
        self.init_sql = init_sql
        self.data_dir = data_dir
        self.port = 0
        self.proc = None
        self._stderr = tempfile.NamedTemporaryFile(
            mode="w", prefix=f"worker-{pkg}-", suffix=".log", delete=False)
        self.launch()
        if wait:
            self.wait_ready()

    def spawn(self):
        self.launch()
        self.wait_ready()

    def launch(self):
        if self.pkg == "jax":
            cmd = [sys.executable, "-m", "galaxysql_tpu.net.worker",
                   "--port", str(self.port), "--platform", "cpu"]
        else:
            cmd = [sys.executable, "-m", "galaxysql_tpu_torch.net.worker",
                   "--port", str(self.port), "--device", "cpu"]
        if self.data_dir:
            cmd += ["--data-dir", self.data_dir]
        if self.init_sql and (self.data_dir is None or self.port == 0):
            # with a data dir the bootstrap state persists across restarts
            cmd += ["--init-sql", self.init_sql]
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=self._stderr, env=env, text=True)

    def wait_ready(self):
        line = _readline(self.proc.stdout, BOOT_S)
        if not line.startswith("WORKER_READY"):
            self.kill()
            raise AssertionError(f"{self.pkg} worker failed to start: {line!r} "
                                 f"(stderr: {self._stderr.name})")
        self.port = int(line.split()[1])

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def restart(self):
        self.kill()
        self.spawn()

    def wait_dead(self, timeout_s: float = 10.0):
        self.proc.wait(timeout=timeout_s)

    def close(self):
        self.kill()
        try:
            self._stderr.close()
            os.unlink(self._stderr.name)
        except OSError:
            pass

    @property
    def addr(self):
        return ("127.0.0.1", self.port)


def coordinator(pkg: str, data_dir=None):
    """A fresh coordinator instance and session of package `pkg` (the port's on
    the CPU)."""
    if pkg == "jax":
        from galaxysql_tpu.server.instance import Instance
        from galaxysql_tpu.server.session import Session
        inst = Instance(data_dir=data_dir)
    else:
        from galaxysql_tpu_torch.server.instance import Instance
        from galaxysql_tpu_torch.server.session import Session
        inst = Instance(data_dir=data_dir, device="cpu")
    return inst, Session(inst)


def outcome(fn):
    """('ok', rows, affected) of a statement, or ('error', class name): the form
    two packages' results are compared in."""
    try:
        rs = fn()
    except Exception as e:  # noqa: BLE001 - the class name is the outcome
        return ("error", type(e).__name__)
    return ("ok", [tuple(r) for r in rs.rows], rs.affected)


def start_all(*specs):
    """Workers booted side by side: [(pkg, init_sql, data_dir)] -> WorkerProcs,
    every one killed again if any fails to start."""
    procs = [WorkerProc(pkg, init, data_dir, wait=False) for pkg, init, data_dir in specs]
    try:
        for p in procs:
            p.wait_ready()
    except BaseException:
        for p in procs:
            p.close()
        raise
    return procs
