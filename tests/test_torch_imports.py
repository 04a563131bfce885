"""The port stands alone: in a fresh interpreter (this test process has jax loaded by
conftest), importing every module of `galaxysql_tpu_torch` and `chip_smoke` pulls in
neither `jax` nor any module of `galaxysql_tpu`; no file of the port names them in an
import, lazy ones included; and where CUDA is absent the CUDA entry points refuse to
run rather than fall back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys

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
