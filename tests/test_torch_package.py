"""Guards of the PyTorch port: it stands without JAX and without the JAX
package, it never moves to the CPU on its own, and ``chip_smoke.py``
refuses to report without a card or without the repository."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.core.shortcut_eh import ShortcutEH\n"
            "sc = ShortcutEH(6, 8, 32, device='cpu')\n"
            "sc.insert([5, 6, 7], [1, 2, 3])\n"
            "sc.pump()\n"
            "assert sc.lookup([5, 6, 7, 8]).tolist() == "
            "[1, 2, 3, 0xFFFFFFFF]\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m, v in sys.modules.items() if v)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


FORBIDDEN = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\.|"
                       r"import repro\s*$|from repro import)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    + [ROOT / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)
    assert "import jax" not in text and "from repro." not in text \
        and "import repro." not in text


def test_default_device_is_cuda(monkeypatch):
    from repro_torch.core.rewiring import pool_create
    from repro_torch.core.shortcut_eh import ShortcutEH
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ShortcutEH(4, 4, 8), lambda: pool_create(4, 2),
                 lambda: resolve_device(None),
                 lambda: resolve_device("cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_follows_the_sources():
    from repro_torch.kernels import _build
    names = {_build.library_path(n).name for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    digest = _build._digest()
    assert all(digest in n for n in names)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def test_launch_counter():
    from repro_torch.kernels import _build
    _build.reset_launches()
    _build.count_launch("x")
    _build.count_launch("x")
    _build.count_launch("y", 3)
    assert _build.launches() == {"x": 2, "y": 3}
    _build.reset_launches()
    assert _build.launches() == {}


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
