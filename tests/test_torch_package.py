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
            "import torch\n"
            "from repro_torch.kvcache import ShortcutKVManager, cache_create\n"
            "kv = ShortcutKVManager(cache_create(1, 8, 2, 1, 8, 2, 4, "
            "torch.float32, device='cpu'), 8, device='cpu')\n"
            "kv.prefill([0, 1], torch.ones(1, 2, 4, 1, 8), "
            "torch.ones(1, 2, 4, 1, 8))\n"
            "kv.pump()\n"
            "assert kv.in_sync([0, 1]) and kv.route([0, 1]) == 'paged'\n"
            "from repro_torch.configs import get\n"
            "from repro_torch.models import model as M\n"
            "from repro_torch.runtime import serve\n"
            "cfg = get('qwen3_4b').reduced()\n"
            "p = M.init_params(cfg, 0, torch.float32, device='cpu')\n"
            "logits, st = serve.make_prefill_step(cfg, 24)(\n"
            "    p, {'tokens': torch.arange(32).reshape(2, 16)})\n"
            "tok = logits.argmax(-1)\n"
            "step = serve.make_serve_step(cfg)\n"
            "for _ in range(2):\n"
            "    tok, st = step(p, st, tok)\n"
            "assert st.ctx_len.tolist() == [18, 18] and tok.shape == (2,)\n"
            "from repro_torch.core import baselines as bl\n"
            "keys, vals = list(range(1, 301)), list(range(300))\n"
            "for table, look in (\n"
            "        (bl.ht_insert_many(bl.ht_create(10, 4, device='cpu'),\n"
            "                           keys, vals), bl.ht_lookup_many),\n"
            "        (bl.hti_insert_many(bl.hti_create(10, 4, device='cpu'),\n"
            "                            keys, vals, 8), bl.hti_lookup_many),\n"
            "        (bl.ch_insert_many(bl.ch_create(3, 64, 8, device='cpu'),\n"
            "                           keys, vals), bl.ch_lookup_many)):\n"
            "    assert look(table, keys + [999]).tolist() == vals + "
            "[0xFFFFFFFF]\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch import serve as serve_cli\n"
            "assert serve_cli.main(['--arch', 'qwen3_4b', '--reduced', "
            "'--device', 'cpu', '--gen', '3']) == 0\n"
            "rec = dryrun.lower_cell('qwen3_4b', 'decode_32k', "
            "path='paged')\n"
            "assert rec['status'] == 'ok' and rec['hlo_flops'] > 0\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m, v in sys.modules.items() if v)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


FORBIDDEN = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\.|"
                       r"import repro\s*$|from repro import)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    + [ROOT / "chip_smoke.py"]
    + list((ROOT / "examples").glob("*_torch.py"))
    + list((ROOT / "tools").glob("*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)
    assert "import jax" not in text and "from repro." not in text \
        and "import repro." not in text


def test_default_device_is_cuda(monkeypatch):
    from repro_torch.core.rewiring import pool_create
    from repro_torch.core.shortcut_eh import ShortcutEH
    from repro_torch.device import resolve_device
    from repro_torch.kvcache import ShortcutKVManager, cache_create
    from repro_torch.kvcache.prefix_index import PrefixCacheIndex
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serve import decode_state_init
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch import dryrun
    cfg = get("qwen3_4b").reduced()
    cpu_cache = cache_create(1, 4, 2, 1, 8, 2, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ShortcutEH(4, 4, 8), lambda: pool_create(4, 2),
                 lambda: cache_create(1, 4, 2, 1, 8, 2, 2),
                 lambda: ShortcutKVManager(cpu_cache, 4),
                 lambda: PrefixCacheIndex(4),
                 lambda: init_params(cfg), lambda: decode_state_init(cfg, 2, 8),
                 lambda: SyntheticLM(cfg, DataConfig(8, 2)),
                 lambda: train_main(["--arch", "qwen3_4b", "--reduced"]),
                 lambda: serve_main(["--arch", "qwen3_4b", "--reduced"]),
                 lambda: resolve_device(None),
                 lambda: resolve_device("cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # the dry run reckons on the meta device: it needs no card
    rec = dryrun.lower_cell("qwen3_4b", "decode_32k")
    assert rec["status"] == "ok" and rec["chips"] == 1


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


def test_chip_smoke_ptxas_summary():
    """Phase (b)'s one line per kernel of ``nvcc -Xptxas -v``: registers,
    spills and stack of each, and ptxas's notes on serialized wgmma."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z6kernelPf' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z6kernelPf",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register "
        "resources for the function '_Z6kernelPf'"])
    rows = chip_smoke.ptxas_summary(out)
    assert len(rows) == 2
    assert rows[0].split(" | ")[0] in ("kernel", "_Z6kernelPf")
    assert "4 bytes spill stores" in rows[0]
    assert rows[0].endswith("Used 168 registers, used 16 barriers")
    assert "serialized" in rows[1]
