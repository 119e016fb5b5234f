"""Nothing of the benchmark loads JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` is not ``repro``), and the plain
reference imports nothing of the program."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench.tests import stand_in

PKG = stand_in.REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "references").glob("*.py"):
        names = _imports(path)
        assert names <= {"__future__", "torch", "numpy", "math"}, names


def test_names_compared_whole():
    from perfbench import harness
    assert "repro" in harness.FORBIDDEN
    # repro_torch's top-level name is not repro
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_loaded_modules_after_importing_everything():
    """In a fresh interpreter: every workload resolved (which imports its
    adapter, the program, its generator, reference and readers), then
    ``sys.modules`` holds no forbidden top-level name."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(stand_in.REPO / 'src')!r},
                        {str(stand_in.REPO)!r}]
        from pathlib import Path
        from perfbench import control, harness, spec, trace_read
        root = Path({str(stand_in.REPO)!r})
        b = spec.load_spec(root)
        for w in b["workloads"]:
            spec.resolve(b, w["name"], root / "perfbench")
        print(json.dumps(harness.forbidden_modules()))
        print("repro_torch" in sys.modules)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert lines == ["[]", "True"]
