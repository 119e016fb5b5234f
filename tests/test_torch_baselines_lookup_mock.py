"""The baselines' lookup kernels (``csrc/baselines_lookup.cu``:
``open_lookup_kernel<false>`` for HT, ``<true>`` for HTI, ``ch_lookup_kernel``
for CH) compiled for the CPU with g++ against the stand-in CUDA runtime
(``tests/cuda_mock/``: every CUDA thread an OS thread), run through the real
wrapper (``kernels/baselines_lookup.py``) on CPU tensors and held bit for bit
to their plain versions (``core/baselines.py``'s ``*_lookup_plain``) and to
the JAX package's ``*_lookup_many`` on the states of
``chip_smoke.lookup_edge_states``, which reach the lookups' edges (windows
that wrap, full windows, keys behind an EMPTY slot, HTI mid-migration with
either table first and a key in both, CH chains of several buckets,
duplicate appends, values equal to MISS, rows of 5, 6, 16 and 20 slots;
probes from a sector's last slot into the next, hits at home + 8, tables
under one sector with keys past 2^L, a single probe).  Each wrong kernel of
``chip_smoke.LOOKUP_WRONG`` (the same source with one line replaced) must
fail on a state of its table.

It runs the source's own code at a small grid (2 blocks of 64 threads, so
the grid-stride loops go round); it says nothing of speed, and only a build
on the card checks what nvcc accepts (``chip_smoke.py`` (c) holds the card's
kernels to the same states).  Each run is a subprocess with a time limit."""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
try:
    import chip_smoke
    from repro_torch import convert
    from repro_torch.core import baselines as tbl
finally:
    del sys.path[:2]

SOURCE = ROOT / "src/repro_torch/kernels/csrc/baselines_lookup.cu"
MOCK = Path(__file__).with_name("cuda_mock")
MISS = 0xFFFFFFFF

PRELUDE = r'''
#include <cuda_runtime.h>
inline cudaError_t cudaLaunchKernel(const void* f, dim3 g, dim3 b,
                                    void** args, size_t, cudaStream_t) {
  return mock::launch(f, g, b, args);
}
'''
HOOK = r'''
namespace {
cudaError_t hook(const void* f, dim3 g, dim3 b, void** args) {
  if (f == reinterpret_cast<const void*>(open_lookup_kernel<false>))
    return mock::run_grid<OpenArgs, open_lookup_kernel<false>>(g, b, args);
  if (f == reinterpret_cast<const void*>(open_lookup_kernel<true>))
    return mock::run_grid<OpenArgs, open_lookup_kernel<true>>(g, b, args);
  if (f == reinterpret_cast<const void*>(ch_lookup_kernel))
    return mock::run_grid<ChArgs, ch_lookup_kernel>(g, b, args);
  return cudaErrorInvalidValue;
}
const int hooked = (mock::launch = hook, 0);
}  // namespace
'''
STATES = chip_smoke.lookup_edge_states(np, 0)
LABELS = [label for label, *_ in STATES]
# table -> the port's state from arrays, the plain version, the JAX
# package's state class and lookup (by name: the subprocess imports no JAX)
TABLES = {"ht": (convert.ht_state_from_numpy, tbl.ht_lookup_plain,
                 "HTState", "ht_lookup_many"),
          "hti": (convert.hti_state_from_numpy, tbl.hti_lookup_plain,
                  "HTIState", "hti_lookup_many"),
          "ch": (convert.ch_state_from_numpy, tbl.ch_lookup_plain,
                 "CHState", "ch_lookup_many")}


def harness(wrong) -> str:
    """The source (with ``LOOKUP_WRONG[wrong]``'s line replaced, unless
    ``wrong`` is None) at blocks of 64 threads and a grid of at most 2
    blocks, the launch routed to the stand-in runtime."""
    s = SOURCE.read_text()
    if wrong is not None:
        s = chip_smoke.wrong_lookup_source(wrong, s)
    for name, value in (("kThreads", 64), ("kMaxBlocks", 2)):
        s, k = re.subn(rf"constexpr int {name} = [^;]+;",
                       f"constexpr int {name} = {value};", s)
        assert k == 1
    s = s.replace('#include "common.cuh"',
                  f'#include "{SOURCE.with_name("common.cuh")}"')
    return PRELUDE + s + HOOK


@pytest.fixture(scope="module")
def mock_libs(tmp_path_factory):
    """The sound kernels (key None) and each wrong one, built at once."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU stand-in of the kernel")
    d = tmp_path_factory.mktemp("lookup_mock")
    started = {}
    for wrong in (None, *chip_smoke.LOOKUP_WRONG):
        tag = wrong or "sound"
        src, lib = d / f"{tag}.cpp", d / f"lib{tag}.so"
        src.write_text(harness(wrong))
        started[wrong] = (subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-w", "-I", str(MOCK), "-o", str(lib), str(src)],
            stderr=subprocess.PIPE, text=True), lib)
    for wrong, (proc, _) in started.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (wrong, err[-4000:])
    return {wrong: lib for wrong, (_, lib) in started.items()}


def kernel_results(lib: Path, indices, tmp_path) -> dict:
    """The kernel's answers on the states ``indices``, from a subprocess."""
    out = tmp_path / f"out_{lib.stem}.npz"
    r = subprocess.run([sys.executable, __file__, str(lib), str(out),
                        *map(str, indices)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    got = np.load(out)
    return {i: got[str(i)] for i in indices}


def plain(index: int) -> np.ndarray:
    _, table, arrays, probes = STATES[index]
    make, lookup, _, _ = TABLES[table]
    return lookup(make(arrays, device="cpu"), probes).numpy().view(np.uint32)


def reference(index: int, want: np.ndarray) -> tuple:
    """The JAX package's answers on the probes it can take, and those
    probes' mask.  CH leaves out keys stored with the value MISS: the
    reference's ``while_loop`` never ends on them (the port's lookup stops
    at the first hit; ROADMAP's deliberate differences)."""
    import jax.numpy as jnp

    from repro.core import baselines as jbl
    _, table, arrays, probes = STATES[index]
    _, _, cls, lookup = TABLES[table]
    take = np.ones(probes.size, bool)
    if table == "ch":
        take = (want != MISS) | ~np.isin(probes, arrays[1])
    jst = getattr(jbl, cls)(*(jnp.asarray(a) for a in arrays))
    return (np.asarray(getattr(jbl, lookup)(jst, jnp.asarray(probes[take]))),
            take)


@pytest.mark.parametrize("index", range(len(STATES)), ids=LABELS)
def test_kernel_matches_plain_and_jax(mock_libs, index, tmp_path):
    got = kernel_results(mock_libs[None], [index], tmp_path)[index]
    want = plain(index)
    np.testing.assert_array_equal(got, want)
    jax_want, take = reference(index, want)
    np.testing.assert_array_equal(got[take], jax_want)
    # at most the CH state's two keys stored with the value MISS are left out
    assert np.unique(STATES[index][3][~take]).size <= 2


@pytest.mark.parametrize("name", list(chip_smoke.LOOKUP_WRONG))
def test_wrong_kernel_fails(mock_libs, name, tmp_path):
    """The wrong kernel differs from the plain version on a state of its
    table (and so from the sound kernel, held to it above)."""
    table = chip_smoke.LOOKUP_WRONG[name][0]
    indices = [i for i, s in enumerate(STATES) if s[1] == table]
    got = kernel_results(mock_libs[name], indices, tmp_path)
    differ = {LABELS[i]: int((got[i] != plain(i)).sum()) for i in indices}
    assert sum(differ.values()) > 0, differ


def test_wrappers_refuse_cpu_tensors_and_bad_states():
    from repro_torch.kernels import baselines_lookup as look
    k = torch.arange(4, dtype=torch.int32)
    ht = tbl.ht_create(6, 4, device="cpu")
    for fn, st in ((look.ht_lookup, ht),
                   (look.hti_lookup, tbl.hti_create(6, 4, device="cpu")),
                   (look.ch_lookup, tbl.ch_create(2, 8, 4, device="cpu"))):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(st, k)
    with pytest.raises(ValueError, match=r"expected \(2\*\*k,\)"):
        look.ht_lookup(ht._replace(vals=ht.vals[:10]), k)
    with pytest.raises(TypeError):
        look.ht_lookup(ht._replace(keys=ht.keys.float()), k)
    with pytest.raises(ValueError, match="scalars"):
        look.ht_lookup(ht._replace(size_log2=ht.size_log2.long()), k)
    ch = tbl.ch_create(2, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="next_bucket"):
        look.ch_lookup(ch._replace(next_bucket=ch.next_bucket[:5]), k)


def test_cpu_lookups_run_the_plain_version(monkeypatch):
    """A CPU state never reaches the kernel wrappers."""
    from repro_torch.kernels import baselines_lookup as look
    for fn in ("ht_lookup", "hti_lookup", "ch_lookup"):
        monkeypatch.setattr(look, fn, None)
    keys = list(range(1, 40))
    for create, insert, lookup in (
            (lambda: tbl.ht_create(8, 4, device="cpu"), tbl.ht_insert_many,
             tbl.ht_lookup_many),
            (lambda: tbl.hti_create(8, 4, device="cpu"), tbl.hti_insert_many,
             tbl.hti_lookup_many),
            (lambda: tbl.ch_create(2, 16, 4, device="cpu"),
             tbl.ch_insert_many, tbl.ch_lookup_many)):
        st = insert(create(), keys, keys)
        assert lookup(st, keys + [99]).tolist() == keys + [MISS]


def _run(lib_path: str, out: str, indices) -> None:
    """The subprocess: the wrapper on CPU tensors, its library the mock."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_lookup as look
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in look._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _build.load = lambda name, signatures: lib
    _build.require_cuda = lambda name, *t: torch.device("cpu")
    _build.stream = lambda dev: 0
    kernels = {"ht": look.ht_lookup, "hti": look.hti_lookup,
               "ch": look.ch_lookup}
    got = {}
    for i in indices:
        label, table, arrays, probes = STATES[i]
        st = TABLES[table][0](arrays, device="cpu")
        _build.reset_launches()
        got[str(i)] = kernels[table](st, probes).numpy().view(np.uint32)
        assert _build.launches() == {f"{table}_lookup": 1}, label
    np.savez(out, **got)


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2], [int(x) for x in sys.argv[3:]])
