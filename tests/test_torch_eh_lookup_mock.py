"""The EH lookup kernels (``csrc/eh_lookup.cu``) compiled for the CPU with g++
against the stand-in CUDA runtime (``tests/cuda_mock/``: every CUDA thread an
OS thread), their launchers called through ``ctypes`` on CPU tensors and
held bit for bit to the wrappers' plain versions: the padded (N, K) kernels
(``eh_lookup_kernel<true/false>``, ``routed_lookup_kernel``), the stacked
one, and the flat-key mode (``flat_eh_lookup_kernel<true/false>``,
``flat_routed_lookup_kernel``), whose keys come in input order and find
their shard inside the kernel, on the stacks of ``eh_stacks.py``'s
``flat_stacks`` (N 2, 4, 8; shard 0's table
empty; a mixed batch with one shard traditional).  A wrong copy of the
source, whose flat-key mode takes each key's shard from one bit too few of
its hash, must fail.

Each block of a launch runs in turn, its threads at once (the lookups have
no ``__syncthreads`` and no grid-wide step), at 64 threads a block so that
the lane groups' key streams go round.  It says nothing of speed, and only
a build on the card checks what nvcc accepts (``chip_smoke.py`` (f) holds
the card's flat-key kernels to the padded ones).  Each run is a subprocess
with a time limit."""
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
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.hashing import shard_of_keys  # noqa: E402
from repro_torch.kernels import eh_lookup as tk  # noqa: E402
from repro_torch.runtime.shard_group import partition_by_shard  # noqa: E402

from eh_stacks import (ARMS, FLAT_TILE, flat_arm, flat_case,  # noqa: E402
                       flat_stacks)  # noqa: F401 (a fixture)

SOURCE = ROOT / "src/repro_torch/kernels/csrc/eh_lookup.cu"
MOCK = Path(__file__).with_name("cuda_mock")

PRELUDE = r'''
#include <cuda_runtime.h>
#include <thread>
#include <vector>
// A launch: every block of the grid in turn, its threads at once.
template <class... P, class... A>
void mock_launch(dim3 g, dim3 b, void (*k)(P...), A... a) {
  blockDim = b;
  gridDim = g;
  for (auto* w : mock::warps) delete w;
  mock::warps.clear();
  for (unsigned i = 0; i < g.x * b.x / 32; ++i)
    mock::warps.push_back(new mock::Warp());
  for (unsigned y = 0; y < g.y; ++y) {
    for (unsigned x = 0; x < g.x; ++x) {
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < b.x; ++t) {
        ts.emplace_back([=] {
          blockIdx = dim3(x, y);
          threadIdx = dim3(t);
          k(a...);
        });
      }
      for (auto& t : ts) t.join();
    }
  }
}
'''
#: the wrong copy: each key's shard from one bit too few of its hash
WRONG = ("const uint32_t s = st.bits == 0 ? 0 : h >> (32 - st.bits);",
         "const uint32_t s = st.bits == 0 ? 0 : (h >> (32 - st.bits)) >> 1;")


def _launch(m) -> str:
    """``kernel<<<grid, block, smem, stream>>>(`` as a stand-in call."""
    grid, block, _, _ = (p.strip() for p in m.group(2).split(","))
    return f"mock_launch(dim3({grid}), dim3({block}), {m.group(1)}, "


def harness(wrong: bool) -> str:
    s = SOURCE.read_text()
    if wrong:
        assert s.count(WRONG[0]) == 1
        s = s.replace(*WRONG)
    s, k = re.subn(r"constexpr int kThreads = [^;]+;",
                   "constexpr int kThreads = 64;", s)
    assert k == 1
    s, k = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", _launch, s,
                   flags=re.DOTALL)
    assert k == 7, k
    s = s.replace('#include "common.cuh"',
                  f'#include "{SOURCE.with_name("common.cuh")}"')
    return PRELUDE + s


@pytest.fixture(scope="module")
def mock_libs(tmp_path_factory):
    """The sound source (False) and the wrong one (True), built at once."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU stand-in of the kernels")
    d = tmp_path_factory.mktemp("eh_lookup_mock")
    started = {}
    for wrong in (False, True):
        src, lib = d / f"k{int(wrong)}.cpp", d / f"libk{int(wrong)}.so"
        src.write_text(harness(wrong))
        started[wrong] = (subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-w", "-I", str(MOCK), "-o", str(lib), str(src)],
            stderr=subprocess.PIPE, text=True), lib)
    for wrong, (proc, _) in started.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (wrong, err[-4000:])
    return {wrong: lib for wrong, (_, lib) in started.items()}


def inputs(fs, rng) -> dict:
    """The arrays a subprocess launches on: the stacks, a flat batch over
    every shard (absent keys too, its length off the tile; a few hundred
    keys, since each warp collective of the stand-in is an OS-thread
    barrier), that batch padded per shard, and the routed flags (shard 1
    traditional)."""
    keys = flat_case(fs, "every_shard", rng)[:200 + fs["N"]]
    assert keys.size % FLAT_TILE
    k = torch.from_numpy(keys.view(np.int32))
    sid = shard_of_keys(k, fs["bits"])
    counts = torch.bincount(sid, minlength=fs["N"])
    assert (counts > 0).all()
    cap = int(counts.max())
    padded = partition_by_shard(k, sid, fs["N"], cap)[0]
    flags = np.zeros(fs["N"], np.int32)
    flags[1] = 1
    d, bk, bv, gd = fs["trad"]
    vk, vv, vl = fs["view"]
    arrays = dict(keys=keys.view(np.int32), padded=padded.numpy(),
                  flags=flags, bits=np.int32(fs["bits"]))
    for name, t in (("d", d), ("bk", bk), ("bv", bv), ("gd", gd), ("vk", vk),
                    ("vv", vv), ("vl", vl)):
        arrays[name] = t.view(torch.int32).numpy()
    return arrays


def expected(fs, a) -> dict:
    """The plain versions' answers, named as the subprocess names its."""
    bits = fs["bits"]
    want = {}
    for arm in ARMS:
        want[f"flat_{arm}"] = flat_arm(fs, arm, a["keys"], shard_bits=bits)
        want[f"padded_{arm}"] = flat_arm(fs, arm, a["padded"])
    vk, vv, vl = fs["view"]
    for s in range(fs["N"]):
        want[f"stacked_{s}"] = tk.stacked_shortcut_lookup(
            a["padded"][s], vk, vv, vl, s, tile=FLAT_TILE)
    return {n: t.view(torch.int32).numpy() for n, t in want.items()}


def kernel_results(lib: Path, a: dict, tmp_path) -> dict:
    src, out = tmp_path / "in.npz", tmp_path / f"out_{lib.stem}.npz"
    np.savez(src, **a)
    r = subprocess.run([sys.executable, __file__, str(lib), str(src),
                        str(out)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    return dict(np.load(out))


def test_kernels_match_plain(mock_libs, flat_stacks, tmp_path):
    fs = flat_stacks
    a = inputs(fs, np.random.default_rng(fs["N"]))
    got = kernel_results(mock_libs[False], a, tmp_path)
    want = expected(fs, a)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_one_bit_short_kernel_fails(mock_libs, flat_stacks, tmp_path):
    """The wrong copy's padded and stacked kernels still agree; each of
    its flat-key arms differs from the plain version."""
    fs = flat_stacks
    a = inputs(fs, np.random.default_rng(fs["N"]))
    got = kernel_results(mock_libs[True], a, tmp_path)
    want = expected(fs, a)
    for name in want:
        same = np.array_equal(got[name], want[name])
        assert same != name.startswith("flat_"), name


def _run(lib_path: str, src: str, out: str) -> None:
    """The subprocess: every launcher of the library on the arrays."""
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in tk._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    a = {n: torch.from_numpy(v) for n, v in np.load(src).items()}
    bits = int(a["bits"])
    d, bk, bv, gd, vk, vv, vl = (a[n] for n in ("d", "bk", "bv", "gd", "vk",
                                                "vv", "vl"))
    N, C, S = bk.shape
    D, V = d.shape[1], vk.shape[1]
    sc = torch.stack([a["flags"], gd, vl]).contiguous()
    keys, padded = a["keys"], a["padded"]
    K, (_, P) = keys.numel(), padded.shape
    p = torch.Tensor.data_ptr
    got = {}

    def run(name, shape, launch, *args):
        o = torch.full(shape, 7, dtype=torch.int32)
        assert getattr(lib, launch)(*args[:-1], p(o), *args[-1]) == 0, name
        got[name] = o.numpy()

    for arm, two, (rk, rv, dep, rows) in (
            ("shortcut", 0, (vk, vv, vl, V)), ("traditional", 1,
                                               (bk, bv, gd, C))):
        run(f"flat_{arm}", (K,), "eh_lookup_flat_launch", two, p(keys),
            bits, p(d), p(rk), p(rv), p(dep), (K, D, rows, S, FLAT_TILE,
                                               None))
        run(f"padded_{arm}", (N, P), "eh_lookup_launch", two, p(padded),
            p(d), p(rk), p(rv), p(dep), (N, P, D, rows, S, FLAT_TILE, None))
    run("flat_routed", (K,), "routed_lookup_flat_launch", p(keys), bits,
        p(d), p(bk), p(bv), p(vk), p(vv), p(sc), (N, K, D, C, V, S,
                                                  FLAT_TILE, None))
    run("padded_routed", (N, P), "routed_lookup_launch", p(padded), p(d),
        p(bk), p(bv), p(vk), p(vv), p(sc), (N, P, D, C, V, S, FLAT_TILE,
                                            None))
    for s in range(N):
        row = padded[s].contiguous()
        run(f"stacked_{s}", (P,), "stacked_lookup_launch", p(row), p(vk),
            p(vv), p(vl), s, (P, V, S, FLAT_TILE, None))
    np.savez(out, **got)


if __name__ == "__main__":
    _run(*sys.argv[1:4])
