"""The baselines' insert kernels (``csrc/baselines_insert.cu``: HT's and
HTI's ``place_kernel``, CH's ``ch_kernel``) compiled for the CPU with g++
against a stand-in CUDA runtime (``tests/cuda_mock/``: every CUDA thread an
OS thread; ``__syncthreads``, the grid sync and the warp collectives
barriers; atomics under one mutex), run through the real wrapper
(``kernels/baselines_insert.py``) on CPU tensors and held bit for bit to
the plain host loops on every state array after every batch.

It runs the source's own code at a small grid (3 blocks of 64 threads),
with the source's segment cap and with 37 positions (many segments a run;
CH has no segments and runs the same in both); it says nothing of speed,
and only a build on the card checks what nvcc accepts (``chip_smoke.py``
(c) holds the card's kernels to the same loops).
Each trace runs in a subprocess with a time limit, so a grid sync that a
thread skips fails the test instead of hanging it."""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/baselines_insert.cu"
MOCK = Path(__file__).with_name("cuda_mock")
THREADS = 64

HOOK = r'''
namespace {
cudaError_t launch(const void* f, dim3 g, dim3 b, void** args) {
  if (f == reinterpret_cast<const void*>(place_kernel<false>))
    return mock::run_grid<PlaceArgs, place_kernel<false>>(g, b, args);
  if (f == reinterpret_cast<const void*>(place_kernel<true>))
    return mock::run_grid<PlaceArgs, place_kernel<true>>(g, b, args);
  if (f == reinterpret_cast<const void*>(ch_kernel))
    return mock::run_grid<ChArgs, ch_kernel>(g, b, args);
  return cudaErrorInvalidValue;
}
const int hooked = (mock::launch = launch, 0);
}  // namespace
'''


def harness(segment) -> str:
    """The source with blocks of THREADS threads, the __shared__ arrays
    per block, and the launch hook."""
    s = SOURCE.read_text()
    for name in ("kPlaceThreads", "kChThreads"):
        s, k = re.subn(rf"constexpr int {name} = \d+;",
                       f"constexpr int {name} = {THREADS};", s)
        assert k == 1
    if segment is not None:
        s, k = re.subn(r"constexpr long long kSegment = [^;]+;",
                       f"constexpr long long kSegment = {segment};", s)
        assert k == 1
    slots = iter(range(8))
    s = re.sub(r"__shared__ ([\w ]+?) (\w+)\[([^\]]+)\];",
               lambda m: f"static_assert(sizeof({m.group(1)}) * ({m.group(3)})"
                         f" <= mock::kSharedBytes); {m.group(1)}* "
                         f"{m.group(2)} = mock::block_shared<{m.group(1)}>"
                         f"({next(slots)});",
               s)
    return s.replace('#include "common.cuh"',
                     f'#include "{SOURCE.with_name("common.cuh")}"') + HOOK


@pytest.fixture(scope="module", params=[None, 37], ids=["segment", "seg37"])
def mock_lib(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU stand-in of the kernel")
    d = tmp_path_factory.mktemp("mock")
    src, lib = d / "harness.cpp", d / "libbaselines_mock.so"
    src.write_text(harness(request.param))
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-w", "-I", str(MOCK), "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return lib


# -- the traces (run in the subprocess) --------------------------------------

def _traces():
    from repro_torch import convert
    from repro_torch.core import baselines as bl
    rng = np.random.default_rng(0)
    edge = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)

    def keys_of(n):
        return (rng.choice(2**31 - 1, n, replace=False) + 1).astype(np.uint32)

    def split(k, n):
        return [k[i:i + n] for i in range(0, k.size, n)]

    def ht_doublings():
        k = keys_of(700)
        k = np.concatenate([k[:300], edge, np.repeat(k[:60], 2), k[300:],
                            edge, k[:100]])
        return bl.ht_create(10, 4, device="cpu"), split(k, 200), {}

    def same_home_keys(n, log2, home):
        """test_torch_baselines.same_home_keys (that module imports JAX)."""
        inv = pow(2654435761, -1, 2**32)
        low = rng.choice(1 << (32 - log2), n, replace=False).astype(np.uint64)
        h = (np.uint64(home) << np.uint64(32 - log2)) | low
        return ((h * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)

    def ht_lossy():
        # test_torch_baselines.lossy_ht_state: 40 keys of one home in the
        # doubled table, one insert short of a doubling
        keys = np.full(1 << 10, 0xFFFFFFFF, np.uint32)
        vals = np.zeros(1 << 10, np.uint32)
        keys[3:43] = same_home_keys(40, 7, 5)
        vals[3:43] = np.arange(1, 41, dtype=np.uint32)
        st = convert.ht_state_from_numpy(
            (keys, vals, np.int32(6), np.int32(22), np.int32(0)),
            device="cpu")
        return st, [keys_of(10)], {}

    def ht_crowded():
        # 40 slots filled from slot 40 on (keys of home 40 find their
        # window full), 4 entries short of the load test: drops first
        keys = np.full(1 << 9, 0xFFFFFFFF, np.uint32)
        vals = np.zeros(1 << 9, np.uint32)
        keys[40:80] = keys_of(40)
        st = convert.ht_state_from_numpy(
            (keys, vals, np.int32(7), np.int32(40), np.int32(0)),
            device="cpu")
        batch = np.concatenate([same_home_keys(6, 7, 40), keys_of(40)])
        return st, [batch, keys_of(60)], {}

    def tiny():
        k = np.concatenate([keys_of(20), edge, keys_of(4)])
        return np.concatenate([k, k[:6]])

    def ht_tiny():
        return bl.ht_create(4, 0, device="cpu"), split(tiny(), 7), {}

    def hti_stale():
        k = keys_of(1200)
        k = np.concatenate([k[:500], edge, k[100:300], k[500:900], edge,
                            k[600:700], k[900:]])
        return (bl.hti_create(12, 4, device="cpu"), split(k, 150),
                dict(migrate_batch=16))

    def hti_empty_pattern():
        # re-inserts of keys the batch migrates, and the EMPTY pattern
        k = keys_of(900)
        out = []
        for i in range(0, k.size, 150):
            b = np.concatenate([k[i:i + 150], k[max(i - 150, 0):i][::3],
                                np.full(4, 0xFFFFFFFF, np.uint32)])
            out.append(b[rng.permutation(b.size)])
        return bl.hti_create(12, 5, device="cpu"), out, dict(migrate_batch=4)

    def hti_tiny():
        return (bl.hti_create(4, 1, device="cpu"), split(tiny(), 7),
                dict(migrate_batch=2))

    def ch_until_capacity():
        # 16 chains of 8-slot buckets until the capacity runs out, then
        # drops; duplicate appends and the edge keys
        k = keys_of(1600)
        k = np.concatenate([k[:500], edge, k[:150], np.repeat(k[500:600], 2),
                            k[600:], edge])
        return bl.ch_create(4, 160, 8, device="cpu"), split(k, 400), {}

    def ch_one_chain():
        # every key of chain 0 (T 3): 300 keys a batch fill 75 buckets of 4
        # slots, over the grid's blocks; the last batch adds other chains
        k = same_home_keys(900, 3, 0)
        last = np.concatenate([k[600:], keys_of(100)])
        return (bl.ch_create(3, 400, 4, device="cpu"),
                [k[:300], k[300:600], last[rng.permutation(last.size)]], {})

    def ch_capacity_mid_batch():
        # 64 chains take 800 keys (about 4 buckets of 4 each) with room for
        # 100 buckets: the capacity runs out inside the first batch
        return (bl.ch_create(6, 100, 4, device="cpu"),
                [keys_of(800), keys_of(300)], {})

    def ch_t17():
        # 2^17 chains: three radix passes, the last one over one bit
        return bl.ch_create(17, 4096, 16, device="cpu"), \
            split(keys_of(3000), 1000), {}

    def ch_t0():
        # one chain (T 0): no radix pass
        return bl.ch_create(0, 40, 4, device="cpu"), \
            split(np.concatenate([tiny(), keys_of(150)]), 60), {}

    return {f.__name__: f for f in (ht_doublings, ht_lossy, ht_crowded,
                                    ht_tiny, hti_stale, hti_empty_pattern,
                                    hti_tiny, ch_until_capacity, ch_one_chain,
                                    ch_capacity_mid_batch, ch_t17, ch_t0)}


TRACES = ["ht_doublings", "ht_lossy", "ht_crowded", "ht_tiny", "hti_stale",
          "hti_empty_pattern", "hti_tiny", "ch_until_capacity",
          "ch_one_chain", "ch_capacity_mid_batch", "ch_t17", "ch_t0"]


def _run(lib_path: str, name: str) -> None:
    """The subprocess: the wrapper on CPU tensors, its library the mock."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import baselines as bl
    from repro_torch.core import hashing
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_insert as kern
    lib = ctypes.CDLL(lib_path)
    for fn in kern._SIGNATURES:
        getattr(lib, fn).argtypes = kern._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_longlong \
            if fn.endswith("_work_bytes") else ctypes.c_int
    _build.load = lambda name, signatures: lib
    _build.require_cuda = lambda name, *t: torch.device("cpu")
    _build.stream = lambda dev: 0
    st, batches, kw = _traces()[name]()
    rng = np.random.default_rng(1)
    seen = []
    for b, keys in enumerate(batches):
        vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
        got = type(st)(*(t.clone() for t in st))
        want = type(st)(*(t.clone() for t in st))
        k = torch.from_numpy(keys.view(np.int32))
        v = torch.from_numpy(vals.view(np.int32))
        if name.startswith("hti"):
            kern.hti_insert_(got, k, v, 0.35, kw["migrate_batch"])
            bl._hti_insert_host(want, keys, vals, 0.35, kw["migrate_batch"])
        elif name.startswith("ht"):
            kern.ht_insert_(got, k, v, 0.35)
            bl._ht_insert_host(want, keys, vals, 0.35)
        else:
            kern.ch_insert_(got, k, v)
            bl._ch_insert_host(want, keys, vals)
        for f, x, y in zip(type(st)._fields, got, want):
            assert torch.equal(hashing.storage_view(x),
                               hashing.storage_view(y)), \
                f"{name}: batch {b}: {f} differs from the host loop"
        st = want
        seen.append(st)
    if name.startswith("ch"):
        p = kern.passes()["ch_insert"]
        checks = {"ch_until_capacity": int(st.dropped) > 0
                  and int(st.num_buckets) == 160,
                  "ch_one_chain": p["largest_group"] >= 300
                  and p["longest_walk"] == 149
                  and int(seen[0].num_buckets) == 75,
                  "ch_capacity_mid_batch": int(seen[0].num_buckets) == 100
                  and int(seen[0].dropped) > 0,
                  "ch_t17": p["radix_passes"] == 9,
                  "ch_t0": p["radix_passes"] == 0 and int(st.dropped) > 0}
        assert checks[name], f"{name}: the trace missed its case"
    print("passes", kern.passes())


@pytest.mark.parametrize("name", TRACES)
def test_kernel_source_matches_the_host_loop(mock_lib, name):
    r = subprocess.run([sys.executable, __file__, str(mock_lib), name],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "passes" in r.stdout


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2])
