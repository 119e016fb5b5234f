"""The card's rate of random 32-byte sector reads: the ceiling of the
baselines' lookup kernels (``src/repro_torch/kernels/csrc/
baselines_lookup.cu``), whose tables at Fig. 7's size (hundreds of MB) do
not fit in the 50 MB L2.

    python3 tools/random_sector_peak.py

Every thread runs D independent chains of dependent random reads: each
read's index is a hash of the chain's last index and of the data it read,
so D is the number of reads a thread has in flight.  The reads:

  * ``slot``: one 4-byte read in a random sector of a 512 MiB array;
  * ``sector``: that sector whole, as two 16-byte reads;
  * ``pair``: the sector whole at the same random index in two 256 MiB
    arrays, all four reads issued together (HT's key and value sectors
    read at once);
  * ``key then value``: the sector whole in the first array, then the
    sector whole in the second, at an index that depends on the first's
    data (the value read after its key: two round trips);
  * ``sector in L2``: ``sector`` over 16 MiB (CH's heads at Fig. 7's size).

Each at D = 1, 2 and 4, with ``__ldg`` (the read-only path) and ``__ldcs``
(evict-first).  256 threads a block, as many blocks as 8 a SM (fewer stay
resident where the registers run out: the line gives the resident threads a
SM); then ``sector`` and ``key then value`` at D = 1 on 4, 2 and 1 blocks a
SM (fewer reads in flight on the card, each thread taking more).  Timed with CUDA events, the mean of 5 launches after one warm-up; the
rate counts the sectors read (``pair`` and ``key then value``: two a
chain step).  Prints each line beside the card's name and power limit, and
the L2's fetch granularity (``cudaLimitMaxL2FetchGranularity``, read only),
and last a JSON line of the best rate of each kind of read.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

template <bool CS, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (CS) return __ldcs(p);
  return __ldg(p);
}

template <bool CS>
__device__ __forceinline__ uint32_t sector(const uint32_t* p) {
  const uint4 x = ld<CS>(reinterpret_cast<const uint4*>(p));
  const uint4 y = ld<CS>(reinterpret_cast<const uint4*>(p) + 1);
  return x.x ^ x.y ^ x.z ^ x.w ^ y.x ^ y.y ^ y.z ^ y.w;
}

// MODE 0 slot, 1 sector, 2 pair, 3 key then value; `mask`: sectors - 1
template <int MODE, int D, bool CS>
__global__ void __launch_bounds__(256) gather(const uint32_t* __restrict__ a,
                                              const uint32_t* __restrict__ b,
                                              uint32_t mask, int iters,
                                              uint32_t seed, uint32_t* out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t h[D];
#pragma unroll
  for (int d = 0; d < D; ++d) h[d] = fmix(t * D + d + seed);
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    uint32_t x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t s = (h[d] & mask) * 8u;
      if (MODE == 0) {
        x[d] = ld<CS>(a + s + (h[d] >> 29));
      } else if (MODE == 1) {
        x[d] = sector<CS>(a + s);
      } else if (MODE == 2) {
        x[d] = sector<CS>(a + s) ^ sector<CS>(b + s);
      } else {
        const uint32_t k = sector<CS>(a + s);
        x[d] = sector<CS>(b + ((s + (k & ~7u) * 8u) & (mask * 8u)));
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      h[d] = fmix(h[d] + x[d]);
      acc ^= x[d];
    }
  }
  out[t] = acc;
}

template <int MODE, int D>
const void* pick_cs(bool cs) {
  return cs ? reinterpret_cast<const void*>(gather<MODE, D, true>)
            : reinterpret_cast<const void*>(gather<MODE, D, false>);
}

template <int MODE>
const void* pick_d(int d, bool cs) {
  return d == 1 ? pick_cs<MODE, 1>(cs)
       : d == 2 ? pick_cs<MODE, 2>(cs)
       : d == 4 ? pick_cs<MODE, 4>(cs) : nullptr;
}

const void* pick(int mode, int d, bool cs) {
  switch (mode) {
    case 0: return pick_d<0>(d, cs);
    case 1: return pick_d<1>(d, cs);
    case 2: return pick_d<2>(d, cs);
    case 3: return pick_d<3>(d, cs);
  }
  return nullptr;
}

extern "C" int gather_launch(int mode, int d, int cs, const uint32_t* a,
                             const uint32_t* b, unsigned mask, int iters,
                             unsigned seed, uint32_t* out, int blocks,
                             void* stream) {
  const void* k = pick(mode, d, cs != 0);
  if (!k) return 1;
  void* args[] = {&a, &b, &mask, &iters, &seed, &out};
  const cudaError_t e = cudaLaunchKernel(k, dim3(blocks), dim3(256), args, 0,
                                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int gather_blocks_per_sm(int mode, int d, int cs) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pick(mode, d, cs != 0),
                                                256, 0);
  return n;
}

extern "C" int l2_fetch_granularity() {
  size_t v = 0;
  cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  return static_cast<int>(v);
}
'''

MODES = {0: "slot", 1: "sector", 2: "pair", 3: "key then value"}


def build():
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "random_sector_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "peak.cu", out_dir / "libpeak.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gather_launch.argtypes = [I, I, I, P, P, ctypes.c_uint, I,
                                  ctypes.c_uint, P, I, P]
    lib.gather_blocks_per_sm.argtypes = [I, I, I]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("random_sector_peak: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    smi = cs.phase_device(torch)
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = torch.randint(-2**31, 2**31 - 1, (1 << 27,), dtype=torch.int32,
                        device="cuda", generator=gen)
    halves = big[:1 << 26], big[1 << 26:]
    out = torch.empty(8 * sms * 256, dtype=torch.int32, device="cuda")
    grain = lib.l2_fetch_granularity()
    print(f"L2 fetch granularity {grain} B; {sms} SMs, "
          f"blocks of 256 threads; card {smi}", flush=True)
    best = {}
    cases = [(mode, d, ld, big if mode < 2 else halves[0],
              halves[1], 512 if mode < 2 else 256, 8)
             for ld in (False, True) for mode in MODES for d in (1, 2, 4)]
    cases += [(1, d, False, big[:1 << 22], big, 16, 8) for d in (1, 4)]
    cases += [(mode, 1, False, big if mode == 1 else halves[0], halves[1],
               512 if mode == 1 else 256, per_sm)
              for mode in (1, 3) for per_sm in (4, 2, 1)]
    for mode, d, ld, a, b, mib, per_sm in cases:
        sectors = a.numel() // 8
        iters = 256 // d * 8 // per_sm
        blocks = per_sm * sms

        def run():
            assert lib.gather_launch(mode, d, int(ld), a.data_ptr(),
                                     b.data_ptr(), sectors - 1, iters, 7,
                                     out.data_ptr(), blocks, stream) == 0
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        reads = blocks * 256 * iters * d * (2 if mode >= 2 else 1)
        rate = reads / ms * 1e3
        name = MODES[mode] + (" in L2" if mib == 16 else "")
        resident = min(per_sm, lib.gather_blocks_per_sm(mode, d,
                                                         int(ld))) * 256
        key = (name, "__ldcs" if ld else "__ldg")
        best[key] = max(best.get(key, 0.0), rate)
        print(f"{name}, {mib} MiB{' x 2' if mode >= 2 else ''}, {d} in "
              f"flight a thread, {key[1]}: {ms:.4f} ms for {reads} sectors, "
              f"{rate / 1e9:.2f} G sectors/s, {rate * 32 / 1e9:.1f} GB/s "
              f"(32 B a sector; {rate * grain / 1e9:.1f} GB/s from the "
              f"memory at {grain} B a miss); {resident} threads resident a "
              f"SM; {smi}",
              flush=True)
    for (name, how), rate in best.items():
        print(f"best {name} with {how}: {rate / 1e9:.2f} G sectors/s, "
              f"{rate * 32 / 1e9:.1f} GB/s; {smi}", flush=True)
    print(json.dumps({"sectors_per_s": {f"{name}, {how}": rate
                                        for (name, how), rate in best.items()},
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
