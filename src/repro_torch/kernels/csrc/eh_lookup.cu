// Extendible-hashing lookup, traditional and shortcut, over N stacked shards.
//
// Replaces the Pallas kernel of repro/kernels/eh_lookup.py (_run, body
// _resolve_tile/_lookup_kernel): one kernel, a compile-time TWO_LEVEL flag,
// and a (key tiles x N shards) grid, as _run is one pallas_call.
//
//   TWO_LEVEL: hash -> directory[slot] -> bucket row -> probe
//   shortcut : hash -> view row `slot`           -> probe
//
// Bound: memory latency.  Each key costs one or two dependent, data-dependent
// reads before its probe, and the probe reads a 128-byte run of its row (one
// warp, 32 positions, per step).  The design keeps one warp per key, so the
// probe is coalesced and ends at the first step holding a hit or an EMPTY,
// and keeps many keys in flight (8 warps per block, many blocks per SM) to
// cover the latency; the TPU kernel instead held the shard's pages in VMEM.
#include "common.cuh"

namespace {

template <bool TWO_LEVEL>
__global__ void eh_lookup_kernel(const uint32_t* __restrict__ keys,
                                 const int32_t* __restrict__ directory,
                                 const uint32_t* __restrict__ bucket_keys,
                                 const uint32_t* __restrict__ bucket_vals,
                                 const int32_t* __restrict__ depths,
                                 uint32_t* __restrict__ out, int K, int D,
                                 int C, int S, int tile) {
  const int shard = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = depths[shard];
  const size_t kbase = static_cast<size_t>(shard) * K;
  const size_t rbase = static_cast<size_t>(shard) * C;
  const int lo = blockIdx.x * tile;
  const int hi = min(lo + tile, K);
  for (int i = lo + warp; i < hi; i += nwarps) {
    const uint32_t key = keys[kbase + i];
    const int32_t slot = repro::dir_slot(repro::hash_dir(key), g);
    int32_t row = slot;
    if (TWO_LEVEL) row = directory[static_cast<size_t>(shard) * D + slot];
    const size_t off = (rbase + row) * static_cast<size_t>(S);
    const int p = repro::warp_find(bucket_keys + off, S, key,
                                   repro::hash_bucket(key) % S, lane);
    if (lane == 0) out[kbase + i] = p >= 0 ? bucket_vals[off + p] : repro::kMiss;
  }
}

}  // namespace

// keys (N, K) u32; directory (N, D) i32 (ignored unless two_level);
// bucket_keys/vals (N, C, S) u32; depths (N,) i32; out (N, K) u32.
extern "C" int eh_lookup_launch(int two_level, const void* keys,
                                const void* directory, const void* bucket_keys,
                                const void* bucket_vals, const void* depths,
                                void* out, int N, int K, int D, int C, int S,
                                int tile, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  const dim3 grid((K + tile - 1) / tile, N);
  const int threads = 256;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* d = static_cast<const int32_t*>(directory);
  const auto* bk = static_cast<const uint32_t*>(bucket_keys);
  const auto* bv = static_cast<const uint32_t*>(bucket_vals);
  const auto* gd = static_cast<const int32_t*>(depths);
  auto* o = static_cast<uint32_t*>(out);
  if (two_level) {
    eh_lookup_kernel<true><<<grid, threads, 0, st>>>(k, d, bk, bv, gd, o, K, D,
                                                     C, S, tile);
  } else {
    eh_lookup_kernel<false><<<grid, threads, 0, st>>>(k, d, bk, bv, gd, o, K,
                                                      D, C, S, tile);
  }
  return static_cast<int>(cudaGetLastError());
}
