// Extendible-hashing lookups over N stacked shards: traditional, shortcut,
// stacked (one shard of a stack) and per-shard routed.
//
// Replaces the Pallas kernels of repro/kernels/eh_lookup.py: _run
// (_lookup_kernel), stacked_shortcut_lookup (_stacked_select_kernel) and
// sharded_routed_lookup (_routed_kernel).  As there, the three kernels share
// one per-tile body, resolve_tile (the TPU module's _resolve_tile):
//
//   TWO_LEVEL: hash -> directory[slot] -> bucket row -> probe
//   shortcut : hash -> view row `slot`           -> probe
//
// Bound: memory latency.  Each key costs one or two dependent, data-dependent
// reads before its probe, and the probe reads a 128-byte run of its row (one
// warp, 32 positions, per step).  The design keeps one warp per key, so the
// probe is coalesced and ends at the first step holding a hit or an EMPTY,
// and keeps many keys in flight (8 warps per block, many blocks per SM) to
// cover the latency; the TPU kernels instead held the shard's pages in VMEM.
// A shard's block of a stack is a pointer offset, so no slice is copied, and
// every per-shard scalar (depth, view log2, route flag) is read from device
// memory by the block that needs it, so the host never syncs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Resolve keys [lo, hi) of one shard, one warp per key: `keys`/`out` are the
// shard's key row, `rows_k`/`rows_v` its bucket pool (TWO_LEVEL, through
// `directory` at depth g) or its view (the slot is the row, at log2 g).
template <bool TWO_LEVEL>
__device__ __forceinline__ void resolve_tile(
    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out, int lo,
    int hi, int g, const int32_t* __restrict__ directory,
    const uint32_t* __restrict__ rows_k, const uint32_t* __restrict__ rows_v,
    int S) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = lo + warp; i < hi; i += nwarps) {
    const uint32_t key = keys[i];
    const int32_t slot = repro::dir_slot(repro::hash_dir(key), g);
    const int32_t row = TWO_LEVEL ? directory[slot] : slot;
    const size_t off = static_cast<size_t>(row) * S;
    const int p = repro::warp_find(rows_k + off, S, key,
                                   repro::hash_bucket(key) % S, lane);
    if (lane == 0) out[i] = p >= 0 ? rows_v[off + p] : repro::kMiss;
  }
}

// grid (key tiles, N): every shard in one mode.
template <bool TWO_LEVEL>
__global__ void eh_lookup_kernel(const uint32_t* __restrict__ keys,
                                 const int32_t* __restrict__ directory,
                                 const uint32_t* __restrict__ bucket_keys,
                                 const uint32_t* __restrict__ bucket_vals,
                                 const int32_t* __restrict__ depths,
                                 uint32_t* __restrict__ out, int K, int D,
                                 int C, int S, int tile) {
  const int shard = blockIdx.y;
  const size_t kbase = static_cast<size_t>(shard) * K;
  const size_t rbase = static_cast<size_t>(shard) * C * S;
  const int lo = blockIdx.x * tile;
  resolve_tile<TWO_LEVEL>(keys + kbase, out + kbase, lo, min(lo + tile, K),
                          depths[shard],
                          TWO_LEVEL ? directory + static_cast<size_t>(shard) * D
                                    : nullptr,
                          bucket_keys + rbase, bucket_vals + rbase, S);
}

// grid (key tiles): block `shard` of the (N, V, S) view stacks.
__global__ void stacked_lookup_kernel(const uint32_t* __restrict__ keys,
                                      const uint32_t* __restrict__ view_keys,
                                      const uint32_t* __restrict__ view_vals,
                                      const int32_t* __restrict__ view_log2s,
                                      int shard, uint32_t* __restrict__ out,
                                      int K, int V, int S, int tile) {
  const size_t base = static_cast<size_t>(shard) * V * S;
  const int lo = blockIdx.x * tile;
  resolve_tile<false>(keys, out, lo, min(lo + tile, K), view_log2s[shard],
                      nullptr, view_keys + base, view_vals + base, S);
}

// grid (key tiles, N): shard blockIdx.y resolves through its directory and
// buckets when its flag is set, else through its view.  The flag is per
// shard, so it is uniform across a block and no warp diverges on it.
// scalars (3, N) i32: flags, traditional depths, view log2s.
__global__ void routed_lookup_kernel(const uint32_t* __restrict__ keys,
                                     const int32_t* __restrict__ directories,
                                     const uint32_t* __restrict__ bucket_keys,
                                     const uint32_t* __restrict__ bucket_vals,
                                     const uint32_t* __restrict__ view_keys,
                                     const uint32_t* __restrict__ view_vals,
                                     const int32_t* __restrict__ scalars,
                                     uint32_t* __restrict__ out, int N, int K,
                                     int D, int C, int V, int S, int tile) {
  const int shard = blockIdx.y;
  const size_t kbase = static_cast<size_t>(shard) * K;
  const int lo = blockIdx.x * tile;
  const int hi = min(lo + tile, K);
  if (scalars[shard] != 0) {
    const size_t rbase = static_cast<size_t>(shard) * C * S;
    resolve_tile<true>(keys + kbase, out + kbase, lo, hi, scalars[N + shard],
                       directories + static_cast<size_t>(shard) * D,
                       bucket_keys + rbase, bucket_vals + rbase, S);
  } else {
    const size_t vbase = static_cast<size_t>(shard) * V * S;
    resolve_tile<false>(keys + kbase, out + kbase, lo, hi,
                        scalars[2 * N + shard], nullptr, view_keys + vbase,
                        view_vals + vbase, S);
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
  auto st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* d = static_cast<const int32_t*>(directory);
  const auto* bk = static_cast<const uint32_t*>(bucket_keys);
  const auto* bv = static_cast<const uint32_t*>(bucket_vals);
  const auto* gd = static_cast<const int32_t*>(depths);
  auto* o = static_cast<uint32_t*>(out);
  if (two_level) {
    eh_lookup_kernel<true><<<grid, kThreads, 0, st>>>(k, d, bk, bv, gd, o, K,
                                                      D, C, S, tile);
  } else {
    eh_lookup_kernel<false><<<grid, kThreads, 0, st>>>(k, d, bk, bv, gd, o, K,
                                                       D, C, S, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys (K,) u32; view_keys/vals (N, V, S) u32; view_log2s (N,) i32;
// 0 <= shard < N (the wrapper checks); out (K,) u32.
extern "C" int stacked_lookup_launch(const void* keys, const void* view_keys,
                                     const void* view_vals,
                                     const void* view_log2s, int shard,
                                     void* out, int K, int V, int S, int tile,
                                     void* stream) {
  if (K <= 0) return 0;
  stacked_lookup_kernel<<<(K + tile - 1) / tile, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(view_keys),
      static_cast<const uint32_t*>(view_vals),
      static_cast<const int32_t*>(view_log2s), shard,
      static_cast<uint32_t*>(out), K, V, S, tile);
  return static_cast<int>(cudaGetLastError());
}

// keys (N, K) u32; directories (N, D) i32; bucket_keys/vals (N, C, S) u32;
// view_keys/vals (N, V, S) u32; scalars (3, N) i32; out (N, K) u32.
extern "C" int routed_lookup_launch(const void* keys, const void* directories,
                                    const void* bucket_keys,
                                    const void* bucket_vals,
                                    const void* view_keys,
                                    const void* view_vals,
                                    const void* scalars, void* out, int N,
                                    int K, int D, int C, int V, int S,
                                    int tile, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  const dim3 grid((K + tile - 1) / tile, N);
  routed_lookup_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys),
      static_cast<const int32_t*>(directories),
      static_cast<const uint32_t*>(bucket_keys),
      static_cast<const uint32_t*>(bucket_vals),
      static_cast<const uint32_t*>(view_keys),
      static_cast<const uint32_t*>(view_vals),
      static_cast<const int32_t*>(scalars), static_cast<uint32_t*>(out), N, K,
      D, C, V, S, tile);
  return static_cast<int>(cudaGetLastError());
}
