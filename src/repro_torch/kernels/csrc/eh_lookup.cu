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
// Bound: the card's random reads.  Each key is a chain of dependent reads
// (key, directory entry, probe, value); the rows (hundreds of MB) do not
// fit in L2, so the probe's chunk and the value are two random reads from
// device memory.  The design keeps many chains in flight: a warp serves
// 32/G keys at once, G lanes a key (common.cuh's probe_step, 16-byte
// reads, a step of 4G slots, which at a load near 0.7 usually ends the
// probe in one step); each group streams through its keys on its own,
// reading its next key's directory entry one key ahead, and stores a key's
// value while the next key is probed.  G = kGroup = 4, chosen on the card
// over 1, 2, 4 and 8 (PERF.md, section 6).  A shard's block of a stack is a pointer offset, so
// no slice is copied, and every per-shard scalar (depth, view log2, route
// flag) is read from device memory by the block that needs it, so the host
// never syncs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // lanes a key

// Resolve keys [lo, hi) of one shard, G lanes a key: `keys`/`out` are the
// shard's key row, `rows_k`/`rows_v` its bucket pool (TWO_LEVEL, through
// `directory` at depth g) or its view (the slot is the row, at log2 g).
// Group q of warp w takes keys lo + w * KPW + q + n * stride, n = 0, 1, ...
// in turn, one probe step a loop trip: a group whose probe is over moves
// to its next key at once, while the warp's other groups go on probing, so
// no group waits for the warp's longest probe.  A group holds its next key
// and that key's directory entry (read one key ahead) and the key after
// (read two keys ahead), and stores a key's value when its next key is
// over, so the value read overlaps that probe.
template <bool TWO_LEVEL>
__device__ __forceinline__ void resolve_tile(
    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out, int lo,
    int hi, int g, const int32_t* __restrict__ directory,
    const uint32_t* __restrict__ rows_k, const uint32_t* __restrict__ rows_v,
    int S) {
  constexpr int G = kGroup;
  constexpr int KPW = 32 / G;  // keys a warp serves at once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (blockDim.x >> 5) * KPW;
  const bool leader = lane % G == 0;
  auto row_of = [&](uint32_t key) -> int32_t {
    const int32_t slot = repro::dir_slot(repro::hash_dir(key), g);
    return TWO_LEVEL ? __ldg(directory + slot) : slot;
  };
  int i = lo + warp * KPW + lane / G;  // the group's key
  uint32_t key = i < hi ? __ldg(keys + i) : 0u;
  uint32_t key1 = i + stride < hi ? __ldg(keys + i + stride) : 0u;
  uint32_t key2 = i + 2 * stride < hi ? __ldg(keys + i + 2 * stride) : 0u;
  int32_t row = i < hi ? row_of(key) : 0;
  int32_t row1 = i + stride < hi ? row_of(key1) : 0;
  uint32_t start = repro::hash_bucket(key) % S;
  int t0 = 0;        // the probe's step base
  int pending = -1;  // key whose value read is in flight
  uint32_t pv = 0u;
  while (__any_sync(repro::kFullMask, i < hi)) {
    const bool act = i < hi;
    const size_t off = static_cast<size_t>(row) * S;
    int p;
    uint32_t at;
    const bool over = repro::probe_step<G, true>(rows_k + off, S, key, start,
                                                 t0, act, &p, &at);
    if (act && over) {
      if (pending >= 0 && leader) out[pending] = pv;
      pv = leader && p >= 0 && at == key ? __ldg(rows_v + off + p)
                                         : repro::kMiss;
      pending = i;
      i += stride;
      key = key1;
      row = row1;
      key1 = key2;
      row1 = i + stride < hi ? row_of(key1) : 0;
      key2 = i + 2 * stride < hi ? __ldg(keys + i + 2 * stride) : 0u;
      start = repro::hash_bucket(key) % S;
      t0 = 0;
    } else {
      t0 += G;
    }
  }
  if (pending >= 0 && leader) out[pending] = pv;
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
