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
//
// Flat-key mode (flat_eh_lookup_kernel, flat_routed_lookup_kernel): the
// sharded index's keys come as one (K,) row in input order, not padded per
// shard.  Each lane group finds its key's shard, the top `bits` of the
// directory hash (as core/hashing.py's shard_of_keys), reads that shard's
// depth or view log2 (and route flag) from the per-shard arrays, resolves
// the key in that shard's block of the stacks and writes the value at the
// key's own index.  So one warp serves keys of several shards, the grid is
// 1-D over key tiles, and no sort, pad or scatter-back surrounds the launch.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // lanes a key

// How resolve_tile finds a key's row: in one shard's tables (kShard: the
// padded (N, K) layout, a block a shard), or in flat-key mode in its own
// shard's block of the stacks, every shard in one family (kFlat) or each by
// its route flag (kFlatRouted).
enum KeyLayout { kShard, kFlat, kFlatRouted };

// Flat-key mode's stacks.  A key's shard is the top `bits` of its directory
// hash (0 bits: shard 0).  `scalars` is (N,) depths (TWO_LEVEL) or view
// log2s (kFlat), or the routed kernel's (3, N) flags, depths, view log2s;
// `D` the directory entries and `rows` the bucket or view rows a shard;
// kFlatRouted also reads the views (N, V, S).  A stack holds under 2^31
// rows (the wrapper checks), so a row's index in it is 31 bits.
struct Stacks {
  int bits = 0;
  int N = 0;
  const int32_t* scalars = nullptr;
  size_t D = 0;
  uint32_t rows = 0, V = 0;
  const uint32_t* view_keys = nullptr;
  const uint32_t* view_vals = nullptr;
};

// kFlatRouted: the bit of a row that says it lies in the views.
constexpr uint32_t kViewBit = 1u << 31;

// Resolve keys [lo, hi), G lanes a key: `keys`/`out` are the shard's key
// row (kShard) or the whole (K,) batch (flat), `rows_k`/`rows_v` the
// shard's bucket pool (TWO_LEVEL, through `directory` at depth g) or its
// view (the slot is the row, at log2 g); in flat-key mode the stacks of
// every shard, `directory` the (N, D) directories and `st` the rest.
// Group q of warp w takes keys lo + w * KPW + q + n * stride, n = 0, 1, ...
// in turn, one probe step a loop trip: a group whose probe is over moves
// to its next key at once, while the warp's other groups go on probing, so
// no group waits for the warp's longest probe.  A group holds its next key
// and that key's directory entry (read one key ahead) and the key after
// (read two keys ahead), and stores a key's value when its next key is
// over, so the value read overlaps that probe.
template <bool TWO_LEVEL, int LAYOUT = kShard>
__device__ __forceinline__ void resolve_tile(
    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out, int lo,
    int hi, int g, const int32_t* __restrict__ directory,
    const uint32_t* __restrict__ rows_k, const uint32_t* __restrict__ rows_v,
    int S, const Stacks& st = Stacks{}) {
  constexpr int G = kGroup;
  constexpr int KPW = 32 / G;  // keys a warp serves at once
  // kShard: the row in the shard's tables; flat: the row in the stack,
  // shard * rows + the shard's row (kViewBit set for a view row)
  using Row = std::conditional_t<LAYOUT == kShard, int32_t, uint32_t>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (blockDim.x >> 5) * KPW;
  const bool leader = lane % G == 0;
  auto row_of = [&](uint32_t key) -> Row {
    if constexpr (LAYOUT == kShard) {
      const int32_t slot = repro::dir_slot(repro::hash_dir(key), g);
      return TWO_LEVEL ? __ldg(directory + slot) : slot;
    } else {
      const uint32_t h = repro::hash_dir(key);
      const uint32_t s = st.bits == 0 ? 0 : h >> (32 - st.bits);
      bool two_level = TWO_LEVEL;
      int32_t depth;
      if constexpr (LAYOUT == kFlatRouted) {
        two_level = __ldg(st.scalars + s) != 0;
        depth = __ldg(st.scalars + (two_level ? 1 : 2) * st.N + s);
      } else {
        depth = __ldg(st.scalars + s);
      }
      const int32_t slot = repro::dir_slot(h, depth);
      if (two_level) {
        return s * st.rows + __ldg(directory + s * st.D + slot);
      }
      if constexpr (LAYOUT == kFlatRouted) {
        return (s * st.V + slot) | kViewBit;
      }
      return s * st.rows + slot;
    }
  };
  int i = lo + warp * KPW + lane / G;  // the group's key
  uint32_t key = i < hi ? __ldg(keys + i) : 0u;
  uint32_t key1 = i + stride < hi ? __ldg(keys + i + stride) : 0u;
  uint32_t key2 = i + 2 * stride < hi ? __ldg(keys + i + 2 * stride) : 0u;
  Row row = i < hi ? row_of(key) : 0;
  Row row1 = i + stride < hi ? row_of(key1) : 0;
  uint32_t start = repro::hash_bucket(key) % S;
  int t0 = 0;        // the probe's step base
  int pending = -1;  // key whose value read is in flight
  uint32_t pv = 0u;
  while (__any_sync(repro::kFullMask, i < hi)) {
    const bool act = i < hi;
    const uint32_t* rk = rows_k;  // the pool holding the key's row
    const uint32_t* rv = rows_v;
    size_t off;
    if constexpr (LAYOUT == kShard) {
      off = static_cast<size_t>(row) * S;
    } else {
      off = static_cast<size_t>(row & ~kViewBit) * S;
      if (LAYOUT == kFlatRouted && (row & kViewBit)) {
        rk = st.view_keys;
        rv = st.view_vals;
      }
    }
    int p;
    uint32_t at;
    const bool over = repro::probe_step<G, true>(rk + off, S, key, start,
                                                 t0, act, &p, &at);
    if (act && over) {
      if (pending >= 0 && leader) out[pending] = pv;
      pv = leader && p >= 0 && at == key ? __ldg(rv + off + p)
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

// grid (key tiles): flat-key mode of eh_lookup_kernel.  keys (K,) in input
// order, each resolved in its own shard's block of the (N, C, S) stacks at
// depths[shard] (TWO_LEVEL: directories (N, D) and buckets; else views, C
// their rows and depths their log2s); out (K,).  Eight blocks an SM (and
// 32-bit rows) hold the flat kernels to 32 registers, as the padded ones:
// with 64-bit rows and no bound they took 36, 7 blocks an SM, and 2^24
// probes over 4 shards 7-11% longer on an H100.
template <bool TWO_LEVEL>
__global__ void __launch_bounds__(kThreads, 8) flat_eh_lookup_kernel(
    const uint32_t* __restrict__ keys, int bits,
    const int32_t* __restrict__ directory,
    const uint32_t* __restrict__ bucket_keys,
    const uint32_t* __restrict__ bucket_vals,
    const int32_t* __restrict__ depths, uint32_t* __restrict__ out, int K,
    int D, int C, int S, int tile) {
  Stacks st;
  st.bits = bits;
  st.scalars = depths;
  st.D = D;
  st.rows = C;
  const int lo = blockIdx.x * tile;
  resolve_tile<TWO_LEVEL, kFlat>(keys, out, lo, min(lo + tile, K), 0,
                                 directory, bucket_keys, bucket_vals, S, st);
}

// grid (key tiles): flat-key mode of routed_lookup_kernel.  Each key goes
// through its shard's directory and buckets when the shard's flag is set,
// else through its view; one warp may hold keys of both routes.
__global__ void __launch_bounds__(kThreads, 8) flat_routed_lookup_kernel(
    const uint32_t* __restrict__ keys, int bits,
    const int32_t* __restrict__ directories,
    const uint32_t* __restrict__ bucket_keys,
    const uint32_t* __restrict__ bucket_vals,
    const uint32_t* __restrict__ view_keys,
    const uint32_t* __restrict__ view_vals,
    const int32_t* __restrict__ scalars, uint32_t* __restrict__ out, int N,
    int K, int D, int C, int V, int S, int tile) {
  Stacks st;
  st.bits = bits;
  st.N = N;
  st.scalars = scalars;
  st.D = D;
  st.rows = C;
  st.V = V;
  st.view_keys = view_keys;
  st.view_vals = view_vals;
  const int lo = blockIdx.x * tile;
  resolve_tile<true, kFlatRouted>(keys, out, lo, min(lo + tile, K), 0,
                                  directories, bucket_keys, bucket_vals, S,
                                  st);
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

// Flat-key mode.  keys (K,) u32 in input order, key k in shard
// hash_dir(k) >> (32 - shard_bits) (0 bits: shard 0; the wrapper checks
// 2^shard_bits <= N); the stacks as eh_lookup_launch's; out (K,) u32.
extern "C" int eh_lookup_flat_launch(int two_level, const void* keys,
                                     int shard_bits, const void* directory,
                                     const void* bucket_keys,
                                     const void* bucket_vals,
                                     const void* depths, void* out, int K,
                                     int D, int C, int S, int tile,
                                     void* stream) {
  if (K <= 0) return 0;
  const int grid = (K + tile - 1) / tile;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* d = static_cast<const int32_t*>(directory);
  const auto* bk = static_cast<const uint32_t*>(bucket_keys);
  const auto* bv = static_cast<const uint32_t*>(bucket_vals);
  const auto* gd = static_cast<const int32_t*>(depths);
  auto* o = static_cast<uint32_t*>(out);
  if (two_level) {
    flat_eh_lookup_kernel<true><<<grid, kThreads, 0, st>>>(
        k, shard_bits, d, bk, bv, gd, o, K, D, C, S, tile);
  } else {
    flat_eh_lookup_kernel<false><<<grid, kThreads, 0, st>>>(
        k, shard_bits, d, bk, bv, gd, o, K, D, C, S, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// Flat-key mode of routed_lookup_launch: keys (K,) u32 as above; out (K,).
extern "C" int routed_lookup_flat_launch(const void* keys, int shard_bits,
                                         const void* directories,
                                         const void* bucket_keys,
                                         const void* bucket_vals,
                                         const void* view_keys,
                                         const void* view_vals,
                                         const void* scalars, void* out,
                                         int N, int K, int D, int C, int V,
                                         int S, int tile, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  flat_routed_lookup_kernel<<<(K + tile - 1) / tile, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), shard_bits,
      static_cast<const int32_t*>(directories),
      static_cast<const uint32_t*>(bucket_keys),
      static_cast<const uint32_t*>(bucket_vals),
      static_cast<const uint32_t*>(view_keys),
      static_cast<const uint32_t*>(view_vals),
      static_cast<const int32_t*>(scalars), static_cast<uint32_t*>(out), N, K,
      D, C, V, S, tile);
  return static_cast<int>(cudaGetLastError());
}
