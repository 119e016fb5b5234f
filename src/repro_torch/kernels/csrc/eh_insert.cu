// Extendible-hashing batch insert: one launch per batch, one thread block.
//
// Replaces repro/core/extendible_hashing.py:eh_insert_many, a per-key
// lax.scan with in-line cascading splits and doublings (no Pallas kernel
// there; this is its device-side form).  Where a key lands depends on the
// order of the keys and, inside a split, on the order of the old bucket's
// slots, so the kernel keeps both orders and leaves all eight state arrays
// bit-identical to the reference:
//
//   * warp 0 walks the keys in order: hash, directory, bucket, warp-wide
//     probe (common.cuh), write.  It only needs __syncwarp between keys.
//   * when a key needs a split, warp 0 hands it to the whole block: the
//     block doubles the directory if needed (all threads), stages the old
//     row in shared memory, warp 0 redistributes it in slot order into two
//     fresh rows (shared memory), and the block writes both rows back and
//     rewrites the directory range of the new bucket (all threads).
//
// Bound: latency, not bytes.  The walk is sequential by definition; each key
// costs a chain of dependent reads (directory, count, bucket row).  The
// design keeps that chain on one warp with no block-wide barrier per key and
// spends the block's other warps only where the work is wide (doubling,
// directory ranges, row copies).  The state is updated in place; the caller
// hands in a copy (copy-on-write), so readers of the old state never see a
// partial batch.
#include "common.cuh"

namespace {

struct Shared {
  int g;         // global depth
  int nb;        // buckets allocated
  int dropped;   // inserts refused
  int next;      // next key for warp 0
  int split;     // 1 if key `next` needs a split first
  uint32_t h;    // hash_dir of that key
  int c0, c1;    // live counts of the two rows a split produced
};

__global__ void __launch_bounds__(1024)
eh_insert_kernel(const uint32_t* __restrict__ keys,
                                 const uint32_t* __restrict__ vals, int n,
                                 int32_t* directory, uint32_t* bucket_keys,
                                 uint32_t* bucket_vals, int32_t* counts,
                                 int32_t* local_depth, int32_t* global_depth,
                                 int32_t* num_buckets, int32_t* dropped,
                                 int max_depth, int C, int S) {
  extern __shared__ uint32_t smem[];
  uint32_t* old_k = smem;           // the row being split, staged
  uint32_t* old_v = smem + S;
  uint32_t* k0 = smem + 2 * S;      // rows it splits into: stays (bit 0) ...
  uint32_t* v0 = smem + 3 * S;
  uint32_t* k1 = smem + 4 * S;      // ... and moves to the new bucket (bit 1)
  uint32_t* v1 = smem + 5 * S;
  __shared__ Shared sh;

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    sh.g = *global_depth;
    sh.nb = *num_buckets;
    sh.dropped = *dropped;
    sh.next = 0;
  }
  __syncthreads();

  while (true) {
    if (warp == 0) {
      const int g = sh.g;
      const int nb = sh.nb;
      int drop = sh.dropped;
      int i = sh.next;
      int split = 0;
      uint32_t h = 0;
      for (; i < n; ++i) {
        const uint32_t key = keys[i];
        h = repro::hash_dir(key);
        const uint32_t start = repro::hash_bucket(key) % S;
        const int32_t b = directory[repro::dir_slot(h, g)];
        uint32_t* row_k = bucket_keys + static_cast<size_t>(b) * S;
        if (counts[b] >= S) {
          const bool present = repro::warp_find(row_k, S, key, start, lane) >= 0;
          const bool can_grow =
              nb < C && (local_depth[b] < g || g < max_depth);
          if (!present && can_grow) {
            split = 1;
            break;
          }
        }
        const int idx = repro::warp_first_usable(row_k, S, key, start, lane);
        if (idx >= 0) {
          const bool was_empty = row_k[idx] == repro::kEmpty;
          __syncwarp();
          if (lane == 0) {
            row_k[idx] = key;
            bucket_vals[static_cast<size_t>(b) * S + idx] = vals[i];
            if (was_empty) counts[b] += 1;
          }
          __syncwarp();
        } else {
          drop += 1;
        }
      }
      if (lane == 0) {
        sh.next = i;
        sh.split = split;
        sh.h = h;
        sh.dropped = drop;
      }
    }
    __syncthreads();
    if (!sh.split) break;

    // ---- split the bucket that hash sh.h addresses (all threads) ----------
    const uint32_t h = sh.h;
    int g = sh.g;
    if (local_depth[directory[repro::dir_slot(h, g)]] == g) {
      // doubling, MSB indexing: new[i] = old[i >> 1] for i < 2^(g+1).
      // Descending chunks: a chunk reads below its own start or inside it
      // (read, barrier, write), never a slot an earlier chunk rewrote.
      for (int hi = 1 << (g + 1); hi > 0; hi -= T) {
        const int i = hi - T + tid;
        const int32_t v = i >= 0 ? directory[i >> 1] : 0;
        __syncthreads();
        if (i >= 0) directory[i] = v;
        __syncthreads();
      }
      g += 1;
    }
    const int32_t slot = repro::dir_slot(h, g);
    const int32_t b = directory[slot];
    const int32_t l = local_depth[b];
    const int32_t b2 = sh.nb;
    const size_t ob = static_cast<size_t>(b) * S;
    const size_t nb2 = static_cast<size_t>(b2) * S;
    for (int j = tid; j < S; j += T) {
      old_k[j] = bucket_keys[ob + j];
      old_v[j] = bucket_vals[ob + j];
      k0[j] = repro::kEmpty;
      k1[j] = repro::kEmpty;
      v0[j] = 0u;
      v1[j] = 0u;
    }
    __syncthreads();
    if (warp == 0) {
      // redistribute in slot order on hash bit l+1 from the top
      int c0 = 0, c1 = 0;
      for (int j = 0; j < S; ++j) {
        const uint32_t key = old_k[j];
        if (key == repro::kEmpty) continue;
        const bool to_new = (repro::hash_dir(key) >> (31 - l)) & 1u;
        uint32_t* tk = to_new ? k1 : k0;
        uint32_t* tv = to_new ? v1 : v0;
        const int idx = repro::warp_first_usable(
            tk, S, key, repro::hash_bucket(key) % S, lane);
        if (idx >= 0) {
          const bool was_empty = tk[idx] == repro::kEmpty;
          __syncwarp();
          if (lane == 0) {
            tk[idx] = key;
            tv[idx] = old_v[j];
          }
          if (was_empty) (to_new ? c1 : c0) += 1;
          __syncwarp();
        }
      }
      if (lane == 0) {
        sh.c0 = c0;
        sh.c1 = c1;
      }
    }
    __syncthreads();
    for (int j = tid; j < S; j += T) {
      bucket_keys[ob + j] = k0[j];
      bucket_vals[ob + j] = v0[j];
      bucket_keys[nb2 + j] = k1[j];
      bucket_vals[nb2 + j] = v1[j];
    }
    // directory range [start, start + 2^(g-l)) pointed at b; upper half -> b2
    const int shift = g - l;
    const int start = (slot >> shift) << shift;
    const int length = 1 << shift;
    for (int i = start + (length >> 1) + tid; i < start + length; i += T) {
      directory[i] = b2;
    }
    if (tid == 0) {
      counts[b] = sh.c0;
      counts[b2] = sh.c1;
      local_depth[b] = l + 1;
      local_depth[b2] = l + 1;
      sh.nb = b2 + 1;
      sh.g = g;
    }
    __syncthreads();
  }

  if (tid == 0) {
    *global_depth = sh.g;
    *num_buckets = sh.nb;
    *dropped = sh.dropped;
  }
}

}  // namespace

constexpr int kThreads = 1024;  // == the kernel's __launch_bounds__

// keys/vals (n,) u32; the EHState arrays in place: directory (2^max_depth,)
// i32, bucket_keys/vals (C, S) u32, counts/local_depth (C,) i32, and the
// three 0-d i32 scalars.
extern "C" int eh_insert_launch(const void* keys, const void* vals, int n,
                                void* directory, void* bucket_keys,
                                void* bucket_vals, void* counts,
                                void* local_depth, void* global_depth,
                                void* num_buckets, void* dropped, int max_depth,
                                int C, int S, void* stream) {
  if (n <= 0) return 0;
  const long long smem = 6LL * S * static_cast<long long>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      eh_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  eh_insert_kernel<<<1, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(vals), n,
      static_cast<int32_t*>(directory), static_cast<uint32_t*>(bucket_keys),
      static_cast<uint32_t*>(bucket_vals), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(local_depth), static_cast<int32_t*>(global_depth),
      static_cast<int32_t*>(num_buckets), static_cast<int32_t*>(dropped),
      max_depth, C, S);
  return static_cast<int>(cudaGetLastError());
}
