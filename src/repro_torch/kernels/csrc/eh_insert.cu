// Extendible-hashing batch insert: one launch per batch, one thread block.
//
// Replaces repro/core/extendible_hashing.py:eh_insert_many, a per-key
// lax.scan with in-line cascading splits and doublings (no Pallas kernel
// there; this is its device-side form).  Where a key lands depends on the
// order of the keys and, inside a split, on the order of the old bucket's
// slots, so the kernel keeps both orders and leaves all eight state arrays
// bit-identical to the reference.
//
// Bound: latency, not bytes.  The walk is sequential by definition, and
// each key is a chain of dependent reads (key, directory entry, count, bucket
// row).  Almost none of that chain depends on the key before it, so the
// design takes it off the sequential path.  The keys go in windows of W:
//
//   * lookahead (warps 1..31): while warp 0 commits window k, they resolve
//     window k+1 against the state as it stood when the commit began: hash,
//     directory entry, count, local depth and the probe (common.cuh's
//     group_probe, kLookGroup lanes a key), one Record a key in shared
//     memory (two buffers, one per window in flight).  Their reads may race
//     warp 0's stores;
//   * revalidation (all warps, between windows, nothing written meanwhile):
//     a record of window k+1 whose bucket is the record bucket of a key of
//     window k is resolved again.  Window k wrote only into its record
//     buckets and into buckets its splits created, which no record of k+1
//     can name, so every other record is exact as it stands.  Then each
//     record is flagged `dup` when an earlier key of its window has the same
//     bucket;
//   * commit (warp 0, in key order), 32 keys a step, one a lane: the keys
//     before the first one that is dup or must split write at once (their
//     buckets differ, so their stores are disjoint); that key then goes
//     alone: a dup key is probed again by all 32 lanes at the current state,
//     a split goes to the block.  The split test, the overwrite, the drop
//     and the count update are the reference's;
//   * a split (whole block, between phases): the doubling and the directory
//     range rewrite as the reference's, the old row staged in shared memory
//     and its keys put into two fresh rows as the reference puts them, one
//     by one in slot order, but found at once: every key claims slots from
//     its home on, the key of the earliest staged slot keeps a slot, and
//     the others move on, until no key moves (a few rounds).  The key goes
//     through the commit again, probing the fresh row in shared memory
//     (cascades stay in-line).
//
// Stores reach other warps only through block barriers.  The state is
// updated in place; the caller hands in a copy (copy-on-write), so readers of
// the old state never see a partial batch.
#include <climits>

#include "common.cuh"

namespace {

// The lookahead's lanes a key and the window were chosen on the card over
// 2, 4, 8 lanes and 62, 124, 248 keys (PERF.md, section 6).  A window of 124
// keys is one key for each lookahead group of 8 lanes (31 warps x 4 groups).
constexpr int kThreads = 1024;  // == the kernel's __launch_bounds__
constexpr int kLookGroup = 8;   // lanes a key in the lookahead
constexpr int kWindow = 124;    // keys a window (kernels/eh_insert.py WINDOW)
constexpr size_t kMaxShared = 232448;  // a block's shared memory on Hopper

// What the lookahead learned about one key of a window.
struct Record {
  uint32_t key, val;
  int32_t b;    // directory[slot] at the global depth it was resolved at
  int32_t idx;  // first position holding the key or EMPTY; -1: full, absent
  uint32_t at;  // what idx holds (the key: present; EMPTY: a fresh slot)
  int32_t cnt;  // counts[b]
  int32_t ld;   // local_depth[b]
  int32_t dup;  // an earlier key of the window has the same b
};

struct Shared {
  int g;          // global depth
  int nb;         // buckets allocated
  int dropped;    // inserts refused
  int next;       // next key warp 0 commits
  int win;        // window warp 0 commits (-1 before the first)
  int look;       // window the lookahead resolves this phase (-1: none)
  int split;      // 1 if key `next` needs a split first
  uint32_t h;     // hash_dir of that key
  int side_n[2];  // live keys of a split on each side
  int side_c[2];  // the fresh slots each side's row took
  int redo;       // key `next` was split for: probe the fresh row below
  int redo_b, redo_side, redo_ld;
};
// the block's static shared memory (kernels/eh_insert.py counts it)
static_assert(sizeof(Shared) == 64, "kernels/eh_insert.py _STATIC_BYTES");

// Dynamic shared memory: six staged rows (u32; each side's claims on its
// new row, i32, share the first two fresh rows until the claims are over)
// and each staged key's candidate slot (u16); two record buffers of W.
__host__ __device__ constexpr size_t rows_bytes(int S) {
  return (26 * static_cast<size_t>(S) + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t smem_bytes(int S) {
  return rows_bytes(S) + 2 * static_cast<size_t>(kWindow) * sizeof(Record);
}

// Side of a staged key in a split of a bucket of local depth l: hash bit
// l+1 from the top (1: it moves to the new bucket).
__device__ __forceinline__ int side_of(uint32_t key, int l) {
  return (repro::hash_dir(key) >> (31 - l)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
eh_insert_kernel(const uint32_t* __restrict__ keys,
                 const uint32_t* __restrict__ vals, int n, int32_t* directory,
                 uint32_t* bucket_keys, uint32_t* bucket_vals, int32_t* counts,
                 int32_t* local_depth, int32_t* global_depth,
                 int32_t* num_buckets, int32_t* dropped, int max_depth, int C,
                 int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* old_k = reinterpret_cast<uint32_t*>(smem);  // the row being split
  uint32_t* old_v = old_k + S;
  uint32_t* k0 = old_k + 2 * S;  // rows it splits into: stays (bit 0) ...
  uint32_t* v0 = old_k + 3 * S;
  uint32_t* k1 = old_k + 4 * S;  // ... and moves to the new bucket (bit 1)
  uint32_t* v1 = old_k + 5 * S;
  int* owner = reinterpret_cast<int*>(k0);  // 2S, a side each, over k0/v0
  uint16_t* cand = reinterpret_cast<uint16_t*>(old_k + 6 * S);
  Record* recs = reinterpret_cast<Record*>(smem + rows_bytes(S));
  __shared__ Shared sh;
  constexpr int W = kWindow;

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int GI = kLookGroup;
  const int r = lane % GI;
  const unsigned gbits = ((1u << GI) - 1u) << (lane - r);

  if (tid == 0) {
    sh.g = *global_depth;
    sh.nb = *num_buckets;
    sh.dropped = *dropped;
    sh.next = 0;
    sh.win = -1;
    sh.look = 0;
    sh.split = 0;
    sh.redo = 0;
  }
  __syncthreads();

  while (true) {
    if (warp == 0 && sh.win >= 0) {
      // ---- commit keys [next, end of window) in order (warp 0) ------------
      const int win = sh.win;
      const int wbase = win * W;
      const int end = min(wbase + W, n);
      const Record* rw = recs + (win & 1) * W;  // key i's record: rw[i - wbase]
      const int g = sh.g;
      const int nb = sh.nb;
      int drop = sh.dropped;
      int i = sh.next;
      bool redo = sh.redo;
      int split = 0;
      uint32_t h = 0;
      while (i < end) {
        if (!redo) {
          // one key a lane; the keys before the first dup or split key
          // write at once
          const int j = i + lane;
          const bool act = j < end;
          Record rc{};
          if (act) rc = rw[j - wbase];
          const bool present = rc.idx >= 0 && rc.at == rc.key;
          const bool grow = !rc.dup && rc.cnt >= S && !present && nb < C &&
                            (rc.ld < g || g < max_depth);
          const unsigned stop = __ballot_sync(repro::kFullMask,
                                              act && (rc.dup || grow));
          const int f = stop ? __ffs(stop) - 1 : 32;
          const bool mine = act && lane < f;
          if (mine && rc.idx >= 0) {
            const size_t at_slot = static_cast<size_t>(rc.b) * S + rc.idx;
            bucket_keys[at_slot] = rc.key;
            bucket_vals[at_slot] = rc.val;
            if (rc.at == repro::kEmpty) counts[rc.b] = rc.cnt + 1;
          }
          drop += __popc(__ballot_sync(repro::kFullMask, mine && rc.idx < 0));
          const bool f_dup = __shfl_sync(repro::kFullMask, rc.dup, f & 31);
          if (stop == 0u) {
            i = min(i + 32, end);
            continue;
          }
          i += f;
          if (!f_dup) {  // key i's bucket is full: split it first
            split = 1;
            h = repro::hash_dir(rw[i - wbase].key);
            break;
          }
          __syncwarp();  // the prefix's stores reach the re-probe below
        }
        // ---- key i alone, at the current state (all 32 lanes) -------------
        const Record rc = rw[i - wbase];
        const uint32_t key = rc.key;
        int32_t b, cnt, ld, idx;
        uint32_t at;
        if (redo) {  // the split's fresh row, still in shared memory
          b = sh.redo_b;
          cnt = sh.side_c[sh.redo_side];
          ld = sh.redo_ld;
          idx = repro::group_probe<32, false>(sh.redo_side ? k1 : k0, S, key,
                                              repro::hash_bucket(key) % S,
                                              true, &at);
          redo = false;
        } else {
          b = directory[repro::dir_slot(repro::hash_dir(key), g)];
          cnt = counts[b];
          ld = local_depth[b];
          idx = repro::group_probe<32, false>(
              bucket_keys + static_cast<size_t>(b) * S, S, key,
              repro::hash_bucket(key) % S, true, &at);
        }
        const bool present = idx >= 0 && at == key;
        if (cnt >= S && !present && nb < C && (ld < g || g < max_depth)) {
          split = 1;
          h = repro::hash_dir(key);
          break;
        }
        if (idx >= 0) {
          if (lane == 0) {
            const size_t at_slot = static_cast<size_t>(b) * S + idx;
            bucket_keys[at_slot] = key;
            bucket_vals[at_slot] = rc.val;
            if (at == repro::kEmpty) counts[b] = cnt + 1;
          }
        } else {
          drop += 1;
        }
        ++i;
      }
      if (lane == 0) {
        sh.next = i;
        sh.split = split;
        sh.h = h;
        sh.dropped = drop;
        sh.redo = 0;
      }
    } else if (warp > 0 && sh.look >= 0) {
      // ---- resolve window `look` against the phase's state (warps 1..) ---
      const int look = sh.look;
      const int g = sh.g;
      const int base = look * W;
      const int m = min(W, n - base);
      Record* out = recs + (look & 1) * W;
      const int grp = (warp - 1) * (32 / GI) + lane / GI;
      const int ngroups = (T / 32 - 1) * (32 / GI);
      for (int j0 = 0; j0 < m; j0 += ngroups) {  // warp-uniform
        const int j = j0 + grp;
        const bool act = j < m;
        uint32_t key = 0u, val = 0u;
        int32_t b = 0, cnt = 0, ld = 0;
        if (act) {
          key = __ldg(keys + base + j);
          val = __ldg(vals + base + j);
          b = directory[repro::dir_slot(repro::hash_dir(key), g)];
          cnt = counts[b];
          ld = local_depth[b];
        }
        uint32_t at;
        const int idx = repro::group_probe<GI, false>(
            bucket_keys + static_cast<size_t>(b) * S, S, key,
            repro::hash_bucket(key) % S, act, &at);
        if (act && r == 0) out[j] = Record{key, val, b, idx, at, cnt, ld, 0};
      }
    }
    __syncthreads();

    if (!sh.split) {
      // ---- window `win` done: ready window win+1 (all threads) ------------
      const int win = sh.win;
      const int nw = win + 1;
      if (static_cast<long long>(nw) * W >= n) break;
      Record* rn = recs + (nw & 1) * W;
      const int m = min(W, n - nw * W);
      if (win >= 0) {
        // records whose bucket window `win` may have written: resolve again
        const Record* rp = recs + (win & 1) * W;
        const int g = sh.g;
        const int grp = warp * (32 / GI) + lane / GI;
        const int ngroups = (T / 32) * (32 / GI);
        for (int j0 = 0; j0 < m; j0 += ngroups) {  // warp-uniform
          const int j = j0 + grp;
          const bool act = j < m;
          const int32_t b = act ? rn[j].b : -1;
          bool seen = false;
          if (act) {
            for (int q = r; q < W; q += GI) seen |= rp[q].b == b;
          }
          const bool stale =
              (__ballot_sync(repro::kFullMask, seen) & gbits) != 0u;
          const uint32_t key = act ? rn[j].key : 0u;
          int32_t b2 = 0, cnt = 0, ld = 0;
          if (stale) {
            b2 = directory[repro::dir_slot(repro::hash_dir(key), g)];
            cnt = counts[b2];
            ld = local_depth[b2];
          }
          uint32_t at;
          const int idx = repro::group_probe<GI, false>(
              bucket_keys + static_cast<size_t>(b2) * S, S, key,
              repro::hash_bucket(key) % S, stale, &at);
          if (stale && r == 0) {
            rn[j].b = b2;
            rn[j].idx = idx;
            rn[j].at = at;
            rn[j].cnt = cnt;
            rn[j].ld = ld;
          }
        }
      }
      __syncthreads();  // every thread has read sh.win; the records are final
      for (int j = tid; j < m; j += T) {
        const int32_t b = rn[j].b;
        int dup = 0;
        for (int q = 0; q < j; ++q) dup |= rn[q].b == b;
        rn[j].dup = dup;
      }
      if (tid == 0) {
        sh.win = nw;
        sh.next = nw * W;
        sh.look = static_cast<long long>(nw + 1) * W < n ? nw + 1 : -1;
      }
      __syncthreads();
      continue;
    }

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
    if (tid == 0) sh.side_n[0] = sh.side_n[1] = 0;
    for (int j = tid; j < S; j += T) {
      const uint32_t key = bucket_keys[ob + j];
      old_k[j] = key;
      old_v[j] = bucket_vals[ob + j];
      owner[j] = INT_MAX;
      owner[S + j] = INT_MAX;
      cand[j] = static_cast<uint16_t>(repro::hash_bucket(key) % S);
    }
    __syncthreads();
    // Each side's row as the reference's bucket_put builds it, key by key in
    // staged-slot order, found all at once: a key takes the first slot from
    // its home on that no key of an earlier staged slot takes.  So every live
    // key claims its candidate slot (atomicMin of its staged slot), and a key
    // that an earlier one outbid moves one slot on, until no key moves.  A
    // key that stays outbids every later claim; a key passes only slots
    // earlier keys hold; and a row holds no key twice (an insert overwrites,
    // nothing deletes), so no key stops at a copy of itself.
    for (int j = tid; j < S; j += T) {
      const uint32_t key = old_k[j];
      if (key != repro::kEmpty) atomicAdd(&sh.side_n[side_of(key, l)], 1);
    }
    while (true) {
      for (int j = tid; j < S; j += T) {
        const uint32_t key = old_k[j];
        if (key != repro::kEmpty) {
          atomicMin(owner + side_of(key, l) * S + cand[j], j);
        }
      }
      __syncthreads();
      bool moved = false;
      for (int j = tid; j < S; j += T) {
        const uint32_t key = old_k[j];
        const int c = cand[j];
        if (key != repro::kEmpty && owner[side_of(key, l) * S + c] != j) {
          cand[j] = static_cast<uint16_t>(c + 1 == S ? 0 : c + 1);
          moved = true;
        }
      }
      if (!__syncthreads_or(moved)) break;
    }
    for (int j = tid; j < S; j += T) {  // the claims are over: clear k0/v0
      k0[j] = repro::kEmpty;
      k1[j] = repro::kEmpty;
      v0[j] = 0u;
      v1[j] = 0u;
    }
    __syncthreads();
    for (int j = tid; j < S; j += T) {
      const uint32_t key = old_k[j];
      if (key != repro::kEmpty) {
        const int side = side_of(key, l);
        (side ? k1 : k0)[cand[j]] = key;
        (side ? v1 : v0)[cand[j]] = old_v[j];
      }
    }
    if (tid == 0) {  // distinct keys: every one took an EMPTY slot
      sh.side_c[0] = sh.side_n[0];
      sh.side_c[1] = sh.side_n[1];
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
      counts[b] = sh.side_c[0];
      counts[b2] = sh.side_c[1];
      local_depth[b] = l + 1;
      local_depth[b2] = l + 1;
      sh.nb = b2 + 1;
      sh.g = g;
      sh.split = 0;
      sh.look = -1;  // the next window's records are already resolved
      const int side = (h >> (31 - l)) & 1u;  // the key's side
      sh.redo = 1;
      sh.redo_side = side;
      sh.redo_b = side ? b2 : b;
      sh.redo_ld = l + 1;
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
  const size_t smem = smem_bytes(S);
  if (S < 1 || S > 65535 || smem + sizeof(Shared) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      eh_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  eh_insert_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(vals), n,
      static_cast<int32_t*>(directory), static_cast<uint32_t*>(bucket_keys),
      static_cast<uint32_t*>(bucket_vals), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(local_depth), static_cast<int32_t*>(global_depth),
      static_cast<int32_t*>(num_buckets), static_cast<int32_t*>(dropped),
      max_depth, C, S);
  return static_cast<int>(cudaGetLastError());
}
