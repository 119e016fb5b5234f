// The paper's §4.2 baselines' batch inserts (HT, HTI, CH): one block a batch.
//
// Replaces repro/core/baselines.py's ht_insert_many, hti_insert_many and
// ch_insert_many, per-key lax.scans (no Pallas kernel there; this is their
// device-side form).  Where a key lands depends on the order of the keys (and
// for HT's doubling on the order of the old slots), so the kernels keep both
// orders and leave every state array bit-identical to the reference.
//
// Bound: latency, not bytes.  The walk is sequential by definition and each
// key's probe is a dependent read of the table (CH: head, links, count).  The
// design takes the reads off the sequential path.  The keys go in windows:
//
//   * resolve (all warps, nothing written meanwhile): a record a key (for HTI
//     a record an item of its stream: the live old slots each insert migrates,
//     then the key), read from the state as the window begins: for the open
//     tables the home slot and the 32-slot probe window as two masks, EMPTY
//     slots and slots holding the key (one coalesced read and two ballots a
//     window); for CH the chain's tail bucket and its count;
//   * commit (warp 0, in order, 32 items a step, one a lane).  A record is
//     exact unless an earlier item of its window wrote a slot its probe
//     passes (home up to the slot it chose; CH: an earlier key of the window
//     has its chain).  Each lane looks its passed slots up in a shared-memory
//     shadow of every slot the window wrote, and in the slots the lanes
//     before it choose; the items before the first stale one write at once,
//     the load test of every key made on the exact count (a prefix count of
//     the fresh slots before it).  A stale item goes alone, its 32 slots
//     corrected from the shadow (CH: the chain's tail and count as the window
//     left them, from a map of the window's chains).  CH allocates buckets in
//     key order by a prefix count of the allocating keys.
//
// HT's doubling and HTI's migration start end the launch: the launcher runs
// the grid pass (doubling: claim rounds over the doubled table, a key of an
// earlier old slot keeping a slot and the others moving on, a key past its 32
// slots lost as in the reference; migration start: new table to old, new
// cleared) and launches the insert again from the key that asked for it.
// Both are rare (about 17 each for 2^24 keys from a table of 2^9).
//
// The state is updated in place; the caller hands in a copy (copy-on-write).
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // == the insert kernels' __launch_bounds__
constexpr int kWindowKeys = 1024;  // HT and CH: keys a window
constexpr int kStream = 2048;      // HTI: stream positions a window
constexpr int kProbe = 32;         // the probe window (PROBE_WINDOW)
constexpr size_t kMaxShared = 232448;
constexpr int32_t kFree = INT_MAX;  // an unclaimed slot of a doubling

enum Event : int { kDone = 0, kDouble = 1, kMigrate = 2 };
constexpr int kCanStart = 1;  // a key whose load test may double / migrate

// One item of an open table's insert stream.
struct Item {
  uint32_t key, val;
  int32_t home;   // home slot in the table the item goes to
  uint32_t emp;   // bit j: slot home + j EMPTY as the window began
  uint32_t hit;   // bit j: slot home + j held the key as the window began
  int32_t src;    // a migrated item's old slot (>= 0); -1 - key index
  int32_t flags;  // kCanStart
  int32_t pad;
};
static_assert(sizeof(Item) == 32, "Item");

// One key of a CH window.
struct ChRec {
  uint32_t key, val;
  int32_t slot;   // chain slot
  int32_t tail;   // the chain's last bucket (-1: empty chain)
  int32_t cnt;    // counts[tail]
  int32_t entry;  // its chain's entry in the window map
  int32_t dup;    // an earlier key of the window has the same chain
  int32_t pad;
};
static_assert(sizeof(ChRec) == 32, "ChRec");

// Items a window and dynamic shared memory of each insert kernel: the
// records, and the open tables' shadow of 4R entries (8 bytes an entry) or
// CH's chain map of 2R entries (16 bytes an entry).
template <bool HTI>
__host__ __device__ constexpr int window_items() {
  return HTI ? kStream : kWindowKeys;
}
template <bool HTI>
__host__ __device__ constexpr size_t open_smem_bytes() {
  return window_items<HTI>() * (sizeof(Item) + 4 * 8);
}
__host__ __device__ constexpr size_t ch_smem_bytes() {
  return kWindowKeys * (sizeof(ChRec) + 2 * 16);
}
static_assert(open_smem_bytes<true>() + 256 <= kMaxShared &&
                  ch_smem_bytes() + 256 <= kMaxShared,
              "shared memory of one block");

__device__ __forceinline__ uint32_t map_hash(int32_t key, int log2) {
  return (static_cast<uint32_t>(key) * repro::kHashC2) >> (32 - log2);
}

// Open-addressing map in shared memory, keys >= 0 (-1 free): the entry of
// `key`, claimed if new.  Safe for lanes inserting different keys at once.
__device__ __forceinline__ int map_entry(int32_t* keys, int log2, int32_t key) {
  const uint32_t m = (1u << log2) - 1u;
  uint32_t e = map_hash(key, log2);
  while (true) {
    const int32_t old = atomicCAS(keys + e, -1, key);
    if (old == -1 || old == key) return static_cast<int>(e);
    e = (e + 1u) & m;
  }
}

// The entry of `key`, or -1.
__device__ __forceinline__ int map_find(const int32_t* keys, int log2,
                                        int32_t key) {
  const uint32_t m = (1u << log2) - 1u;
  uint32_t e = map_hash(key, log2);
  while (true) {
    const int32_t k = keys[e];
    if (k == key) return static_cast<int>(e);
    if (k == -1) return -1;
    e = (e + 1u) & m;
  }
}

// Exclusive prefix sum of x over the block; *total gets the sum.  Every
// thread calls it; `sums` holds 33 ints.
__device__ int block_scan(int x, int* sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(repro::kFullMask, wi, d);
      if (lane >= d) wi += y;
    }
    sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  const int out = sums[warp] + incl - x;
  *total = sums[32];
  __syncthreads();  // sums is free again
  return out;
}

// The probe-window masks of items it[0, cnt) (cnt <= 32) in the table of
// 2^L slots; all 32 lanes of the warp.  Lane j reads slot home + j of each
// item in turn (16 reads in flight), and two ballots give the item's masks.
// A table under 32 slots has a window of its size (the reference's wrapped
// positions repeat those slots).
__device__ void resolve_masks(Item* it, int cnt, const uint32_t* table,
                              int L) {
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << L) - 1u;
  const bool in = lane < (L >= 5 ? kProbe : (1 << L));
  uint32_t key = 0u;
  int32_t home = 0;
  if (lane < cnt) {
    key = it[lane].key;
    home = it[lane].home;
  }
  uint32_t emp = 0u, hit = 0u;
#pragma unroll
  for (int half = 0; half < 32; half += 16) {
    uint32_t x[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint32_t h =
          static_cast<uint32_t>(__shfl_sync(repro::kFullMask, home, half + t));
      x[t] = (half + t < cnt && in) ? table[(h + lane) & mask] : 0u;
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint32_t k = __shfl_sync(repro::kFullMask, key, half + t);
      const uint32_t e =
          __ballot_sync(repro::kFullMask, in && x[t] == repro::kEmpty);
      const uint32_t hb = __ballot_sync(repro::kFullMask, in && x[t] == k);
      if (lane == half + t) {
        emp = e;
        hit = hb;
      }
    }
  }
  if (lane < cnt) {
    it[lane].emp = emp;
    it[lane].hit = hit;
  }
}

// The open tables' state, in place.  HT: the table is (newk, newv), its log2
// and count new_log2 and new_count; the old-table fields are unused.
struct OpenArgs {
  const uint32_t* keys;
  const uint32_t* vals;
  int n;
  int resume;  // key 0 already took its migration step and load test
  uint32_t* newk;
  uint32_t* newv;
  uint32_t* oldk;
  uint32_t* oldv;
  int32_t* new_log2;
  int32_t* old_log2;
  int32_t* new_count;
  int32_t* old_count;
  int32_t* ptr;
  uint8_t* migrating;
  int32_t* dropped;
  int max_log2;
  float threshold;
  int batch;  // HTI migrate_batch
  int32_t* status;  // [key the launch stopped at, Event, table log2]
};

// HTI's stream, counted from the launch's first key: key k' = k - resume
// (key 0 of a resumed launch migrates nothing) first migrates its old slots
// [B k', min(B (k'+1), D)) past the pointer, then inserts itself.  Position v
// is either old slot P + *d (returns false) or key *k (returns true).
__device__ __forceinline__ bool stream_at(long long v, int resume, long long B,
                                          long long D, long long* d,
                                          long long* k) {
  if (resume && v == 0) {
    *k = 0;
    return true;
  }
  v -= resume;
  const long long kd = (D + B - 1) / B;  // keys that migrate slots
  if (kd == 0 || v > D + kd - 1) {
    *k = v - D + resume;
    return true;
  }
  const long long k1 = v / (B + 1);
  const long long r = v - k1 * (B + 1);
  const long long c = min(B, D - B * k1);
  if (r < c) {
    *d = B * k1 + r;
    return false;
  }
  *k = k1 + resume;
  return true;
}

template <bool HTI>
__global__ void __launch_bounds__(kThreads) open_insert_kernel(OpenArgs a) {
  constexpr int R = window_items<HTI>();
  constexpr int SH_LOG2 = HTI ? 13 : 12;  // 4R entries
  static_assert((1 << SH_LOG2) == 4 * R, "shadow size");
  extern __shared__ __align__(16) unsigned char smem[];
  Item* recs = reinterpret_cast<Item*>(smem);
  int32_t* sh_slot = reinterpret_cast<int32_t*>(recs + R);  // the shadow of
  uint32_t* sh_key = reinterpret_cast<uint32_t*>(sh_slot + 4 * R);  // writes
  __shared__ int sums[33];
  __shared__ int s_event, s_at;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = *a.new_log2;
  const uint32_t mask = (1u << L) - 1u;
  const int win = L >= 5 ? kProbe : (1 << L);
  const uint32_t wbits = win == 32 ? repro::kFullMask : (1u << win) - 1u;
  const bool can_grow = L < a.max_log2;
  const float thr = a.threshold * static_cast<float>(1u << L);
  // HTI: the migration in progress as the launch begins
  long long P = 0, D = 0;
  bool mig0 = false;
  if (HTI) {
    mig0 = *a.migrating != 0;
    P = *a.ptr;
    const long long E = 1ll << *a.old_log2;
    D = mig0 && P < E ? E - P : 0;
  }
  const long long B = a.batch;
  long long vtot = a.n;  // stream length
  if (HTI) {
    const long long kl = a.n - 1 - a.resume;  // last key, counted as k'
    vtot = kl < 0 ? 1 : a.resume + 1 + kl + (kl >= (D + B - 1) / B
                                                   ? D : min(B * (kl + 1), D));
  }
  // warp 0's running state (the same on every lane)
  int c_new = *a.new_count;
  int c_old = HTI ? *a.old_count : 0;
  int dropped = *a.dropped;
  if (tid == 0) s_event = kDone;

  for (long long v0 = 0; v0 < vtot; v0 += R) {
    // ---- the window's items, in stream order (all threads) ----------------
    for (int e = tid; e < 4 * R; e += kThreads) sh_slot[e] = -1;
    int m;
    if (!HTI) {
      m = static_cast<int>(min(static_cast<long long>(R), vtot - v0));
      for (int t = tid; t < m; t += kThreads) {
        const long long k = v0 + t;
        const uint32_t key = __ldg(a.keys + k);
        Item it{key, __ldg(a.vals + k),
                repro::dir_slot(repro::hash_dir(key), L), 0u, 0u,
                static_cast<int32_t>(-1 - k), 0, 0};
        if (can_grow && !(a.resume && k == 0)) it.flags = kCanStart;
        recs[t] = it;
      }
    } else {
      Item mine[2];
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long v = v0 + 2 * tid + q;
        if (v >= vtot) break;
        long long d = 0, k = 0;
        if (stream_at(v, a.resume, B, D, &d, &k)) {
          const uint32_t key = __ldg(a.keys + k);
          const long long kp = k - a.resume;  // k'
          const bool mig_after = mig0 && B * (kp + 1) < D;
          mine[cnt++] = Item{key, __ldg(a.vals + k),
                             repro::dir_slot(repro::hash_dir(key), L), 0u, 0u,
                             static_cast<int32_t>(-1 - k),
                             (kp >= 0 && !mig_after && can_grow) ? kCanStart
                                                                 : 0,
                             0};
        } else {
          const long long s = P + d;
          const uint32_t key = a.oldk[s];
          if (key != repro::kEmpty) {
            mine[cnt++] = Item{key, a.oldv[s],
                               repro::dir_slot(repro::hash_dir(key), L), 0u,
                               0u, static_cast<int32_t>(s), 0, 0};
          }
        }
      }
      const int at = block_scan(cnt, sums, &m);
      for (int q = 0; q < cnt; ++q) recs[at + q] = mine[q];
    }
    __syncthreads();

    // ---- probe-window masks, at the state as the window begins ------------
    for (int g = warp * 32; g < m; g += kThreads) {
      resolve_masks(recs + g, min(32, m - g), a.newk, L);
    }
    __syncthreads();

    // ---- commit in order (warp 0) ------------------------------------------
    if (warp == 0) {
      const unsigned lt = (1u << lane) - 1u;
      int i = 0;
      while (i < m) {
        const int j = i + lane;
        const bool act = j < m;
        Item r{};
        if (act) r = recs[j];
        const uint32_t usable = act ? (r.emp | r.hit) & wbits : 0u;
        const bool ok = usable != 0u;
        const int off = ok ? __ffs(usable) - 1 : 0;
        const bool fresh = ok && ((r.emp >> off) & 1u);
        const bool migr = act && r.src >= 0;
        // stale: a slot the probe passes (home up to its choice; the whole
        // window when full) written by the window so far or by a lane before
        const uint32_t span = ok ? off + 1 : win;
        bool stale = false;
        if (act) {
          for (uint32_t d = 0; d < span && !stale; ++d) {
            stale = map_find(sh_slot, SH_LOG2, static_cast<int32_t>(
                (static_cast<uint32_t>(r.home) + d) & mask)) >= 0;
          }
        }
        const int32_t chosen =
            act && ok ? static_cast<int32_t>((static_cast<uint32_t>(r.home) +
                                              off) & mask)
                      : -1;
        for (int q = 0; q < 31; ++q) {
          const int32_t pq = __shfl_sync(repro::kFullMask, chosen, q);
          stale |= q < lane && pq >= 0 &&
                   ((static_cast<uint32_t>(pq) - static_cast<uint32_t>(r.home))
                    & mask) < span;
        }
        stale &= act;
        const unsigned b_fresh = __ballot_sync(repro::kFullMask, fresh);
        const unsigned b_migr = __ballot_sync(repro::kFullMask, migr);
        const int before =
            c_new + c_old + __popc(b_fresh & lt) - __popc(b_migr & lt);
        const bool trig = act && (r.flags & kCanStart) &&
                          static_cast<float>(before) + 1.0f > thr;
        const unsigned stop = __ballot_sync(repro::kFullMask, trig || stale);
        const int f = stop ? __ffs(stop) - 1 : 32;
        const bool mine = act && lane < f;
        if (mine && ok) {
          a.newk[chosen] = r.key;
          a.newv[chosen] = r.val;
          sh_key[map_entry(sh_slot, SH_LOG2, chosen)] = r.key;
        }
        if (HTI && mine && migr) a.oldk[r.src] = repro::kEmpty;
        const unsigned below = f == 32 ? repro::kFullMask : (1u << f) - 1u;
        c_new += __popc(b_fresh & below);
        c_old -= __popc(b_migr & below);
        dropped += __popc(
            __ballot_sync(repro::kFullMask, act && !migr && !ok) & below);
        if (stop == 0u) {
          i += 32;
          continue;
        }
        i += f;
        if (__shfl_sync(repro::kFullMask, static_cast<int>(trig), f)) {
          if (lane == 0) {
            s_event = HTI ? kMigrate : kDouble;
            s_at = -1 - recs[i].src;
          }
          break;
        }
        __syncwarp();  // the prefix's shadow entries reach the lanes below
        // ---- item i alone: its window corrected by the shadow --------------
        const Item q = recs[i];
        const uint32_t p = (static_cast<uint32_t>(q.home) + lane) & mask;
        bool e_bit = (q.emp >> lane) & 1u;
        bool h_bit = (q.hit >> lane) & 1u;
        if (lane < win) {
          const int e = map_find(sh_slot, SH_LOG2, static_cast<int32_t>(p));
          if (e >= 0) {
            const uint32_t now = sh_key[e];
            e_bit = now == repro::kEmpty;
            h_bit = now == q.key;
          }
        }
        const unsigned ue =
            __ballot_sync(repro::kFullMask, lane < win && e_bit);
        const unsigned u =
            __ballot_sync(repro::kFullMask, lane < win && (e_bit || h_bit));
        const bool qok = u != 0u;
        const int qoff = qok ? __ffs(u) - 1 : 0;
        __syncwarp();  // every lane has read the shadow
        if (lane == 0) {
          if (qok) {
            const uint32_t pp = (static_cast<uint32_t>(q.home) + qoff) & mask;
            a.newk[pp] = q.key;
            a.newv[pp] = q.val;
            sh_key[map_entry(sh_slot, SH_LOG2, static_cast<int32_t>(pp))] =
                q.key;
          }
          if (HTI && q.src >= 0) a.oldk[q.src] = repro::kEmpty;
        }
        c_new += qok && ((ue >> qoff) & 1u);
        if (q.src >= 0) {
          c_old -= 1;
        } else {
          dropped += !qok;
        }
        __syncwarp();
        ++i;
      }
    }
    __syncthreads();
    if (s_event != kDone) break;
  }

  if (tid == 0) {
    *a.dropped = dropped;
    a.status[1] = s_event;
    a.status[2] = L;
    if (!HTI) {
      *a.new_count = c_new;
      a.status[0] = s_event == kDone ? a.n : s_at;
    } else if (s_event == kMigrate) {
      // start_migration: the new table becomes the old one (the launcher
      // copies it over and clears the new one)
      *a.old_log2 = L;
      *a.new_log2 = L + 1;
      *a.old_count = c_new;
      *a.new_count = 0;
      *a.ptr = 0;
      *a.migrating = 1;
      a.status[0] = s_at;
    } else {
      *a.new_count = c_new;
      *a.old_count = c_old;
      if (mig0) {
        const long long moved = B * (a.n - a.resume);
        *a.ptr = static_cast<int32_t>(P + min(moved, D));
        *a.migrating = moved < D ? 1 : 0;
      }
      a.status[0] = a.n;
    }
  }
}

// ---- HT's doubling: grid passes -------------------------------------------

__device__ __forceinline__ size_t grid_start() {
  return static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ size_t grid_stride() {
  return static_cast<size_t>(gridDim.x) * blockDim.x;
}

// Stage the 2^L old slots, and mark every slot of the doubled table free.
__global__ void ht_stage_kernel(uint32_t* keys, const uint32_t* vals,
                                uint32_t* old_k, uint32_t* old_v, uint8_t* cand,
                                int L) {
  const size_t size = size_t{1} << L;
  for (size_t s = grid_start(); s < size; s += grid_stride()) {
    old_k[s] = keys[s];
    old_v[s] = vals[s];
    cand[s] = 0;
    keys[s] = static_cast<uint32_t>(kFree);
    keys[s + size] = static_cast<uint32_t>(kFree);
  }
}

// One claim round: every live old entry still in its window claims its
// candidate slot of the doubled table for its old slot (the smallest wins).
__global__ void ht_claim_kernel(const uint32_t* old_k, const uint8_t* cand,
                                int32_t* owner, int L, int32_t* moved) {
  const size_t size = size_t{1} << L;
  const uint32_t mask = (2u << L) - 1u;
  const int win = L + 1 >= 5 ? kProbe : 2 << L;
  if (grid_start() == 0) *moved = 0;
  for (size_t s = grid_start(); s < size; s += grid_stride()) {
    const uint32_t k = old_k[s];
    const int c = cand[s];
    if (k != repro::kEmpty && c < win) {
      const uint32_t home = repro::dir_slot(repro::hash_dir(k), L + 1);
      atomicMin(owner + ((home + c) & mask), static_cast<int32_t>(s));
    }
  }
}

// An entry outbid at its candidate slot moves one slot on; one that passes
// its window is lost (the reference ignores the failed re-insert).
__global__ void ht_move_kernel(const uint32_t* old_k, uint8_t* cand,
                               const int32_t* owner, int L, int32_t* moved) {
  const size_t size = size_t{1} << L;
  const uint32_t mask = (2u << L) - 1u;
  const int win = L + 1 >= 5 ? kProbe : 2 << L;
  bool any = false;
  for (size_t s = grid_start(); s < size; s += grid_stride()) {
    const uint32_t k = old_k[s];
    const int c = cand[s];
    if (k != repro::kEmpty && c < win) {
      const uint32_t home = repro::dir_slot(repro::hash_dir(k), L + 1);
      if (owner[(home + c) & mask] != static_cast<int32_t>(s)) {
        cand[s] = static_cast<uint8_t>(c + 1);
        any = true;
      }
    }
  }
  if (__any_sync(repro::kFullMask, any) && (threadIdx.x & 31) == 0) *moved = 1;
}

// Each slot of the doubled table gets the entry that holds it, or EMPTY.
__global__ void ht_place_kernel(uint32_t* keys, uint32_t* vals,
                                const uint32_t* old_k, const uint32_t* old_v,
                                int L, int32_t* size_log2) {
  const size_t size = size_t{2} << L;
  for (size_t p = grid_start(); p < size; p += grid_stride()) {
    const int32_t o = static_cast<int32_t>(keys[p]);
    keys[p] = o == kFree ? repro::kEmpty : old_k[o];
    vals[p] = o == kFree ? 0u : old_v[o];
  }
  if (grid_start() == 0) *size_log2 = L + 1;
}

// HTI's migration start: the new table's 2^L slots become the old table, and
// the new table is cleared.
__global__ void hti_flip_kernel(uint32_t* ok, uint32_t* ov, uint32_t* nk,
                                uint32_t* nv, int L) {
  const size_t size = size_t{1} << L;
  for (size_t s = grid_start(); s < size; s += grid_stride()) {
    ok[s] = nk[s];
    ov[s] = nv[s];
    nk[s] = repro::kEmpty;
    nv[s] = 0u;
  }
}

// ---- CH --------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ch_insert_kernel(const uint32_t* __restrict__ keys,
                 const uint32_t* __restrict__ vals, int n, int32_t* heads,
                 uint32_t* bucket_keys, uint32_t* bucket_vals,
                 int32_t* next_bucket, int32_t* counts, int32_t* num_buckets,
                 int32_t* dropped_p, int T, int C, int S) {
  constexpr int W = kWindowKeys;
  constexpr int MAP_LOG2 = 11;  // 2W entries
  extern __shared__ __align__(16) unsigned char smem[];
  ChRec* recs = reinterpret_cast<ChRec*>(smem);
  int32_t* map_key = reinterpret_cast<int32_t*>(recs + W);  // chain slot
  int32_t* map_min = map_key + 2 * W;   // its first key in the window
  int32_t* map_tail = map_min + 2 * W;  // its tail and count as committed
  int32_t* map_cnt = map_tail + 2 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int nb = *num_buckets;  // warp 0's running state
  int dropped = *dropped_p;

  for (int base = 0; base < n; base += W) {
    const int m = min(W, n - base);
    for (int e = tid; e < 2 * W; e += kThreads) {
      map_key[e] = -1;
      map_min[e] = INT_MAX;
    }
    __syncthreads();
    // ---- resolve: the chain's tail and count (all threads) ----------------
    for (int t = tid; t < m; t += kThreads) {
      const uint32_t key = __ldg(keys + base + t);
      const int32_t slot = repro::dir_slot(repro::hash_dir(key), T);
      int32_t b = heads[slot];
      while (b >= 0) {
        const int32_t nx = next_bucket[b];
        if (nx < 0) break;
        b = nx;
      }
      const int e = map_entry(map_key, MAP_LOG2, slot);
      atomicMin(map_min + e, t);
      recs[t] = ChRec{key, __ldg(vals + base + t), slot, b,
                      b >= 0 ? counts[b] : 0, e, 0, 0};
    }
    __syncthreads();
    for (int t = tid; t < m; t += kThreads) {
      ChRec& r = recs[t];
      r.dup = map_min[r.entry] < t;
      if (!r.dup) {
        map_tail[r.entry] = r.tail;
        map_cnt[r.entry] = r.cnt;
      }
    }
    __syncthreads();
    // ---- commit in order (warp 0) -------------------------------------------
    if (tid < 32) {
      const unsigned lt = (1u << lane) - 1u;
      int i = 0;
      while (i < m) {
        const int j = i + lane;
        const bool act = j < m;
        ChRec r{};
        if (act) r = recs[j];
        const unsigned dups = __ballot_sync(repro::kFullMask, act && r.dup);
        const int f = dups ? __ffs(dups) - 1 : 32;
        const bool mine = act && lane < f;
        const bool room = r.tail >= 0 && r.cnt < S;
        const unsigned allocs = __ballot_sync(repro::kFullMask, mine && !room);
        const int b = nb + __popc(allocs & lt);
        if (mine && room) {  // append, no duplicate check
          const size_t at = static_cast<size_t>(r.tail) * S + r.cnt;
          bucket_keys[at] = r.key;
          bucket_vals[at] = r.val;
          counts[r.tail] = r.cnt + 1;
          map_cnt[r.entry] = r.cnt + 1;
        } else if (mine && b < C) {  // a new bucket, linked in
          const size_t at = static_cast<size_t>(b) * S;
          bucket_keys[at] = r.key;
          bucket_vals[at] = r.val;
          counts[b] = 1;
          if (r.tail < 0) {
            heads[r.slot] = b;
          } else {
            next_bucket[r.tail] = b;
          }
          map_tail[r.entry] = b;
          map_cnt[r.entry] = 1;
        }
        const int want = __popc(allocs);
        const int got = max(0, min(want, C - nb));
        nb += got;
        dropped += want - got;
        if (dups == 0u) {
          i += 32;
          continue;
        }
        i += f;
        __syncwarp();  // the prefix's map entries reach lane 0
        // ---- key i alone, at its chain as the window left it ---------------
        int grew = 0, lost = 0;
        if (lane == 0) {
          const ChRec q = recs[i];
          const int32_t tail = map_tail[q.entry];
          const int32_t cnt = map_cnt[q.entry];
          if (tail >= 0 && cnt < S) {
            const size_t at = static_cast<size_t>(tail) * S + cnt;
            bucket_keys[at] = q.key;
            bucket_vals[at] = q.val;
            counts[tail] = cnt + 1;
            map_cnt[q.entry] = cnt + 1;
          } else if (nb < C) {
            const size_t at = static_cast<size_t>(nb) * S;
            bucket_keys[at] = q.key;
            bucket_vals[at] = q.val;
            counts[nb] = 1;
            if (tail < 0) {
              heads[q.slot] = nb;
            } else {
              next_bucket[tail] = nb;
            }
            map_tail[q.entry] = nb;
            map_cnt[q.entry] = 1;
            grew = 1;
          } else {
            lost = 1;
          }
        }
        nb += __shfl_sync(repro::kFullMask, grew, 0);
        dropped += __shfl_sync(repro::kFullMask, lost, 0);
        __syncwarp();
        ++i;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    *num_buckets = nb;
    *dropped_p = dropped;
  }
}

// ---- launchers -------------------------------------------------------------

int grid_for(size_t n) {
  return static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
}

template <bool HTI>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(open_insert_kernel<HTI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(open_smem_bytes<HTI>()));
}

// Launch the open table's insert from key `start` on; returns the status the
// launch left ([stop key, Event, log2]) through `host`.
template <bool HTI>
cudaError_t run_open(OpenArgs a, const uint32_t* keys, const uint32_t* vals,
                     int n, int start, int resume, int32_t* host,
                     cudaStream_t stream) {
  a.keys = keys + start;
  a.vals = vals + start;
  a.n = n - start;
  a.resume = resume;
  open_insert_kernel<HTI><<<1, kThreads, open_smem_bytes<HTI>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(host, a.status, 3 * sizeof(int32_t),
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(stream);
}

}  // namespace

// keys/vals (n,) u32; the HTState arrays in place: keys/vals (2^max_log2,)
// u32, size_log2/count/dropped 0-d i32.  Work space: old_k/old_v (2^work_log2,)
// u32, cand (2^work_log2,) u8, enough for a doubling from 2^work_log2 slots
// (work_log2 -1: none; a doubling from a larger table returns an error),
// status (4,) i32 on the device.  launches[0] gets the insert kernel's
// launches, launches[1] the doubling passes'.
extern "C" int ht_insert_launch(const void* keys, const void* vals, int n,
                                void* tkeys, void* tvals, void* size_log2,
                                void* count, void* dropped, int max_log2,
                                float threshold, void* old_k, void* old_v,
                                void* cand, int work_log2, void* status,
                                int* launches, void* stream_) {
  launches[0] = launches[1] = 0;
  if (n <= 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = set_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  OpenArgs a{};
  a.newk = static_cast<uint32_t*>(tkeys);
  a.newv = static_cast<uint32_t*>(tvals);
  a.new_log2 = static_cast<int32_t*>(size_log2);
  a.new_count = static_cast<int32_t*>(count);
  a.dropped = static_cast<int32_t*>(dropped);
  a.max_log2 = max_log2;
  a.threshold = threshold;
  a.batch = 1;
  a.status = static_cast<int32_t*>(status);
  int32_t* moved = a.status + 3;
  int start = 0, resume = 0;
  while (true) {
    int32_t st[3];
    err = run_open<false>(a, static_cast<const uint32_t*>(keys),
                          static_cast<const uint32_t*>(vals), n, start, resume,
                          st, stream);
    ++launches[0];
    if (err != cudaSuccess) return static_cast<int>(err);
    if (st[1] == kDone) return 0;
    // double 2^L -> 2^(L+1) before key start + st[0]
    const int L = st[2];
    if (L > work_log2) return static_cast<int>(cudaErrorInvalidValue);
    const int g_old = grid_for(size_t{1} << L);
    ht_stage_kernel<<<g_old, 256, 0, stream>>>(
        a.newk, a.newv, static_cast<uint32_t*>(old_k),
        static_cast<uint32_t*>(old_v),
        static_cast<uint8_t*>(cand), L);
    ++launches[1];
    while (true) {
      ht_claim_kernel<<<g_old, 256, 0, stream>>>(
          static_cast<const uint32_t*>(old_k),
          static_cast<const uint8_t*>(cand),
          reinterpret_cast<int32_t*>(a.newk), L, moved);
      ht_move_kernel<<<g_old, 256, 0, stream>>>(
          static_cast<const uint32_t*>(old_k), static_cast<uint8_t*>(cand),
          reinterpret_cast<const int32_t*>(a.newk), L, moved);
      launches[1] += 2;
      int32_t any = 0;
      err = cudaGetLastError();
      if (err == cudaSuccess) {
        err = cudaMemcpyAsync(&any, moved, sizeof(int32_t),
                              cudaMemcpyDeviceToHost, stream);
      }
      if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (!any) break;
    }
    ht_place_kernel<<<grid_for(size_t{2} << L), 256, 0, stream>>>(
        a.newk, a.newv, static_cast<const uint32_t*>(old_k),
        static_cast<const uint32_t*>(old_v), L, a.new_log2);
    ++launches[1];
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    start += st[0];
    resume = 1;
  }
}

// keys/vals (n,) u32; the HTIState arrays in place: old/new keys/vals
// (2^max_log2,) u32, the log2s, counts and pointer 0-d i32, migrating 0-d
// bool, dropped 0-d i32.  status (4,) i32 on the device.  launches[0] gets
// the insert kernel's launches, launches[1] the migration starts'.
extern "C" int hti_insert_launch(const void* keys, const void* vals, int n,
                                 void* old_keys, void* old_vals, void* new_keys,
                                 void* new_vals, void* old_log2, void* new_log2,
                                 void* old_count, void* new_count, void* ptr,
                                 void* migrating, void* dropped, int max_log2,
                                 float threshold, int batch, void* status,
                                 int* launches, void* stream_) {
  launches[0] = launches[1] = 0;
  if (n <= 0) return 0;
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = set_smem<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  OpenArgs a{};
  a.oldk = static_cast<uint32_t*>(old_keys);
  a.oldv = static_cast<uint32_t*>(old_vals);
  a.newk = static_cast<uint32_t*>(new_keys);
  a.newv = static_cast<uint32_t*>(new_vals);
  a.old_log2 = static_cast<int32_t*>(old_log2);
  a.new_log2 = static_cast<int32_t*>(new_log2);
  a.old_count = static_cast<int32_t*>(old_count);
  a.new_count = static_cast<int32_t*>(new_count);
  a.ptr = static_cast<int32_t*>(ptr);
  a.migrating = static_cast<uint8_t*>(migrating);
  a.dropped = static_cast<int32_t*>(dropped);
  a.max_log2 = max_log2;
  a.threshold = threshold;
  a.batch = batch;
  a.status = static_cast<int32_t*>(status);
  int start = 0, resume = 0;
  while (true) {
    int32_t st[3];
    err = run_open<true>(a, static_cast<const uint32_t*>(keys),
                         static_cast<const uint32_t*>(vals), n, start, resume,
                         st, stream);
    ++launches[0];
    if (err != cudaSuccess) return static_cast<int>(err);
    if (st[1] == kDone) return 0;
    hti_flip_kernel<<<grid_for(size_t{1} << st[2]), 256, 0, stream>>>(
        a.oldk, a.oldv, a.newk, a.newv, st[2]);
    ++launches[1];
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    start += st[0];
    resume = 1;
  }
}

// keys/vals (n,) u32; the CHState arrays in place: heads (2^T,) i32,
// bucket_keys/vals (C, S) u32, next_bucket/counts (C,) i32, num_buckets and
// dropped 0-d i32.  One launch.
extern "C" int ch_insert_launch(const void* keys, const void* vals, int n,
                                void* heads, void* bucket_keys,
                                void* bucket_vals, void* next_bucket,
                                void* counts, void* num_buckets, void* dropped,
                                int T, int C, int S, void* stream) {
  if (n <= 0) return 0;
  if (S < 1 || C < 0 || T < 0 || T > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = ch_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ch_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ch_insert_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(vals), n,
      static_cast<int32_t*>(heads), static_cast<uint32_t*>(bucket_keys),
      static_cast<uint32_t*>(bucket_vals), static_cast<int32_t*>(next_bucket),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(num_buckets),
      static_cast<int32_t*>(dropped), T, C, S);
  return static_cast<int>(cudaGetLastError());
}
