// The paper's §4.2 baselines' batch inserts (HT, HTI, CH).
//
// Replaces repro/core/baselines.py's ht_insert_many, hti_insert_many and
// ch_insert_many, per-key lax.scans (no Pallas kernel there; this is their
// device-side form).  Where a key lands depends on the order of the keys (and
// for HT's doubling on the order of the old slots), so the kernels keep both
// orders and leave every state array bit-identical to the reference.
//
// HT and HTI: one cooperative kernel a batch over the whole card, bound by
// the bytes it moves and the grid-wide rounds it takes, no longer by a
// sequential walk.  The batch is an insert stream (HT: the keys; HTI: the
// live old slots each insert migrates, then the key; HT's doubling: the old
// table's entries in old-slot order), and an item's priority is its stream
// position.  Sequential linear probing with no deletes is what claim rounds
// reach, so the stream is placed in segments of at most kSegment positions:
//
//   * records (one grid pass): each item's home and its 32-slot probe
//     window as two masks, EMPTY slots and slots holding the key (a warp
//     reads 32 windows, a lane a slot), read as the segment begins;
//   * map: a hash keyed by key gives each key the first and the last
//     position among its items.  Only a key's first item walks; the others
//     hit the slot it ends in or drop with it, and the slot gets the last
//     item's value (duplicates, re-inserts and HTI's stale overwrite).  The
//     EMPTY pattern is not grouped: it writes its value into the first slot
//     still EMPTY at its position and occupies nothing;
//   * claim rounds: a walking item passes slots filled by other keys, stops
//     at a slot that holds its key, claims an EMPTY slot by atomicMin of its
//     priority in an owner array (never in the key array); a loser moves on,
//     a settled item outbid later moves on again, and only unsettled items
//     go on to the next round (a compacted list); a grid-wide sync between
//     rounds, no host sync;
//   * the load test: a segment ends before the first key whose test may
//     fire, found from a prefix count that takes every first item as fresh
//     (an upper bound); after the writes an exact count decides whether it
//     fires there (HT doubles by the same placement of the old entries into
//     the cleared, doubled table; HTI starts a migration) or the next
//     segment begins.  Earlier segments stay final: later items never
//     displace earlier ones.
//
// CH: one block a batch.  All warps resolve a window's records (the chain's
// tail bucket and its count, from the state as the window begins); warp 0
// commits in key order, 32 keys a step; a key whose chain an earlier key of
// its window has goes alone, at the chain as the window left it (a map of
// the window's chains in shared memory); new buckets go in key order by a
// prefix count.  Bound: latency (three dependent reads a key).
//
// The state is updated in place; the caller hands in a copy (copy-on-write).
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;     // == ch_insert_kernel's __launch_bounds__
constexpr int kWindowKeys = 1024;  // CH: keys a window
constexpr int kProbe = 32;         // the probe window (PROBE_WINDOW)
constexpr size_t kMaxShared = 232448;
constexpr int kPlaceThreads = 512;  // == place_kernel's __launch_bounds__
constexpr long long kSegment = 1ll << 22;  // open tables: positions a segment
constexpr int32_t kFree = INT_MAX;  // an unclaimed slot
constexpr int kMaxBlocks = 4096;    // the placement grid's blocks at most
constexpr int kMaxRounds = 1 << 16;  // a segment's claim rounds, at most

// A record's kind and its state in the claim rounds
enum Kind : uint8_t { kNone = 0, kKey = 1, kOld = 2 };
enum State : uint8_t {
  kWalk = 0, kSettled = 1, kHit = 2, kDropped = 3, kFound = 4
};

// The placement's control words (zeroed by the launcher): two list counters
// (alternate rounds) and the counts' accumulators, only ever incremented, so
// no thread resets what another may still read; the position a prefix count
// found; the statistics (kStatWords from kStat).
constexpr int kCtr0 = 0;
constexpr int kAccNew = 2;   // fresh slots
constexpr int kAccOld = 3;   // migrated entries (each leaves the old table)
constexpr int kAccDrop = 4;  // dropped keys
constexpr int kAt = 5;
constexpr int kStat = 8;
constexpr int kCtlWords = 16;
// statistics
constexpr int kSegments = 0;     // a records and map pass and a write pass each
constexpr int kCountPasses = 1;  // prefix counts for a segment end
constexpr int kRounds = 2;       // claim rounds (a claim and a check pass each)
constexpr int kMostRounds = 3;   // the most one segment took
constexpr int kEvents = 4;       // doublings (HT) or migration starts (HTI)
constexpr int kGridThreads = 5;
constexpr int kError = 6;        // 0, or the cudaError the launcher returns
constexpr int kStatWords = 7;
constexpr int kLaunchStats = 7;  // the ints a launcher reports
static_assert(kStat + kStatWords <= kCtlWords, "control words");

// One item of an open table's insert stream, at its stream position.
struct Rec {
  uint32_t key, val;
  uint32_t emp;   // bit j: slot home + j EMPTY as the segment began
  uint32_t hit;   // bit j: slot home + j held the key then
  int32_t home;   // home slot in the table the stream goes to
  int32_t ent;    // the key's map entry (-1: the EMPTY pattern)
  int32_t src;    // HTI's migrated old slot (cleared when placed), else -1
  uint8_t kind, state, pos, first;  // pos: the window offset reached
};
static_assert(sizeof(Rec) == 32, "Rec");

// Dynamic shared memory of CH's insert kernel: the window's records and its
// chain map of 2R entries (16 bytes an entry).
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

__host__ __device__ constexpr size_t ch_smem_bytes() {
  return kWindowKeys * (sizeof(ChRec) + 2 * 16);
}
static_assert(ch_smem_bytes() + 256 <= kMaxShared,
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

// The key map's hash: the murmur3 finalizer.  Not the tables' multiplicative
// hash: old entries come in old-slot order, sorted by its top bits, and a
// segment of them would crowd one part of the map.
__device__ __forceinline__ uint32_t key_hash(uint32_t x, int log2) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >> (32 - log2);
}

// The entry of `key` in the key map in device memory (any key but the
// EMPTY pattern, its free mark), claimed if new.
__device__ __forceinline__ int32_t key_entry(uint32_t* keys, int log2,
                                             uint32_t key) {
  const uint32_t m = (1u << log2) - 1u;
  uint32_t e = key_hash(key, log2);
  while (true) {
    const uint32_t old = atomicCAS(keys + e, repro::kEmpty, key);
    if (old == repro::kEmpty || old == key) return static_cast<int32_t>(e);
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

// HTI's stream, counted from the run's first key: key k' = k - resume
// (key 0 of a resumed run migrates nothing) first migrates its old slots
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

// ---- HT and HTI: placement by claim rounds --------------------------------

// The open tables' state, in place, and the placement's work space.  HT: the
// table is (tk, tv), its log2 and count `log2` and `count`; the old-table
// fields are unused.  HTI: (tk, tv) is the new table, (ok, ov) the old.
struct PlaceArgs {
  const uint32_t* keys;
  const uint32_t* vals;
  int n;
  uint32_t* tk;
  uint32_t* tv;
  uint32_t* ok;
  uint32_t* ov;
  int32_t* log2;
  int32_t* old_log2;
  int32_t* count;
  int32_t* old_count;
  int32_t* ptr;
  uint8_t* migrating;
  int32_t* dropped;
  int max_log2;
  float threshold;
  int batch;         // HTI's migrate_batch (HT: 1)
  Rec* rec;          // seg_cap records
  long long seg_cap;
  uint32_t* mkey;    // the key map: 2^map_log2 entries
  int32_t* mfirst;
  int32_t* mlast;
  int map_log2;
  int32_t* list;     // two lists of seg_cap record indices
  int32_t* owner;    // 2^owner_log2 slots' claims (kFree: none)
  int owner_log2;
  uint32_t* stage_k;  // HT's doubling: the old table, 2^stage_log2 slots
  uint32_t* stage_v;
  int stage_log2;
  int32_t* bcount;   // a count a block
  unsigned long long* ctl;
};

// One run of a stream: positions [0, vtot) placed into the table of 2^L
// slots; a doubling's (old entries from the stage, nothing counted) or the
// batch's from key `key0` on (HTI: with the migration's P, D and B).
struct Run {
  long long vtot;
  int L;
  bool doubling;
  long long key0;
  int resume;
  long long P, D, B;
};

// What every thread keeps in step: the counts as of the last write pass and
// the control words' values it last read.
struct Ctx {
  long long c_new, c_old, dropped;
  unsigned long long base[2];  // the list counters' values at their last read
  unsigned long long acc[3];   // the accumulators' values at their last read
  long long stat[kStatWords];
  int* sums;                   // 33 ints of shared memory
  long long* shared2;          // 2 long longs of shared memory
};

__device__ __forceinline__ long long grid_tid() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_threads() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

__device__ __forceinline__ Rec load_rec(const Rec* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = __ldcg(q);
  const uint4 y = __ldcg(q + 1);
  Rec r;
  r.key = x.x;
  r.val = x.y;
  r.emp = x.z;
  r.hit = x.w;
  r.home = static_cast<int32_t>(y.x);
  r.ent = static_cast<int32_t>(y.y);
  r.src = static_cast<int32_t>(y.z);
  r.kind = y.w & 0xffu;
  r.state = (y.w >> 8) & 0xffu;
  r.pos = (y.w >> 16) & 0xffu;
  r.first = y.w >> 24;
  return r;
}

// The least count C whose load test f32(C) + 1 > thr fires.
__device__ __forceinline__ long long trigger_count(float thr) {
  long long lo = 0, hi = INT_MAX;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (__fadd_rn(__ll2float_rn(mid), 1.0f) > thr) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ bool load_fires(long long c, float thr) {
  return __fadd_rn(__ll2float_rn(c), 1.0f) > thr;
}

// Append `item` to `list` for each lane that `wants` (all 32 lanes call);
// the list's counter is only incremented, so the slot is counter - base.
__device__ __forceinline__ void push(int32_t* list, unsigned long long* ctr,
                                     unsigned long long base, bool wants,
                                     int32_t item) {
  const unsigned m = __ballot_sync(repro::kFullMask, wants);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned long long at = 0;
  if (lane == leader) {
    at = atomicAdd(ctr, static_cast<unsigned long long>(__popc(m)));
  }
  at = __shfl_sync(repro::kFullMask, at, leader);
  if (wants) list[at - base + __popc(m & ((1u << lane) - 1u))] = item;
}

// The sum of x over the block (every thread calls it and gets the sum).
__device__ __forceinline__ long long block_sum(long long x, long long* sh) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x += __shfl_down_sync(repro::kFullMask, x, d);
  }
  if (threadIdx.x == 0) sh[0] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && x) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sh),
              static_cast<unsigned long long>(x));
  }
  __syncthreads();
  const long long s = sh[0];
  __syncthreads();
  return s;
}

// The item at stream position v of run r: its kind, key, value and HTI's
// old slot.
template <bool HTI>
__device__ __forceinline__ Kind item_at(const PlaceArgs& a, const Run& r,
                                        long long v, uint32_t* key,
                                        uint32_t* val, int32_t* src) {
  *src = -1;
  if (r.doubling) {
    const uint32_t k = __ldcg(a.stage_k + v);
    if (k == repro::kEmpty) return kNone;
    *key = k;
    *val = __ldcg(a.stage_v + v);
    return kOld;
  }
  long long k = v;
  if (HTI) {
    long long d = 0;
    if (!stream_at(v, r.resume, r.B, r.D, &d, &k)) {
      const long long s = r.P + d;
      const uint32_t kk = __ldcg(a.ok + s);
      if (kk == repro::kEmpty) return kNone;  // nothing to migrate
      *key = kk;
      *val = __ldcg(a.ov + s);
      *src = static_cast<int32_t>(s);
      return kOld;
    }
  }
  *key = __ldg(a.keys + r.key0 + k);
  *val = __ldg(a.vals + r.key0 + k);
  return kKey;
}

// Records of positions [s0, s1) and the key map (first positions).  A warp
// takes 32 positions; lane j reads slot home + j of each item's window (16
// reads in flight), and two ballots give the item's masks.  A table under
// 32 slots has a window of its size (the reference's wrapped positions
// repeat those slots).
template <bool HTI>
__device__ void records_pass(const PlaceArgs& a, const Run& r, long long s0,
                             long long s1, int M) {
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << r.L) - 1u;
  const bool in = lane < (r.L >= 5 ? kProbe : (1 << r.L));
  for (long long i0 = s0 + grid_tid() - lane; i0 < s1; i0 += grid_threads()) {
    const long long v = i0 + lane;
    uint32_t key = 0u, val = 0u;
    int32_t src = -1;
    Kind kind = kNone;
    if (v < s1) kind = item_at<HTI>(a, r, v, &key, &val, &src);
    const bool has = kind != kNone;
    const uint32_t home =
        has ? static_cast<uint32_t>(repro::dir_slot(repro::hash_dir(key), r.L))
            : 0u;
    const unsigned items = __ballot_sync(repro::kFullMask, has);
    uint32_t emp = 0u, hit = 0u;
#pragma unroll
    for (int half = 0; half < 32; half += 16) {
      uint32_t x[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const uint32_t h = __shfl_sync(repro::kFullMask, home, half + t);
        x[t] = (in && ((items >> (half + t)) & 1u))
                   ? __ldcg(a.tk + ((h + lane) & mask)) : 0u;
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
    if (v >= s1) continue;
    int32_t ent = -1;
    if (has && key != repro::kEmpty) {
      ent = key_entry(a.mkey, M, key);
      atomicMin(a.mfirst + ent, static_cast<int32_t>(v));
    }
    uint4* out = reinterpret_cast<uint4*>(a.rec + (v - s0));
    out[0] = make_uint4(key, val, emp, hit);
    out[1] = make_uint4(home, static_cast<uint32_t>(ent),
                        static_cast<uint32_t>(src), kind);  // kWalk, pos 0
  }
}

// An item the prefix count takes as +1: a key (not a migrated entry) that
// is its key's first item or the EMPTY pattern.
__device__ __forceinline__ int counted(const PlaceArgs& a, long long s0,
                                       long long v) {
  const Rec r = load_rec(a.rec + (v - s0));
  return r.kind == kKey &&
         (r.key == repro::kEmpty || __ldcg(a.mfirst + r.ent) == v);
}

// The block tiles of [s0, s1) the prefix count takes, whole multiples of the
// block.
__device__ __forceinline__ void block_tile(long long s0, long long s1,
                                           long long* lo, long long* hi) {
  const long long len = s1 - s0;
  long long t = (len + gridDim.x - 1) / gridDim.x;
  t = (t + blockDim.x - 1) / blockDim.x * blockDim.x;
  *lo = min(s1, s0 + blockIdx.x * t);
  *hi = min(s1, *lo + t);
}

// The end of the segment from s0: the position of the first key whose load
// test may fire (an upper-bound prefix count: every first item fresh), or
// -1 if none is below s1.  The whole grid calls it (it syncs the grid).
__device__ long long segment_end(const PlaceArgs& a, cg::grid_group& grid,
                                 Ctx& c, long long s0, long long s1,
                                 long long need, long long E0) {
  if (need <= 0) {
    const long long at = max(E0, s0);
    return at < s1 ? at : -1;
  }
  if (E0 >= s1 || need > s1 - s0) return -1;
  long long lo, hi;
  block_tile(s0, s1, &lo, &hi);
  long long mine = 0;
  for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    mine += counted(a, s0, v);
  }
  mine = block_sum(mine, c.shared2);
  if (threadIdx.x == 0) a.bcount[blockIdx.x] = static_cast<int32_t>(mine);
  ++c.stat[kCountPasses];
  grid.sync();
  // the blocks before this one, and all of them
  if (threadIdx.x < 32) {
    long long before = 0, total = 0;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += 32) {
      const long long x = __ldcg(a.bcount + b);
      total += x;
      if (b < static_cast<int>(blockIdx.x)) before += x;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_down_sync(repro::kFullMask, before, d);
      total += __shfl_down_sync(repro::kFullMask, total, d);
    }
    if (threadIdx.x == 0) {
      c.shared2[0] = before;
      c.shared2[1] = total;
    }
  }
  __syncthreads();
  const long long before = c.shared2[0], total = c.shared2[1];
  __syncthreads();
  if (need > total) return -1;  // the same in every block
  if (before < need && need <= before + mine) {  // this block holds it
    long long run = before;
    for (long long b0 = lo; b0 < hi; b0 += blockDim.x) {
      const long long v = b0 + threadIdx.x;
      const int f = v < hi ? counted(a, s0, v) : 0;
      int tot;
      const int ex = block_scan(f, c.sums, &tot);
      if (f && run + ex + 1 == need) {
        a.ctl[kAt] = static_cast<unsigned long long>(v);
      }
      run += tot;
      if (run >= need) break;
    }
  }
  grid.sync();
  const long long u = static_cast<long long>(__ldcg(a.ctl + kAt));
  const long long at = max(u + 1, E0);
  return at < s1 ? at : -1;
}

// Place the records of [s0, end): claim rounds, the EMPTY pattern, writes.
// The counts' changes go to the accumulators.
__device__ void place_segment(const PlaceArgs& a, cg::grid_group& grid,
                              Ctx& c, int L, long long s0, long long end) {
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << L) - 1u;
  const int win = L >= 5 ? kProbe : (1 << L);
  const uint32_t wbits = win == 32 ? repro::kFullMask : (1u << win) - 1u;
  const long long len = end - s0;
  // each key's last position; its first item into list 0
  for (long long i0 = grid_tid() - lane; i0 < len; i0 += grid_threads()) {
    const long long i = i0 + lane;
    bool walks = false;
    if (i < len) {
      const Rec r = load_rec(a.rec + i);
      if (r.kind != kNone && r.key != repro::kEmpty) {
        const int32_t v = static_cast<int32_t>(s0 + i);
        atomicMax(a.mlast + r.ent, v);
        walks = __ldcg(a.mfirst + r.ent) == v;
        if (walks) a.rec[i].first = 1;
      }
    }
    push(a.list, a.ctl + kCtr0, c.base[0], walks, static_cast<int32_t>(i));
  }
  grid.sync();
  unsigned long long t = __ldcg(a.ctl + kCtr0);
  long long nA = static_cast<long long>(t - c.base[0]);
  c.base[0] = t;
  int p = 0, rounds = 0;
  while (nA > 0) {
    if (++rounds > kMaxRounds) {
      c.stat[kError] = cudaErrorLaunchTimeout;
      break;
    }
    const int q = p ^ 1;
    const int32_t* A = a.list + p * a.seg_cap;
    int32_t* Bl = a.list + q * a.seg_cap;
    // claim: the next usable slot of each item's window
    for (long long i0 = grid_tid() - lane; i0 < nA; i0 += grid_threads()) {
      const long long i = i0 + lane;
      bool moves = false;
      int32_t x = 0;
      if (i < nA) {
        const int32_t ia = __ldcg(A + i);
        const Rec r = load_rec(a.rec + ia);
        const uint32_t above = r.pos >= 32 ? 0u : ~((1u << r.pos) - 1u);
        const uint32_t bits = (r.emp | r.hit) & wbits & above;
        if (bits == 0u) {
          a.rec[ia].state = kDropped;
        } else {
          const int j = __ffs(bits) - 1;
          a.rec[ia].pos = static_cast<uint8_t>(j);
          if ((r.hit >> j) & 1u) {
            a.rec[ia].state = kHit;
          } else {
            const uint32_t s = (static_cast<uint32_t>(r.home) + j) & mask;
            const int32_t prio = static_cast<int32_t>(s0 + ia);
            const int32_t old = atomicMin(a.owner + s, prio);
            if (old != kFree && old > prio) {
              // outbid: a settled item moves on (one claimant sees it)
              const int32_t xo = static_cast<int32_t>(old - s0);
              if (__ldcg(&a.rec[xo].state) == kSettled) {
                a.rec[xo].state = kWalk;
                a.rec[xo].pos =
                    static_cast<uint8_t>(__ldcg(&a.rec[xo].pos) + 1);
                moves = true;
                x = xo;
              }
            }
          }
        }
      }
      push(Bl, a.ctl + kCtr0 + q, c.base[q], moves, x);
    }
    grid.sync();
    // check: the lowest claim holds the slot, the others move on
    for (long long i0 = grid_tid() - lane; i0 < nA; i0 += grid_threads()) {
      const long long i = i0 + lane;
      bool moves = false;
      int32_t ia = 0;
      if (i < nA) {
        ia = __ldcg(A + i);
        const Rec r = load_rec(a.rec + ia);
        if (r.state == kWalk) {
          const uint32_t s = (static_cast<uint32_t>(r.home) + r.pos) & mask;
          if (__ldcg(a.owner + s) == static_cast<int32_t>(s0 + ia)) {
            a.rec[ia].state = kSettled;
          } else {
            a.rec[ia].pos = static_cast<uint8_t>(r.pos + 1);
            moves = true;
          }
        }
      }
      push(Bl, a.ctl + kCtr0 + q, c.base[q], moves, ia);
    }
    grid.sync();
    t = __ldcg(a.ctl + kCtr0 + q);
    nA = static_cast<long long>(t - c.base[q]);
    c.base[q] = t;
    p = q;
  }
  c.stat[kRounds] += rounds;
  c.stat[kMostRounds] =
      max(c.stat[kMostRounds], static_cast<long long>(rounds));
  // the EMPTY pattern: the first slot still EMPTY at its position; of those
  // no key claims, the last such writer's value stays (the most negative)
  for (long long i = grid_tid(); i < len; i += grid_threads()) {
    const Rec r = load_rec(a.rec + i);
    if (r.kind != kKey || r.key != repro::kEmpty) continue;
    const int32_t prio = static_cast<int32_t>(s0 + i);
    uint8_t st = kDropped, pos = 0;
    for (uint32_t bits = r.emp & wbits; bits; bits &= bits - 1u) {
      const int j = __ffs(bits) - 1;
      const uint32_t s = (static_cast<uint32_t>(r.home) + j) & mask;
      const int32_t o = __ldcg(a.owner + s);
      if (o < 0 || o > prio) {  // unclaimed, or claimed later
        st = kFound;
        pos = static_cast<uint8_t>(j);
        if (o == kFree || o < 0) atomicMin(a.owner + s, -1 - prio);
        break;
      }
    }
    a.rec[i].state = st;
    a.rec[i].pos = pos;
  }
  grid.sync();
  // the writes: a key's slot gets its last item's value; claims go
  long long fresh = 0, moved = 0, drops = 0;
  for (long long i = grid_tid(); i < len; i += grid_threads()) {
    const Rec r = load_rec(a.rec + i);
    if (r.kind == kNone) continue;
    const int32_t prio = static_cast<int32_t>(s0 + i);
    const uint32_t s = (static_cast<uint32_t>(r.home) + r.pos) & mask;
    if (r.key == repro::kEmpty) {
      if (r.state == kFound) {
        if (__ldcg(a.owner + s) == -1 - prio) {
          a.tv[s] = r.val;
          a.owner[s] = kFree;
        }
        ++fresh;
      } else {
        ++drops;
      }
      continue;
    }
    // a follower takes its key's first item's fate
    const uint8_t st =
        r.first ? r.state
                : __ldcg(&a.rec[__ldcg(a.mfirst + r.ent) - s0].state);
    if (r.first && (st == kSettled || st == kHit)) {
      const int32_t l = __ldcg(a.mlast + r.ent);
      a.tk[s] = r.key;
      a.tv[s] = l == prio ? r.val : __ldcg(&a.rec[l - s0].val);
      if (st == kSettled) {
        a.owner[s] = kFree;
        ++fresh;
      }
    }
    if (r.src >= 0) {
      a.ok[r.src] = repro::kEmpty;
      ++moved;
    } else if (r.kind == kKey && st == kDropped) {
      ++drops;
    }
  }
  fresh = block_sum(fresh, c.shared2);
  moved = block_sum(moved, c.shared2);
  drops = block_sum(drops, c.shared2);
  if (threadIdx.x == 0) {
    using ull = unsigned long long;
    if (fresh) atomicAdd(a.ctl + kAccNew, static_cast<ull>(fresh));
    if (moved) atomicAdd(a.ctl + kAccOld, static_cast<ull>(moved));
    if (drops) atomicAdd(a.ctl + kAccDrop, static_cast<ull>(drops));
  }
}

// Place run r's stream in segments.  With `test`, a segment ends before the
// first key whose load test may fire; returns the position of the key whose
// test fired (-1: none).  The counts follow the writes unless r.doubling.
template <bool HTI>
__device__ long long place_stream(const PlaceArgs& a, cg::grid_group& grid,
                                  Ctx& c, const Run& r, bool test,
                                  long long E0) {
  const float thr = a.threshold * static_cast<float>(1u << r.L);
  const long long cstar = trigger_count(thr);
  for (long long s0 = 0; s0 < r.vtot && !c.stat[kError];) {
    const long long s1 = min(s0 + a.seg_cap, r.vtot);
    const long long len = s1 - s0;
    // the map at most half full (2^M >= 2 len), 32 entries at least
    const int M = min(a.map_log2,
                      max(5, 64 - __clzll(static_cast<unsigned long long>(
                                      2 * len - 1))));
    for (long long e = grid_tid(); e < (1ll << M); e += grid_threads()) {
      a.mkey[e] = repro::kEmpty;
      a.mfirst[e] = INT_MAX;
      a.mlast[e] = -1;
    }
    grid.sync();
    records_pass<HTI>(a, r, s0, s1, M);
    ++c.stat[kSegments];
    grid.sync();
    const long long at = test ? segment_end(a, grid, c, s0, s1,
                                            cstar - (c.c_new + c.c_old), E0)
                              : -1;
    const long long end = at >= 0 ? at : s1;
    place_segment(a, grid, c, r.L, s0, end);
    grid.sync();
    unsigned long long now[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) now[k] = __ldcg(a.ctl + kAccNew + k);
    if (!r.doubling) {
      c.c_new += static_cast<long long>(now[0] - c.acc[0]);
      c.c_old -= static_cast<long long>(now[1] - c.acc[1]);
      c.dropped += static_cast<long long>(now[2] - c.acc[2]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) c.acc[k] = now[k];
    if (at >= 0 && load_fires(c.c_new + c.c_old, thr)) return at;
    s0 = end;
  }
  return -1;
}

// HT (HTI false) and HTI's batch insert: one cooperative launch, the whole
// batch.
// Two blocks an SM (64 registers a thread): the passes are bound by random
// reads and atomics, which want warps in flight more than registers.
template <bool HTI>
__global__ void __launch_bounds__(kPlaceThreads, 2)
    place_kernel(PlaceArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int sums[33];
  __shared__ long long shared2[2];
  Ctx c{};
  c.sums = sums;
  c.shared2 = shared2;
  int L = *a.log2;
  int oL = HTI ? *a.old_log2 : 0;
  c.c_new = *a.count;
  c.c_old = HTI ? *a.old_count : 0;
  c.dropped = *a.dropped;
  long long P = HTI ? *a.ptr : 0;
  bool mig = HTI && *a.migrating != 0;
  const long long B = HTI ? a.batch : 1;
  // the owner array covers the largest table the batch may reach
  const int owner_log2 = a.owner_log2;
  if (L > owner_log2) c.stat[kError] = cudaErrorInvalidValue;
  for (long long s = grid_tid(); s < (1ll << min(L, owner_log2));
       s += grid_threads()) {
    a.owner[s] = kFree;
  }
  grid.sync();
  Run r{};
  long long key0 = 0;
  int resume = 0;
  while (!c.stat[kError]) {
    // the run from key key0: its stream and the first key that may fire
    const long long E = 1ll << oL;
    r = Run{0, L, false, key0, resume, P,
            HTI && mig && P < E ? E - P : 0, B};
    const long long nk = a.n - key0;
    const long long kd = (r.D + B - 1) / B;
    const long long kl = nk - 1 - resume;
    r.vtot = !HTI ? nk
                  : (kl < 0 ? 1 : resume + 1 + kl + min(B * (kl + 1), r.D));
    const long long E0 = resume + max(kd - 1, 0ll) + r.D;
    const long long at = place_stream<HTI>(a, grid, c, r, L < a.max_log2, E0);
    if (at < 0) break;
    ++c.stat[kEvents];
    const long long size = 1ll << L;
    if (L + 1 > owner_log2 || (!HTI && L > a.stage_log2)) {
      c.stat[kError] = cudaErrorInvalidValue;  // past the work space
      break;
    }
    if (!HTI) {
      // double: the old table staged, the doubled one cleared, then the
      // old entries placed into it in old-slot order (lost past a window)
      for (long long s = grid_tid(); s < size; s += grid_threads()) {
        a.stage_k[s] = __ldcg(a.tk + s);
        a.stage_v[s] = __ldcg(a.tv + s);
        a.tk[s] = repro::kEmpty;
        a.tv[s] = 0u;
        a.tk[s + size] = repro::kEmpty;
        a.tv[s + size] = 0u;
        a.owner[s + size] = kFree;
      }
      grid.sync();
      const Run d{size, L + 1, true, 0, 0, 0, 0, 1};
      place_stream<HTI>(a, grid, c, d, false, 0);
      L += 1;
      key0 += at;
    } else {
      // start a migration (the flip): the new table becomes the old one
      for (long long s = grid_tid(); s < size; s += grid_threads()) {
        a.ok[s] = __ldcg(a.tk + s);
        a.ov[s] = __ldcg(a.tv + s);
        a.tk[s] = repro::kEmpty;
        a.tv[s] = 0u;
        a.owner[s + size] = kFree;
      }
      grid.sync();
      oL = L;
      L += 1;
      c.c_old = c.c_new;
      c.c_new = 0;
      P = 0;
      mig = true;
      key0 += at - r.D;
    }
    resume = 1;
  }
  if (grid_tid() == 0) {
    c.stat[kGridThreads] = grid_threads();
    for (int k = 0; k < kStatWords; ++k) {
      a.ctl[kStat + k] = static_cast<unsigned long long>(c.stat[k]);
    }
    if (c.stat[kError]) return;
    *a.log2 = L;
    *a.count = static_cast<int32_t>(c.c_new);
    *a.dropped = static_cast<int32_t>(c.dropped);
    if (HTI) {
      *a.old_log2 = oL;
      *a.old_count = static_cast<int32_t>(c.c_old);
      if (mig) {
        const long long moved = B * (a.n - key0 - resume);
        *a.ptr = static_cast<int32_t>(P + min(moved, r.D));
        *a.migrating = moved < r.D ? 1 : 0;
      }
    }
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

// The open tables' work space, carved from one buffer and sized from the
// batch: the control words, the blocks' counts, the records, the key map
// and the two lists of a segment of at most min(kSegment, positions)
// positions (positions: the longest run of the stream the batch may place,
// its keys, the migrated slots among them, a doubling's old slots); the
// claims' owner array of 2^owner_log2 slots (the largest table the batch
// may reach); and HT's doubling stage of the old table, 2^stage_log2 slots
// (the largest table it may double from; -1: none).
struct Layout {
  long long seg_cap;
  int map_log2;
  size_t bcount, rec, mkey, mfirst, mlast, list, owner, stage_k, stage_v,
      total;
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

Layout open_layout(long long positions, int owner_log2, int stage_log2) {
  Layout l{};
  l.seg_cap = std::max(1ll, std::min(kSegment, positions));
  l.map_log2 = 5;
  while ((1ll << l.map_log2) < 2 * l.seg_cap) ++l.map_log2;
  const size_t entries = size_t{1} << l.map_log2;
  const size_t stage = stage_log2 >= 0 ? size_t{1} << stage_log2 : 0;
  size_t at = align256(kCtlWords * sizeof(unsigned long long));
  l.bcount = at;
  at = align256(at + kMaxBlocks * sizeof(int32_t));
  l.rec = at;
  at = align256(at + l.seg_cap * sizeof(Rec));
  l.mkey = at;
  at = align256(at + entries * sizeof(uint32_t));
  l.mfirst = at;
  at = align256(at + entries * sizeof(int32_t));
  l.mlast = at;
  at = align256(at + entries * sizeof(int32_t));
  l.list = at;
  at = align256(at + 2 * l.seg_cap * sizeof(int32_t));
  l.owner = at;
  at = align256(at + (size_t{1} << owner_log2) * sizeof(int32_t));
  l.stage_k = at;
  at = align256(at + stage * sizeof(uint32_t));
  l.stage_v = at;
  at = align256(at + stage * sizeof(uint32_t));
  l.total = at;
  return l;
}

// Point a's work-space arrays into `work` (open_layout's bytes).
void carve(PlaceArgs& a, long long positions, int owner_log2, int stage_log2,
           void* work) {
  const Layout l = open_layout(positions, owner_log2, stage_log2);
  char* w = static_cast<char*>(work);
  a.ctl = reinterpret_cast<unsigned long long*>(w);
  a.bcount = reinterpret_cast<int32_t*>(w + l.bcount);
  a.rec = reinterpret_cast<Rec*>(w + l.rec);
  a.seg_cap = l.seg_cap;
  a.mkey = reinterpret_cast<uint32_t*>(w + l.mkey);
  a.mfirst = reinterpret_cast<int32_t*>(w + l.mfirst);
  a.mlast = reinterpret_cast<int32_t*>(w + l.mlast);
  a.map_log2 = l.map_log2;
  a.list = reinterpret_cast<int32_t*>(w + l.list);
  a.owner = reinterpret_cast<int32_t*>(w + l.owner);
  a.owner_log2 = owner_log2;
  a.stage_k = reinterpret_cast<uint32_t*>(w + l.stage_k);
  a.stage_v = reinterpret_cast<uint32_t*>(w + l.stage_v);
  a.stage_log2 = stage_log2;
}

// One cooperative launch of place_kernel<HTI> over every SM, as many blocks
// as fit at once; then the statistics to `stats` (the stream synced):
// [launches, segments, count passes, claim rounds, most rounds in a
// segment, events, grid threads].
template <bool HTI>
int run_place(PlaceArgs& a, int* stats, cudaStream_t stream) {
  std::fill(stats, stats + kLaunchStats, 0);
  if (a.owner_log2 < 0 || a.owner_log2 > 31 || a.stage_log2 > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, place_kernel<HTI>, kPlaceThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = std::min(per_sm * sms, kMaxBlocks);
  if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaMemsetAsync(a.ctl, 0, kCtlWords * sizeof(unsigned long long),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(place_kernel<HTI>),
                                    blocks, kPlaceThreads, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long st[kStatWords];
  err = cudaMemcpyAsync(st, a.ctl + kStat, sizeof(st), cudaMemcpyDeviceToHost,
                        stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fields[] = {kSegments, kCountPasses, kRounds, kMostRounds,
                        kEvents, kGridThreads};
  stats[0] = 1;
  for (int k = 0; k < 6; ++k) stats[1 + k] = static_cast<int>(st[fields[k]]);
  return static_cast<int>(st[kError]);
}

}  // namespace

// Bytes of the open tables' work space (`work` of the two launchers).
extern "C" long long open_work_bytes(long long positions, int owner_log2,
                                     int stage_log2) {
  return static_cast<long long>(
      open_layout(positions, owner_log2, stage_log2).total);
}

// keys/vals (n,) u32; the HTState arrays in place: keys/vals (2^max_log2,)
// u32, size_log2/count/dropped 0-d i32.  work: open_work_bytes(positions,
// owner_log2, stage_log2) bytes, with positions >= max(n, 2^stage_log2),
// owner_log2 >= max(size_log2, stage_log2 + 1), and stage_log2 the largest
// table the batch may double from (-1: none; a doubling from a larger one
// is an error); stats: kLaunchStats ints (run_place).
extern "C" int ht_insert_launch(const void* keys, const void* vals, int n,
                                void* tkeys, void* tvals, void* size_log2,
                                void* count, void* dropped, int max_log2,
                                float threshold, void* work,
                                long long positions, int owner_log2,
                                int stage_log2, int* stats, void* stream) {
  std::fill(stats, stats + kLaunchStats, 0);
  if (n <= 0) return 0;
  PlaceArgs a{};
  a.keys = static_cast<const uint32_t*>(keys);
  a.vals = static_cast<const uint32_t*>(vals);
  a.n = n;
  a.tk = static_cast<uint32_t*>(tkeys);
  a.tv = static_cast<uint32_t*>(tvals);
  a.log2 = static_cast<int32_t*>(size_log2);
  a.count = static_cast<int32_t*>(count);
  a.dropped = static_cast<int32_t*>(dropped);
  a.max_log2 = max_log2;
  a.threshold = threshold;
  a.batch = 1;
  carve(a, positions, owner_log2, stage_log2, work);
  return run_place<false>(a, stats, static_cast<cudaStream_t>(stream));
}

// keys/vals (n,) u32; the HTIState arrays in place: old/new keys/vals
// (2^max_log2,) u32, the log2s, counts and pointer 0-d i32, migrating 0-d
// bool, dropped 0-d i32.  work: open_work_bytes(positions, owner_log2, -1)
// bytes, with positions the longest run (n + 1 keys and the old slots one
// migration moves) and owner_log2 the largest new table the batch may
// reach; stats: as HT's.
extern "C" int hti_insert_launch(const void* keys, const void* vals, int n,
                                 void* old_keys, void* old_vals, void* new_keys,
                                 void* new_vals, void* old_log2, void* new_log2,
                                 void* old_count, void* new_count, void* ptr,
                                 void* migrating, void* dropped, int max_log2,
                                 float threshold, int batch, void* work,
                                 long long positions, int owner_log2,
                                 int* stats, void* stream) {
  std::fill(stats, stats + kLaunchStats, 0);
  if (n <= 0) return 0;
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  PlaceArgs a{};
  a.keys = static_cast<const uint32_t*>(keys);
  a.vals = static_cast<const uint32_t*>(vals);
  a.n = n;
  a.ok = static_cast<uint32_t*>(old_keys);
  a.ov = static_cast<uint32_t*>(old_vals);
  a.tk = static_cast<uint32_t*>(new_keys);
  a.tv = static_cast<uint32_t*>(new_vals);
  a.old_log2 = static_cast<int32_t*>(old_log2);
  a.log2 = static_cast<int32_t*>(new_log2);
  a.old_count = static_cast<int32_t*>(old_count);
  a.count = static_cast<int32_t*>(new_count);
  a.ptr = static_cast<int32_t*>(ptr);
  a.migrating = static_cast<uint8_t*>(migrating);
  a.dropped = static_cast<int32_t*>(dropped);
  a.max_log2 = max_log2;
  a.threshold = threshold;
  a.batch = batch;
  carve(a, positions, owner_log2, -1, work);
  return run_place<true>(a, stats, static_cast<cudaStream_t>(stream));
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
