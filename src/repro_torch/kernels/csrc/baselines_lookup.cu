// The paper's §4.2 baselines' batch lookups (HT, HTI, CH).
//
// Replaces repro/core/baselines.py's ht_lookup_many, hti_lookup_many and
// ch_lookup_many, jitted vmaps (no Pallas kernel there; XLA compiles each into
// one device program, and these are their device-side form), so that Fig. 7b
// sets compiled lookups beside the EH kernels on the card as on the TPU.
//
//   open_lookup_kernel<false>: HT.  The home slot is the top L bits of the
//     directory hash; the probe walks the 32-slot window (home + j) mod 2^L
//     and stops at the first slot that holds the key or is EMPTY: the value
//     there if it holds the key, MISS otherwise (so the EMPTY pattern as a key
//     hits the first EMPTY slot, and a key behind an EMPTY slot is not found,
//     as in the reference).
//   open_lookup_kernel<true>: HTI.  The same probe of the fuller table first
//     (new first when new_count >= old_count), then of the other only on a
//     MISS: the reference takes the second answer only when the first is MISS.
//   ch_lookup_kernel: CH.  The chain's head from the top T bits; each bucket
//     row is searched whole for the first slot equal to the key (no EMPTY
//     stop: the EMPTY pattern finds an unused slot); on a hit its value, else
//     the next bucket, MISS at -1.  A key stops at its first hit, where the
//     reference's while_loop would not end on a stored value equal to MISS.
//
// Every scalar (size_log2; old/new log2 and counts) is read from the state's
// device memory, so a lookup makes no host sync.
//
// Bound: the card's random reads.  Each key is a short chain of dependent
// reads (HT: the home slot's sector, then its value's; HTI: that on up to two
// tables; CH: the head, the 64-byte row, then the value), and the tables
// (hundreds of MB at Fig. 7's size) do not fit in L2.  One thread a key, the
// probe read slot by slot: at HT's load of at most 0.35 a probe ends after
// one or two slots, almost always inside the home slot's 32-byte sector, so
// the window read whole (a warp on 32 slots) would move up to four times the
// sectors for nothing; many keys in flight per SM (full occupancy, few
// registers) hide the latency.  A CH row of S slots is read 64 bytes at a
// time (four 16-byte loads issued together, then scanned) when S % 4 == 0
// and the rows are 16-byte aligned, else slot by slot.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;  // the grid, at most (grid-stride beyond)
constexpr int kWindow = 32;          // the probe window (PROBE_WINDOW)

// HT: table 0.  HTI: table 0 the new table, 1 the old one.
struct OpenArgs {
  const uint32_t* keys;
  uint32_t* out;
  long long n;
  const uint32_t* tk[2];
  const uint32_t* tv[2];
  const int32_t* log2[2];
  const int32_t* count[2];
};

struct ChArgs {
  const uint32_t* keys;
  uint32_t* out;
  long long n;
  const int32_t* heads;
  const uint32_t* bk;
  const uint32_t* bv;
  const int32_t* next;
  int T, C, S;
};

// The linear probe of `key` in the table prefix [0, 2^L): the value of the
// first slot that holds the key, MISS at the first EMPTY slot or after the
// window.
__device__ __forceinline__ uint32_t open_probe(const uint32_t* __restrict__ tk,
                                               const uint32_t* __restrict__ tv,
                                               int L, uint32_t key) {
  const uint32_t mask = (1u << L) - 1u;
  const uint32_t home =
      static_cast<uint32_t>(repro::dir_slot(repro::hash_dir(key), L));
  for (int j = 0; j < kWindow; ++j) {
    const uint32_t p = (home + static_cast<uint32_t>(j)) & mask;
    const uint32_t k = __ldg(tk + p);
    if (k == key) return __ldg(tv + p);
    if (k == repro::kEmpty) return repro::kMiss;
  }
  return repro::kMiss;
}

// The tables are picked by selects, not by indexing the parameter arrays
// with `first`: an index known only at run time puts the arrays in local
// memory (an 88-byte stack frame a thread).
template <bool TWO_TABLES>
__global__ void __launch_bounds__(kThreads) open_lookup_kernel(OpenArgs a) {
  const bool swap = TWO_TABLES && __ldg(a.count[0]) < __ldg(a.count[1]);
  const uint32_t* k0 = swap ? a.tk[1] : a.tk[0];
  const uint32_t* v0 = swap ? a.tv[1] : a.tv[0];
  const uint32_t* k1 = swap ? a.tk[0] : a.tk[1];
  const uint32_t* v1 = swap ? a.tv[0] : a.tv[1];
  const int L0 = __ldg(swap ? a.log2[1] : a.log2[0]);
  const int L1 = TWO_TABLES ? __ldg(swap ? a.log2[0] : a.log2[1]) : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += stride) {
    const uint32_t key = __ldg(a.keys + i);
    uint32_t v = open_probe(k0, v0, L0, key);
    if (TWO_TABLES && v == repro::kMiss) v = open_probe(k1, v1, L1, key);
    a.out[i] = v;
  }
}

// The first slot of `row` (S slots) equal to `key`, or -1.  VEC: S % 4 == 0
// and the row 16-byte aligned; 16 slots are loaded together, then scanned
// (slots past S are filled with a value other than the key).
template <bool VEC>
__device__ __forceinline__ int row_find(const uint32_t* __restrict__ row,
                                        int S, uint32_t key) {
  if constexpr (VEC) {
    const uint32_t no = ~key;
    for (int c = 0; c < S; c += 16) {
      uint32_t x[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 q = c + 4 * u < S
            ? __ldg(reinterpret_cast<const uint4*>(row + c + 4 * u))
            : make_uint4(no, no, no, no);
        x[4 * u] = q.x;
        x[4 * u + 1] = q.y;
        x[4 * u + 2] = q.z;
        x[4 * u + 3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (x[j] == key) return c + j;
      }
    }
    return -1;
  } else {
    for (int j = 0; j < S; ++j) {
      if (__ldg(row + j) == key) return j;
    }
    return -1;
  }
}

template <bool VEC>
__device__ __forceinline__ uint32_t ch_find(const ChArgs& a, uint32_t key) {
  int32_t cur = __ldg(a.heads + repro::dir_slot(repro::hash_dir(key), a.T));
  // a chain holds at most C buckets: a longer walk is a corrupt (cyclic)
  // state, which ends as a MISS instead of never
  for (int links = 0; cur >= 0 && links < a.C; ++links) {
    const size_t row = static_cast<size_t>(cur) * static_cast<size_t>(a.S);
    const int j = row_find<VEC>(a.bk + row, a.S, key);
    if (j >= 0) return __ldg(a.bv + row + j);
    cur = __ldg(a.next + cur);
  }
  return repro::kMiss;
}

__global__ void __launch_bounds__(kThreads) ch_lookup_kernel(ChArgs a) {
  const bool vec = (a.S & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.bk) & 15u) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += stride) {
    const uint32_t key = __ldg(a.keys + i);
    a.out[i] = vec ? ch_find<true>(a, key) : ch_find<false>(a, key);
  }
}

dim3 grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

int launch_lookup(const void* kernel, long long n, void* args,
                  void* stream) {
  void* params[] = {args};
  const cudaError_t err =
      cudaLaunchKernel(kernel, grid_for(n), dim3(kThreads), params, 0,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// keys/out (n,) u32.  HT (two_tables 0): keys0/vals0 its table, log2_0 its
// size_log2 (0-d i32); the rest null.  HTI (two_tables 1): table 0 the new
// table, 1 the old one, each with its log2 and count (0-d i32).  Each table
// holds at least 2^log2 slots (the caller checks its capacity).
extern "C" int open_lookup_launch(int two_tables, const void* keys, void* out,
                                  long long n, const void* keys0,
                                  const void* vals0, const void* log2_0,
                                  const void* count0, const void* keys1,
                                  const void* vals1, const void* log2_1,
                                  const void* count1, void* stream) {
  if (n <= 0) return 0;
  OpenArgs a{};
  a.keys = static_cast<const uint32_t*>(keys);
  a.out = static_cast<uint32_t*>(out);
  a.n = n;
  a.tk[0] = static_cast<const uint32_t*>(keys0);
  a.tv[0] = static_cast<const uint32_t*>(vals0);
  a.log2[0] = static_cast<const int32_t*>(log2_0);
  a.count[0] = static_cast<const int32_t*>(count0);
  a.tk[1] = static_cast<const uint32_t*>(keys1);
  a.tv[1] = static_cast<const uint32_t*>(vals1);
  a.log2[1] = static_cast<const int32_t*>(log2_1);
  a.count[1] = static_cast<const int32_t*>(count1);
  const void* kernel =
      two_tables ? reinterpret_cast<const void*>(open_lookup_kernel<true>)
                 : reinterpret_cast<const void*>(open_lookup_kernel<false>);
  return launch_lookup(kernel, n, &a, stream);
}

// keys/out (n,) u32; the CHState arrays: heads (2^T,) i32, bucket_keys and
// bucket_vals (C, S) u32, next_bucket (C,) i32.
extern "C" int ch_lookup_launch(const void* keys, void* out, long long n,
                                const void* heads, const void* bucket_keys,
                                const void* bucket_vals,
                                const void* next_bucket, int T, int C, int S,
                                void* stream) {
  if (n <= 0) return 0;
  if (S < 1 || C < 0 || T < 0 || T > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChArgs a{};
  a.keys = static_cast<const uint32_t*>(keys);
  a.out = static_cast<uint32_t*>(out);
  a.n = n;
  a.heads = static_cast<const int32_t*>(heads);
  a.bk = static_cast<const uint32_t*>(bucket_keys);
  a.bv = static_cast<const uint32_t*>(bucket_vals);
  a.next = static_cast<const int32_t*>(next_bucket);
  a.T = T;
  a.C = C;
  a.S = S;
  return launch_lookup(reinterpret_cast<const void*>(ch_lookup_kernel), n,
                       &a, stream);
}
