// Hashing and the lane-group probe shared by the Shortcut-EH kernels.
//
// The constants and the first-empty-terminates rule are those of
// repro_torch/core/hashing.py (and of the JAX package's core/hashing.py);
// the tests hold the kernels to both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr uint32_t kHashC1 = 2654435761u;  // directory hash
constexpr uint32_t kHashC2 = 0x9E3779B1u;  // bucket-slot hash
constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // slot unused
constexpr uint32_t kMiss = 0xFFFFFFFFu;    // lookup miss
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t hash_dir(uint32_t key) {
  return key * kHashC1;  // unsigned: wraps mod 2^32
}

__device__ __forceinline__ uint32_t hash_bucket(uint32_t key) {
  const uint32_t k = key * kHashC2;
  return k ^ (k >> 16);
}

// Top `depth` bits of h; depth 0 is slot 0 (a shift by 32 is undefined).
__device__ __forceinline__ int32_t dir_slot(uint32_t h, int32_t depth) {
  return depth == 0 ? 0 : static_cast<int32_t>(h >> (32 - depth));
}

template <bool NC>
__device__ __forceinline__ uint32_t load1(const uint32_t* p) {
  if constexpr (NC) return __ldg(p);
  return *p;
}

template <bool NC>
__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  if constexpr (NC) return __ldg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// One step of the probe of `key` in `row` (S slots) along the cyclic probe
// sequence from `start`: the search for the first slot that holds `key` or
// is EMPTY.  A lookup hits iff that slot holds the key (so the EMPTY
// pattern as a key hits the first EMPTY slot); an insert writes there.
//
// Every lane of the warp calls it, in groups of G consecutive lanes, each
// group serving its own key (`active` false for a group with none); `t0`,
// a multiple of G, is the group's step base.  Returns true (the same on
// every lane of the group) when the probe is over: `*pos` is then that
// slot, or -1 when none of the S slots is one, and `*at` what it holds.
// Two paths:
//   * vector (S a multiple of 4, S >= 4 G; rows 16-byte aligned): lane r
//     reads chunk visit t0 + r, 16 bytes, so the group reads G consecutive
//     chunks of the probe sequence.  The first chunk holds `start` at
//     offset o = start % 4; its slots below o come last in probe order, so
//     that chunk is visited twice when o != 0: at visit 0 masked to
//     [o, 4), at visit S/4 masked to [0, o);
//   * scalar (otherwise): lane r reads the slot at probe distance t0 + r.
// NC selects the read-only path (`ld.global.nc`) for data no thread writes
// during the kernel (the lookups); the insert reads with plain loads.
template <int G, bool NC>
__device__ __forceinline__ bool probe_step(const uint32_t* row, int S,
                                           uint32_t key, uint32_t start,
                                           int t0, bool active, int* pos,
                                           uint32_t* at) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
                "G divides the warp");
  const int lane = threadIdx.x & 31;
  const int r = lane % G;
  const unsigned gbits =
      G == 32 ? kFullMask : ((1u << G) - 1u) << (lane - r);
  int hit = -1;
  uint32_t x = 0u;
  int steps;  // chunk visits (vector) or slots (scalar) of the sequence
  if ((S & 3) == 0 && S >= 4 * G) {
    const int nc = S >> 2;
    const int c0 = static_cast<int>(start >> 2);
    const int o = static_cast<int>(start & 3u);
    steps = o ? nc + 1 : nc;
    const int t = t0 + r;
    if (active && t < steps) {
      const int c = c0 + t < nc ? c0 + t : c0 + t - nc;
      const uint4 q = load4<NC>(row + 4 * c);
      const uint32_t xs[4] = {q.x, q.y, q.z, q.w};
      const int jlo = t == 0 ? o : 0;
      const int jhi = t == nc ? o : 4;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        if (j >= jlo && j < jhi && (xs[j] == key || xs[j] == kEmpty)) {
          hit = 4 * c + j;
          x = xs[j];
        }
      }
    }
  } else {
    steps = S;
    const int d = t0 + r;
    if (active && d < S) {
      const int s = static_cast<int>(start);
      const int p = s + d < S ? s + d : s + d - S;
      const uint32_t v = load1<NC>(row + p);
      if (v == key || v == kEmpty) {
        hit = p;
        x = v;
      }
    }
  }
  const unsigned m = __ballot_sync(kFullMask, hit >= 0) & gbits;
  const int src = m ? __ffs(m) - 1 : lane;
  *pos = __shfl_sync(kFullMask, hit, src);
  *at = __shfl_sync(kFullMask, x, src);
  return m != 0u || t0 + G >= steps;
}

// The whole probe (probe_step until the group's probe is over): the first
// slot holding `key` or EMPTY, or -1; `*at` gets what it holds.  Called by
// every lane of the warp, G lanes a key; a group with `active` false gets
// -1.
template <int G, bool NC>
__device__ __forceinline__ int group_probe(const uint32_t* row, int S,
                                           uint32_t key, uint32_t start,
                                           bool active, uint32_t* at) {
  bool done = !active;
  int pos = -1;
  uint32_t val = 0u;
  for (int t0 = 0; __any_sync(kFullMask, !done); t0 += G) {
    int p;
    uint32_t v;
    const bool over = probe_step<G, NC>(row, S, key, start, t0, !done, &p, &v);
    if (!done && over) {
      pos = p;
      val = v;
      done = true;
    }
  }
  *at = val;
  return pos;
}

}  // namespace repro
