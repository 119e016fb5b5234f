// Hashing and warp-wide probes shared by the Shortcut-EH kernels.
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

// Position of `key` in `row` (S slots) along the cyclic probe sequence from
// `start`, or -1: the first hit that no EMPTY slot precedes.  The whole warp
// calls it and gets the same answer; it reads 32 consecutive probe positions
// per step and stops at the first step holding a hit or an EMPTY.
__device__ __forceinline__ int warp_find(const uint32_t* row, int S,
                                         uint32_t key, uint32_t start,
                                         int lane) {
  for (int base = 0; base < S; base += 32) {
    const int j = base + lane;
    const bool in = j < S;
    const uint32_t k = in ? row[(start + j) % S] : 0u;
    const unsigned hit = __ballot_sync(kFullMask, in && k == key);
    const unsigned emp = __ballot_sync(kFullMask, in && k == kEmpty);
    if (hit | emp) {
      const int fh = hit ? __ffs(hit) - 1 : 32;
      const int fe = emp ? __ffs(emp) - 1 : 32;
      // fh == fe only for key == EMPTY, which the reference counts as a hit
      return (hit && fh <= fe) ? static_cast<int>((start + base + fh) % S)
                               : -1;
    }
  }
  return -1;
}

// First position along the probe sequence that holds `key` or is EMPTY
// (the insert slot), or -1 when the row is full and the key absent.
__device__ __forceinline__ int warp_first_usable(const uint32_t* row, int S,
                                                 uint32_t key, uint32_t start,
                                                 int lane) {
  for (int base = 0; base < S; base += 32) {
    const int j = base + lane;
    const bool in = j < S;
    const uint32_t k = in ? row[(start + j) % S] : 0u;
    const unsigned ok = __ballot_sync(kFullMask, in && (k == key || k == kEmpty));
    if (ok) return static_cast<int>((start + base + __ffs(ok) - 1) % S);
  }
  return -1;
}

}  // namespace repro
