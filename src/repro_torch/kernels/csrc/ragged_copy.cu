// Ragged row copy, in place: view[slots[i]] = pool[offsets[i]] for i < M.
//
// Replaces the Pallas kernel of repro/kernels/ragged_copy.py (ragged_copy),
// whose grid walks i in order, so that of duplicate slots the last i wins.
// Blocks here run in no order, so the kernel first elects, for each slot,
// the largest i that writes it (reset, then atomicMax into a V-sized int32
// scratch, touching only the M entries named in `slots`), and then copies
// only the elected rows.  The result equals the sequential one.
//
// Bound: bytes.  The copy moves 2 x (distinct slots) x row_bytes; one block
// per row moves it with the widest vector loads its alignment allows (the
// wrapper picks vec_bytes from the row width and both base pointers).
#include "common.cuh"

namespace {

__global__ void reset_winner(const int32_t* __restrict__ slots,
                             int32_t* __restrict__ winner, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) winner[slots[i]] = -1;
}

__global__ void elect_winner(const int32_t* __restrict__ slots,
                             int32_t* __restrict__ winner, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) atomicMax(&winner[slots[i]], i);
}

template <typename V>
__global__ void copy_rows(const int32_t* __restrict__ slots,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ winner,
                          const V* __restrict__ pool, V* __restrict__ view,
                          int M, long long row_vecs) {
  for (int i = blockIdx.x; i < M; i += gridDim.x) {
    const int32_t s = slots[i];
    if (winner[s] != i) continue;
    const V* src = pool + static_cast<size_t>(offsets[i]) * row_vecs;
    V* dst = view + static_cast<size_t>(s) * row_vecs;
    for (long long j = threadIdx.x; j < row_vecs; j += blockDim.x) dst[j] = src[j];
  }
}

template <typename V>
void launch_copy(const int32_t* slots, const int32_t* offsets,
                 const int32_t* winner, const void* pool, void* view, int M,
                 long long row_bytes, cudaStream_t st) {
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  long long threads = ((row_vecs + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const int blocks = M < (1 << 20) ? M : (1 << 20);
  copy_rows<V><<<blocks, static_cast<int>(threads), 0, st>>>(
      slots, offsets, winner, static_cast<const V*>(pool),
      static_cast<V*>(view), M, row_vecs);
}

}  // namespace

// view (V, row) and pool (P, row) of any dtype, row_bytes each, base pointers
// aligned to vec_bytes (16, 8, 4, 2 or 1); slots/offsets (M,) i32 in range;
// winner (V,) i32 scratch, contents ignored.
extern "C" int ragged_copy_launch(void* view, const void* pool,
                                  const void* slots, const void* offsets,
                                  void* winner, int M, long long row_bytes,
                                  int vec_bytes, void* stream) {
  if (M <= 0 || row_bytes <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* of = static_cast<const int32_t*>(offsets);
  auto* w = static_cast<int32_t*>(winner);
  const int threads = 256;
  const int blocks = (M + threads - 1) / threads;
  reset_winner<<<blocks, threads, 0, st>>>(sl, w, M);
  elect_winner<<<blocks, threads, 0, st>>>(sl, w, M);
  switch (vec_bytes) {
    case 16: launch_copy<uint4>(sl, of, w, pool, view, M, row_bytes, st); break;
    case 8: launch_copy<uint2>(sl, of, w, pool, view, M, row_bytes, st); break;
    case 4: launch_copy<uint32_t>(sl, of, w, pool, view, M, row_bytes, st); break;
    case 2: launch_copy<uint16_t>(sl, of, w, pool, view, M, row_bytes, st); break;
    case 1: launch_copy<uint8_t>(sl, of, w, pool, view, M, row_bytes, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
