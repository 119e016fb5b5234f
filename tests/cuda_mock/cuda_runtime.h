// A stand-in for the CUDA runtime, to compile a kernel source for the CPU
// with g++ (-std=c++20 -pthread) and run it at a small grid: every CUDA
// thread is an OS thread; __syncthreads, the grid sync and each warp's
// collectives are barriers (a lane that skips one deadlocks here as the
// card would hang); atomics take one mutex.  It checks what a kernel
// computes, never how fast; only a build on the card checks what nvcc
// accepts.  tests/test_torch_baselines_mock.py uses it.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchTimeout = 6,
  cudaErrorLaunchOutOfResources = 7,
};
using cudaStream_t = void*;
enum cudaMemcpyKind { cudaMemcpyDeviceToHost = 2 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace mock {
inline int sms = 3;  // blocks of a cooperative grid (one per "SM")
struct Warp {
  std::barrier<> bar{32};
  uint64_t v[32];
};
inline std::vector<Warp*> warps;
inline std::vector<std::barrier<>*> blocks;
inline std::barrier<>* grid = nullptr;
inline std::vector<std::vector<std::vector<char>>> shared;  // [block][slot]
inline std::mutex mu;
inline int lane() { return threadIdx.x & 31; }
inline Warp& warp() {
  return *warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
}
// Every lane posts x; each gets lane src's.
template <class T>
T exchange(T x, int src) {
  Warp& w = warp();
  uint64_t b = 0;
  std::memcpy(&b, &x, sizeof(T));
  w.v[lane()] = b;
  w.bar.arrive_and_wait();
  const uint64_t r = w.v[src];
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
// A block's __shared__ array number `slot` (at most kSharedBytes bytes).
constexpr size_t kSharedBytes = 16384;
template <class T>
T* block_shared(int slot) {
  return reinterpret_cast<T*>(shared[blockIdx.x][slot].data());
}
// Runs a cooperative launch; set by the harness, which knows the kernels.
inline cudaError_t (*launch)(const void*, dim3, dim3, void**) = nullptr;

// All gx * bx threads of a grid run K(a) at once.
template <class A, void (*K)(A)>
cudaError_t run_grid(dim3 g, dim3 b, void** args) {
  const A a = *static_cast<A*>(args[0]);
  blockDim = b;
  gridDim = g;
  const unsigned nt = g.x * b.x;
  grid = new std::barrier<>(nt);
  blocks.clear();
  for (unsigned i = 0; i < g.x; ++i) blocks.push_back(new std::barrier<>(b.x));
  warps.clear();
  for (unsigned i = 0; i < nt / 32; ++i) warps.push_back(new Warp());
  shared.assign(g.x, std::vector<std::vector<char>>(
                         8, std::vector<char>(kSharedBytes)));
  std::vector<std::thread> ts;
  for (unsigned blk = 0; blk < g.x; ++blk) {
    for (unsigned t = 0; t < b.x; ++t) {
      ts.emplace_back([=] {
        blockIdx = dim3(blk);
        threadIdx = dim3(t);
        K(a);
      });
    }
  }
  for (auto& t : ts) t.join();
  for (auto* p : blocks) delete p;
  for (auto* p : warps) delete p;
  delete grid;
  return cudaSuccess;
}
}  // namespace mock

inline void __syncthreads() { mock::blocks[blockIdx.x]->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  mock::Warp& w = mock::warp();
  w.v[mock::lane()] = p;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (w.v[i] ? 1u : 0u) << i;
  w.bar.arrive_and_wait();
  return m;
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  mock::warp().bar.arrive_and_wait();
}
template <class T>
T __shfl_sync(unsigned, T x, int src) {
  return mock::exchange(x, src & 31);
}
template <class T>
T __shfl_up_sync(unsigned, T x, unsigned d) {
  const int s = mock::lane() - static_cast<int>(d);
  return mock::exchange(x, s < 0 ? mock::lane() : s);
}
template <class T>
T __shfl_down_sync(unsigned, T x, unsigned d) {
  const int s = mock::lane() + static_cast<int>(d);
  return mock::exchange(x, s > 31 ? mock::lane() : s);
}
template <class T>
T __ldg(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}
template <class T>
T __ldcg(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}
inline uint4 __ldg(const uint4* p) {
  const volatile unsigned* q = reinterpret_cast<const volatile unsigned*>(p);
  return uint4{q[0], q[1], q[2], q[3]};
}
inline uint4 __ldcg(const uint4* p) { return __ldg(p); }
template <class T>
T __ldcs(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}
inline uint4 __ldcs(const uint4* p) { return __ldg(p); }
template <class T>
void __stcs(T* p, T v) {
  *reinterpret_cast<volatile T*>(p) = v;
}
template <class T>
T atomicMin(T* p, T v) {
  std::lock_guard<std::mutex> g(mock::mu);
  const T o = *p;
  if (v < o) *p = v;
  return o;
}
template <class T>
T atomicMax(T* p, T v) {
  std::lock_guard<std::mutex> g(mock::mu);
  const T o = *p;
  if (v > o) *p = v;
  return o;
}
template <class T>
T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> g(mock::mu);
  const T o = *p;
  *p = o + v;
  return o;
}
template <class T>
T atomicCAS(T* p, T c, T v) {
  std::lock_guard<std::mutex> g(mock::mu);
  const T o = *p;
  if (o == c) *p = v;
  return o;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clzll(unsigned long long x) { return x ? __builtin_clzll(x) : 64; }
inline float __ll2float_rn(long long x) { return static_cast<float>(x); }
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = mock::sms;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  std::memcpy(d, s, n);
  return cudaSuccess;
}
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaLaunchCooperativeKernel(const void* f, dim3 g, dim3 b,
                                               void** args, size_t = 0,
                                               cudaStream_t = nullptr) {
  return mock::launch(f, g, b, args);
}
