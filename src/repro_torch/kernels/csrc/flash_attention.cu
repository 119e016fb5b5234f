// Flash attention, forward (prefill): causal, windowed and softcapped
// attention with GQA folded into the query tile.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel).  Its function, kept here:
//
//   s = q . k * hd^-0.5 in f32 (the TPU kernel and the SIMT kernel below
//   scale q first, the tensor-core kernel scales s: equal up to the f32
//   rounding); an optional softcap cap*tanh(s/cap); then
//   the masks, in the TPU kernel's order: kpos < Skv, causal qpos >= kpos
//   with qpos = i + Skv - Sq (q right-aligned), window kpos > qpos - window;
//   a masked score is -1e30.  A bidirectional prefix of P positions
//   (PaliGemma's image tokens; the reference model's mask, for which the
//   TPU kernel has no argument) widens the causal term by qpos < P and
//   kpos < P and the window term by kpos < P, on absolute positions: a row
//   below P sees the whole prefix whatever the tiling.  The online softmax
//   (m, l, acc) runs in f32 over key tiles, l sums the f32 p, and the
//   output is acc / max(l, 1e-30) in q's dtype.  A key tile wholly above
//   every row's diagonal, or wholly below every row's window, is skipped,
//   as the TPU kernel's in_range / pl.when does; with a prefix, every tile
//   from key 0 on is visited, up to the prefix's last tile for a CTA with a
//   row below P.  The -1e30 terms a row picks up in a tile where all its
//   keys are masked are multiplied by exp(-1e30 - m) = 0 at its first
//   visible key, so the answer does not depend on the tiling.  Causal calls
//   with Sq > Skv are refused: their first rows would see no key.
//
// Bound: operations.  A prefill layer call does 4*hd flops per visible
// (query row, key) pair on a few MB of operands: at qwen3_4b's 8 x 2048
// tokens about 2.7e11 flops against 0.3 GB, hundreds of flops per byte, so
// the bound is the bf16 tensor cores' 989 TFLOP/s (0.278 ms there).
//
// Two kernels, picked by dtype and head_dim in flash_attention_launch (no
// switch, no fallback):
//
// flash_tc_kernel<HD>: bfloat16 at hd 64, 128 and 256 (every head_dim of the
// port's configs), on the tensor cores.  A CTA takes 128 rows of the
// flattened (position, query head) axis of one (b, kv head), so the G heads
// share every K/V tile, and has 12 warps: two consumer warpgroups of 64 rows
// each and one producer warpgroup, which hands its registers to the
// consumers (setmaxnreg: 24 for it, 240 for them).  One producer thread
// streams K and V tiles (128 keys; 64 at hd 256) by TMA
// (cp.async.bulk.tensor, one 4-D tensor map (hd, Skv, KV, B) per operand
// over the caller's strides, so transposed views are read in place) into a
// ring of 3 stages (2 at hd 256) of 128-byte-swizzled shared memory, with a
// "full" and an "empty" mbarrier per stage; TMA's zero fill past Skv
// replaces the tail's bounds checks.  Q is read once with 16-byte loads
// into the same swizzled layout (its rows are (position, head) pairs, which
// TMA cannot box when G does not divide 64).  S = Q K^T is
// wgmma.m64nBKk16 (bf16 operands, both K-major in shared memory, f32
// accumulators in registers).  S is scaled by hd^-0.5 in f32, softcapped
// and masked (masks only on tiles that cross the diagonal, the window edge
// or Skv; each case its own unrolled loop), and the online softmax runs in
// base 2 (scores times log2 e, ex2.approx).  p is converted in place to
// bf16 pairs, which is the register layout of wgmma's A operand, for O +=
// P V as wgmma.m64nHDk16 with P from registers and V read MN-major from
// its (keys, hd) tile by the descriptor's transpose bit; l sums the f32 p.
// Each warpgroup issues tile i's S before tile i-1's P V and runs tile i's
// softmax while that P V is on the tensor cores (FlashAttention-3's
// intra-warpgroup overlap).  Output rows go through strides into the
// caller's buffer.  CTAs are ordered heaviest row tile first across all
// (b, kv head) pairs.
//
// flash_kernel<T, HD>: float32 at every head_dim, and bfloat16 at hd 16 and
// 32 (which only the checks use; the swizzled 128-byte rows of the
// tensor-core kernel need hd >= 64), f32 FMAs on the CUDA cores.  TF32
// tensor cores could not hold float32's 2e-5 limit.  One CTA of 256 threads
// per (b, kv head, 64 query rows), Q (pre-scaled), a K and V tile of 64
// keys and the tile's p in shared memory as f32; thread (ty, tx) of a 16 x
// 16 grid owns rows 4ty..4ty+3 and keys tx + 16j, row max and sum reduce
// over the 16 tx lanes by shuffles.  Operands are read element by element
// through strides, ragged tails bounds-checked.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// The SIMT kernel (float32; bfloat16 at hd 16 and 32).

constexpr int kRows = 64;      // query rows per CTA
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats after each Q/K row and p row in smem

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kRows * (HD + kPad) + kKeys * HD +
                          kRows * (kKeys + kPad));
}

// grid (row tiles, KV, B).  q: (B, KV, G, Sq, hd) with strides q_s*; k/v:
// (B, KV, Skv, hd) with strides k_s*/v_s*; out: (B, KV, G, Sq, hd) with
// strides o_s*.  window <= 0: none; softcap <= 0: none.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_sg,
    long long q_ss, const T* __restrict__ k, long long k_sb, long long k_sh,
    long long k_ss, const T* __restrict__ v, long long v_sb, long long v_sh,
    long long v_ss, T* __restrict__ out, long long o_sb, long long o_sh,
    long long o_sg, long long o_ss, int G, int Sq, int Skv, int causal,
    int window, int prefix, float softcap, float scale) {
  constexpr int QS = HD + kPad;                 // row stride of Qs and Ks
  constexpr int PS = kKeys + kPad;              // row stride of Ps
  constexpr int VW = HD >= 64 ? 4 : HD / 16;    // columns per vector load
  constexpr int NV = HD / (16 * VW);            // vectors per row and thread
  extern __shared__ float smem[];
  float* Qs = smem;                             // kRows x QS
  float* Ks = Qs + kRows * QS;                  // kKeys x QS
  float* Vs = Ks + kKeys * QS;                  // kKeys x HD
  float* Ps = Vs + kKeys * HD;                  // kRows x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = Sq * G, q_offset = Skv - Sq;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    float x = 0.f;
    if (row < nrows)
      x = to_float(qb[(row % G) * q_sg + (row / G) * q_ss + d]) * scale;
    Qs[r * QS + d] = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + 4 * ty + i) / G + q_offset;
  const int last = min(r0 + kRows, nrows) - 1;
  const int q_lo = r0 / G + q_offset, q_hi = last / G + q_offset;
  const int ntiles = (Skv + kKeys - 1) / kKeys;
  int t_hi = causal ? min(ntiles, q_hi / kKeys + 1) : ntiles;
  int t_lo = window > 0 ? max(0, q_lo - window + 1) / kKeys : 0;
  if (prefix > 0) {  // the prefix keys, visible to every row
    t_lo = 0;
    if (q_lo < prefix)
      t_hi = max(t_hi, min(ntiles, (prefix + kKeys - 1) / kKeys));
  }

  float m[4], l[4], acc[4][NV][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // Qs written; the last tile's Ks, Vs, Ps read
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_float(kb[kp * k_ss + d]);
        vx = to_float(vb[kp * v_ss + d]);
      }
      Ks[j * QS + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(Qs + (4 * ty + i) * QS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vec<4>(Ks + (tx + 16 * j) * QS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Skv;
        if (causal)
          ok = ok && (qpos[i] >= kp || (qpos[i] < prefix && kp < prefix));
        if (window > 0) ok = ok && (kp > qpos[i] - window || kp < prefix);
        s[i][j] = ok ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xFFFFFFFFu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(4 * ty + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        ps += __shfl_xor_sync(0xFFFFFFFFu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(Ps + (4 * ty + i) * PS + kk, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vv[VW];
          load_vec<VW>(Vs + (kk + u) * HD + c * 16 * VW + tx * VW, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[i][c][e] = fmaf(pv[i][u], vv[e], acc[i][c][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= nrows) continue;
    T* o = out + b * o_sb + h * o_sh + (row % G) * o_sg + (row / G) * o_ss;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(o + c * 16 * VW + tx * VW + e, acc[i][c][e] / lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs,
           void* out, const long long* os, int B, int KV, int G, int Sq,
           int Skv, int causal, int window, int prefix, float softcap,
           float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq * G + kRows - 1) / kRows, KV, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2], qs[3],
      static_cast<const T*>(k), ks[0], ks[1], ks[2],
      static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(out),
      os[0], os[1], os[2], os[3], G, Sq, Skv, causal, window, prefix, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The tensor-core kernel (bfloat16, hd 64/128/256).

namespace tc {

constexpr int kRows = 128;                  // query rows per CTA
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int NS = HD == 256 ? 2 : 3;     // stages of the ring
  static constexpr int CB = HD / 64;               // 128-byte column blocks
  static constexpr int Q_BLOCK = kRows * 128;      // bytes of a Q column block
  static constexpr int T_BLOCK = BK * 128;         // ... of a K or V one
  static constexpr int TILE = CB * T_BLOCK;        // one K or V tile
  static constexpr int SMEM = CB * Q_BLOCK + 2 * NS * TILE + 16 * NS + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait past 2^36 clock cycles (half a minute) traps: a fault the launch
// reports, where a lost arrival would otherwise hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023u) == 1023u) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1ll << 36)) __trap();
    }
  }
}

// One box (64 elements of hd, rows of keys, 1, 1) of a 4-D tensor map
// (hd, Skv, KV, B) into shared memory; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (1024-byte aligned atoms of 8 rows x 128 bytes): `lbo` and `sbo` in bytes.
// K-major: sbo = 1024 (the next 8 rows), lbo unused; MN-major: lbo = the
// stride between 64-element column blocks, sbo = 1024 (the next 8 rows of
// the reduction axis).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins accumulator registers after wgmma.wait_group, so that no read of
// them is scheduled before the asynchronous product has written them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What the masks of one key tile need to know of a thread's two rows: the
// masks as two bounds a row.  Key kp is visible when kp <= hi (inside Skv,
// and causal: at or below max(qpos, prefix - 1), which is the diagonal
// widened by the prefix) and when kp > lo (the window's edge, qpos - window;
// -1 without one) or kp < prefix.
struct Tile {
  int k0;        // key of the thread's first column in the tile
  int hi0, hi1, lo0, lo1;
  int prefix;
};

// S (a thread's accumulator fragment, rows 0 and 1 of the Tile, columns
// k0 + 8 n + {0, 1}) to base-2 scores in place: s * mul (= hd^-0.5 log2 e),
// or with CAP cap tanh(s * mul) * cap2 (mul = hd^-0.5 / cap, cap2 = cap
// log2 e); with MASK the masks, a masked score -1e30.  Folds each row's
// largest score into mt.
template <bool CAP, bool MASK, int NV>
__device__ __forceinline__ void scores(float (&s)[NV], float (&mt)[2],
                                       float mul, float cap2,
                                       const Tile& t) {
#pragma unroll
  for (int n = 0; n < NV / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * mul;
      if constexpr (CAP) x = cap2 * tanhf(x);
      if constexpr (MASK) {
        const int kp = t.k0 + 8 * n + (e & 1);
        const bool first = e < 2;
        const bool ok = kp <= (first ? t.hi0 : t.hi1) &&
                        (kp > (first ? t.lo0 : t.lo1) || kp < t.prefix);
        x = ok ? x : kNegInf;
      }
      s[4 * n + e] = x;
      mt[e >> 1] = fmaxf(mt[e >> 1], x);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define REPRO_D32                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define REPRO_D64                                                        \
  REPRO_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define REPRO_D128                                                         \
  REPRO_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "   \
  "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "     \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "    \
  "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "    \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127"
#define REPRO_F4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define REPRO_F16(i) \
  REPRO_F4(i), REPRO_F4(i + 4), REPRO_F4(i + 8), REPRO_F4(i + 12)
#define REPRO_F32(i) REPRO_F16(i), REPRO_F16(i + 16)
#define REPRO_F64(i) REPRO_F32(i), REPRO_F32(i + 32)

// wgmma.m64nNk16.f32.bf16.bf16.  ss: D (+)= A B with A (64 x 16) and B (16 x
// N) both K-major in shared memory (scale_d 0 overwrites D); rs: D += A B
// with A from registers (four bf16 pairs a thread) and B MN-major (the
// transpose bit) in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REPRO_D32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : REPRO_F32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REPRO_D32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : REPRO_F32(0)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REPRO_D64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : REPRO_F64(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REPRO_D64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : REPRO_F64(0)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" REPRO_D128
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : REPRO_F64(0), REPRO_F64(64)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

// grid (B * KV, row tiles): x = b * KV + kv head, y counts row tiles from
// the heaviest (latest positions) down, so the heaviest tiles of every (b,
// kv head) start first.  q: (B, KV, G, Sq, hd) with element strides q_s*,
// read in 16-byte units; k, v: the tensor maps; out: like q, strides o_s*.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh,
    long long q_sg, long long q_ss, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    long long o_sb, long long o_sh, long long o_sg, long long o_ss, int KV,
    int G, int Sq, int Skv, int causal, int window, int prefix, float softcap,
    float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NS = C::NS, CB = C::CB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // shared memory: Q (CB column blocks of kRows x 128 B), then NS stages of
  // K and V (CB column blocks of BK x 128 B each), then the barriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sq = smem_raw + (base - raw);
  const uint32_t s_kv = base + CB * C::Q_BLOCK;
  const uint32_t s_bar = s_kv + 2 * NS * C::TILE;  // full[NS], empty[NS]

  const int tid = threadIdx.x;
  const int h = blockIdx.x % KV, b = blockIdx.x / KV;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nrows = Sq * G, q_offset = Skv - Sq;
  const int last = min(r0 + kRows, nrows) - 1;
  const int q_lo = r0 / G + q_offset, q_hi = last / G + q_offset;
  const int ntiles = (Skv + BK - 1) / BK;
  int t_hi = causal ? min(ntiles, q_hi / BK + 1) : ntiles;
  int t_lo = window > 0 ? max(0, q_lo - window + 1) / BK : 0;
  if (prefix > 0) {  // the prefix keys, visible to every row
    t_lo = 0;
    if (q_lo < prefix) t_hi = max(t_hi, min(ntiles, (prefix + BK - 1) / BK));
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(s_bar + 8 * s, 1);
      mbar_init(s_bar + 8 * (NS + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The producer warpgroup gives its registers to the consumers (128 x 24 +
  // 256 x 240 of the SM's 65536) and one of its threads issues every copy.
  // The two paths never rejoin, as setmaxnreg requires.
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == kConsumers) {
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(s_bar + 8 * (NS + s), (i / NS - 1) & 1);
        const uint32_t full = s_bar + 8 * s;
        mbar_expect_tx(full, 2 * C::TILE);
        const uint32_t kt = s_kv + 2 * s * C::TILE, vt = kt + C::TILE;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load(kt + c * C::T_BLOCK, &tm_k, full, 64 * c, t * BK, h, b);
          tma_load(vt + c * C::T_BLOCK, &tm_v, full, 64 * c, t * BK, h, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the CTA's rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  {
    constexpr int CH = HD / 8;  // 16-byte chunks of a row
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    for (int i = wtid; i < 64 * CH; i += 128) {
      const int r = 64 * wg + i / CH, j = i % CH, row = r0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows)
        x = *reinterpret_cast<const uint4*>(qb + (row % G) * q_sg +
                                            (row / G) * q_ss + 8 * j);
      // 128-byte swizzle: chunk j % 8 of row r goes to chunk (j % 8) ^ (r % 8)
      *reinterpret_cast<uint4*>(sq + (j / 8) * C::Q_BLOCK + r * 128 +
                                (((j % 8) ^ (r % 8)) * 16)) = x;
    }
    // make the generic-proxy stores visible to wgmma's (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }

  // this thread's two rows (accumulator layout of wgmma.m64nN: warp w of
  // the group holds rows 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8,
  // columns 8 n + 2 (l % 4) + {0, 1} in registers 4 n + {0, 1} and
  // 4 n + {2, 3})
  const int lr = 64 * wg + 16 * (wtid / 32) + lane / 4;
  int hi[2], lo[2];  // the two rows' mask bounds (Tile)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = (r0 + lr + 8 * r) / G + q_offset;
    hi[r] = causal ? min(max(qpos, prefix - 1), Skv - 1) : Skv - 1;
    lo[r] = window > 0 ? qpos - window : -1;
  }
  const int col0 = 2 * (lane % 4);
  const uint64_t q_desc = smem_desc(base + wg * 64 * 128, 16, 1024);
  const float sl2 = scale * kLog2e;

  float o[HD / 2], s[BK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t p[BK / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // s is an operand of the first S product too, which ignores its value
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  // tile i's S = Q K^T over hd in steps of 16 (32 bytes within a 128-byte
  // block), both operands K-major in shared memory
  auto issue_s = [&](int st) {
    const uint64_t k_desc = smem_desc(s_kv + 2 * st * C::TILE, 16, 1024);
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<BK>::ss(s, q_desc + c * (C::Q_BLOCK >> 4) + 2 * kk,
                      k_desc + c * (C::T_BLOCK >> 4) + 2 * kk, c + kk > 0);
    wgmma_commit();
  };
  // O += P V over a tile's keys in steps of 16 (16 rows of 128 bytes), P
  // from registers, V MN-major in shared memory
  auto issue_pv = [&](int st) {
    const uint64_t v_desc =
        smem_desc(s_kv + (2 * st + 1) * C::TILE, C::T_BLOCK, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<HD>::rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                     p[4 * kk + 3], v_desc + kk * (2048 >> 4));
    wgmma_commit();
  };
  // tile i's scale, softcap and masks, then the online softmax in base 2:
  // m, l and corr updated, s holding the f32 p.  A tile skips the masks
  // when none can fire for any of the CTA's rows: every key inside Skv,
  // every key at or below the lowest row's position (or every key and every
  // row inside the prefix), and every key above the highest row's window
  // edge (or every key inside the prefix).  So a tile crossing the
  // diagonal, the window edge, Skv or the prefix's end is masked, and so is
  // a prefix tile past the diagonal of a CTA that reaches past the prefix.
  float corr[2];
  auto softmax = [&](int i) {
    const int k0 = (t_lo + i) * BK;
    const bool keys_in_prefix = k0 + BK <= prefix;
    const bool edge =
        k0 + BK > Skv ||
        (causal && k0 + BK - 1 > q_lo && !(keys_in_prefix && q_hi < prefix)) ||
        (window > 0 && k0 <= q_hi - window && !keys_in_prefix);
    float mt[2] = {m[0], m[1]};
    const Tile tile{k0 + col0, hi[0], hi[1], lo[0], lo[1], prefix};
    if (softcap > 0.f) {
      const float mul = scale / softcap;
      if (edge) scores<true, true>(s, mt, mul, softcap * kLog2e, tile);
      else scores<true, false>(s, mt, mul, softcap * kLog2e, tile);
    } else {
      if (edge) scores<false, true>(s, mt, sl2, 0.f, tile);
      else scores<false, false>(s, mt, sl2, 0.f, tile);
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xFFFFFFFFu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xFFFFFFFFu, mt[r], 2));
      corr[r] = ex2(m[r] - mt[r]);
      m[r] = mt[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(s[4 * n + e] - m[e >> 1]);
        ps[e >> 1] += pe;
        s[4 * n + e] = pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
  };
  // O rescaled to the new row maxima (once no P V writes it), and the f32
  // p converted in place: registers 8 kk .. 8 kk + 7 of S are the A
  // fragment of keys 16 kk .. 16 kk + 15
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };
  auto full = [&](int st) { return s_bar + 8 * st; };
  auto empty = [&](int st) { return s_bar + 8 * (NS + st); };

  // Tile i's S = Q K^T is issued before tile i-1's O += P V, and tile i's
  // softmax runs while that P V is still on the tensor cores.
  const int n_t = t_hi - t_lo;
  if (n_t > 0) {
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    rescale_and_pack();
    for (int i = 1; i < n_t; ++i) {
      const int st = i % NS, pst = (i - 1) % NS;
      mbar_wait(full(st), (i / NS) & 1);
      wgmma_fence();
      issue_s(st);
      issue_pv(pst);
      wgmma_wait<1>();  // S done, P V may still run
      fence_regs(s);
      softmax(i);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(pst));  // stage free
      rescale_and_pack();
    }
    wgmma_fence();
    issue_pv((n_t - 1) % NS);
    wgmma_wait<0>();
    fence_regs(o);
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 1);
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + lr + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* orow = ob + (row % G) * o_sg + (row / G) * o_ss + col0;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          o[4 * n + 2 * r] / lc[r], o[4 * n + 2 * r + 1] / lc[r]);
  }
}

#undef REPRO_F64
#undef REPRO_F32
#undef REPRO_F16
#undef REPRO_F4
#undef REPRO_D128
#undef REPRO_D64
#undef REPRO_D32

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

constexpr int kTensorMapError = 10000;  // + the CUresult of the encode

// A 4-D map (hd, Skv, KV, B) over k or v with element strides s (b, kv
// head, position), boxes of (64, rows, 1, 1), 128-byte swizzle, zero fill
// past the edges.  An axis of length 1 gets the stride of a contiguous
// layout (its own is never used).
int make_map(CUtensorMap* map, const void* base, const long long* s, int B,
             int KV, int Skv, int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(Skv),
                              cuuint64_t(KV), cuuint64_t(B)};
  const long long elem[3] = {s[2], s[1], s[0]};
  cuuint64_t strides[3];
  cuuint64_t inner = cuuint64_t(hd) * 2;
  for (int d = 0; d < 3; ++d) {
    strides[d] = dims[d + 1] == 1 ? inner : cuuint64_t(elem[d]) * 2;
    inner = strides[d] * dims[d + 1];
  }
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs,
           void* out, const long long* os, int B, int KV, int G, int Sq,
           int Skv, int causal, int window, int prefix, float softcap,
           float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  const long long row_tiles = (static_cast<long long>(Sq) * G + kRows - 1) /
                              kRows;
  if (row_tiles > 65535 || static_cast<long long>(B) * KV > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  int e = make_map(&tm_k, k, ks, B, KV, Skv, HD, C::BK);
  if (e != 0) return e;
  e = make_map(&tm_v, v, vs, B, KV, Skv, HD, C::BK);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid(B * KV, static_cast<unsigned>(row_tiles));
  flash_tc_kernel<HD><<<grid, kThreads, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), qs[0], qs[1], qs[2], qs[3], tm_k,
      tm_v, static_cast<__nv_bfloat16*>(out), os[0], os[1], os[2], os[3], KV,
      G, Sq, Skv, causal, window, prefix, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T>
int launch_hd(int hd, const void* q, const long long* qs, const void* k,
              const long long* ks, const void* v, const long long* vs,
              void* out, const long long* os, int B, int KV, int G, int Sq,
              int Skv, int causal, int window, int prefix, float softcap,
              float scale, cudaStream_t st) {
#define REPRO_SIMT(HD)                                                      \
  return launch<T, HD>(q, qs, k, ks, v, vs, out, os, B, KV, G, Sq, Skv,     \
                       causal, window, prefix, softcap, scale, st)
#define REPRO_TC(HD)                                                        \
  return tc::launch<HD>(q, qs, k, ks, v, vs, out, os, B, KV, G, Sq, Skv,    \
                        causal, window, prefix, softcap, scale, st)
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) {
      case 16: REPRO_SIMT(16);
      case 32: REPRO_SIMT(32);
      case 64: REPRO_SIMT(64);
      case 128: REPRO_SIMT(128);
      case 256: REPRO_SIMT(256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (hd) {
      case 16: REPRO_SIMT(16);
      case 32: REPRO_SIMT(32);
      case 64: REPRO_TC(64);
      case 128: REPRO_TC(128);
      case 256: REPRO_TC(256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef REPRO_TC
#undef REPRO_SIMT
}

}  // namespace

// Dynamic shared memory of one tensor-core CTA at head_dim hd (0: none).
extern "C" int flash_tc_smem_bytes(int hd) {
  switch (hd) {
    case 64: return tc::Cfg<64>::SMEM;
    case 128: return tc::Cfg<128>::SMEM;
    case 256: return tc::Cfg<256>::SMEM;
    default: return 0;
  }
}

// bf16: 0 float32, 1 bfloat16.  q_strides: 4 element strides (b, kv head,
// g, position); k_strides, v_strides: 3 (b, kv head, position; a 4th entry
// is ignored); out_strides: 4 as q's.  The last axis of every operand has
// stride 1.  hd in {16, 32, 64, 128, 256}.  causal: 0 or 1 (with causal,
// Sq <= Skv); window <= 0: none; prefix_len <= 0: none (else the length of
// the bidirectional prefix); softcap <= 0: none; scale: hd^-0.5 rounded to
// float by the caller.  bfloat16 at hd 64, 128 and 256 takes the
// tensor-core kernel, which needs q, k and v 16-byte aligned with strides
// (of axes longer than 1) in multiples of 16 bytes, and returns 10000 + the
// CUresult when a tensor map cannot be made (10000: the encoder was not
// found).
extern "C" int flash_attention_launch(
    int bf16, const void* q, const long long* q_strides, const void* k,
    const long long* k_strides, const void* v, const long long* v_strides,
    void* out, const long long* out_strides, int B, int KV, int G, int Sq,
    int Skv, int hd, int causal, int window, int prefix_len, float softcap,
    float scale, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int prefix = prefix_len > 0 ? prefix_len : 0;
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, q_strides, k, k_strides, v,
                                    v_strides, out, out_strides, B, KV, G,
                                    Sq, Skv, causal, window, prefix, softcap,
                                    scale, st);
  return launch_hd<float>(hd, q, q_strides, k, k_strides, v, v_strides, out,
                          out_strides, B, KV, G, Sq, Skv, causal, window,
                          prefix, softcap, scale, st);
}
