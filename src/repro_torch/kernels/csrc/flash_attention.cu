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
// the bound is the bf16 tensor cores' 989 TFLOP/s (0.278 ms there).  In
// float32 it is 3xTF32's three TF32 products a product at 494.7 TFLOP/s
// (0.834 ms at the serve CLI's 4 x 2048 tokens; the CUDA cores' 67 TFLOP/s
// would give 2.052 ms).
//
// Three kernels, picked by dtype and head_dim in flash_attention_launch (no
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
// flash_tf32x3_kernel<HD>: float32 at hd 64, 128 and 256, on the tensor
// cores in 3xTF32.  One TF32 product keeps 11 significant bits of each
// operand (a relative error near 2^-11), which float32's 2e-5 limit does not
// allow; the error-compensated form (CUTLASS's OpMultiplyAddFastF32) does.
// Each operand x is split into big = tf32(x) and small = tf32(x - big)
// (x - big is exact in f32), both rounded to nearest with ties away from
// zero on the f32 bits ((bits + 0x1000) & ~0x1FFF, which is what
// cvt.rna.tf32.f32 computes), and a product is small*big + big*small +
// big*big accumulated in f32: about 22 bits of each product survive, and
// the dropped small*small term is under 2^-22 of it.  Both S = Q K^T and
// O += P V run so, p (in [0, 1]) split like the others; l sums the f32 p.
// The instruction is mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, three for
// each 16 x 8 x 8 step.  The tensor cores add inside a chain of mma's with
// truncation: with O accumulated across all keys (3 x 256 products at 2048
// keys) the kernel sat at 0.3 of the limit and went past it on large
// softcapped scores.  So every chain is two k-steps (six mma's) from zero,
// and its sum goes into the f32 total by an add that rounds to nearest.
// A CTA takes 128 rows of the flattened (position, query head) axis (GQA
// folded in, as above) and has 8 warps, each owning 16 rows; K and V tiles
// of BK = 4096 / hd keys arrive by 16-byte cp.async (zero fill past Skv)
// into a ring of NS stages, and the copies of tile i + NS - 1 run while
// tile i is computed.  Q is copied once a CTA, and every tile is kept
// unsplit in shared memory, rows padded by 4 floats so that each fragment
// load hits 32 banks; Q's and K's fragments come by ldmatrix (four 8 x 4
// f32 matrices a call), V's by 32-bit loads, and the threads split what
// they load, in registers (no tensor holds the small parts; splitting K and
// V once a CTA into shared memory was timed and did not pay for its
// shared memory).  Geometry (254 registers a thread, no spills):
//   hd 64:  BK 64, NS 3, 139264 B of shared memory;
//   hd 128: BK 32, NS 2, 135168 B;
//   hd 256: BK 16, NS 2, 199680 B.
// S's accumulators become P V's A fragments with no shuffle: m16n8k8's C
// fragment gives thread (g = lane / 4, t = lane % 4) the keys 2t and 2t + 1
// of an 8-key block in rows g and g + 8, where the A fragment wants columns
// t and t + 4.  So P V's reduction column t stands for key 2t and column
// t + 4 for key 2t + 1: A = {c0, c2, c1, c3}, and the B fragment reads V's
// rows 2t and 2t + 1 (the sum over keys does not depend on their order).
// Masks (masks only on edge tiles), the base-2 online softmax (scores times
// hd^-0.5 log2 e, ex2.approx.ftz: its relative error, about 2^-22, stays far
// under the 2e-5 limit) and the heaviest-first CTA order are the bf16
// kernel's, one copy of each for both (tc::row_bounds, tc::edge_tile,
// tc::online_softmax; cta_span, which the SIMT kernel takes too).  What bounds it: mma.sync in TF32 peaks at about 320 TFLOP/s
// on an H100 (tools/mma_tf32_peak.py), 65% of the data sheet's rate, which
// only wgmma reaches; so the instruction's own ceiling for 3xTF32 is about
// 107 TFLOP/s of float32 work.
//
// flash_kernel<T, HD>: bfloat16 and float32 at hd 16 and 32 (which only the
// checks use; the tensor-core kernels' tiles need hd >= 64), f32 FMAs on
// the CUDA cores.  One CTA of 256 threads per (b, kv head, 64 query rows),
// Q (pre-scaled), a K and V tile of 64 keys and the tile's p in shared
// memory as f32; thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and
// keys tx + 16j, row max and sum reduce over the 16 tx lanes by shuffles.
// Operands are read element by element through strides, ragged tails
// bounds-checked.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// What a CTA of ROWS rows of the flattened (position, query head) axis
// visits, for all three kernels.  The grid's row tiles are ordered
// heaviest first: the CTA with index idx of n takes rows r0 = (n - 1 - idx)
// ROWS on, at positions q_lo .. q_hi (q right-aligned, q_offset = Skv -
// Sq).  Its key tiles of BK keys are [t_lo, t_hi): none wholly above its
// last row's diagonal, none wholly below its first row's window; with a
// prefix, every tile from key 0 on, up to the prefix's last tile where a
// row sits below P.
struct Span {
  int r0, q_lo, q_hi, t_lo, t_hi;
};

template <int ROWS, int BK>
__device__ __forceinline__ Span cta_span(int n, int idx, int G, int Sq,
                                         int Skv, int causal, int window,
                                         int prefix) {
  Span c;
  c.r0 = (n - 1 - idx) * ROWS;
  const int q_offset = Skv - Sq, last = min(c.r0 + ROWS, Sq * G) - 1;
  c.q_lo = c.r0 / G + q_offset;
  c.q_hi = last / G + q_offset;
  const int ntiles = (Skv + BK - 1) / BK;
  c.t_hi = causal ? min(ntiles, c.q_hi / BK + 1) : ntiles;
  c.t_lo = window > 0 ? max(0, c.q_lo - window + 1) / BK : 0;
  if (prefix > 0) {  // the prefix keys, visible to every row
    c.t_lo = 0;
    if (c.q_lo < prefix)
      c.t_hi = max(c.t_hi, min(ntiles, (prefix + BK - 1) / BK));
  }
  return c;
}

// ---------------------------------------------------------------------------
// The SIMT kernel (float32 and bfloat16 at hd 16 and 32).

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
  const Span cta = cta_span<kRows, kKeys>(gridDim.x, blockIdx.x, G, Sq,
                                          Skv, causal, window, prefix);
  const int r0 = cta.r0, h = blockIdx.y, b = blockIdx.z;
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

  for (int t = cta.t_lo; t < cta.t_hi; ++t) {
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

// A Tile's bounds hi and lo for the row at position qpos.
__device__ __forceinline__ void row_bounds(int qpos, int Skv, int causal,
                                           int window, int prefix, int& hi,
                                           int& lo) {
  hi = causal ? min(max(qpos, prefix - 1), Skv - 1) : Skv - 1;
  lo = window > 0 ? qpos - window : -1;
}

// Whether the key tile [k0, k0 + bk) needs its masks for a CTA whose rows
// sit at positions q_lo .. q_hi.  It does not when none can fire for any
// of those rows: every key inside Skv, every key at or below the lowest
// row's position (or every key and every row inside the prefix), and every
// key above the highest row's window edge (or every key inside the
// prefix).  So a tile crossing the diagonal, the window edge, Skv or the
// prefix's end is masked, and so is a prefix tile past the diagonal of a
// CTA that reaches past the prefix.
__device__ __forceinline__ bool edge_tile(int k0, int bk, int Skv, int causal,
                                          int window, int prefix, int q_lo,
                                          int q_hi) {
  const bool keys_in_prefix = k0 + bk <= prefix;
  return k0 + bk > Skv ||
         (causal && k0 + bk - 1 > q_lo && !(keys_in_prefix && q_hi < prefix)) ||
         (window > 0 && k0 <= q_hi - window && !keys_in_prefix);
}

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

// One key tile of the online softmax, in base 2, for a thread's two rows:
// S (its accumulator fragment, as scores() takes it) scaled by hd^-0.5,
// softcapped and, on an edge tile, masked; then m (the running row maxima,
// base 2), corr (exp2 of the old maxima minus the new), l (the running sums
// of the f32 p, over the thread's own columns) updated, and s holding the
// f32 p.  The row maxima reduce over the 4 threads of a row (lanes 4 g ..
// 4 g + 3).
template <int NV>
__device__ __forceinline__ void online_softmax(float (&s)[NV], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               bool edge, const Tile& tile,
                                               float softcap, float scale) {
  float mt[2] = {m[0], m[1]};
  if (softcap > 0.f) {
    const float mul = scale / softcap;
    if (edge) scores<true, true>(s, mt, mul, softcap * kLog2e, tile);
    else scores<true, false>(s, mt, mul, softcap * kLog2e, tile);
  } else {
    if (edge) scores<false, true>(s, mt, scale * kLog2e, 0.f, tile);
    else scores<false, false>(s, mt, scale * kLog2e, 0.f, tile);
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
  for (int n = 0; n < NV / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(s[4 * n + e] - m[e >> 1]);
      ps[e >> 1] += pe;
      s[4 * n + e] = pe;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
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
  const Span cta = cta_span<kRows, BK>(gridDim.y, blockIdx.y, G, Sq, Skv,
                                       causal, window, prefix);
  const int r0 = cta.r0, t_lo = cta.t_lo, t_hi = cta.t_hi;
  const int nrows = Sq * G, q_offset = Skv - Sq;

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
  for (int r = 0; r < 2; ++r)
    row_bounds((r0 + lr + 8 * r) / G + q_offset, Skv, causal, window, prefix,
               hi[r], lo[r]);
  const int col0 = 2 * (lane % 4);
  const uint64_t q_desc = smem_desc(base + wg * 64 * 128, 16, 1024);

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
  // tile i's scale, softcap and masks (on edge tiles only), then the
  // online softmax in base 2: m, l and corr updated, s holding the f32 p
  float corr[2];
  auto softmax = [&](int i) {
    const int k0 = (t_lo + i) * BK;
    online_softmax(s, m, l, corr,
                   edge_tile(k0, BK, Skv, causal, window, prefix, cta.q_lo,
                             cta.q_hi),
                   Tile{k0 + col0, hi[0], hi[1], lo[0], lo[1], prefix},
                   softcap, scale);
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

// ---------------------------------------------------------------------------
// The float32 tensor-core kernel (3xTF32, hd 64/128/256).

namespace tf32x3 {

template <int HD>
struct Cfg {
  static constexpr int ROWS = 128;          // query rows per CTA
  static constexpr int THREADS = 256;       // 8 warps of 16 rows
  static constexpr int BK = 4096 / HD;      // keys per K/V tile
  static constexpr int NS = HD == 64 ? 3 : 2;  // stages of the ring
  static constexpr int LD = HD + 4;         // floats a row in smem
  static constexpr int TILE = BK * LD;      // floats of a K or V tile
  static constexpr int SMEM = 4 * (ROWS * LD + 2 * NS * TILE);
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + (under 2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d (+)= a b, one mma.sync.m16n8k8 in TF32 (a: 16 x 8 row-major fragment,
// b: 8 x 8 column-major, d: 16 x 8 f32); ZERO: d = a b
template <bool ZERO = false>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (ZERO)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand fragments of two k-steps, split
struct AFrag {
  uint32_t big[2][4], small[2][4];
};

// total += a b over two k-steps in 3xTF32, b the B fragments of the two
// steps ({b0, b1} each, unsplit).  The products run as one short chain
// from zero, the cross terms first, and the chain's sum goes into total
// with an f32 add: the tensor cores add inside a chain with truncation
// (toward zero), so a chain as long as a row of keys (3 x 256 products at
// 2048 keys) would drift by about its length times 2^-24 of the sum, where
// the f32 adds round to nearest.
__device__ __forceinline__ void mma3x2(float* total, const AFrag& a,
                                       const float (&b)[2][2]) {
  uint32_t bb[2][2], bs[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j) split(b[u][j], bb[u][j], bs[u][j]);
  float t[4];
  mma<true>(t, a.small[0], bb[0][0], bb[0][1]);
  mma(t, a.big[0], bs[0][0], bs[0][1]);
  mma(t, a.small[1], bb[1][0], bb[1][1]);
  mma(t, a.big[1], bs[1][0], bs[1][1]);
  mma(t, a.big[0], bb[0][0], bb[0][1]);
  mma(t, a.big[1], bb[1][0], bb[1][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) total[e] += t[e];
}

// four 8 x 4 f32 matrices of shared memory, one register of each a lane:
// lane l gives the address of row l % 8 of matrix l / 8 and receives row
// (l % 32) / 4, word l % 4 of each (ldmatrix's b16 pairs are f32 words)
__device__ __forceinline__ void ldsm4(float (&r)[4], uint32_t addr) {
  uint32_t x[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(addr));
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __uint_as_float(x[j]);
}

// 16 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// grid (B * KV, row tiles), as flash_tc_kernel's.  q: (B, KV, G, Sq, hd)
// with element strides q_s*; k, v: (B, KV, Skv, hd) with strides k_s*,
// v_s*; out: like q, strides o_s*.  Every operand is read in 16-byte units.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1) flash_tf32x3_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh,
    long long q_sg, long long q_ss, const float* __restrict__ k,
    long long k_sb, long long k_sh, long long k_ss,
    const float* __restrict__ v, long long v_sb, long long v_sh,
    long long v_ss, float* __restrict__ out, long long o_sb, long long o_sh,
    long long o_sg, long long o_ss, int KV, int G, int Sq, int Skv,
    int causal, int window, int prefix, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NS = C::NS, LD = C::LD, ROWS = C::ROWS;
  constexpr int CH = HD / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  // shared memory: Q (ROWS x LD), then NS stages of a K and a V tile
  float* const qs = smem;
  float* const kvs = smem + ROWS * LD;
  const uint32_t s_q = tc::smem_addr(qs), s_kv = tc::smem_addr(kvs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.x % KV, b = blockIdx.x / KV;
  const Span cta = cta_span<ROWS, BK>(gridDim.y, blockIdx.y, G, Sq, Skv,
                                      causal, window, prefix);
  const int r0 = cta.r0, t_lo = cta.t_lo, n_t = cta.t_hi - cta.t_lo;
  const int nrows = Sq * G, q_offset = Skv - Sq;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  for (int i = tid; i < ROWS * CH; i += C::THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < nrows;
    cp_async16(s_q + 4 * (r * LD + 4 * c),
               ok ? qb + (row % G) * q_sg + (row / G) * q_ss + 4 * c : qb,
               ok);
  }
  // tile t's K and V into stage st
  auto load_tile = [&](int t, int st) {
    const uint32_t kt = s_kv + 4 * (2 * st * C::TILE), vt = kt + 4 * C::TILE;
    for (int i = tid; i < BK * CH; i += C::THREADS) {
      const int j = i / CH, c = i % CH, kp = t * BK + j;
      const bool ok = kp < Skv;
      cp_async16(kt + 4 * (j * LD + 4 * c), ok ? kb + kp * k_ss + 4 * c : kb,
                 ok);
      cp_async16(vt + 4 * (j * LD + 4 * c), ok ? vb + kp * v_ss + 4 * c : vb,
                 ok);
    }
  };
  // Q joins the first stage's group; a group is committed for every stage,
  // empty or not, so that wait_group counts stages
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_t) load_tile(t_lo + st, st);
    cp_async_commit();
  }

  // this thread's rows of the warp's 16 (the C fragment of m16n8k8: rows g
  // and g + 8, columns 8 n + 2 t + {0, 1} in registers 4 n + {0, 1} and
  // 4 n + {2, 3}, the wgmma accumulator's layout, so tc::online_softmax
  // takes it as it is)
  const int lr = 16 * warp + g;
  int hi[2], lo[2];  // the two rows' mask bounds (tc::Tile)
#pragma unroll
  for (int r = 0; r < 2; ++r)
    tc::row_bounds((r0 + lr + 8 * r) / G + q_offset, Skv, causal, window,
                   prefix, hi[r], lo[r]);
  // ldmatrix addresses (bytes): Q's A fragment at hd column d0 (matrix j:
  // rows 8 (j % 2), columns d0 + 4 (j / 2), of the warp's 16 rows) and K's
  // B fragments of key blocks n and n + 1 (matrix j: keys 8 (n + j / 2),
  // columns d0 + 4 (j % 2))
  const int mj = lane / 8, mr = lane % 8;
  const uint32_t q_ld =
      s_q + 4 * ((16 * warp + mr + 8 * (mj % 2)) * LD + 4 * (mj / 2));
  const uint32_t k_ld = 4 * ((mr + 8 * (mj / 2)) * LD + 4 * (mj % 2));

  float o[HD / 2], s[BK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f},
        corr[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<NS - 2>();  // tile i (and Q) copied by this thread
    __syncthreads();          // ... by every thread; tile i - 1 read by all
    if (i + NS - 1 < n_t) load_tile(t_lo + i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();
    const uint32_t kt = s_kv + 4 * (2 * (i % NS) * C::TILE);
    const float* vt = kvs + (2 * (i % NS) + 1) * C::TILE;

    // S = Q K^T over hd, two k-steps of 8 a chain: A = Q's rows, B = K's
    // rows (K^T's columns), split as they are loaded
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < HD; d0 += 16) {
      AFrag a;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float f[4];
        ldsm4(f, q_ld + 4 * (d0 + 8 * u));
#pragma unroll
        for (int j = 0; j < 4; ++j) split(f[j], a.big[u][j], a.small[u][j]);
      }
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        float f[2][4];  // step u: b0, b1 of block n, then of block n + 1
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ldsm4(f[u], kt + k_ld + 4 * (8 * n * LD + d0 + 8 * u));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          mma3x2(s + 4 * (n + nn), a,
                 {{f[0][2 * nn], f[0][2 * nn + 1]},
                  {f[1][2 * nn], f[1][2 * nn + 1]}});
      }
    }

    const int k0 = (t_lo + i) * BK;
    tc::online_softmax(
        s, m, l, corr,
        tc::edge_tile(k0, BK, Skv, causal, window, prefix, cta.q_lo,
                      cta.q_hi),
        tc::Tile{k0 + 2 * t4, hi[0], hi[1], lo[0], lo[1], prefix}, softcap,
        scale);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];

    // O += P V over the tile's keys, two blocks of 8 a chain: reduction
    // column t is key 2 t and column t + 4 key 2 t + 1, so S's registers
    // are P's A fragment as they lie (A = {c0, c2, c1, c3}) and B reads V's
    // rows 2 t and 2 t + 1
#pragma unroll
    for (int kk = 0; kk < BK / 8; kk += 2) {
      AFrag a;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* p = s + 4 * (kk + u);
        split(p[0], a.big[u][0], a.small[u][0]);
        split(p[2], a.big[u][1], a.small[u][1]);
        split(p[1], a.big[u][2], a.small[u][2]);
        split(p[3], a.big[u][3], a.small[u][3]);
      }
      const float* vr = vt + (8 * kk + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        mma3x2(o + 4 * n, a,
               {{vr[8 * n], vr[LD + 8 * n]},
                {vr[8 * LD + 8 * n], vr[9 * LD + 8 * n]}});
    }
  }
  cp_async_wait<0>();

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 1);
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + lr + 8 * r;
    if (row >= nrows) continue;
    float* orow = ob + (row % G) * o_sg + (row / G) * o_ss + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(
          o[4 * n + 2 * r] / lc[r], o[4 * n + 2 * r + 1] / lc[r]);
  }
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs,
           void* out, const long long* os, int B, int KV, int G, int Sq,
           int Skv, int causal, int window, int prefix, float softcap,
           float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  const long long row_tiles =
      (static_cast<long long>(Sq) * G + C::ROWS - 1) / C::ROWS;
  if (row_tiles > 65535 || static_cast<long long>(B) * KV > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t a = cudaFuncSetAttribute(
      flash_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid(B * KV, static_cast<unsigned>(row_tiles));
  flash_tf32x3_kernel<HD><<<grid, C::THREADS, C::SMEM, st>>>(
      static_cast<const float*>(q), qs[0], qs[1], qs[2], qs[3],
      static_cast<const float*>(k), ks[0], ks[1], ks[2],
      static_cast<const float*>(v), vs[0], vs[1], vs[2],
      static_cast<float*>(out), os[0], os[1], os[2], os[3], KV, G, Sq, Skv,
      causal, window, prefix, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

template <typename T>
int launch_hd(int hd, const void* q, const long long* qs, const void* k,
              const long long* ks, const void* v, const long long* vs,
              void* out, const long long* os, int B, int KV, int G, int Sq,
              int Skv, int causal, int window, int prefix, float softcap,
              float scale, cudaStream_t st) {
#define REPRO_SIMT(HD)                                                      \
  return launch<T, HD>(q, qs, k, ks, v, vs, out, os, B, KV, G, Sq, Skv,     \
                       causal, window, prefix, softcap, scale, st)
#define REPRO_TC(NS, HD)                                                    \
  return NS::launch<HD>(q, qs, k, ks, v, vs, out, os, B, KV, G, Sq, Skv,    \
                        causal, window, prefix, softcap, scale, st)
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) {
      case 16: REPRO_SIMT(16);
      case 32: REPRO_SIMT(32);
      case 64: REPRO_TC(tf32x3, 64);
      case 128: REPRO_TC(tf32x3, 128);
      case 256: REPRO_TC(tf32x3, 256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (hd) {
      case 16: REPRO_SIMT(16);
      case 32: REPRO_SIMT(32);
      case 64: REPRO_TC(tc, 64);
      case 128: REPRO_TC(tc, 128);
      case 256: REPRO_TC(tc, 256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef REPRO_TC
#undef REPRO_SIMT
}

}  // namespace

// Dynamic shared memory of one tensor-core CTA at head_dim hd (0: none):
// the bfloat16 kernel's, and (flash_tf32x3_smem_bytes) the float32 one's.
extern "C" int flash_tc_smem_bytes(int hd) {
  switch (hd) {
    case 64: return tc::Cfg<64>::SMEM;
    case 128: return tc::Cfg<128>::SMEM;
    case 256: return tc::Cfg<256>::SMEM;
    default: return 0;
  }
}
extern "C" int flash_tf32x3_smem_bytes(int hd) {
  switch (hd) {
    case 64: return tf32x3::Cfg<64>::SMEM;
    case 128: return tf32x3::Cfg<128>::SMEM;
    case 256: return tf32x3::Cfg<256>::SMEM;
    default: return 0;
  }
}

// bf16: 0 float32, 1 bfloat16.  q_strides: 4 element strides (b, kv head,
// g, position); k_strides, v_strides: 3 (b, kv head, position; a 4th entry
// is ignored); out_strides: 4 as q's.  The last axis of every operand has
// stride 1.  hd in {16, 32, 64, 128, 256}.  causal: 0 or 1 (with causal,
// Sq <= Skv); window <= 0: none; prefix_len <= 0: none (else the length of
// the bidirectional prefix); softcap <= 0: none; scale: hd^-0.5 rounded to
// float by the caller.  At hd 64, 128 and 256 both dtypes take a
// tensor-core kernel (bfloat16 flash_tc_kernel, float32
// flash_tf32x3_kernel), which needs q, k and v 16-byte aligned with strides
// (of axes longer than 1) in multiples of 16 bytes; the bfloat16 one
// returns 10000 + the CUresult when a tensor map cannot be made (10000: the
// encoder was not found).
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
