// Flash attention, forward (prefill): causal, windowed and softcapped
// attention with GQA folded into the query tile.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel).  Its function, kept here:
//
//   q is scaled by hd^-0.5 in f32; s = q . k in f32; an optional softcap
//   cap*tanh(s/cap); then the masks, in the TPU kernel's order: kpos < Skv,
//   causal qpos >= kpos with qpos = i + Skv - Sq (q right-aligned), window
//   kpos > qpos - window; a masked score is -1e30.  The online softmax
//   (m, l, acc) runs in f32 over key tiles, p stays f32 for the value
//   product, and the output is acc / max(l, 1e-30) in q's dtype.  A key tile
//   wholly above every row's diagonal, or wholly below every row's window, is
//   skipped, as the TPU kernel's in_range / pl.when does.  The -1e30 terms a
//   row picks up in a tile where all its keys are masked are multiplied by
//   exp(-1e30 - m) = 0 at its first visible key, so the answer does not
//   depend on the tiling.
//
// Bound: operations.  A prefill layer call does 4*hd flops per visible
// (query row, key) pair on a few MB of operands: at qwen3_4b's 8 x 2048
// tokens about 2.7e11 flops against 0.3 GB, hundreds of flops per byte.
//
// The design, simple first: f32 FMAs on the CUDA cores (no tensor cores
// yet).  One CTA of 256 threads per (b, kv head, 64 query rows), a row being
// one (position, query head) pair of the flattened (Sq, G) axis, so the G
// heads of a kv head share each K/V tile it loads.  Q (pre-scaled), the K
// and V tile (64 keys) and the tile's p live in shared memory as f32.
// Thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3: it computes their
// scores for keys tx + 16j (j < 4) with 16-byte shared loads along hd, the
// row max and sum reduce over the 16 tx lanes by shuffles, and it
// accumulates hd/16 output columns of each of its rows.  Row tiles run
// heaviest (latest positions) first.  Operands are read through element
// strides (last axis contiguous), and the output is written through strides
// too: ops.mha_forward passes transposed views and a (B, Sq, H, hd) buffer,
// so nothing is copied around the launch, and the ragged tails are bounds-
// checked instead of padded.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // query rows per CTA
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats after each Q/K row and p row in smem
constexpr float kNegInf = -1e30f;

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
    int window, float softcap, float scale) {
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
  const int t_hi = causal ? min(ntiles, q_hi / kKeys + 1) : ntiles;
  const int t_lo = window > 0 ? max(0, q_lo - window + 1) / kKeys : 0;

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
        if (causal) ok = ok && qpos[i] >= kp;
        if (window > 0) ok = ok && kp > qpos[i] - window;
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
           int Skv, int causal, int window, float softcap, float scale,
           cudaStream_t st) {
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
      os[0], os[1], os[2], os[3], G, Sq, Skv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const long long* qs, const void* k,
              const long long* ks, const void* v, const long long* vs,
              void* out, const long long* os, int B, int KV, int G, int Sq,
              int Skv, int causal, int window, float softcap, float scale,
              cudaStream_t st) {
#define REPRO_FLASH(HD)                                                     \
  return launch<T, HD>(q, qs, k, ks, v, vs, out, os, B, KV, G, Sq, Skv,     \
                       causal, window, softcap, scale, st)
  switch (hd) {
    case 16: REPRO_FLASH(16);
    case 32: REPRO_FLASH(32);
    case 64: REPRO_FLASH(64);
    case 128: REPRO_FLASH(128);
    case 256: REPRO_FLASH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH
}

}  // namespace

// bf16: 0 float32, 1 bfloat16.  q_strides: 4 element strides (b, kv head,
// g, position); k_strides, v_strides: 3 (b, kv head, position; a 4th entry
// is ignored); out_strides: 4 as q's.  The last axis of every operand has
// stride 1.  hd in {16, 32, 64, 128, 256}.  causal: 0 or 1 (with causal,
// Sq <= Skv); window <= 0: none; softcap <= 0: none; scale: hd^-0.5 rounded
// to float by the caller.
extern "C" int flash_attention_launch(
    int bf16, const void* q, const long long* q_strides, const void* k,
    const long long* k_strides, const void* v, const long long* v_strides,
    void* out, const long long* out_strides, int B, int KV, int G, int Sq,
    int Skv, int hd, int causal, int window, float softcap, float scale,
    void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, q_strides, k, k_strides, v,
                                    v_strides, out, out_strides, B, KV, G,
                                    Sq, Skv, causal, window, softcap, scale,
                                    st);
  return launch_hd<float>(hd, q, q_strides, k, k_strides, v, v_strides, out,
                          out_strides, B, KV, G, Sq, Skv, causal, window,
                          softcap, scale, st);
}
