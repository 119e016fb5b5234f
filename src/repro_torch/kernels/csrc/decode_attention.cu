// Decode attention, one query token per sequence, over a contiguous view
// (shortcut) or through a block table (paged).
//
// Replaces the Pallas kernels of repro/kernels/shortcut_attention.py
// (shortcut_attention) and repro/kernels/paged_attention.py
// (paged_attention).  As there, the two share their math verbatim: one
// __device__ body, attend_tile, takes an online-softmax step over one tile of
// tokens whose rows start at a base pointer; the kernel template's PAGED flag
// only decides where a tile's base comes from:
//
//   shortcut: view + b*stride_b + h*stride_h + 64*chunk*stride_t  (arithmetic)
//   paged   : pool + table[b, block]*stride_n + h*stride_h    (indirection)
//
// Semantics (those of the TPU kernels): q is scaled by hd^-0.5 in f32, scores
// are f32, an optional softcap cap*tanh(s/cap), an optional window (shortcut:
// positions > ctx-1-window), positions >= ctx dropped, paged blocks whose
// table entry is -1 skipped; a row with no live position is all zeros (the
// kernels' l = max(l, 1e-30) over an untouched accumulator).
//
// Bound: bytes.  A decode step reads each live K and V row once and does
// 4*G flops per element read, far under the card's 295 flops per byte.  The
// design: one CTA per (b, kv head, chunk of G), 8 warps.  A warp splits into
// lane groups of hd/8 lanes; each lane holds 8 elements of each of the CTA's
// query rows in registers and loads 8 elements (16 bytes in bf16) of a K and
// a V row per token, so a group reads a row with coalesced vector loads.  A
// lane group takes 4 tokens per step with all 8 loads issued before use,
// keeping several rows in flight per warp.  Warps stride over 64-token chunks
// (shortcut) or over blocks (paged; the loop stops at ceil(ctx/bs), so dead
// blocks past the context are never visited, where the TPU grid walks all MB).
// The partial (m, l, acc) of the lane groups merge by warp shuffles, those of
// the warps through shared memory.  Every pointer and stride comes from the
// caller, so transposed views (ops.decode_*) are read in place.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kVec = 8;        // elements of a row per lane
constexpr int kTile = 4;       // tokens per lane group per step
constexpr int kChunk = 64;     // tokens of a shortcut tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Running softmax state of GC query rows, per lane: the lane's 8 elements of
// each accumulator row, and the row's max and sum (equal across a group).
template <int GC>
struct Partial {
  float m[GC], l[GC], acc[GC][kVec];
};

// One online-softmax step over tokens [lo, hi) of a tile whose token t has
// its K row at k + t*k_st and its V row at v + t*v_st.  Lane group `grp` of
// `ngroups` (of `lanes` lanes each, `sub` this lane's index in it) takes
// tokens base + j*ngroups + grp.  Every lane runs every step (the shuffles
// need the whole warp); a token past `hi` is masked out.
template <typename T, int GC>
__device__ __forceinline__ void attend_tile(
    Partial<GC>& st, const float (&q)[GC][kVec], const T* __restrict__ k,
    const T* __restrict__ v, long long k_st, long long v_st, int lo, int hi,
    int grp, int ngroups, int sub, int lanes, float softcap) {
  for (int base = lo; base < hi; base += ngroups * kTile) {
    float kx[kTile][kVec], vx[kTile][kVec];
    bool ok[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int t = base + j * ngroups + grp;
      ok[j] = t < hi;
      if (ok[j]) {
        load8(k + t * k_st + sub * kVec, kx[j]);
        load8(v + t * v_st + sub * kVec, vx[j]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kx[j][i] = vx[j][i] = 0.f;
      }
    }
    float s[kTile][GC];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) d = fmaf(q[g][i], kx[j][i], d);
        for (int off = lanes >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[j][g] = ok[j] ? d : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int j = 1; j < kTile; ++j) mt = fmaxf(mt, s[j][g]);
      const float m_new = fmaxf(st.m[g], mt);
      const float corr = expf(st.m[g] - m_new);
      float p[kTile], psum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        p[j] = ok[j] ? expf(s[j][g] - m_new) : 0.f;
        psum += p[j];
      }
      st.l[g] = st.l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float a = st.acc[g][i] * corr;
#pragma unroll
        for (int j = 0; j < kTile; ++j) a = fmaf(p[j], vx[j][i], a);
        st.acc[g][i] = a;
      }
      st.m[g] = m_new;
    }
  }
}

// grid (B, KV, G / GC), kWarps warps.  Shortcut: k/v strides are those of the
// (B, KV, S_cap, hd) view, S = S_cap.  Paged: those of the (nblocks, KV, bs,
// hd) pools, S = bs, tables (B, MB) with row stride tab_st.  out is the
// contiguous (B, KV, G, hd) result; q is (B, KV, G, hd) with strides q_s*.
template <typename T, int GC, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_sg,
    const T* __restrict__ k, long long k_s0, long long k_s1, long long k_st,
    const T* __restrict__ v, long long v_s0, long long v_s1, long long v_st,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ tables,
    long long tab_st, int MB, T* __restrict__ out, int G, int hd, int S,
    int window, float softcap, float scale) {
  extern __shared__ float smem[];  // kWarps x GC x (hd + 2)
  const int b = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * GC;
  const int KV = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lanes = hd / kVec, ngroups = 32 / lanes;
  const int grp = lane / lanes, sub = lane % lanes;

  float qr[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const T* row = q + b * q_sb + h * q_sh + (g0 + g) * q_sg + sub * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) qr[g][i] = to_float(row[i]) * scale;
  }
  Partial<GC> st;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    st.m[g] = kNegInf;
    st.l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) st.acc[g][i] = 0.f;
  }

  if constexpr (PAGED) {
    const int ctx = min(lens[b], MB * S);
    const int nblk = (ctx + S - 1) / S;
    for (int c = warp; c < nblk; c += kWarps) {
      const int32_t blk = tables[b * tab_st + c];
      if (blk < 0) continue;  // unset entry: skipped, as the TPU kernel does
      attend_tile<T, GC>(st, qr, k + blk * k_s0 + h * k_s1,
                         v + blk * v_s0 + h * v_s1, k_st, v_st, 0,
                         min(S, ctx - c * S), grp, ngroups, sub, lanes,
                         softcap);
    }
  } else {
    const int ctx = min(lens[b], S);
    const int lo = window > 0 ? max(0, ctx - window) : 0;
    for (int c = lo / kChunk + warp; c * kChunk < ctx; c += kWarps) {
      const int start = c * kChunk;
      attend_tile<T, GC>(st, qr, k + b * k_s0 + h * k_s1 + start * k_st,
                         v + b * v_s0 + h * v_s1 + start * v_st, k_st, v_st,
                         max(lo, start) - start,
                         min(ctx, start + kChunk) - start, grp, ngroups, sub,
                         lanes, softcap);
    }
  }

  // merge the lane groups of this warp (butterfly: every group ends with it)
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(kFull, st.m[g], off);
      const float lo_ = __shfl_xor_sync(kFull, st.l[g], off);
      const float mn = fmaxf(st.m[g], mo);
      const float a = expf(st.m[g] - mn), c = expf(mo - mn);
      st.l[g] = st.l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ao = __shfl_xor_sync(kFull, st.acc[g][i], off);
        st.acc[g][i] = st.acc[g][i] * a + ao * c;
      }
      st.m[g] = mn;
    }
  }
  // then the warps, through shared memory
  const int row = hd + 2;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* dst = smem + (warp * GC + g) * row;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[sub * kVec + i] = st.acc[g][i];
      if (sub == 0) {
        dst[hd] = st.m[g];
        dst[hd + 1] = st.l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GC * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx % hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[(w * GC + g) * row + hd]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* src = smem + (w * GC + g) * row;
      const float e = expf(src[hd] - mx);
      l += src[hd + 1] * e;
      o += src[d] * e;
    }
    store(out + ((static_cast<long long>(b) * KV + h) * G + g0 + g) * hd + d,
          o / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool PAGED>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs,
           const void* lens, const void* tables, long long tab_st, int MB,
           void* out, int B, int KV, int G, int hd, int S, int window,
           float softcap, float scale, cudaStream_t st) {
  const int gc = G % 4 == 0 ? 4 : (G % 2 == 0 ? 2 : 1);
  const dim3 grid(B, KV, G / gc);
  const size_t smem = sizeof(float) * kWarps * gc * (hd + 2);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int32_t*>(lens);
  const auto* tp = static_cast<const int32_t*>(tables);
  auto* op = static_cast<T*>(out);
#define REPRO_DECODE(GC)                                                     \
  decode_kernel<T, GC, PAGED><<<grid, kWarps * 32, smem, st>>>(              \
      qp, qs[0], qs[1], qs[2], kp, ks[0], ks[1], ks[2], vp, vs[0], vs[1],    \
      vs[2], lp, tp, tab_st, MB, op, G, hd, S, window, softcap, scale)
  if (gc == 4) REPRO_DECODE(4);
  else if (gc == 2) REPRO_DECODE(2);
  else REPRO_DECODE(1);
#undef REPRO_DECODE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// paged: 0 shortcut, 1 paged; bf16: 0 float32, 1 bfloat16.  q_strides,
// k_strides, v_strides: 3 element strides each (the last axis has stride 1):
// q (b, kv head, g); k/v (b or block, kv head, token).  Rows start 16-byte
// aligned; hd is 8 x a power of two up to 256.  S: S_cap (shortcut) or the
// block size (paged).  window <= 0: none; softcap <= 0: none; scale: hd^-0.5
// rounded to float by the caller.  tables is ignored by the shortcut kernel.
extern "C" int decode_attention_launch(
    int paged, int bf16, const void* q, const long long* q_strides,
    const void* k, const long long* k_strides, const void* v,
    const long long* v_strides, const void* lens, const void* tables,
    long long tab_stride, int MB, void* out, int B, int KV, int G, int hd,
    int S, int window, float softcap, float scale, void* stream) {
  const int lanes = hd / kVec;
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (hd % kVec != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, P)                                                    \
  launch<T, P>(q, q_strides, k, k_strides, v, v_strides, lens, tables,        \
               tab_stride, MB, out, B, KV, G, hd, S, window, softcap, scale,  \
               st)
  if (bf16)
    return paged ? REPRO_LAUNCH(__nv_bfloat16, true)
                 : REPRO_LAUNCH(__nv_bfloat16, false);
  return paged ? REPRO_LAUNCH(float, true) : REPRO_LAUNCH(float, false);
#undef REPRO_LAUNCH
}
