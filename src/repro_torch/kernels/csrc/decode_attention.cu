// Decode attention, one query token per sequence, over a contiguous view
// (shortcut) or through a block table (paged): split-K flash-decoding.
//
// Replaces the Pallas kernels of repro/kernels/shortcut_attention.py
// (shortcut_attention) and repro/kernels/paged_attention.py
// (paged_attention).  As there, the two share their math verbatim: one
// kernel body; a runtime flag only decides where token t's K/V row comes
// from (a block size that is a power of two by shifts):
//
//   shortcut: view + b*stride_b + h*stride_h + t*stride_t      (arithmetic)
//   paged   : pool + table[b, t / bs]*stride_n + h*stride_h
//                  + (t % bs)*stride_t                     (indirection)
//
// Semantics (those of the TPU kernels): q is scaled by hd^-0.5 in f32, scores
// are f32, an optional softcap cap*tanh(s/cap), an optional window (live
// positions are those > n-1-window, n = ctx plus the self row if any),
// positions >= ctx dropped, paged tokens whose table entry is -1 skipped; a
// row with no live position is all zeros (l = max(l, 1e-30) over a zero
// accumulator).  An optional self row (k_new, v_new), the current token,
// which is in neither the view nor the pools yet, is folded in by the
// combine as one more live position, with the same scale and softcap.
//
// Bound: bytes.  A decode call reads each live K and V row once and does
// 4*G flops per element read, far under the card's 295 flops per byte: at
// qwen3_4b's widths (G 4, hd 128, bf16) 242 MB for 16 sequences of 2048-4000
// tokens, 0.072 ms at 3.35 TB/s.  What the design does about it:
//
// * Split-K.  The context is cut into splits of `split` tokens (a multiple
//   of 64; the wrapper's SPLIT).  A CTA of 4 warps takes one split of one
//   (b, kv head) for GC query rows (G rounded up to 1, 2, 4 or 8; G > 8 in
//   chunks of 8), so a batch of 16 x 8 heads x 4000 tokens is some 2000
//   CTAs, several per SM, where one CTA per (b, kv head) left most of the
//   card idle.  The grid's split count comes from S_cap or MB*bs, never from
//   a host read of ctx; a CTA whose split holds no live token writes an
//   empty partial (l = 0) and exits.
// * A ring of tiles.  Within a split, tiles of 64 tokens go by 16-byte
//   cp.async copies into a ring in shared memory, issued one stage ahead of
//   the tile being scored: 3 stages when a stage (K and V) is at most 16 KB,
//   2 up to 64 KB, else 1 (bf16 at hd 128: 2 stages of 32 KB, 69 KB a CTA,
//   3 CTAs an SM).  Rows past ctx, before the window and under a -1 entry
//   are zero-filled (src-size 0), so no load leaves the live rows.  A row's
//   16-byte chunks are XOR-swizzled by the token's low bits against bank
//   conflicts.
// * Whole tiles at once, on the CUDA cores (f32 FMAs, p kept in f32):
//   thread (t, part) dots one of P = 2 parts of token t's K row with the GC
//   rows of q (f32, in shared memory, broadcast), the parts add by a
//   shuffle; one warp per query row takes the tile's max, one rescale and
//   the base-2 exponentials (ex2.approx); thread (token group, 16-byte
//   column) adds p * V into GC x 8 (bf16) register accumulators.  At 4
//   flops per byte the tensor cores would buy nothing the memory allows,
//   and f32 and bf16 share one path.  On the card a third stage (2 CTAs an
//   SM), 8 warps a CTA, and two tokens a score thread were each slower.
// * A fixed-order combine.  A second kernel, one CTA per (b, kv head, query
//   row), merges the splits' partials (m, l, acc) in split order, skipping
//   empty ones, then the self row, so a run repeats bit for bit.  The
//   partials are f32 scratch the wrapper allocates.
//
// Both routes share the tile geometry (tiles at absolute multiples of 64,
// splits at multiples of `split`), the order of every sum and the combine,
// so when the pools hold the view's rows (no -1 entry below ctx, no window
// difference) the two give bitwise equal outputs, whatever the block size.
// Every pointer and stride comes from the caller, so transposed views
// (ops.decode_*) are read in place.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // tokens per tile
constexpr int kMaxSplits = 12000;   // combine's weights, under 48 KB
constexpr float kNegInf = -1e30f;   // m before the first live token
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) unless `live`
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte chunk of a row in shared memory, as floats
template <int E>
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[E]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
template <int E>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[E]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// a dead token's score: its p is ex2(-inf) = 0 whatever the row's max
__device__ __forceinline__ float dead_score() {
  return -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float cap_scores(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// Shapes fixed at compile time for one instantiation.
template <typename T, int HD, int GC>
struct Geo {
  static constexpr int E = 16 / sizeof(T);        // elements per chunk
  static constexpr int RC = HD / E;               // chunks per row
  static constexpr int SW = (RC < 8 ? RC : 8) - 1;  // swizzle mask
  static constexpr int NTG = kThreads / RC;       // P.V token groups
  static constexpr int P = kThreads / kTile;      // score threads a token
  static constexpr int QS = HD + 4 * P;           // q row stride (floats)
  static constexpr int STAGE = 2 * kTile * HD;    // K and V, elements
  static constexpr int STAGE_BYTES = STAGE * static_cast<int>(sizeof(T));
  static constexpr int NS =
      STAGE_BYTES <= 16384 ? 3 : (STAGE_BYTES <= 65536 ? 2 : 1);
  static constexpr int RING_BYTES = NS * STAGE_BYTES;
  static constexpr int RED_BYTES = NTG * GC * HD * 4;
  static constexpr int REGION =
      RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static constexpr int ROWS = (GC + kWarps - 1) / kWarps;  // softmax rows
  static constexpr int SMEM =
      REGION + NS * kTile * 4 + GC * QS * 4 + 2 * GC * kTile * 4 + GC * 4;
  static_assert(RC >= P && RC <= kThreads, "head_dim out of range");
};

struct Args {
  const void* q; long long q_sb, q_sh, q_sg;
  const void* k; long long k_s0, k_s1, k_st;
  const void* v; long long v_s0, v_s1, v_st;
  const int32_t* lens; const int32_t* tables; long long tab_st; int MB;
  int paged, bs_shift;  // paged route; log2(S) when S is a power of two
  int G, S, smax, window, has_self, split, nsplit;
  float softcap, scale;
  float* m_part; float* l_part; float* acc_part;
};

// grid (nsplit, KV * ceil(G / GC), B), kThreads threads.  Writes the split's
// partial of each of its live rows g: m (base 2) and l at
// [((b*KV + h)*G + g)*nsplit + split], and acc (unnormalized, f32) at that
// index times HD.
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads) split_kernel(const Args a) {
  using Gm = Geo<T, HD, GC>;
  constexpr int E = Gm::E, RC = Gm::RC, SW = Gm::SW, NTG = Gm::NTG,
                QS = Gm::QS, NS = Gm::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);   // after the ring drains
  int* flags = reinterpret_cast<int*>(smem + Gm::REGION);   // NS x kTile
  float* qs = reinterpret_cast<float*>(flags + NS * kTile);  // GC x QS
  float* sc = qs + GC * QS;                      // GC x kTile scores
  float* pr = sc + GC * kTile;                   // GC x kTile p
  float* corr = pr + GC * kTile;                 // GC

  const int split = blockIdx.x, b = blockIdx.z;
  const int ngc = (a.G + GC - 1) / GC;
  const int h = blockIdx.y / ngc, g0 = (blockIdx.y % ngc) * GC;
  const int KV = gridDim.y / ngc;
  const int gv = min(GC, a.G - g0);              // live rows of this CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long part = (static_cast<long long>(b) * KV + h) * a.G + g0;

  const int lens = a.lens[b];
  const int ctx = min(lens, a.smax);
  const int lo = a.window > 0 ? max(0, lens + a.has_self - a.window) : 0;
  const int s0 = split * a.split, s1 = min(s0 + a.split, ctx);
  const int first = max(s0, lo);
  if (first >= s1) {              // no live token here: an empty partial
    if (tid < gv) {
      a.m_part[(part + tid) * a.nsplit + split] = kNegInf;
      a.l_part[(part + tid) * a.nsplit + split] = 0.f;
    }
    return;
  }
  const int t_begin = s0 + (first - s0) / kTile * kTile;
  const int ntiles = (s1 - 1 - t_begin) / kTile + 1;

  // q rows, scaled, as f32 (part p of a row shifted by 16p bytes against
  // bank conflicts between the parts of the score threads)
  for (int i = tid; i < GC * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float x = 0.f;
    if (g < gv) {
      const T* row = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                     (g0 + g) * a.q_sg;
      x = to_float(row[d]) * a.scale;
    }
    qs[g * QS + d + d / (HD / Gm::P) * 4] = x;
  }

  const bool paged = a.paged;
  const T* kbase = static_cast<const T*>(a.k) + h * a.k_s1;
  const T* vbase = static_cast<const T*>(a.v) + h * a.v_s1;
  if (!paged) {
    kbase += b * a.k_s0;
    vbase += b * a.v_s0;
  }
  // issue tile i's copies into stage st (and its live flags)
  auto load = [&](int i, int st) {
    T* kt = ring + st * Gm::STAGE;
    T* vt = kt + kTile * HD;
    const int t0 = t_begin + i * kTile;
    for (int idx = tid; idx < kTile * RC; idx += kThreads) {
      const int t = idx / RC, c = idx % RC;
      const int pos = t0 + t;
      bool live = pos >= lo && pos < s1;
      long long ko = 0, vo = 0;
      if (live) {
        if (paged) {
          // a power-of-two block size (a.bs_shift >= 0) by shifts
          const int blk_i = a.bs_shift >= 0 ? pos >> a.bs_shift : pos / a.S;
          const int r = a.bs_shift >= 0 ? pos & (a.S - 1) : pos % a.S;
          const int32_t blk = a.tables[b * a.tab_st + blk_i];
          live = blk >= 0;
          ko = blk * a.k_s0 + r * a.k_st;
          vo = blk * a.v_s0 + r * a.v_st;
        } else {
          ko = pos * a.k_st;
          vo = pos * a.v_st;
        }
      }
      const int dst = t * HD + (c ^ (t & SW)) * E;
      cp_async16(kt + dst, live ? kbase + ko + c * E : kbase, live);
      cp_async16(vt + dst, live ? vbase + vo + c * E : vbase, live);
      if (c == 0) flags[st * kTile + t] = live;
    }
  };

  float m_r[Gm::ROWS], l_r[Gm::ROWS];
#pragma unroll
  for (int r = 0; r < Gm::ROWS; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
  float acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < ntiles) load(i, i);
    cp_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int nxt = i + NS - 1;
    if (nxt < ntiles) load(nxt, nxt % NS);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    const int st = i % NS;
    const T* kt = ring + st * Gm::STAGE;
    const T* vt = kt + kTile * HD;

    // scores: thread (t, part) over part `part` of P of token t's K row,
    // all GC rows; the parts add by shuffles
    {
      constexpr int P = Gm::P;
      const int t = tid / P, part = tid % P;
      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] = 0.f;
#pragma unroll
      for (int j = 0; j < RC / P; ++j) {
        const int c = part * (RC / P) + j;
        float kx[E];
        load_chunk<E>(kt + t * HD + (c ^ (t & SW)) * E, kx);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float* qr = qs + g * QS + c * E + part * 4;
          float qx[E];
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 f = *reinterpret_cast<const float4*>(qr + e);
            qx[e] = f.x; qx[e + 1] = f.y; qx[e + 2] = f.z; qx[e + 3] = f.w;
          }
#pragma unroll
          for (int e = 0; e < E; ++e) s[g] = fmaf(qx[e], kx[e], s[g]);
        }
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1)
#pragma unroll
        for (int g = 0; g < GC; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
      if (part == 0) {
        const bool live = flags[st * kTile + t];
#pragma unroll
        for (int g = 0; g < GC; ++g)
          sc[g * kTile + t] =
              live ? cap_scores(s[g], a.softcap) * kLog2e : dead_score();
      }
    }
    __syncthreads();

    // softmax: warp w takes rows w, w + kWarps; one max, one rescale a tile
#pragma unroll
    for (int r = 0; r < Gm::ROWS; ++r) {
      const int g = warp + kWarps * r;
      if (g < GC) {
        const float x0 = sc[g * kTile + lane], x1 = sc[g * kTile + lane + 32];
        float mt = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        const float m_new = fmaxf(m_r[r], mt);
        const float cr = ex2(m_r[r] - m_new);
        const float p0 = ex2(x0 - m_new), p1 = ex2(x1 - m_new);
        pr[g * kTile + lane] = p0;
        pr[g * kTile + lane + 32] = p1;
        float ps = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(kFull, ps, off);
        l_r[r] = l_r[r] * cr + ps;
        m_r[r] = m_new;
        if (lane == 0) corr[g] = cr;
      }
    }
    __syncthreads();

    // P.V: thread (token group, chunk) into its GC x E accumulators
    {
      const int tg = tid / RC, c = tid % RC;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float cr = corr[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= cr;
      }
#pragma unroll 4
      for (int t = tg; t < kTile; t += NTG) {
        float vx[E];
        load_chunk<E>(vt + t * HD + (c ^ (t & SW)) * E, vx);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = pr[g * kTile + t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();

  // the token groups' accumulators, summed in group order
  {
    const int tg = tid / RC, c = tid % RC;
    if (tg < NTG) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          red[(tg * GC + g) * HD + c * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < gv * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
    for (int k = 0; k < NTG; ++k) o += red[(k * GC + g) * HD + d];
    a.acc_part[((part + g) * a.nsplit + split) * HD + d] = o;
  }
#pragma unroll
  for (int r = 0; r < Gm::ROWS; ++r) {
    const int g = warp + kWarps * r;
    if (g < gv && lane == 0) {
      a.m_part[(part + g) * a.nsplit + split] = m_r[r];
      a.l_part[(part + g) * a.nsplit + split] = l_r[r];
    }
  }
}

// grid (B * KV, G), kThreads threads: row g of out (B, KV, G, hd) from the
// partials.  Warp 0 takes the row's max over the live splits (l > 0) and the
// self row (k_new/v_new (B, KV, hd), strides n_sb, n_sh, when there is one),
// each split's weight into shared memory, and l summed in split order; then
// each thread sums its columns of acc in split order, then the self row.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const Args a, const T* __restrict__ k_new, const T* __restrict__ v_new,
    long long n_sb, long long n_sh, T* __restrict__ out, int KV, int hd) {
  extern __shared__ float wts[];                 // nsplit weights
  __shared__ float row[2];                       // L, the self row's weight
  const int bh = blockIdx.x, g = blockIdx.y, b = bh / KV, h = bh % KV;
  const int tid = threadIdx.x;
  const long long base = (static_cast<long long>(bh) * a.G + g) * a.nsplit;
  if (tid < 32) {
    float s_self = kNegInf;
    if (a.has_self) {
      const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                    g * a.q_sg;
      const T* kr = k_new + b * n_sb + h * n_sh;
      float s = 0.f;
      for (int d = tid; d < hd; d += 32)
        s = fmaf(to_float(qr[d]) * a.scale, to_float(kr[d]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFull, s, off);
      s_self = cap_scores(s, a.softcap) * kLog2e;
    }
    float M = s_self;
    for (int j = tid; j < a.nsplit; j += 32)
      if (a.l_part[base + j] > 0.f) M = fmaxf(M, a.m_part[base + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
    for (int j = tid; j < a.nsplit; j += 32) {
      const float l = a.l_part[base + j];
      wts[j] = l > 0.f ? ex2(a.m_part[base + j] - M) : 0.f;
    }
    __syncwarp();
    if (tid == 0) {
      float L = 0.f;
      for (int j = 0; j < a.nsplit; ++j)
        if (wts[j] != 0.f) L += a.l_part[base + j] * wts[j];
      const float w_self = a.has_self ? ex2(s_self - M) : 0.f;
      row[0] = L + w_self;
      row[1] = w_self;
    }
  }
  __syncthreads();
  const float L = fmaxf(row[0], 1e-30f), w_self = row[1];
  for (int d = tid; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < a.nsplit; ++j) {
      const float w = wts[j];
      if (w != 0.f) o += a.acc_part[(base + j) * hd + d] * w;
    }
    if (a.has_self) o += w_self * to_float(v_new[b * n_sb + h * n_sh + d]);
    store(out + (static_cast<long long>(bh) * a.G + g) * hd + d, o / L);
  }
}

template <typename T, int HD, int GC>
int launch_split(const Args& a, int B, int KV, cudaStream_t st) {
  using Gm = Geo<T, HD, GC>;
  auto kern = split_kernel<T, HD, GC>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid(a.nsplit, KV * ((a.G + GC - 1) / GC), B);
  kern<<<grid, kThreads, Gm::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_gc(const Args& a, int B, int KV, cudaStream_t st) {
  if (a.G <= 1) return launch_split<T, HD, 1>(a, B, KV, st);
  if (a.G <= 2) return launch_split<T, HD, 2>(a, B, KV, st);
  if (a.G <= 4) return launch_split<T, HD, 4>(a, B, KV, st);
  return launch_split<T, HD, 8>(a, B, KV, st);
}

template <typename T>
int by_hd(const Args& a, int hd, int B, int KV, cudaStream_t st) {
  switch (hd) {
    case 16: return by_gc<T, 16>(a, B, KV, st);
    case 32: return by_gc<T, 32>(a, B, KV, st);
    case 64: return by_gc<T, 64>(a, B, KV, st);
    case 128: return by_gc<T, 128>(a, B, KV, st);
    case 256: return by_gc<T, 256>(a, B, KV, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const Args& a, int hd, int B, int KV, const void* k_new,
           const void* v_new, long long n_sb, long long n_sh, void* out,
           cudaStream_t st) {
  const int err = by_hd<T>(a, hd, B, KV, st);
  if (err) return err;
  const dim3 grid(B * KV, a.G);
  combine_kernel<T><<<grid, kThreads, a.nsplit * sizeof(float), st>>>(
      a, static_cast<const T*>(k_new), static_cast<const T*>(v_new), n_sb,
      n_sh, static_cast<T*>(out), KV, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the split kernel and the combine (two __global__ kernels).
// args: 32 int64 values (pointers as integers), in this order:
//   0 paged (0 shortcut, 1 paged), 1 bf16 (0 float32, 1 bfloat16),
//   2 q, 3-5 its element strides (b, kv head, g),
//   6 k, 7-9 its strides (b or block, kv head, token), 10 v, 11-13 strides,
//   14 lens, 15 tables, 16 tables' row stride, 17 MB, 18 out,
//   19 B, 20 KV, 21 G, 22 hd, 23 S, 24 window,
//   25 k_new, 26 v_new (or 0), 27-28 their strides (b, kv head),
//   29 partials, 30 split, 31 nsplit.
// The last axis of every operand has stride 1; rows start 16-byte aligned;
// hd is 16, 32, 64, 128 or 256.  S: S_cap (shortcut) or the block size
// (paged); tables (B, MB) (ignored by the shortcut route).  window <= 0:
// none; softcap <= 0: none; scale: hd^-0.5 rounded to float by the caller.
// k_new/v_new: the self rows (B, KV, hd).  partials: 2*n + n*hd floats, n =
// B*KV*G*nsplit (m, then l, then acc); nsplit = ceil(smax / split), smax =
// S (shortcut) or MB*S (paged); split a multiple of 64.
extern "C" int decode_attention_launch(const long long* args, float softcap,
                                       float scale, void* stream) {
  const int paged = static_cast<int>(args[0]);
  const int bf16 = static_cast<int>(args[1]);
  const int MB = static_cast<int>(args[17]);
  const int B = static_cast<int>(args[19]), KV = static_cast<int>(args[20]);
  const int G = static_cast<int>(args[21]), hd = static_cast<int>(args[22]);
  const int S = static_cast<int>(args[23]);
  const int split = static_cast<int>(args[30]);
  const int nsplit = static_cast<int>(args[31]);
  const void* k_new = reinterpret_cast<const void*>(args[25]);
  const void* v_new = reinterpret_cast<const void*>(args[26]);
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  const long long smax = paged ? static_cast<long long>(MB) * S : S;
  if (G > 65535 || split <= 0 || split % kTile != 0 || smax <= 0 ||
      nsplit > kMaxSplits || nsplit != (smax + split - 1) / split ||
      (k_new == nullptr) != (v_new == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = reinterpret_cast<const void*>(args[2]);
  a.q_sb = args[3]; a.q_sh = args[4]; a.q_sg = args[5];
  a.k = reinterpret_cast<const void*>(args[6]);
  a.k_s0 = args[7]; a.k_s1 = args[8]; a.k_st = args[9];
  a.v = reinterpret_cast<const void*>(args[10]);
  a.v_s0 = args[11]; a.v_s1 = args[12]; a.v_st = args[13];
  a.lens = reinterpret_cast<const int32_t*>(args[14]);
  a.tables = reinterpret_cast<const int32_t*>(args[15]);
  a.tab_st = args[16]; a.MB = MB;
  a.paged = paged;
  a.bs_shift = (S & (S - 1)) == 0 ? __builtin_ctz(S) : -1;
  a.G = G; a.S = S; a.smax = static_cast<int>(smax);
  a.window = static_cast<int>(args[24]);
  a.has_self = k_new != nullptr; a.split = split; a.nsplit = nsplit;
  a.softcap = softcap; a.scale = scale;
  const long long n = static_cast<long long>(B) * KV * G * nsplit;
  a.m_part = reinterpret_cast<float*>(args[29]);
  a.l_part = a.m_part + n;
  a.acc_part = a.m_part + 2 * n;
  void* out = reinterpret_cast<void*>(args[18]);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(a, hd, B, KV, k_new, v_new, args[27],
                                 args[28], out, st);
  return launch<float>(a, hd, B, KV, k_new, v_new, args[27], args[28], out,
                       st);
}
