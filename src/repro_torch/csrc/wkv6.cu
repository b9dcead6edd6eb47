// WKV6 recurrence (RWKV-6 "Finch") forward for Hopper (sm_90a), plain C
// interface.
//
//   wkv6_kernel, wkv6_kernel_columns  replace the TPU kernel
//       repro/kernels/rwkv6_scan/kernel.py:wkv6_bthd (_wkv6_kernel): per
//       (batch b, head h) an fp32 (hd, hd) state S and, for each token t
//       with kv = k_tᵀ v_t,
//           y_t[j] = Σ_i r_t[i] · (S[i][j] + u[i] · kv[i][j])
//           S[i][j] <- w_t[i] · S[i][j] + kv[i][j]
//       r, k, v in bf16 or fp32, w in fp32 or r's dtype, u and the states
//       in fp32, y in r's dtype.
//
// Bound on an H100 SXM at the rwkv6-3b prefill shape (B = 1, T = 1024,
// H = 40, hd = 64; r, k, v bf16, w fp32): 5 fp32 operations per state
// element and token (r S and its sum into y, k v, w S + k v; with the
// bonus term split off as below, u's part costs O(hd) a token), 0.84
// GFLOP, 12.5 us at 67 TFLOP/s; 32.8 MB moved, 9.8 us at 3.35 TB/s.  So
// the function is bound by operations.  The recurrence is sequential in
// t, and at B = 1 there are only 40 (b, h) pairs: a kernel with one block
// per pair leaves most of the 132 SMs idle and runs each busy one on too
// few warps to hide its latencies.
//
// wkv6_kernel (a sequence, T > kTC).  Column j of the state evolves on
// its own: S[:, j] needs only v_t[j], and y_t[j] reads only S[:, j].  So
// a block owns a (b, h) and a group of kCG = 16 columns, and splits the
// key dimension i over L = hd / 8 lanes per column: compute thread (p, c)
// keeps S[8 p .. 8 p + 7][j0 + c .. j0 + c + 1], 8 rows of 2 columns, in
// registers for the whole sequence.  That is B * H * hd / 16 blocks of hd
// compute threads and as many helpers: at rwkv6's B = 1, hd = 64, 160
// blocks of 4 warps (640 warps, where one block a (b, h) had 80), each
// compute thread doing 16 elements' work per token.  The bonus term is
// split off, y_t[j] = Σ_i r_i S_ij + v_j Σ_i r_i u_i k_i, so an element
// costs three fp32 operations (r S into y, k v, w S + k v) and the scalar
// Σ_i r_i u_i k_i is formed once per token.  Time goes in chunks of kTC
// tokens, and the helper threads keep the sequential loop fed: while the
// compute threads work on chunk c, they issue chunk c + 3 by TMA (four
// boxes, r, k, w and v's columns; tokens past T arrive as zeros) into a
// ring of kStages buffers in the inputs' own types, convert chunk c + 1
// to fp32 once per block, with its bonus, and reduce chunk c - 1's y.
// Compute threads that share p read the same r, k, w values at once (a
// broadcast, 16 bytes a load), and each value serves two columns:
// shared-memory loads, not arithmetic, set the pace.  Each compute thread
// keeps its partial y_t[j] of the chunk's tokens in registers, then in
// shared memory; a helper sums each (token, column) over its L lanes and
// stores it.  One barrier a chunk.
//
// wkv6_kernel_columns (a decode step, T <= kTC).  B * H pairs are plenty
// (320 at B = 8) and the step is bound by moving the states, so one block
// of hd threads owns a (b, h) and thread j the whole column S[:, j], which
// reads and writes each state row in one coalesced access; the tokens
// come in by cp.async, and the last token stores each state row as soon
// as it is final.
//
// The state update S = fmaf(w, S, k·v) is elementwise in both, so the
// final state is the same arithmetic for each element as in a
// token-by-token loop; only y's summation order differs from the plain
// version.  Any T >= 1 is taken with no padding; r, k, v and w are read
// through (b, t, h) element strides with a unit stride along hd (rows
// that are not 16-byte aligned are copied element by element).
#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "smem_allowance.cuh"

namespace {

constexpr int kTC = 16;      // tokens per chunk
constexpr int kStages = 4;   // chunks in the TMA ring (sequences)
constexpr int kR = 8;        // state rows per thread (sequences)
constexpr int kCG = 16;      // state columns per block (sequences)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// 8 consecutive values from 16-byte aligned shared memory, as fp32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    o[2 * n] = __uint_as_float(w[n] << 16);
    o[2 * n + 1] = __uint_as_float(w[n] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// mbarriers: a stage's TMA copies complete its barrier's phase
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// one box of a (hd, T, H, B) tensor map (see make_map) into shared
// memory: columns from j, tokens from t, head h, batch b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int j, int t, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(j), "r"(t), "r"(h), "r"(b),
         "r"(smem_u32(bar))
      : "memory");
}

struct Strides {
  int64_t b, t, h;
};

// `rows` (<= kTC) rows of WIDTH elements (a multiple of 16 bytes) from
// `src` (row stride `ld` elements) into `dst`, rows packed, by NT threads
// of which this is thread `idx`: 16 bytes a thread by cp.async when
// `vec`, else element by element
template <typename E, int NT, int WIDTH>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, int64_t ld,
                                          int rows, bool vec, int idx) {
  constexpr int kE = 16 / (int)sizeof(E);    // elements of 16 bytes
  constexpr int kPer = WIDTH / kE;           // 16-byte units a row
  constexpr int kUnits = kTC * kPer;
#pragma unroll
  for (int n0 = 0; n0 < kUnits; n0 += NT) {
    const int n = n0 + idx;
    const int row = n / kPer, part = n % kPer;
    if ((kUnits % NT == 0 || n < kUnits) && row < rows) {
      E* d = dst + row * WIDTH + part * kE;
      const E* s = src + row * ld + part * kE;
      if (vec) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) d[e] = s[e];
      }
    }
  }
}

// One chunk of kTC tokens in the inputs' own types, CG columns of v: a
// stage of the ring.
template <typename T, typename TW, int HD, int CG>
struct Raw {
  static constexpr size_t bytes =
      (size_t)kTC * (HD * (2 * sizeof(T) + sizeof(TW)) + CG * sizeof(T));
  T* r;
  T* k;
  TW* w;
  T* v;
  __device__ Raw(unsigned char* base, int stage) {
    unsigned char* p = base + stage * bytes;
    r = reinterpret_cast<T*>(p);
    k = r + kTC * HD;
    w = reinterpret_cast<TW*>(k + kTC * HD);
    v = reinterpret_cast<T*>(w + kTC * HD);
  }
};

// ----------------------------------------------------------------------
// sequences: kR rows x 2 columns a thread, kCG columns a block

template <int HD>
struct Split {
  static constexpr int L = HD / kR;          // lanes per column
  static constexpr int NC = kCG / 2 * L;     // compute threads (hd)
  static constexpr int NT = 2 * NC;          // and as many helpers
  static constexpr int G = HD / kCG;         // blocks per (b, h)
  static constexpr int RED = kTC * kCG + 8;  // padded lane stride of the
                                             // y parts
  // a converted chunk, fp32: r, k, w [kTC][HD], v [kTC][kCG] and the
  // bonus Σ_i r_i u_i k_i of each token
  static constexpr int CONV = kTC * (3 * HD + kCG + 1);
  template <typename T, typename TW>
  static constexpr size_t smem_bytes() {
    return kStages * Raw<T, TW, HD, kCG>::bytes +
           (size_t)(2 * CONV + 2 * L * RED) * sizeof(float) +
           kStages * sizeof(uint64_t);
  }
};

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(Split<HD>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_final, int n_t, int n_h,
            Strides rs, Strides ks, Strides vs, Strides ws, int vec,
            const __grid_constant__ CUtensorMap tr,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tv) {
  using Sp = Split<HD>;
  using RawT = Raw<T, TW, HD, kCG>;
  constexpr int L = Sp::L, NC = Sp::NC;
  // the helpers' lanes, for their shuffles (at hd 16 they share a warp
  // with the compute threads)
  constexpr unsigned kLanes =
      NC >= 32 ? 0xffffffffu : ((1u << NC) - 1u) << NC;
  static_assert(kTC * HD == 16 * NC, "a helper converts 16 values a chunk");
  extern __shared__ __align__(128) unsigned char smem_wkv[];
  float* conv = reinterpret_cast<float*>(smem_wkv + kStages * RawT::bytes);
  float* red = conv + 2 * Sp::CONV;          // [2][L][RED]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 2 * L * Sp::RED);

  // threads [0, NC) compute: thread (p, c) owns rows kR p .., columns
  // j0 + c, + 1; threads [NC, 2 NC) help: they bring chunks in, convert
  // them and reduce y, for the next and the previous chunk while the
  // compute threads work on this one
  const int tid = threadIdx.x;
  const bool computes = tid < NC;
  const int p = tid / (kCG / 2);
  const int c = 2 * (tid % (kCG / 2));
  const int ht = tid - NC;
  const int g = blockIdx.x % Sp::G;
  const int bh = blockIdx.x / Sp::G;
  const int b = bh / n_h, h = bh % n_h;
  const int j0 = g * kCG;
  const int i0 = p * kR;
  // the values a helper converts each chunk: rows e0 % HD .. + 7 of
  // tokens e0 / HD and e0 / HD + kTC / 2; the HD / 8 helpers of a token
  // are adjacent lanes
  const int e0 = ht * 8;
  float uc[8], S0[kR], S1[kR];
  const float* sp = s0 + (size_t)bh * HD * HD + (size_t)i0 * HD + j0 + c;
  if (computes) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const float2 x =
          *reinterpret_cast<const float2*>(sp + (size_t)q * HD);
      S0[q] = x.x;
      S1[q] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) uc[e] = u[(size_t)h * HD + e0 % HD + e];
  }

  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h + j0;
  const TW* wp = w + b * ws.b + h * ws.h;
  T* yp = y + ((size_t)b * n_t * n_h + h) * HD + j0;
  const int64_t y_t = (int64_t)n_h * HD;
  const int n_chunks = (n_t + kTC - 1) / kTC;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // (helpers) chunk ch into its stage: four TMA boxes (r, k, w rows; v's
  // kCG columns) issued by one helper, tokens past T arriving as zeros;
  // or plain copies when the rows are not 16-byte aligned
  auto issue = [&](int ch) {
    const int t0 = ch * kTC, tn = min(kTC, n_t - t0);
    const RawT raw(smem_wkv, ch % kStages);
    uint64_t* sb = bar + ch % kStages;
    if (vec) {
      if (ht == 0) {
        mbar_expect(sb, RawT::bytes);
        tma_load(raw.r, &tr, 0, t0, h, b, sb);
        tma_load(raw.k, &tk, 0, t0, h, b, sb);
        tma_load(raw.w, &tw, 0, t0, h, b, sb);
        tma_load(raw.v, &tv, j0, t0, h, b, sb);
      }
    } else {
      copy_rows<T, NC, HD>(raw.r, rp + t0 * rs.t, rs.t, tn, false, ht);
      copy_rows<T, NC, HD>(raw.k, kp + t0 * ks.t, ks.t, tn, false, ht);
      copy_rows<TW, NC, HD>(raw.w, wp + t0 * ws.t, ws.t, tn, false, ht);
      copy_rows<T, NC, kCG>(raw.v, vp + t0 * vs.t, vs.t, tn, false, ht);
      if (ht == 0) mbar_expect(sb, 0);
    }
  };
  // (helpers) the landed chunk to fp32 once a block, not once a column,
  // with each token's bonus (tokens past the end convert garbage, never
  // used); the plain copies of a chunk are two barriers old when it is
  // converted
  auto convert = [&](int ch) {
    mbar_wait(bar + ch % kStages, (ch / kStages) & 1);
    const RawT raw(smem_wkv, ch % kStages);
    float* dst = conv + (ch & 1) * Sp::CONV;
    float* dv = dst + 3 * kTC * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = e0 + half * kTC * HD / 2;
      float rq[8], kq[8], wq[8];
      load8(raw.r + e, rq);
      load8(raw.k + e, kq);
      load8(raw.w + e, wq);
      store8(dst + e, rq);
      store8(dst + kTC * HD + e, kq);
      store8(dst + 2 * kTC * HD + e, wq);
      float ruk = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) ruk = fmaf(rq[q] * uc[q], kq[q], ruk);
#pragma unroll
      for (int off = 1; off < HD / 8; off <<= 1)
        ruk += __shfl_xor_sync(kLanes, ruk, off);
      if (e % HD == 0) dv[kTC * kCG + e / HD] = ruk;
    }
    for (int e = ht; e < kTC * kCG; e += NC) dv[e] = to_f(raw.v[e]);
  };
  // (helpers) y parts of chunk ch, summed over the L lanes of each
  // column: a pair of columns at a time
  auto reduce = [&](int ch) {
    const int t0 = ch * kTC, tn = min(kTC, n_t - t0);
    const float* part = red + (ch & 1) * L * Sp::RED;
    for (int e = 2 * ht; e < tn * kCG; e += 2 * NC) {
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float2 x =
            *reinterpret_cast<const float2*>(part + l * Sp::RED + e);
        sum.x += x.x;
        sum.y += x.y;
      }
      T* dst = yp + (t0 + e / kCG) * y_t + e % kCG;
      store(dst, sum.x);
      store(dst + 1, sum.y);
    }
  };
  // (compute threads) y_t[j] = Σ_i r_i S_ij + v_j Σ_i r_i u_i k_i: this
  // thread's rows of the first sum for its two columns, and (lanes p = 0)
  // the bonus term; the state update in place
  const float bonus_mul = p == 0 ? 1.f : 0.f;
  auto compute = [&](int ch) {
    const int tn = min(kTC, n_t - ch * kTC);
    const float* src = conv + (ch & 1) * Sp::CONV;
    const float* rr = src + i0;
    const float* kk = src + kTC * HD + i0;
    const float* ww = src + 2 * kTC * HD + i0;
    const float* vv = src + 3 * kTC * HD;
    auto token = [&](int tt) {
      const float2 vj = *reinterpret_cast<const float2*>(vv + tt * kCG + c);
      float rq[kR], kq[kR], wq[kR];
      load8(rr + tt * HD, rq);
      load8(kk + tt * HD, kq);
      load8(ww + tt * HD, wq);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int e = 0; e < kR; ++e) {
        a0 = fmaf(rq[e], S0[e], a0);
        a1 = fmaf(rq[e], S1[e], a1);
        S0[e] = fmaf(wq[e], S0[e], kq[e] * vj.x);
        S1[e] = fmaf(wq[e], S1[e], kq[e] * vj.y);
      }
      const float bonus = vv[kTC * kCG + tt] * bonus_mul;
      return make_float2(fmaf(vj.x, bonus, a0), fmaf(vj.y, bonus, a1));
    };
    // the chunk's parts stay in registers until its tokens are done, so
    // no shared-memory store sits between one token's loads and the next
    float2 yv[kTC];
    if (tn == kTC) {
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) yv[tt] = token(tt);
    } else {
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt)
        if (tt < tn) yv[tt] = token(tt);
    }
    float* part = red + (ch & 1) * L * Sp::RED + p * Sp::RED + c;
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt)
      if (tt < tn) *reinterpret_cast<float2*>(part + tt * kCG) = yv[tt];
  };

  // the ring: while the compute threads work on chunk ch, the helpers
  // issue chunk ch + kStages - 1, reduce chunk ch - 1's y and convert
  // chunk ch + 1; one barrier a chunk
  if (!computes) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      if (s < n_chunks) issue(s);
  }
  __syncthreads();                    // plain copies of the first chunks
  if (!computes) convert(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();                  // chunk ch converted, chunk ch - 1
                                      // computed, their stages free
    if (computes) {
      compute(ch);
    } else {
      if (ch + kStages - 1 < n_chunks) issue(ch + kStages - 1);
      if (ch > 0) reduce(ch - 1);
      if (ch + 1 < n_chunks) convert(ch + 1);
    }
  }
  __syncthreads();
  if (computes) {
    float* op = s_final + (size_t)bh * HD * HD + (size_t)i0 * HD + j0 + c;
#pragma unroll
    for (int q = 0; q < kR; ++q)
      *reinterpret_cast<float2*>(op + (size_t)q * HD) =
          make_float2(S0[q], S1[q]);
  } else {
    reduce(n_chunks - 1);
  }
}

// ----------------------------------------------------------------------
// decode steps (T <= kTC): a whole column a thread, one block a (b, h)

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel_columns(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const TW* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_final, int n_t,
                    int n_h, Strides rs, Strides ks, Strides vs, Strides ws,
                    int vec) {
  using RawT = Raw<T, TW, HD, HD>;
  extern __shared__ __align__(128) unsigned char smem_wkv[];
  float* u_s = reinterpret_cast<float*>(smem_wkv + RawT::bytes);
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / n_h, h = bh % n_h;
  // u's load is waited for only once the tokens' copies are in flight
  const float u_mine = u[(size_t)h * HD + j];
  float S[HD];
  const float* sp = s0 + (size_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = sp[(size_t)i * HD];

  const RawT raw(smem_wkv, 0);
  copy_rows<T, HD, HD>(raw.r, r + b * rs.b + h * rs.h, rs.t, n_t, vec, j);
  copy_rows<T, HD, HD>(raw.k, k + b * ks.b + h * ks.h, ks.t, n_t, vec, j);
  copy_rows<TW, HD, HD>(raw.w, w + b * ws.b + h * ws.h, ws.t, n_t, vec, j);
  copy_rows<T, HD, HD>(raw.v, v + b * vs.b + h * vs.h, vs.t, n_t, vec, j);
  cp_async_commit();
  u_s[j] = u_mine;
  cp_async_wait<0>();
  __syncthreads();

  T* yp = y + ((size_t)b * n_t * n_h + h) * HD + j;
  float* op = s_final + (size_t)bh * HD * HD + j;
  // the last token stores each state row as soon as it is final, so the
  // stores overlap the rest of its arithmetic
  auto token = [&](int tt, auto last) {
    const float vj = to_f(raw.v[tt * HD + j]);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < HD; q += 8) {
      float rq[8], kq[8], wq[8], uq[8];
      load8(raw.r + tt * HD + q, rq);
      load8(raw.k + tt * HD + q, kq);
      load8(raw.w + tt * HD + q, wq);
      load8(u_s + q, uq);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kv = kq[e] * vj;
        a[e & 3] = fmaf(rq[e], fmaf(uq[e], kv, S[q + e]), a[e & 3]);
        S[q + e] = fmaf(wq[e], S[q + e], kv);
        if constexpr (decltype(last)::value)
          op[(size_t)(q + e) * HD] = S[q + e];
      }
    }
    store(yp + (int64_t)tt * n_h * HD, (a[0] + a[1]) + (a[2] + a[3]));
  };
  for (int tt = 0; tt + 1 < n_t; ++tt) token(tt, std::false_type{});
  token(n_t - 1, std::true_type{});
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename E>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(E) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// A (B, T, H, hd) view with strides `st` as the tensor (hd, T, H, B), its
// box (`cols`, kTC, 1, 1): kTC token rows of `cols` values, tokens past T
// filled with zeros
template <typename E>
bool make_map(CUtensorMap* map, const void* base, int b, int t, int h,
              int hd, Strides st, int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)t, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * sizeof(E),
                                 (cuuint64_t)st.h * sizeof(E),
                                 (cuuint64_t)st.b * sizeof(E)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, kTC, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, tma_type<E>(), 4, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename TW, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_final, int b,
           int t, int h, Strides rs, Strides ks, Strides vs, Strides ws,
           int vec, cudaStream_t stream) {
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const TW* w_ = static_cast<const TW*>(w);
  const float* u_ = static_cast<const float*>(u);
  const float* s0_ = static_cast<const float*>(s0);
  T* y_ = static_cast<T*>(y);
  float* sf_ = static_cast<float*>(s_final);
  cudaError_t err;
  if (t <= kTC) {                     // a decode step
    auto kernel = wkv6_kernel_columns<T, TW, HD>;
    const size_t smem = Raw<T, TW, HD, HD>::bytes + HD * sizeof(float);
    static std::atomic<uint64_t> smem_set{0};
    err = allow_smem_once(smem_set, kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if ((int64_t)b * h > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)(b * h), HD, smem, stream>>>(
        r_, k_, v_, w_, u_, s0_, y_, sf_, t, h, rs, ks, vs, ws, vec);
    return (int)cudaGetLastError();
  }
  using Sp = Split<HD>;
  auto kernel = wkv6_kernel<T, TW, HD>;
  const size_t smem = Sp::template smem_bytes<T, TW>();
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)b * h * Sp::G;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tr{}, tk{}, tw{}, tv{};
  if (vec && !(make_map<T>(&tr, r, b, t, h, HD, rs, HD) &&
               make_map<T>(&tk, k, b, t, h, HD, ks, HD) &&
               make_map<TW>(&tw, w, b, t, h, HD, ws, HD) &&
               make_map<T>(&tv, v, b, t, h, HD, vs, kCG)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, Sp::NT, smem, stream>>>(
      r_, k_, v_, w_, u_, s0_, y_, sf_, t, h, rs, ks, vs, ws, vec, tr, tk,
      tw, tv);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const void* w, const void* u, const void* s0, void* y,
                void* s_final, int b, int t, int h, Strides rs, Strides ks,
                Strides vs, Strides ws, int vec, cudaStream_t stream) {
#define REPRO_HD(HD)                                                      \
  case HD:                                                                \
    return launch<T, TW, HD>(r, k, v, w, u, s0, y, s_final, b, t, h, rs,  \
                             ks, vs, ws, vec, stream)
  switch (hd) {
    REPRO_HD(16);
    REPRO_HD(32);
    REPRO_HD(64);
    REPRO_HD(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_HD
}

// TMA and cp.async copy 16-byte units: every row of every input must
// start on a 16-byte boundary (v's column groups start 16 elements apart)
bool aligned16(const void* p, Strides s, int elem) {
  const int64_t n = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % n == 0 &&
         s.t % n == 0 && s.h % n == 0;
}

}  // namespace

extern "C" {

// r, k, v: (B, T, H, hd) of one dtype (bf16 != 0: bfloat16, else
// float32); w: the same shape, bfloat16 if w_bf16 else float32; all four
// given by their (b, t, h) element strides with a unit stride along hd.
// u: (H, hd), s0 and s_final: (B, H, hd, hd), float32 and contiguous; y:
// (B, T, H, hd) contiguous in r's dtype.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s_final, int bf16,
             int w_bf16, int b, int t, int h, int hd, int64_t rsb,
             int64_t rst, int64_t rsh, int64_t ksb, int64_t kst, int64_t ksh,
             int64_t vsb, int64_t vst, int64_t vsh, int64_t wsb, int64_t wst,
             int64_t wsh, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || (w_bf16 && !bf16))
    return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rst, rsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      ws{wsb, wst, wsh};
  const int e = bf16 ? 2 : 4, ew = w_bf16 ? 2 : 4;
  const int vec = aligned16(r, rs, e) && aligned16(k, ks, e) &&
                  aligned16(v, vs, e) && aligned16(w, ws, ew);
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return dispatch_hd<float, float>(hd, r, k, v, w, u, s0, y, s_final, b, t,
                                     h, rs, ks, vs, ws, vec, s);
  if (w_bf16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, r, k, v, w, u, s0, y, s_final, b, t, h, rs, ks, vs, ws, vec, s);
  return dispatch_hd<__nv_bfloat16, float>(hd, r, k, v, w, u, s0, y, s_final,
                                           b, t, h, rs, ks, vs, ws, vec, s);
}

}  // extern "C"
