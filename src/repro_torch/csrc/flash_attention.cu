// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Both kernels replace the TPU kernel
//     repro/kernels/flash_attention/kernel.py:flash_attention_bhsd
//     (_flash_kernel): blocked online-softmax attention with an fp32
//     running max, sum and accumulator, causal and sliding-window masks
//     (diff = q_pos - k_pos, both counted from 0; attend iff diff >= 0
//     when causal and diff < window when window > 0), GQA with kv head =
//     q head / group without expanding kv, output in q's dtype, scale
//     1/sqrt(hd).  A q row that no key may attend to returns 0.  Any Sq
//     and Skv: the ragged edge is masked here, nothing is padded.  The
//     inputs are read through (b, h, s) element strides with a unit
//     stride along hd, so the model layout (B, S, H, hd) goes in and out
//     without a transpose copy.
//
// Bound on an H100 SXM at the main path's prefill shape (B = 1, S = 1024,
// Hq = 16, Hkv = 8, hd = 128, bf16, causal): the unmasked pairs need
// 4 * hd * Hq * S(S+1)/2 = 4.30 GFLOP, 4.35 us at the tensor cores' 989
// TFLOP/s; q, k, v and o move 12.6 MB, 3.8 us at 3.35 TB/s.  So the
// function is bound by operations, and only the tensor cores can come
// near that bound.
//
// flash_attention_bf16_kernel (bf16 inputs, the models' path).  A block
// of two consumer warpgroups (256 threads) owns 128 q rows of one
// (batch, q head), 64 rows a warpgroup, and runs both products on the
// tensor cores with wgmma, bf16 x bf16 into fp32:
//   * S = Q K^T: m64n64k16 with Q and the K tile from shared memory.  A
//     bf16 x bf16 product is exact in fp32, so S matches an fp32
//     dot_general up to the order of the sum.
//   * O += P V: m64n{hd}k16 with P from registers and the V tile from
//     shared memory (V is N-major there, so the instruction transposes
//     it).  P is rounded to bf16 as the A operand, as FlashAttention does;
//     this is the one place where the kernel rounds more than the fp32
//     reference.  S's accumulator layout is the A-fragment layout of the
//     next product, so P never leaves the registers.
// K and V tiles of 64 rows, in bf16, arrive by TMA (one thread issues a
// box per tile; rows past Skv arrive as zeros) into a ring of four stages
// whose mbarriers the consumers wait on, two tiles ahead of use, so the
// warpgroups spend no instructions on loads; the two warpgroups share
// every K and V tile, which halves the tiles' traffic from L2.  Shared
// memory uses wgmma's no-swizzle core-matrix layout (8 rows x 16 bytes
// contiguous), which a 5-d tensor-map box lands as it is.  Each tile's
// QK^T is issued ahead of the previous tile's PV, and the softmax runs
// while that PV is on the tensor cores (FlashAttention-3's order; nothing
// is in flight across the loop's back edge, or ptxas serializes every
// wgmma).  The online softmax runs in registers: each thread holds 2 rows
// x 16 columns of S, the row max and sum combine over the 4 lanes of a
// quad with shuffles, and ex2.approx takes scores pre-scaled by scale *
// log2(e).  The band decides which kv tiles a block visits, as in the
// TPU kernel; only a tile that crosses the causal diagonal, the window's
// far edge or Skv is masked element by element (a tile outside one
// warpgroup's rows is masked whole and adds 0).  Blocks are numbered
// heaviest first (the last causal q tiles first) so that the last wave is
// not one long tile.  Operands that are not 16-byte aligned (a pointer,
// or a stride that is not a multiple of 8 elements) take the same kernel
// with plain loads in place of TMA.
//
// flash_attention_f32_kernel (fp32 inputs: the models' prefill when
// models/layers.py's COMPUTE_DTYPE is float32).  The reference keeps p and
// v in fp32, so both products stay on the fp32 FMA pipe (TF32 wgmma keeps
// about 3 digits).  At the prefill shape above the function's 4.30 GFLOP
// take 64.2 us at the 67 TFLOP/s fp32 rate: it is bound by operations,
// and the kernel's task is to keep that pipe fed.
//   * Register-blocked outer products.  A half-block of 4 warps owns 64 q
//     rows; lane 8 rg + cg of warp w holds rows 16 w + rg + 4 i (i < 4)
//     against kv columns cg + 8 j (j < 8) of S, and the same rows against
//     16-byte chunks cg + 8 m of O.  Per 16-byte chunk of d, S takes 4 q
//     and 8 k vector loads for 128 FMAs; O takes, per key, one vector
//     load of P and hd/32 (hd/16 at hd 80) of V for hd/2 FMAs.  Q and K
//     rows keep chunk c at c ^ (row & 7) (hd rounded up to 32 floats), so
//     the 4 rows and the 8 columns a warp reads at once fall in distinct
//     banks; P goes through a per-warp buffer (key-major, a thread's 4
//     rows contiguous).
//   * 64-row kv tiles arrive by cp.async into one K and one V buffer: K's
//     next tile is in flight during P V, V's next during the next S; two
//     barriers of the half's 128 threads a tile, each behind a wait for
//     the one copy in flight.  A half uses 112 KB of shared memory at hd
//     128, so a block's two halves fill an SM.
//   * The online softmax runs in registers in the exp2 domain (scores
//     pre-scaled by scale * log2(e)); a row's max and sum combine over
//     the 8 lanes of its row group with shuffles.  Only a tile that
//     crosses the causal diagonal, the window's far edge or Skv is masked
//     element by element.
//   * A block takes a pair of q tiles of one (b, h), the last with the
//     first, the second last with the second: under a causal mask every
//     block then does about the same work (n_qt + 1 kv tiles), and one
//     wave of blocks ends together.  Its two halves split those kv tiles
//     evenly: half 0 takes the heavy tile's first ceil(W / 2), half 1 the
//     light tile's and the rest of the heavy tile's; half 1 leaves its
//     partial softmax of the heavy tile (max, sum, accumulators) in its
//     shared memory and half 0 merges it after a block barrier.  With the
//     heavy tile left to one half, that half ran alone for most of the
//     block's time, 177 us at the shape above against 150 (PERF.md).
// Operands that are not 16-byte aligned take the same kernel with 4-byte
// copies.  At the shape above it takes about 150 us, 43% of its bound.
// What holds it there: a tile's loop issues about 10,700 instructions a
// thread for its 8,192 FFMAs (the cp.async address arithmetic and the
// softmax take most of the rest), and a block fills an SM with 8 warps,
// 2 a scheduler, at 254 registers a thread, so a shared load's latency
// can leave a scheduler idle.  Without the causal mask, where no tile is
// masked or merged, it runs at 34 TFLOP/s, half the fp32 rate; cutting
// the barriers from four a tile to two moved nothing (PERF.md).
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "smem_allowance.cuh"

namespace {

struct Strides {
  int64_t b, h, s;
};

constexpr float kNegInf = -1e30f;

// 16-byte rows: the pointer aligned and every stride a multiple of E
// elements (E of them in 16 bytes)
template <int E>
bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % E == 0 &&
         s.h % E == 0 && s.s % E == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------------
// fp32: register-blocked outer products on the FMA pipe

constexpr int kF32Rows = 64;             // q rows of a half's tile
constexpr int kF32Keys = 64;             // kv rows of a tile
constexpr int kF32Half = 128;            // threads of a half: 4 warps
constexpr int kF32Block = 2 * kF32Half;  // two halves, two q tiles

// Q and K rows in shared memory: hd rounded up to a multiple of 32
// floats, 16-byte chunk c of row r stored at chunk c ^ (r & 7)
template <int HD>
__host__ __device__ constexpr int f32_ld() {
  return (HD + 31) / 32 * 32;
}

// a half's floats: Q and K (64 rows of f32_ld), V (64 rows of HD), then
// each warp's P (64 keys x its 16 rows)
template <int HD>
__host__ __device__ constexpr int f32_half_floats() {
  return 2 * kF32Rows * f32_ld<HD>() + kF32Keys * HD + kF32Keys * kF32Rows;
}

template <int HD>
constexpr size_t f32_smem_bytes() {
  return 2 * sizeof(float) * (size_t)f32_half_floats<HD>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// component e of a vector (e known at compile time)
__device__ __forceinline__ float elem(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}
__device__ __forceinline__ float elem(const float2& x, int e) {
  return e == 0 ? x.x : x.y;
}
// a barrier of one half's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kF32Half) : "memory");
}

// Rows [r0, r0 + 64) of a (rows, HD) fp32 matrix with row stride `ld`
// into shared memory rows of LD floats by cp.async, rows at or past
// `limit` as zeros; SWZ stores 16-byte chunk c of row r at chunk c ^ (r &
// 7).  VEC copies 16-byte chunks, else single floats (operands that are
// not 16-byte aligned).
template <int HD, int LD, bool SWZ, bool VEC>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t ld, int r0, int limit,
                                              int t) {
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int kRowItems = HD / kPer;
#pragma unroll 4
  for (int i = t; i < 64 * kRowItems; i += kF32Half) {
    const int r = i / kRowItems, d = i % kRowItems * kPer;
    const bool in = r0 + r < limit;
    const float* g = in ? src + (int64_t)(r0 + r) * ld + d : src;
    const int col = SWZ ? ((d >> 2) ^ (r & 7)) * 4 + (d & 3) : d;
    if constexpr (VEC)
      cp_async16(dst + r * LD + col, g, in);
    else
      cp_async4(dst + r * LD + col, g, in);
  }
}

// Thread layout of a half: lane 8 rg + cg of warp w holds rows 16 w + rg +
// 4 i (i < 4) of the q tile against kv columns cg + 8 j (j < 8) of S, and
// the same rows against the 16-byte (8-byte at hd 80) chunks cg + 8 m of O
template <int HD>
struct F32Layout {
  static constexpr int LD = f32_ld<HD>();
  static constexpr int VW = HD % 32 == 0 ? 4 : 2;  // floats of an O chunk
  static constexpr int kChunks = HD / (8 * VW);    // a thread's of a row
  static constexpr int kDims = kChunks * VW;       // a thread's dims a row
};

// The kv tiles the band of q rows [q0, q0 + 64) can reach: k <= the last
// q row when causal, k > the first q row - window when windowed.  Returns
// their count; *k_begin the first tile's first key.
__device__ __forceinline__ int f32_band(int q0, int sq, int skv, int causal,
                                        int window, int* k_begin) {
  const int q_last = min(q0 + kF32Rows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  *k_begin = window > 0 ? max(0, q0 - window + 1) / kF32Keys * kF32Keys : 0;
  return k_end > *k_begin ? (k_end - *k_begin + kF32Keys - 1) / kF32Keys
                          : 0;
}

// One half's online softmax over kv tiles [t0, t1) of the band of the q
// tile at q0 (tile t starts at key k_begin + 64 t), into m_run, l_run
// (exp2 domain) and acc.  On return every thread of the half is done with
// its shared memory.
template <int HD, bool VEC>
__device__ __forceinline__ void attend_f32(
    const float* qb, const float* kb, const float* vb, int64_t qss,
    int64_t kss, int64_t vss, int q0, int sq, int skv, int k_begin, int t0,
    int t1, int causal, int window, float scale_log2, float* smem, int bar,
    float (&m_run)[4], float (&l_run)[4],
    float (&acc)[4][F32Layout<HD>::kDims]) {
  using Lay = F32Layout<HD>;
  constexpr int LD = Lay::LD, VW = Lay::VW, kDims = Lay::kDims;
  using VecW = std::conditional_t<VW == 4, float4, float2>;
  if (t0 >= t1) return;
  const int t = threadIdx.x % kF32Half;
  const int warp = t >> 5, rg = (t & 31) >> 3, cg = t & 7;
  float* sq_tile = smem;
  float* sk = sq_tile + kF32Rows * LD;
  float* sv = sk + kF32Keys * LD;
  float* sp = sv + kF32Keys * HD + warp * kF32Keys * 16;  // this warp's P

  // cp.async: Q with K's first tile, then V's; in the loop K's next tile
  // during P V, V's next during the next scores.  Two barriers a tile,
  // each behind a wait for the one group in flight: after the scores (K
  // free, V and P visible) and after P V (V free, K's next visible).
  const int k_first = k_begin + t0 * kF32Keys;
  load_rows_f32<HD, LD, true, VEC>(sq_tile, qb, qss, q0, sq, t);
  load_rows_f32<HD, LD, true, VEC>(sk, kb, kss, k_first, skv, t);
  cp_async_commit();
  load_rows_f32<HD, HD, false, VEC>(sv, vb, vss, k_first, skv, t);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K's first tile (this thread's copies)
  half_sync(bar);      // everyone's

  // row i's Q at q_row + 4 i LD, chunk c at (c ^ (rg + 4 i & 7)); column
  // j's K at k_row + 8 j LD, chunk c at (c ^ cg)
  const float* q_row = sq_tile + (16 * warp + rg) * LD;
  const float* k_row = sk + cg * LD;
  for (int it = t0; it < t1; ++it) {
    const int k0 = k_begin + it * kF32Keys;

    // S = Q K^T: per 16-byte chunk of d, 12 vector loads for 128 FMAs
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < HD / 4; c += 8) {
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {
        if (HD % 32 != 0 && c + cb >= HD / 4) break;
        float4 qv[4], kv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              q_row + 4 * i * LD + 4 * (c + (cb ^ ((rg + 4 * i) & 7))));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              k_row + 8 * j * LD + 4 * (c + (cb ^ cg)));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }

    // the online softmax in the exp2 domain; only a tile that crosses
    // the causal diagonal, the window's far edge or Skv is masked
    const bool edge = k0 + kF32Keys > skv ||
                      (causal && k0 + kF32Keys - 1 > q0) ||
                      (window > 0 && q0 + kF32Rows - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 16 * warp + rg + 4 * i;
      uint32_t ok = 0xffu;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= scale_log2;
        if (edge) {
          const int kpos = k0 + cg + 8 * j;
          const int diff = qpos - kpos;
          if (!(kpos < skv && (!causal || diff >= 0) &&
                (window <= 0 || diff < window))) {
            ok &= ~(1u << j);
            s[i][j] = kNegInf;
          }
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = exp2f(m_run[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = (ok >> j) & 1u ? exp2f(s[i][j] - m_new) : 0.0f;
        psum += s[i][j];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_run[i] = l_run[i] * corr + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= corr;
    }
    // P to this warp's buffer: key j's 16 rows, thread rows at 4 rg
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(sp + (cg + 8 * j) * 16 + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_async_wait<0>();  // this V tile
    half_sync(bar);      // K read by every warp; V and P visible
    if (it + 1 < t1) {
      load_rows_f32<HD, LD, true, VEC>(sk, kb, kss, k0 + kF32Keys, skv, t);
      cp_async_commit();
    }

    // O += P V: per key, one 16-byte load of P, kChunks of V
    const float* p_col = sp + 4 * rg;
    const float* v_col = sv + VW * cg;
#pragma unroll 8
    for (int j = 0; j < kF32Keys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(p_col + 16 * j);
#pragma unroll
      for (int m = 0; m < Lay::kChunks; ++m) {
        const VecW vv = *reinterpret_cast<const VecW*>(
            v_col + j * HD + 8 * VW * m);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][m * VW + e] = fmaf(elem(p, i), elem(vv, e),
                                      acc[i][m * VW + e]);
      }
    }
    cp_async_wait<0>();  // K's next tile
    half_sync(bar);      // V read by every warp; K's next visible
    if (it + 1 < t1) {
      load_rows_f32<HD, HD, false, VEC>(sv, vb, vss, k0 + kF32Keys, skv, t);
      cp_async_commit();
    }
  }
}

// A half's rows of the q tile at q0, acc / l, into o (rows past sq stay
// unwritten).
template <int HD, bool VEC>
__device__ __forceinline__ void store_f32(
    float* ob, int64_t oss, int q0, int sq, const float (&l_run)[4],
    const float (&acc)[4][F32Layout<HD>::kDims]) {
  using Lay = F32Layout<HD>;
  constexpr int VW = Lay::VW;
  const int t = threadIdx.x % kF32Half;
  const int warp = t >> 5, rg = (t & 31) >> 3, cg = t & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 16 * warp + rg + 4 * i;
    if (r >= sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    float* row = ob + (int64_t)r * oss + VW * cg;
#pragma unroll
    for (int m = 0; m < Lay::kChunks; ++m) {
      float* dst = row + 8 * VW * m;
      if constexpr (VEC && VW == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][4 * m] / denom, acc[i][4 * m + 1] / denom,
            acc[i][4 * m + 2] / denom, acc[i][4 * m + 3] / denom);
      } else if constexpr (VEC) {
        *reinterpret_cast<float2*>(dst) = make_float2(
            acc[i][2 * m] / denom, acc[i][2 * m + 1] / denom);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) dst[e] = acc[i][m * VW + e] / denom;
      }
    }
  }
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(kF32Block, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int hq, int nb, int group, int sq, int skv,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int causal, int window, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "hd: a multiple of 16, <= 128");
  constexpr int kDims = F32Layout<HD>::kDims;
  extern __shared__ __align__(16) float smem_f32[];
  const int half = threadIdx.x / kF32Half;
  const int t = threadIdx.x % kF32Half;
  const int bar = 1 + half;
  float* smem = smem_f32 + half * f32_half_floats<HD>();

  // block x: (b, h) = x % (B Hq), pair x / (B Hq) of q tiles: the last
  // ("heavy") with the first ("light"), the second last with the second,
  // ...; the middle tile of an odd count alone.  Their kv tiles, W in
  // all, are split evenly: half 0 takes the heavy tile's first
  // ceil(W / 2), half 1 the light tile's and the rest of the heavy
  // tile's, whose partial softmax half 0 then merges.
  const int n_qt = (sq + kF32Rows - 1) / kF32Rows;
  const int n_bh = hq * nb;
  const int pair = (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int h = bh % hq, b = bh / hq;
  const int hk = h / group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int qh = (n_qt - 1 - pair) * kF32Rows, ql = pair * kF32Rows;
  const bool light = ql < qh;
  int kh = 0, kl = 0;
  const int th = f32_band(qh, sq, skv, causal, window, &kh);
  const int tl = light ? f32_band(ql, sq, skv, causal, window, &kl) : 0;
  const int split = min(th, (th + tl + 1) / 2);

  float m_run[4], l_run[4], acc[4][kDims];
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_run[i] = kNegInf;
      l_run[i] = 0.0f;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] = 0.0f;
    }
  };
  reset();
  if (half == 0) {
    attend_f32<HD, VEC>(qb, kb, vb, qs.s, ks.s, vs.s, qh, sq, skv, kh, 0,
                        split, causal, window, scale_log2, smem, bar, m_run,
                        l_run, acc);
  } else {
    if (light) {
      attend_f32<HD, VEC>(qb, kb, vb, qs.s, ks.s, vs.s, ql, sq, skv, kl, 0,
                          tl, causal, window, scale_log2, smem, bar, m_run,
                          l_run, acc);
      store_f32<HD, VEC>(ob, os.s, ql, sq, l_run, acc);
      reset();
    }
    attend_f32<HD, VEC>(qb, kb, vb, qs.s, ks.s, vs.s, qh, sq, skv, kh,
                        split, th, causal, window, scale_log2, smem, bar,
                        m_run, l_run, acc);
    // the heavy tile's partial softmax, thread t's values at t + 128 e
    float* part = smem;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[i * kF32Half + t] = m_run[i];
      part[(4 + i) * kF32Half + t] = l_run[i];
#pragma unroll
      for (int e = 0; e < kDims; ++e)
        part[(8 + i * kDims + e) * kF32Half + t] = acc[i][e];
    }
  }
  __syncthreads();
  if (half == 1) return;
  // half 0 merges half 1's part of the heavy tile into its own: thread t
  // of each half holds the same rows and dims
  const float* part = smem_f32 + f32_half_floats<HD>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m1 = part[i * kF32Half + t];
    const float l1 = part[(4 + i) * kF32Half + t];
    const float m = fmaxf(m_run[i], m1);
    const float c0 = exp2f(m_run[i] - m), c1 = exp2f(m1 - m);
    l_run[i] = l_run[i] * c0 + l1 * c1;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      acc[i][e] = acc[i][e] * c0 +
                  part[(8 + i * kDims + e) * kF32Half + t] * c1;
  }
  store_f32<HD, VEC>(ob, os.s, qh, sq, l_run, acc);
}

template <int HD, bool VEC>
int launch_f32_v(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int group, int sq, int skv, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  auto kernel = flash_attention_f32_kernel<HD, VEC>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + kF32Rows - 1) / kF32Rows;
  const int64_t blocks = (int64_t)((n_qt + 1) / 2) * hq * b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kF32Block, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, b,
      group, sq, skv, qs, ks, vs, os, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int group, int sq, int skv, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  if (aligned16<4>(q, qs) && aligned16<4>(k, ks) && aligned16<4>(v, vs) &&
      aligned16<4>(o, os))
    return launch_f32_v<HD, true>(q, k, v, o, b, hq, group, sq, skv, qs, ks,
                                  vs, os, causal, window, scale, stream);
  return launch_f32_v<HD, false>(q, k, v, o, b, hq, group, sq, skv, qs, ks,
                                 vs, os, causal, window, scale, stream);
}

// ----------------------------------------------------------------------
// bf16: wgmma on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kM = 64;        // q rows per warpgroup: wgmma's M
constexpr int kN = 64;        // kv rows per tile
constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kWGs = 2;       // consumer warpgroups per block
constexpr int kBlock = kWGs * kWG;
constexpr int kStages = 4;    // the K/V ring

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(kWGs * kM + 2 * kStages * kN) * HD * sizeof(bf16) +
         (kStages + 1) * sizeof(uint64_t);
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// the byte offset between core matrices adjacent along K (leading) and
// along M or N (stride), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// writes by the generic proxy (st.shared) become visible to wgmma, which
// reads shared memory through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// one box of the 5-d tensor map (see make_map) into shared memory: rows
// from `row` of head h, batch b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int row, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
      "[%7];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(0), "r"(row), "r"(0), "r"(h),
         "r"(b), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define REPRO_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define REPRO_ACC8(d, i) REPRO_ACC4(d, i), REPRO_ACC4(d, i + 4)
#define REPRO_ACC16(d, i) REPRO_ACC8(d, i), REPRO_ACC8(d, i + 8)

// D (64 x 64, fp32) (+)= A (64 x 16) * B (16 x 64), A and B K-major in
// shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC16(d, 0), REPRO_ACC16(d, 16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16, bf16 in registers) * B (16 x N), B
// N-major in shared memory (transposed by the instruction), N = 2 x the
// length of d.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC16(d, 0), REPRO_ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : REPRO_ACC16(d, 0), REPRO_ACC16(d, 16), REPRO_ACC8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC16(d, 0), REPRO_ACC16(d, 16), REPRO_ACC16(d, 32),
        REPRO_ACC16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_ACC16
#undef REPRO_ACC8
#undef REPRO_ACC4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tiles in shared memory use wgmma's no-swizzle core-matrix layout in
// the order a TMA box of the tensor map below lands: 16-byte chunk c of
// row r (columns 8 c .. 8 c + 7) at byte (c * ROWS + r) * 16, so a core
// matrix (8 rows x 16 bytes) is 128 contiguous bytes, the next 8 rows
// follow at 128 bytes and the next 8 columns at ROWS * 16 bytes.
//
// Rows [row0, row0 + ROWS) of a (rows, HD) bf16 matrix with row stride
// `ld` into that layout with plain loads, for operands TMA cannot take
// (not 16-byte aligned); rows at or past `limit` are zeros.  Chunk n goes
// to byte n * 16, so the stores are linear.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile_plain(char* dst, const bf16* src,
                                                int64_t ld, int row0,
                                                int limit) {
  constexpr int kChunks = ROWS * HD / 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kBlock - 1) / kBlock; ++i) {
    const int n = threadIdx.x + i * kBlock;
    if (kChunks % kBlock != 0 && n >= kChunks) break;
    const int row = row0 + n % ROWS;
    const unsigned short* g = reinterpret_cast<const unsigned short*>(
        src + (int64_t)row * ld + (n / ROWS) * 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) {
      val.x = g[0] | ((uint32_t)g[1] << 16);
      val.y = g[2] | ((uint32_t)g[3] << 16);
      val.z = g[4] | ((uint32_t)g[5] << 16);
      val.w = g[6] | ((uint32_t)g[7] << 16);
    }
    *reinterpret_cast<uint4*>(dst + n * 16) = val;
  }
  fence_proxy_async();
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(kBlock)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int hq, int nb, int group, int sq, int skv,
                            Strides qs, Strides ks, Strides vs, Strides os,
                            int causal, int window, float scale_log2,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv) {
  static_assert(HD % 16 == 0 && HD <= 128, "hd: a multiple of 16, <= 128");
  constexpr int kTile = kN * HD * 2;        // bytes of one K or V tile
  extern __shared__ __align__(128) char smem_bf16[];
  // the q tiles of the two warpgroups (64 rows each), then the ring:
  // stage st holds its K tile at s_kv + 2 st kTile and its V tile after
  // it; then a barrier for q and one per stage
  char* s_q = smem_bf16;
  char* s_kv = smem_bf16 + kWGs * kM * HD * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_kv + kStages * 2 * kTile);
  uint64_t* bar_q = bar + kStages;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) >> 5, lane = tid & 31;

  // heaviest first: the last q tiles of every (b, h) come first
  constexpr int kRows = kWGs * kM;
  const int n_qt = (sq + kRows - 1) / kRows;
  const int n_bh = hq * nb;
  const int qt = n_qt - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int h = bh % hq, b = bh / hq;
  const int hk = h / group;
  const int q0 = qt * kRows;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // the kv tiles the band of the block's rows can reach, as in the fp32
  // kernel
  const int q_last = min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kN * kN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kN - 1) / kN : 0;
  const int wq0 = q0 + wg * kM;          // this warpgroup's first row

  if (tid == 0) {
    for (int st = 0; st <= kStages; ++st) mbar_init(bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile it's K and V into its stage: two TMA boxes issued by one thread
  // (rows past Skv arrive as zeros), or plain loads by every thread
  auto load_kv = [&](int it) {
    const int k0 = k_begin + it * kN;
    char* st = s_kv + (it % kStages) * 2 * kTile;
    uint64_t* sb = bar + it % kStages;
    if constexpr (VEC) {
      if (tid == 0) {
        mbar_expect(sb, 2 * kTile);
        tma_load(st, &tk, k0, hk, b, sb);
        tma_load(st + kTile, &tv, k0, hk, b, sb);
      }
    } else {
      load_tile_plain<kN, HD>(st, kb, ks.s, k0, skv);
      load_tile_plain<kN, HD>(st + kTile, vb, vs.s, k0, skv);
      if (tid == 0) mbar_expect(sb, 0);
    }
  };
  if constexpr (VEC) {
    if (tid == 0) {
      mbar_expect(bar_q, kWGs * kM * HD * 2);
      for (int w = 0; w < kWGs; ++w)
        tma_load(s_q + w * kM * HD * 2, &tq, q0 + w * kM, h, b, bar_q);
    }
  } else {
    for (int w = 0; w < kWGs; ++w)
      load_tile_plain<kM, HD>(s_q + w * kM * HD * 2, qb, qs.s, q0 + w * kM,
                              sq);
    if (tid == 0) mbar_expect(bar_q, 0);
  }
#pragma unroll
  for (int it = 0; it < kStages - 2; ++it)
    if (it < n_tiles) load_kv(it);

  // this thread's rows of its warpgroup's tile (wgmma's accumulator
  // layout): r0 and r0 + 8; its columns in each 8-wide block: 2 (lane %
  // 4) and + 1
  const int r0 = wq0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int c0 = (lane & 3) * 2;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  // running max (raw scores) and this thread's part of the running sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  // K-major Q and K: the next 8 columns at 64 * 16 bytes (leading), the
  // next 8 rows at 128 (stride); a k16 step is 2 chunks = 2048 bytes
  const uint64_t dq = smem_desc(smem_u32(s_q + wg * kM * HD * 2),
                                kM * 16, 128);

  auto stage = [&](int it) {
    return smem_u32(s_kv + (it % kStages) * 2 * kTile);
  };
  // issue S = Q K^T of tile it, hd / 16 steps of k16; not waited
  float s[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) s[i] = 0.0f;
  auto qk = [&](int it) {
    const uint64_t dk = smem_desc(stage(it), kN * 16, 128);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)   // 2 chunks = 2 * 64 * 16 bytes
      wgmma_ss_n64(s, dq + kk * 128, dk + kk * 128, kk > 0);
    wgmma_commit();
  };
  // P of a tile, rounded to bf16: the A fragments of O += P V's k-steps
  // (S's accumulator layout is the A fragment of k-step kk: its 8-column
  // blocks 2 kk and 2 kk + 1)
  uint32_t pa[kN / 16][4];
  // issue O += P V of tile it from pa; not waited
  auto pv = [&](int it) {
    const uint32_t s_v = stage(it) + kTile;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)   // 16 V rows = 256 bytes; V is
      wgmma_rs(acc, pa[kk],               // N-major: the next 8 rows at
               smem_desc(s_v + kk * 256, 128, kN * 16));   // 128 bytes

    wgmma_commit();
  };
  // the online softmax of tile it's scores in s, in place: s becomes P;
  // returns the factor the output must take before P V is added.  kMask
  // masks element by element (a tile on the causal diagonal, the
  // window's far edge or Skv); a row with nothing to attend to yet keeps
  // p = 0 and a factor of 0
  auto softmax = [&](int it, auto mask_tag) {
    constexpr bool kMask = decltype(mask_tag)::value;
    const int k0 = k_begin + it * kN;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      if constexpr (kMask) {
        const int kpos = k0 + (i >> 2) * 8 + c0 + (i & 1);
        const int diff = ((i & 2) ? r1 : r0) - kpos;
        const bool ok = kpos < skv && (!causal || diff >= 0) &&
                        (window <= 0 || diff < window);
        s[i] = ok ? s[i] : -INFINITY;
      }
      if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // the new maxima in the log2 domain
    const float b0 = n0 == -INFINITY ? 0.0f : n0 * scale_log2;
    const float b1 = n1 == -INFINITY ? 0.0f : n1 * scale_log2;
    const float2 corr = make_float2(ex2(m0 * scale_log2 - b0),
                                    ex2(m1 * scale_log2 - b1));
    m0 = n0;
    m1 = n1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? -b1 : -b0));
      s[i] = p;
      if (i & 2) ps1 += p; else ps0 += p;
    }
    l0 = l0 * corr.x + ps0;            // this thread's columns; the quad's
    l1 = l1 * corr.y + ps1;            // four partial sums meet at the end
    return corr;
  };

  // tile it has landed; every thread is past tile it - 1, so the stage
  // of tile it - 2 is free
  auto wait_tile = [&](int it) {
    mbar_wait(bar + it % kStages, (it / kStages) & 1);
    __syncthreads();
  };
  auto scores = [&](int it) {         // softmax of tile it after its QK^T
    const int k0 = k_begin + it * kN;
    const bool edge = k0 + kN > skv || (causal && k0 + kN - 1 > wq0) ||
                      (window > 0 && wq0 + kM - 1 - k0 >= window);
    return edge ? softmax(it, std::true_type{})
                : softmax(it, std::false_type{});
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale_o = [&](float2 corr) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? corr.y : corr.x;
  };

  // Tile it's S = Q K^T is issued ahead of tile it - 1's O += P V, and
  // tile it's softmax runs while that product is on the tensor cores;
  // nothing is in flight across the loop's back edge.  Both warpgroups
  // run every tile of the block's band: a tile outside one warpgroup's
  // own rows is masked whole and adds exactly 0.
  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    wait_tile(0);
    if (kStages - 2 < n_tiles) load_kv(kStages - 2);
    qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    float2 corr = scores(0);
    pack();
    for (int it = 1; it < n_tiles; ++it) {
      wait_tile(it);
      if (it + kStages - 2 < n_tiles) load_kv(it + kStages - 2);
      rescale_o(corr);
      qk(it);
      pv(it - 1);
      wgmma_wait<1>();                // S of tile it
      fence_regs(s);
      corr = scores(it);
      wgmma_wait<0>();                // O += P V of tile it - 1
      fence_regs(acc);
      pack();
    }
    rescale_o(corr);
    pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= sq) continue;
      const float inv = half ? inv1 : inv0;
      const float x0 = acc[4 * j + 2 * half] * inv;
      const float x1 = acc[4 * j + 2 * half + 1] * inv;
      bf16* dst = ob + (int64_t)r * os.s + j * 8 + c0;
      if constexpr (VEC) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
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

// A (B, H, S, hd) bf16 view with strides `st` as the 5-d tensor (8
// columns of a 16-byte chunk, S rows, hd / 8 chunks, H, B), whose box of
// (8, `rows`, hd / 8, 1, 1) lands in the core-matrix layout of
// load_tile_plain; rows past S are filled with zeros
bool make_map(CUtensorMap* map, const void* base, int b, int h, int s,
              int hd, Strides st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {8, (cuuint64_t)s, (cuuint64_t)(hd / 8),
                              (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[4] = {(cuuint64_t)st.s * 2, 16,
                                 (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)(hd / 8), 1,
                             1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool VEC>
int launch_bf16_v(const void* q, const void* k, const void* v, void* o,
                  int b, int hq, int hkv, int sq, int skv, Strides qs,
                  Strides ks, Strides vs, Strides os, int causal, int window,
                  float scale, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<HD>();
  auto kernel = flash_attention_bf16_kernel<HD, VEC>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((sq + kWGs * kM - 1) / (kWGs * kM)) * hq * b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq{}, tk{}, tv{};
  if (VEC && !(make_map(&tq, q, b, hq, sq, HD, qs, kM) &&
               make_map(&tk, k, b, hkv, skv, HD, ks, kN) &&
               make_map(&tv, v, b, hkv, skv, HD, vs, kN)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, hq, b,
      hq / hkv, sq, skv, qs, ks, vs, os, causal, window,
      scale * 1.4426950408889634f, tq, tk, tv);
  return (int)cudaGetLastError();
}

// TMA and the paired bf16 stores need 16-byte aligned rows (aligned16<8>).
// With no key (Skv = 0) a tensor map cannot be encoded (a zero
// dimension), and no tile is loaded: the plain-load kernel writes the
// rows' zeros.

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int window, float scale,
                cudaStream_t stream) {
  if (skv > 0 && aligned16<8>(q, qs) && aligned16<8>(k, ks) &&
      aligned16<8>(v, vs) && aligned16<8>(o, os))
    return launch_bf16_v<HD, true>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks,
                                   vs, os, causal, window, scale, stream);
  return launch_bf16_v<HD, false>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks,
                                  vs, os, causal, window, scale, stream);
}

template <int HD>
int launch(bool bf16_in, const void* q, const void* k, const void* v,
           void* o, int b, int hq, int group, int sq, int skv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int window,
           float scale, cudaStream_t stream) {
  if (bf16_in)
    return launch_bf16<HD>(q, k, v, o, b, hq, hq / group, sq, skv, qs, ks,
                           vs, os, causal, window, scale, stream);
  return launch_f32<HD>(q, k, v, o, b, hq, group, sq, skv, qs, ks, vs, os,
                        causal, window, scale, stream);
}

}  // namespace

extern "C" {

// q: (B, Hq, Sq, hd), k and v: (B, Hkv, Skv, hd), o: (B, Hq, Sq, hd), all
// of one dtype (bf16 != 0: bfloat16, else float32), given by their
// (b, h, s) element strides with a unit stride along hd.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int bf16, int b, int hq, int hkv, int sq,
                        int skv, int hd, int64_t qsb, int64_t qsh,
                        int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                        int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                        int64_t osh, int64_t oss, int causal, int window,
                        float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      skv < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  const int group = hq / hkv;
#define REPRO_HD(HD)                                                     \
  case HD:                                                               \
    return launch<HD>(bf16 != 0, q, k, v, o, b, hq, group, sq, skv, qs,  \
                      ks, vs, os, causal, window, scale, s)
  switch (hd) {
    REPRO_HD(32);
    REPRO_HD(64);
    REPRO_HD(80);
    REPRO_HD(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_HD
}

}  // extern "C"
