// Diagonal selective scan (the mamba branch of hymba) forward for Hopper
// (sm_90a), plain C interface.
//
//   ssm_scan_kernel, ssm_scan_kernel_decode  replace the TPU kernel
//       repro/kernels/ssm_scan/kernel.py:ssm_scan_btd (_ssm_kernel): per
//       batch row b, channel c < di and state n < N, over tokens t,
//           h[c][n] <- a_t[c] · h[c][n] + bx_t[c] · B_t[n]
//           y_t[c]   = Σ_n h[c][n] · C_t[n]
//       a, bx: (Bz, T, di), B, C: (Bz, T, N), all bf16 or all fp32; h0
//       and h_last: (Bz, di, N) fp32; y in a's dtype.
//
// Bound on an H100 SXM at the hymba-1.5b prefill shape (Bz = 1, T = 1152
// = 1024 prompt + 128 meta tokens, di = 3200, N = 16, fp32): a, bx and y
// move 3 * 14.7 MB, B and C 0.15 MB, h0 and h_last 0.4 MB: 44.8 MB, 13.4
// us at 3.35 TB/s; 5 operations per (t, c, n), 0.30 GFLOP, 4.4 us at 67
// TFLOP/s.  So the function is bound by bytes.  This kernel reads a, bx,
// B and C twice, once for a chunk's local scan and once for its rescan:
// 74 MB, 22.2 us if both reads came from device memory.  The second read
// of a chunk follows the first by microseconds, so it should come from
// the 50 MB L2; no tool on the card's machine can confirm it, so both
// bounds are kept (PERF.md §6).  Its own traffic besides: each chunk's
// published states, (1 + 2 NP) floats a channel, 3.8 MB at that shape,
// and their reads (7.8 MB), all through the L2.
//
// ssm_scan_kernel (T > kDecodeT).  A sequence is cut into chunks of
// kChunk tokens, and a block owns one chunk of kCG channels, one channel
// a thread with all NP of its states in registers (N padded to the next
// power of two; the padding states see B = C = 0 and stay 0).  So y_t[c]
// is a run of independent register FMAs, with B_t and C_t read from
// shared memory as 16-byte broadcasts: no shuffle on a token's path.
// Splitting T gives B = 1 its parallelism: hymba's prefill is 50 channel
// groups x 9 chunks = 450 blocks of 2 warps, all resident at once (30 KB
// of shared memory each in fp32), where one block per channel group over
// the whole sequence had 200.  A block
//   1. takes a ticket from an atomic counter and works on the chunk that
//      ticket names, chunk-major: every chunk it waits for holds a smaller
//      ticket, so it has started (the waits make progress whatever order
//      the card schedules blocks in);
//   2. streams the chunk through a ring of kRing stages, a box of kSub
//      tokens each, filled by TMA kRing boxes ahead of use, each stage
//      completing its own mbarrier (tokens past T, channels past di and
//      states past N arrive as zeros; rows that are not 16-byte aligned
//      are copied element by element instead), and scans it from a zero
//      state: (A, b), A = Π a_t the decay of each channel over the chunk
//      and b its state reached from zero;
//   3. publishes (A, b) with a flag;
//   4. composes the state entering the chunk in a fixed order, so that
//      every call gives the same bits whichever block runs first: every
//      kAnchor-th chunk is an anchor, and the pairs of the chunks between
//      the anchor below this one and this one are composed from the back,
//      (A1, b1) ∘ (A2, b2) = (A1 A2, A2 b1 + b2), as ref.py's
//      _associative_scan composes them (no ratio of decay products, which
//      would underflow for long chunks with a << 1), onto that anchor's
//      inclusive state (h0 below the first anchor: at hymba's 9 chunks
//      every chunk composes onto h0).  One lane of warp 0 waits for each
//      chunk it reads.  An anchor publishes A · h_in + b, flag 2;
//   5. streams the chunk through the ring again (its first boxes were
//      issued as the local scan freed their stages) and rescans it from
//      h_in, writing y; the last chunk of a sequence writes h_last.
// The scans only ever walk a chunk's real tokens: the zeros past T never
// touch a carried state.  A call is one cudaMemsetAsync of the ticket
// counter and flags ((chunks x groups x Bz + 1) words, 1.8 KB at hymba's
// prefill) and one launch.  Streaming was chosen over holding a whole
// chunk in shared memory (one read of a and bx, 64-token chunks, 40 KB a
// block and 1.4 waves at that shape): with the same fixed-order
// composition that design took 46.7 us against this one's 37.7-38.1 at
// hymba's prefill, and 118.1 against 104.9 at Bz = 3 (PERF.md §6).
//
// ssm_scan_kernel_decode (T <= kDecodeT: a decode step).  Bound by moving
// h0 and h_last (1.64 MB each at Bz = 8, di = 3200, N = 16), so one
// thread owns 4 states of one channel: the 4 threads of a channel read
// and write its 64-byte state row in 16-byte accesses, a warp 512
// contiguous bytes.  a, bx, B and C come straight from device memory,
// y_t[c] is summed over the channel's threads by two shuffles and written
// directly: no shared staging, no barrier.
//
// Any T >= 1 and any di are taken, with no padding of the inputs; a, bx,
// B and C are read through (b, t) element strides with a unit stride
// along the last axis.
#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem_allowance.cuh"

namespace {

constexpr int kCG = 64;                  // channels a block, one a thread
constexpr int kSub = 16;                 // tokens a TMA box
constexpr int kBoxes = 8;                // boxes a chunk
constexpr int kChunk = kSub * kBoxes;    // tokens a block
constexpr int kRing = 3;                 // stages of the TMA ring
// every kAnchor-th chunk publishes its inclusive state, onto which the
// chunks after it compose (at most kAnchor - 1 pairs each)
constexpr int kAnchor = 32;
constexpr int kDecodeT = 8;              // T <= kDecodeT: decode kernel
constexpr int kDecodeThreads = 256;
// a wait on a TMA box or an earlier chunk that has not ended after this
// many ns traps: a fault the launch reports, not a hang
constexpr uint64_t kWaitLimitNs = 2000000000ull;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0.f); }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// NP consecutive values from 16-byte aligned shared memory, as fp32
template <int NP>
__device__ __forceinline__ void load_row(const float* p, float (&o)[NP]) {
  if constexpr (NP >= 4) {
#pragma unroll
    for (int q = 0; q < NP; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      o[q] = v.x; o[q + 1] = v.y; o[q + 2] = v.z; o[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NP; ++n) o[n] = p[n];
  }
}
template <int NP>
__device__ __forceinline__ void load_row(const bf16* p, float (&o)[NP]) {
  if constexpr (NP >= 8) {
#pragma unroll
    for (int q = 0; q < NP; q += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + q);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[q + 2 * e] = __uint_as_float(w[e] << 16);
        o[q + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NP; ++n) o[n] = __bfloat162float(p[n]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (const uint64_t t0 = now_ns(); !done;) {
    if (now_ns() - t0 > kWaitLimitNs) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// one box of a (inner, T, Bz) tensor map (see make_map) into shared
// memory: from column x, token t, batch row b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int t, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(x), "r"(t), "r"(b),
         "r"(smem_u32(bar))
      : "memory");
}
// the look-back's flags: release after the chunk's state is written,
// acquire before it is read (the pattern of CUTLASS's generic barrier)
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

struct Strides {
  int64_t b, t;
};

// floats of a chunk's published states for NP states a channel: A, then
// b[NP], then the inclusive state[NP], each kCG channels wide
constexpr int state_floats(int np) { return (1 + 2 * np) * kCG; }

// ----------------------------------------------------------------------
// sequences: a chunk of kChunk tokens x kCG channels a block

template <typename T, int NP>
struct Chunk {
  // row width of B and C in shared memory: a TMA box row is >= 16 bytes
  static constexpr int KB = NP * (int)sizeof(T) >= 16 ? NP
                                                      : 16 / (int)sizeof(T);
  static constexpr int kA = kSub * kCG;    // elements of a (and of bx) a box
  static constexpr int kB = kSub * KB;     // elements of B (and of C) a box
  // bytes one box of each of a, bx, B and C brings (zero fill included)
  static constexpr uint32_t kStageBytes =
      2u * (kA + kB) * (uint32_t)sizeof(T);
  static constexpr size_t smem_bytes =
      kRing * (size_t)kStageBytes + kRing * sizeof(uint64_t) + 16;
  static constexpr int kState = state_floats(NP);
};

template <typename T, int NP>
__global__ void __launch_bounds__(kCG)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int* __restrict__ flags,
                float* __restrict__ states, int n_t, int di, int n_state,
                int bz, Strides as, Strides bxs, Strides Bs, Strides Cs,
                int vec, const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tbx,
                const __grid_constant__ CUtensorMap tB,
                const __grid_constant__ CUtensorMap tC) {
  using Ch = Chunk<T, NP>;
  constexpr int KB = Ch::KB;
  // the ring: stage r holds a box of a, bx [kSub][kCG] and B, C [kSub][KB]
  extern __shared__ __align__(128) unsigned char smem_ssm[];
  auto stage_a = [&](int r) {
    return reinterpret_cast<T*>(smem_ssm + (size_t)r * Ch::kStageBytes);
  };
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem_ssm + kRing * (size_t)Ch::kStageBytes);
  int* s_int = reinterpret_cast<int*>(bar + kRing);   // ticket

  const int tid = threadIdx.x;
  if (tid == 0) {
    s_int[0] = atomicAdd(flags, 1);
    for (int r = 0; r < kRing; ++r) mbar_init(bar + r);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // ticket -> (chunk k, batch row b, channel group g), chunk-major
  const int item = s_int[0];
  const int groups = (di + kCG - 1) / kCG;
  const int per_chunk = bz * groups;
  const int k = item / per_chunk;
  const int rest = item - k * per_chunk;
  const int b = rest / groups, g = rest - b * groups;
  const int c0 = g * kCG, c = c0 + tid;
  const bool live = c < di;
  const int t0 = k * kChunk;
  const int tn = min(kChunk, n_t - t0);
  const int n_boxes = (tn + kSub - 1) / kSub;
  const bool last_chunk = t0 + kChunk >= n_t;

  // use u of the ring (u < n_boxes: the local scan's boxes, then the
  // rescan's, the same boxes again) lands in stage u % kRing; one thread
  // issues its four TMA boxes (tokens past T, channels past di and states
  // past N arrive as zeros)
  const int uses = 2 * n_boxes;
  auto issue = [&](int u) {
    const int r = u % kRing, t = t0 + (u % n_boxes) * kSub;
    T* st = stage_a(r);
    mbar_expect(bar + r, Ch::kStageBytes);
    tma_load(st, &ta, c0, t, b, bar + r);
    tma_load(st + Ch::kA, &tbx, c0, t, b, bar + r);
    tma_load(st + 2 * Ch::kA, &tB, 0, t, b, bar + r);
    tma_load(st + 2 * Ch::kA + Ch::kB, &tC, 0, t, b, bar + r);
  };
  if (vec && tid == 0)
    for (int u = 0; u < kRing && u < uses; ++u) issue(u);
  // rows that are not 16-byte aligned: the box copied element by element
  auto copy = [&](int u) {
    const int box = u % n_boxes, t1 = t0 + box * kSub;
    const int te = min(kSub, tn - box * kSub);
    T* st = stage_a(u % kRing);
    const T* ap = a + b * as.b + (int64_t)t1 * as.t + c;
    const T* bxp = bx + b * bxs.b + (int64_t)t1 * bxs.t + c;
    for (int tt = 0; tt < te; ++tt) {
      st[tt * kCG + tid] = live ? ap[tt * as.t] : zero<T>();
      st[Ch::kA + tt * kCG + tid] = live ? bxp[tt * bxs.t] : zero<T>();
    }
    T* Bst = st + 2 * Ch::kA;
    for (int e = tid; e < te * KB; e += kCG) {
      const int tt = e / KB, n = e - tt * KB;
      const int64_t t = t1 + tt;
      const bool in = n < n_state;
      Bst[e] = in ? Bm[b * Bs.b + t * Bs.t + n] : zero<T>();
      Bst[Ch::kB + e] = in ? Cm[b * Cs.b + t * Cs.t + n] : zero<T>();
    }
  };
  // walk use u's real tokens (never the zeros past T): step(a row, bx
  // row, B row, C row, token of the chunk); then free its stage and
  // refill it kRing uses ahead
  auto walk = [&](int u, auto step) {
    const int r = u % kRing, box = u % n_boxes;
    if (vec) {
      mbar_wait(bar + r, (u / kRing) & 1);
    } else {
      copy(u);
      __syncthreads();
    }
    const T* st = stage_a(r);
    const T* ar = st + tid;
    const T* bxr = st + Ch::kA + tid;
    const T* Br = st + 2 * Ch::kA;
    const T* Cr = Br + Ch::kB;
    const int base = box * kSub;
    if (base + kSub <= tn) {
#pragma unroll
      for (int tt = 0; tt < kSub; ++tt)
        step(ar[tt * kCG], bxr[tt * kCG], Br + tt * KB, Cr + tt * KB,
             base + tt);
    } else {
      for (int tt = 0; tt < tn - base; ++tt)
        step(ar[tt * kCG], bxr[tt * kCG], Br + tt * KB, Cr + tt * KB,
             base + tt);
    }
    __syncthreads();
    if (vec && tid == 0 && u + kRing < uses) issue(u + kRing);
  };

  // 2. the chunk from a zero state: h = b, decay A
  float h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = 0.f;
  float A = 1.f;
  for (int u = 0; u < n_boxes; ++u)
    walk(u, [&](T a_t, T bx_t, const T* B_t, const T*, int) {
      const float av = to_f(a_t), bv = to_f(bx_t);
      float Bt[NP];
      load_row<NP>(B_t, Bt);
#pragma unroll
      for (int n = 0; n < NP; ++n) h[n] = fmaf(av, h[n], bv * Bt[n]);
      A *= av;
    });

  // 3-4. publish (A, b); compose the state entering the chunk in a fixed
  // order: onto the inclusive state of the anchor below (chunk
  // k / kAnchor * kAnchor - 1, or h0 when that is -1), the pairs of the
  // chunks after it, from the back.  The result does not depend on which
  // block ran first.
  float* mine = states + (size_t)item * Ch::kState;
  const int anchor = k / kAnchor * kAnchor - 1;
  if (!last_chunk) {
    mine[tid] = A;
#pragma unroll
    for (int n = 0; n < NP; ++n) mine[(1 + n) * kCG + tid] = h[n];
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flags + 1 + item, 1);
  }
  float hin[NP];
  if (k > 0) {
    // lane l waits for chunk k - 1 - l: for its pair (flag 1), or for
    // the anchor's inclusive state (flag 2); k - 1 - anchor < kAnchor
    // lanes wait, all in warp 0
    const int j = k - 1 - tid;
    if (j >= 0 && j >= anchor) {
      const int need = j == anchor ? 2 : 1;
      const int* f = flags + 1 + j * per_chunk + rest;
      for (const uint64_t w0 = now_ns(); ld_acquire(f) < need;) {
        if (now_ns() - w0 > kWaitLimitNs) __trap();
        __nanosleep(32);
      }
    }
    __syncthreads();
    float PA = 1.f, Pb[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n) Pb[n] = 0.f;
#pragma unroll 4
    for (int jj = k - 1; jj > anchor; --jj) {
      const float* o = states + (size_t)(jj * per_chunk + rest) * Ch::kState;
      const float Aj = __ldcg(o + tid);
#pragma unroll
      for (int n = 0; n < NP; ++n)
        Pb[n] = fmaf(PA, __ldcg(o + (1 + n) * kCG + tid), Pb[n]);
      PA *= Aj;
    }
    if (anchor >= 0) {
      const float* o = states +
                       (size_t)(anchor * per_chunk + rest) * Ch::kState +
                       (1 + NP) * kCG + tid;
#pragma unroll
      for (int n = 0; n < NP; ++n) hin[n] = __ldcg(o + n * kCG);
    } else {
#pragma unroll
      for (int n = 0; n < NP; ++n)
        hin[n] = live && n < n_state
                     ? h0[((int64_t)b * di + c) * n_state + n] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) hin[n] = fmaf(PA, hin[n], Pb[n]);
  } else {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      hin[n] = live && n < n_state
                   ? h0[((int64_t)b * di + c) * n_state + n] : 0.f;
  }
  if (!last_chunk && (k + 1) % kAnchor == 0) {   // an anchor
#pragma unroll
    for (int n = 0; n < NP; ++n)
      mine[(1 + NP + n) * kCG + tid] = fmaf(A, hin[n], h[n]);
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flags + 1 + item, 2);
  }

  // 5. rescan from h_in, the chunk's boxes again, writing y
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = hin[n];
  T* yp = y + ((int64_t)b * n_t + t0) * di + c;
  for (int u = n_boxes; u < uses; ++u)
    walk(u, [&](T a_t, T bx_t, const T* B_t, const T* C_t, int tt) {
      const float av = to_f(a_t), bv = to_f(bx_t);
      float Bt[NP], Ct[NP];
      load_row<NP>(B_t, Bt);
      load_row<NP>(C_t, Ct);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        h[n] = fmaf(av, h[n], bv * Bt[n]);
        p[n & 3] = fmaf(h[n], Ct[n], p[n & 3]);
      }
      if (live) store(yp + (int64_t)tt * di, (p[0] + p[1]) + (p[2] + p[3]));
    });
  if (last_chunk && live) {
    float* hp = h_last + ((int64_t)b * di + c) * n_state;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < n_state) hp[n] = h[n];
  }
}

// ----------------------------------------------------------------------
// decode steps (T <= kDecodeT): 4 states of one channel a thread

template <typename T, int NP>
__global__ void __launch_bounds__(kDecodeThreads)
ssm_scan_kernel_decode(const T* __restrict__ a, const T* __restrict__ bx,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, int n_t, int di,
                       int n_state, int bz, Strides as, Strides bxs,
                       Strides Bs, Strides Cs, int quad) {
  constexpr int Q = NP < 4 ? NP : 4;     // states a thread
  constexpr int G = NP / Q;              // threads a channel, adjacent lanes
  const int64_t idx = (int64_t)blockIdx.x * kDecodeThreads + threadIdx.x;
  const int q = (int)(idx % G);
  const int64_t bc = idx / G;
  const bool live = bc < (int64_t)bz * di;
  const int b = live ? (int)(bc / di) : 0;
  const int c = live ? (int)(bc % di) : 0;
  const int n0 = q * Q;
  const size_t hrow = (size_t)bc * n_state + n0;
  float h[Q];
  // `quad`: the rows hold whole 16-byte aligned quads of states; a
  // thread past the row's last quad (N = 12 in NP = 16, say) holds none
  const bool q4 = Q == 4 && quad && n0 < n_state;
  if constexpr (Q == 4) {
    if (live && q4) {
      const float4 v = *reinterpret_cast<const float4*>(h0 + hrow);
      h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
    }
  }
  if (!q4) {
#pragma unroll
    for (int e = 0; e < Q; ++e)
      h[e] = live && n0 + e < n_state ? h0[hrow + e] : 0.f;
  }
  const T* Bp = Bm + b * Bs.b + n0;
  const T* Cp = Cm + b * Cs.b + n0;
  for (int t = 0; t < n_t; ++t) {
    float av = 0.f, bv = 0.f;
    if (live) {
      av = to_f(a[b * as.b + t * as.t + c]);
      bv = to_f(bx[b * bxs.b + t * bxs.t + c]);
    }
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < Q; ++e) {
      const bool in = live && n0 + e < n_state;
      const float Bv = in ? to_f(Bp[t * Bs.t + e]) : 0.f;
      const float Cv = in ? to_f(Cp[t * Cs.t + e]) : 0.f;
      h[e] = fmaf(av, h[e], bv * Bv);
      p = fmaf(h[e], Cv, p);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (live && q == 0) store(y + ((int64_t)b * n_t + t) * di + c, p);
  }
  if (!live) return;
  if constexpr (Q == 4) {
    if (q4) {
      *reinterpret_cast<float4*>(h_last + hrow) =
          make_float4(h[0], h[1], h[2], h[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < Q; ++e)
    if (n0 + e < n_state) h_last[hrow + e] = h[e];
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

// A (Bz, T, inner) view with strides `st` as the tensor (inner, T, Bz),
// its box (`cols`, kSub, 1): kSub token rows of `cols` values, tokens past
// T and columns past `inner` filled with zeros
template <typename E>
bool make_map(CUtensorMap* map, const void* base, int bz, int t, int inner,
              Strides st, int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)t,
                              (cuuint64_t)bz};
  const cuuint64_t strides[2] = {(cuuint64_t)st.t * sizeof(E),
                                 (cuuint64_t)st.b * sizeof(E)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, kSub, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                sizeof(E) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA copies 16-byte units: every row of the input must start on a
// 16-byte boundary
bool aligned16(const void* p, Strides s, int elem) {
  const int64_t n = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % n == 0 &&
         s.t % n == 0;
}

// (blocks of the sequence kernel, bytes of its flags) at this shape
void chunk_grid(int bz, int t, int di, int64_t* items,
                int64_t* flag_bytes) {
  *items = (int64_t)bz * ((di + kCG - 1) / kCG) *
           ((t + kChunk - 1) / kChunk);
  *flag_bytes = (*items + 1 + 31) / 32 * 32 * (int64_t)sizeof(int);
}

// bytes of the workspace a call at this shape needs (0 for a decode
// step), or -1 when the shape is out of the kernels' range: the ticket
// counter and one flag a block, padded to 128 bytes, then each block's
// published chunk states (Chunk::kState floats)
int64_t workspace_bytes(int bz, int t, int di, int n) {
  if (bz <= 0 || t <= 0 || di <= 0 || n <= 0 || n > 32) return -1;
  if (t <= kDecodeT) return 0;
  int64_t items, flag_bytes;
  chunk_grid(bz, t, di, &items, &flag_bytes);
  if (items > 0x7fffffff) return -1;
  int np = 1;
  while (np < n) np *= 2;
  return flag_bytes + items * state_floats(np) * (int64_t)sizeof(float);
}

template <typename T, int NP>
int launch(const void* a, const void* bx, const void* Bm, const void* Cm,
           const void* h0, void* y, void* h_last, void* ws, int64_t ws_bytes,
           int bz, int t, int di, int n, Strides as, Strides bxs,
           Strides Bs, Strides Cs, cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* bx_ = static_cast<const T*>(bx);
  const T* B_ = static_cast<const T*>(Bm);
  const T* C_ = static_cast<const T*>(Cm);
  const float* h0_ = static_cast<const float*>(h0);
  T* y_ = static_cast<T*>(y);
  float* hl_ = static_cast<float*>(h_last);
  if (t <= kDecodeT) {                 // a decode step
    constexpr int G = NP < 4 ? 1 : NP / 4;
    const int64_t blocks =
        ((int64_t)bz * di * G + kDecodeThreads - 1) / kDecodeThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const int quad = n % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(h_last) % 16 == 0;
    ssm_scan_kernel_decode<T, NP><<<(unsigned)blocks, kDecodeThreads, 0,
                                    stream>>>(
        a_, bx_, B_, C_, h0_, y_, hl_, t, di, n, bz, as, bxs, Bs, Cs, quad);
    return (int)cudaGetLastError();
  }
  using Ch = Chunk<T, NP>;
  int64_t items, flag_bytes;
  chunk_grid(bz, t, di, &items, &flag_bytes);
  const int64_t need = workspace_bytes(bz, t, di, n);
  if (need < 0) return (int)cudaErrorInvalidConfiguration;
  if (ws == nullptr || ws_bytes < need) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      allow_smem_once(smem_set, ssm_scan_kernel<T, NP>, Ch::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // a batch stride of a single row is never used: give the maps a valid
  // one
  if (bz == 1) {
    as.b = as.t * t;
    bxs.b = bxs.t * t;
    Bs.b = Bs.t * t;
    Cs.b = Cs.t * t;
  }
  const int e = (int)sizeof(T);
  const int vec = aligned16(a, as, e) && aligned16(bx, bxs, e) &&
                  aligned16(Bm, Bs, e) && aligned16(Cm, Cs, e);
  CUtensorMap ta{}, tbx{}, tB{}, tC{};
  if (vec && !(make_map<T>(&ta, a, bz, t, di, as, kCG) &&
               make_map<T>(&tbx, bx, bz, t, di, bxs, kCG) &&
               make_map<T>(&tB, Bm, bz, t, n, Bs, Ch::KB) &&
               make_map<T>(&tC, Cm, bz, t, n, Cs, Ch::KB)))
    return (int)cudaErrorInvalidValue;
  int* flags = static_cast<int*>(ws);
  float* states = reinterpret_cast<float*>(static_cast<char*>(ws) +
                                           flag_bytes);
  err = cudaMemsetAsync(flags, 0, (size_t)flag_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<T, NP><<<(unsigned)items, kCG, Ch::smem_bytes, stream>>>(
      a_, bx_, B_, C_, h0_, y_, hl_, flags, states, t, di, n, bz, as, bxs,
      Bs, Cs, vec, ta, tbx, tB, tC);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* a, const void* bx, const void* Bm, const void* Cm,
               const void* h0, void* y, void* h_last, void* ws,
               int64_t ws_bytes, int bz, int t, int di, int n, Strides as,
               Strides bxs, Strides Bs, Strides Cs, cudaStream_t s) {
#define REPRO_NP(NP)                                                       \
  if (n <= NP)                                                             \
    return launch<T, NP>(a, bx, Bm, Cm, h0, y, h_last, ws, ws_bytes, bz, t, \
                         di, n, as, bxs, Bs, Cs, s)
  REPRO_NP(1);
  REPRO_NP(2);
  REPRO_NP(4);
  REPRO_NP(8);
  REPRO_NP(16);
  REPRO_NP(32);
#undef REPRO_NP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a, bx: (Bz, T, di) and B, C: (Bz, T, N), all of one dtype (bf16 != 0:
// bfloat16, else float32), given by their (b, t) element strides with a
// unit stride along the last axis; h0 and h_last: (Bz, di, N) float32
// contiguous; y: (Bz, T, di) contiguous in a's dtype.  1 <= N <= 32.  ws:
// scratch of ws_bytes, at least what ssm_scan_workspace_bytes gives (none
// for a decode step), whose flags this call clears on the stream.
int ssm_scan_fwd(const void* a, const void* bx, const void* Bm,
                 const void* Cm, const void* h0, void* y, void* h_last,
                 void* ws, int64_t ws_bytes, int bf16, int bz, int t, int di,
                 int n, int64_t asb, int64_t ast, int64_t bxsb, int64_t bxst,
                 int64_t Bsb, int64_t Bst, int64_t Csb, int64_t Cst,
                 void* stream) {
  if (bz <= 0 || t <= 0 || di <= 0 || n <= 0 || n > 32)
    return (int)cudaErrorInvalidValue;
  const Strides as{asb, ast}, bxs{bxsb, bxst}, Bs{Bsb, Bst}, Cs{Csb, Cst};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_n<__nv_bfloat16>(a, bx, Bm, Cm, h0, y, h_last, ws,
                                     ws_bytes, bz, t, di, n, as, bxs, Bs, Cs,
                                     s);
  return dispatch_n<float>(a, bx, Bm, Cm, h0, y, h_last, ws, ws_bytes, bz, t,
                           di, n, as, bxs, Bs, Cs, s);
}

// bytes of the workspace ssm_scan_fwd needs at this shape (0 for T <= 8),
// or -1 when the shape is out of its range
int64_t ssm_scan_workspace_bytes(int bz, int t, int di, int n) {
  return workspace_bytes(bz, t, di, n);
}

}  // extern "C"
