// Diagonal selective scan (the mamba branch of hymba) forward for Hopper
// (sm_90a), plain C interface.
//
//   ssm_scan_kernel  replaces the TPU kernel
//       repro/kernels/ssm_scan/kernel.py:ssm_scan_btd (_ssm_kernel): per
//       batch row b, channel c < di and state n < N, over tokens t,
//           h[c][n] <- a_t[c] · h[c][n] + bx_t[c] · B_t[n]
//           y_t[c]   = Σ_n h[c][n] · C_t[n]
//       a, bx: (Bz, T, di), B, C: (Bz, T, N), all bf16 or all fp32; h0
//       and h_last: (Bz, di, N) fp32; y in a's dtype.
//
// Design.  The TPU kernel keeps a (block_d, N) state in VMEM scratch
// across its sequential time grid.  Here one thread owns one (c, n) pair
// and keeps h[c][n] in a register for the whole sequence; the N <= 32
// states of a channel sit in adjacent lanes of one warp (N is padded to
// the next power of two NP; the padding lanes see B = C = 0 and stay 0),
// so y_t[c] is a butterfly of warp shuffles over NP lanes.  A block of
// 256 threads holds 256 / NP channels (16 at N = 16), and the grid covers
// di by blocks and Bz by its second axis: at hymba's di = 3200, N = 16
// that is 200 blocks even at Bz = 1.  Time goes in chunks of kTC tokens:
// the block stages the chunk's a and bx for its channels and its B and C
// rows in shared memory as fp32, scans them, gathers the chunk's y in
// shared memory and writes it as rows of contiguous channels.  Any T >= 1
// (T = 1 is a decode step) and any di are taken, with no padding of the
// inputs; the inputs are read through (b, t) element strides with a unit
// stride along the last axis.
//
// Bound on an H100 SXM at the hymba-1.5b prefill shape (Bz = 1, T = 1152
// = 1024 prompt + 128 meta tokens, di = 3200, N = 16, fp32): a, bx and y
// move 3 * 14.7 MB, B and C 0.15 MB, h0 and h_last 0.4 MB: 44.8 MB, 13.4
// us at 3.35 TB/s; 5 operations per (t, c, n), 0.30 GFLOP, 4.4 us at 67
// TFLOP/s.  So the function is bound by bytes.  This kernel reads each
// input once, but every token costs each warp a dependent chain of loads,
// two FMAs and log2(NP) shuffles, and the chunks are staged without
// overlap (other resident blocks cover the wait): a first kernel that is
// right and simple.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, t;
};

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int n_t, int di, int n_state,
                Strides as, Strides bxs, Strides Bs, Strides Cs) {
  static_assert(NP >= 1 && NP <= 32 && (NP & (NP - 1)) == 0,
                "NP must be a power of two <= 32");
  constexpr int CPB = kThreads / NP;   // channels per block
  // tokens per staged chunk: 32, fewer below NP = 4 so that the block's
  // shared memory (3 * kTC * CPB + 2 * kTC * NP floats) stays <= 24 KB
  constexpr int kTC = NP >= 4 ? 32 : 8 * NP;
  __shared__ float a_s[kTC][CPB];
  __shared__ float bx_s[kTC][CPB];
  __shared__ float B_s[kTC][NP];
  __shared__ float C_s[kTC][NP];
  __shared__ float y_s[kTC][CPB];

  const int tid = threadIdx.x;
  const int cl = tid / NP, n = tid % NP;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int c = c0 + cl;
  const bool live = c < di && n < n_state;
  const size_t hi = ((size_t)b * di + c) * n_state + n;
  float h = live ? h0[hi] : 0.f;

  const T* ap = a + b * as.b + c0;
  const T* bxp = bx + b * bxs.b + c0;
  const T* Bp = Bm + b * Bs.b;
  const T* Cp = Cm + b * Cs.b;
  T* yp = y + (size_t)b * n_t * di + c0;

  for (int t0 = 0; t0 < n_t; t0 += kTC) {
    const int tn = min(kTC, n_t - t0);
    for (int e = tid; e < kTC * CPB; e += kThreads) {
      const int tt = e / CPB, cc = e % CPB;
      const bool in = tt < tn && c0 + cc < di;
      const int64_t t = t0 + tt;
      a_s[tt][cc] = in ? to_f(ap[t * as.t + cc]) : 0.f;
      bx_s[tt][cc] = in ? to_f(bxp[t * bxs.t + cc]) : 0.f;
    }
    for (int e = tid; e < kTC * NP; e += kThreads) {
      const int tt = e / NP, nn = e % NP;
      const bool in = tt < tn && nn < n_state;
      const int64_t t = t0 + tt;
      B_s[tt][nn] = in ? to_f(Bp[t * Bs.t + nn]) : 0.f;
      C_s[tt][nn] = in ? to_f(Cp[t * Cs.t + nn]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      h = fmaf(a_s[tt][cl], h, bx_s[tt][cl] * B_s[tt][n]);
      float p = h * C_s[tt][n];
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) y_s[tt][cl] = p;
    }
    __syncthreads();
    for (int e = tid; e < tn * CPB; e += kThreads) {
      const int tt = e / CPB, cc = e % CPB;
      if (c0 + cc < di) store(yp + (int64_t)(t0 + tt) * di + cc, y_s[tt][cc]);
    }
  }
  if (live) h_last[hi] = h;
}

template <typename T, int NP>
int launch(const void* a, const void* bx, const void* Bm, const void* Cm,
           const void* h0, void* y, void* h_last, int bz, int t, int di,
           int n, Strides as, Strides bxs, Strides Bs, Strides Cs,
           cudaStream_t stream) {
  constexpr int CPB = kThreads / NP;
  const dim3 grid((di + CPB - 1) / CPB, bz);
  ssm_scan_kernel<T, NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), t, di, n, as, bxs, Bs, Cs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* a, const void* bx, const void* Bm, const void* Cm,
               const void* h0, void* y, void* h_last, int bz, int t, int di,
               int n, Strides as, Strides bxs, Strides Bs, Strides Cs,
               cudaStream_t s) {
  if (n <= 1)
    return launch<T, 1>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                        Bs, Cs, s);
  if (n <= 2)
    return launch<T, 2>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                        Bs, Cs, s);
  if (n <= 4)
    return launch<T, 4>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                        Bs, Cs, s);
  if (n <= 8)
    return launch<T, 8>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                        Bs, Cs, s);
  if (n <= 16)
    return launch<T, 16>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                         Bs, Cs, s);
  return launch<T, 32>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as, bxs,
                       Bs, Cs, s);
}

}  // namespace

extern "C" {

// a, bx: (Bz, T, di) and B, C: (Bz, T, N), all of one dtype (bf16 != 0:
// bfloat16, else float32), given by their (b, t) element strides with a
// unit stride along the last axis; h0 and h_last: (Bz, di, N) float32
// contiguous; y: (Bz, T, di) contiguous in a's dtype.  1 <= N <= 32.
int ssm_scan_fwd(const void* a, const void* bx, const void* Bm,
                 const void* Cm, const void* h0, void* y, void* h_last,
                 int bf16, int bz, int t, int di, int n, int64_t asb,
                 int64_t ast, int64_t bxsb, int64_t bxst, int64_t Bsb,
                 int64_t Bst, int64_t Csb, int64_t Cst, void* stream) {
  if (bz <= 0 || bz > 65535 || t <= 0 || di <= 0 || n <= 0 || n > 32)
    return (int)cudaErrorInvalidValue;
  const Strides as{asb, ast}, bxs{bxsb, bxst}, Bs{Bsb, Bst}, Cs{Csb, Cst};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_n<__nv_bfloat16>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di,
                                     n, as, bxs, Bs, Cs, s);
  return dispatch_n<float>(a, bx, Bm, Cm, h0, y, h_last, bz, t, di, n, as,
                           bxs, Bs, Cs, s);
}

}  // extern "C"
