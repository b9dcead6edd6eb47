// WKV6 recurrence (RWKV-6 "Finch") forward for Hopper (sm_90a), plain C
// interface.
//
//   wkv6_kernel  replaces the TPU kernel
//       repro/kernels/rwkv6_scan/kernel.py:wkv6_bthd (_wkv6_kernel): per
//       (batch b, head h) an fp32 (hd, hd) state S and, for each token t
//       with kv = k_tᵀ v_t,
//           y_t[j] = Σ_i r_t[i] · (S[i][j] + u[i] · kv[i][j])
//           S[i][j] <- w_t[i] · S[i][j] + kv[i][j]
//       r, k, v in bf16 or fp32, w in fp32 or r's dtype, u and the states
//       in fp32, y in r's dtype.
//
// Design.  The TPU kernel walks time as the innermost, sequential grid
// axis and carries S in VMEM scratch between grid steps; CUDA blocks run
// in no order, so here one block of hd threads owns one (b, h) and walks
// all of T itself.  Thread j keeps column S[:, j] in registers (hd fp32
// values) for the whole sequence, so the state never leaves the SM until
// the final write.  Time goes in chunks of kTC tokens: the block stages a
// chunk's r, k, v and w rows in shared memory as fp32 (thread j loads
// element j of each row, so each row is one coalesced read), and while it
// computes chunk c from one buffer, the loads of chunk c + 1 are already
// in flight into registers and land in the other buffer afterwards (one
// barrier per chunk).  Every thread reads the same r_i, k_i, w_i, u_i at
// once (a shared-memory broadcast, four values a load).  Any T >= 1 is
// taken, T = 1 included (a decode step), with no padding; r, k, v and w
// are read through (b, t, h) element strides with a unit stride along hd,
// so the model's (B, T, H, hd) views go in without a transpose copy.
//
// Bound on an H100 SXM at the rwkv6-3b prefill shape (B = 1, T = 1024,
// H = 40, hd = 64; r, k, v bf16, w fp32): 7 fp32 operations per state
// element and token, 1.17 GFLOP, 17.5 us at 67 TFLOP/s; 32.8 MB moved,
// 9.8 us at 3.35 TB/s.  So the function is bound by operations.  Its
// recurrence is sequential in t, and this kernel has only B * H blocks of
// hd threads (40 blocks of 2 warps on 132 SMs at B = 1), so latency and
// too few warps limit it, not the bound: a first kernel that is right and
// simple.  Splitting i over more warps per (b, h), or a chunked-parallel
// form of the recurrence, is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTC = 8;   // tokens per staged chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, t, h;
};

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_final, int n_t, int n_h,
            Strides rs, Strides ks, Strides vs, Strides ws) {
  static_assert(HD % 4 == 0, "hd must be a multiple of 4");
  __shared__ __align__(16) float r_s[2][kTC][HD];
  __shared__ __align__(16) float k_s[2][kTC][HD];
  __shared__ __align__(16) float w_s[2][kTC][HD];
  __shared__ __align__(16) float v_s[2][kTC][HD];
  __shared__ __align__(16) float u_s[HD];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / n_h, h = bh % n_h;
  u_s[j] = u[(size_t)h * HD + j];

  float S[HD];
  const float* sp = s0 + (size_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = sp[(size_t)i * HD];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const TW* wp = w + b * ws.b + h * ws.h + j;
  T* yp = y + ((size_t)b * n_t * n_h + h) * HD + j;
  const int64_t y_t = (int64_t)n_h * HD;

  // a chunk's rows, element j of each, in registers on their way in:
  // kept in the input's type and converted only when they land in shared
  // memory, so that nothing waits on the loads while the block computes;
  // a token past the end loads the last token again (never used)
  T pr[kTC], pk[kTC], pv[kTC];
  TW pw[kTC];
  const int n_chunks = (n_t + kTC - 1) / kTC;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      const int64_t t = min(t0 + tt, n_t - 1);
      pr[tt] = rp[t * rs.t];
      pk[tt] = kp[t * ks.t];
      pv[tt] = vp[t * vs.t];
      pw[tt] = wp[t * ws.t];
    }
  };
  auto land = [&](int buf) {
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      r_s[buf][tt][j] = to_f(pr[tt]);
      k_s[buf][tt][j] = to_f(pk[tt]);
      v_s[buf][tt][j] = to_f(pv[tt]);
      w_s[buf][tt][j] = to_f(pw[tt]);
    }
  };

  fetch(0);
  land(0);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * kTC;
    const bool more = c + 1 < n_chunks;
    if (more) fetch(t0 + kTC);        // issue chunk c + 1's loads now
    const int tn = min(kTC, n_t - t0);
    for (int tt = 0; tt < tn; ++tt) {
      const float vj = v_s[buf][tt][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[buf][tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[buf][tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[buf][tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&u_s[i]);
        float kv;
        kv = k4.x * vj;
        acc0 = fmaf(r4.x, fmaf(u4.x, kv, S[i]), acc0);
        S[i] = fmaf(w4.x, S[i], kv);
        kv = k4.y * vj;
        acc1 = fmaf(r4.y, fmaf(u4.y, kv, S[i + 1]), acc1);
        S[i + 1] = fmaf(w4.y, S[i + 1], kv);
        kv = k4.z * vj;
        acc2 = fmaf(r4.z, fmaf(u4.z, kv, S[i + 2]), acc2);
        S[i + 2] = fmaf(w4.z, S[i + 2], kv);
        kv = k4.w * vj;
        acc3 = fmaf(r4.w, fmaf(u4.w, kv, S[i + 3]), acc3);
        S[i + 3] = fmaf(w4.w, S[i + 3], kv);
      }
      store(yp + (t0 + tt) * y_t, (acc0 + acc1) + (acc2 + acc3));
    }
    if (more) land(buf ^ 1);          // chunk c + 1 into the other buffer
    __syncthreads();
  }

  float* op = s_final + (size_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) op[(size_t)i * HD] = S[i];
}

template <typename T, typename TW, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_final, int b,
           int t, int h, Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t stream) {
  wkv6_kernel<T, TW, HD><<<b * h, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_final), t, h, rs, ks, vs, ws);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const void* w, const void* u, const void* s0, void* y,
                void* s_final, int b, int t, int h, Strides rs, Strides ks,
                Strides vs, Strides ws, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, TW, 16>(r, k, v, w, u, s0, y, s_final, b, t, h, rs,
                               ks, vs, ws, stream);
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, s0, y, s_final, b, t, h, rs,
                               ks, vs, ws, stream);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, s0, y, s_final, b, t, h, rs,
                               ks, vs, ws, stream);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, s0, y, s_final, b, t, h, rs,
                                ks, vs, ws, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return dispatch_hd<float, float>(hd, r, k, v, w, u, s0, y, s_final, b, t,
                                     h, rs, ks, vs, ws, s);
  if (w_bf16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, r, k, v, w, u, s0, y, s_final, b, t, h, rs, ks, vs, ws, s);
  return dispatch_hd<__nv_bfloat16, float>(hd, r, k, v, w, u, s0, y, s_final,
                                           b, t, h, rs, ks, vs, ws, s);
}

}  // extern "C"
