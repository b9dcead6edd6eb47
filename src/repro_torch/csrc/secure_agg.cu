// Secure-aggregation and DP kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels share one counter-based PRG (mix32 / mask_bits, the
// lowbias32 finalizer over a Weyl sequence of the JAX package's
// kernels/secure_agg/masking.py):
//
//   masked_rolling_update_kernel  replaces the TPU kernel
//       repro/kernels/secure_agg/kernel.py:masked_rolling_update_flat
//       (_masked_rolling_update_kernel): float MPC round, pairwise masks
//       regenerated per column, survivor mean, rolling-update blend.
//   masked_field_wsum_kernel      replaces the TPU kernel
//       repro/kernels/secure_agg/kernel.py:masked_field_wsum_flat
//       (_masked_field_wsum_kernel): Z_2^32 MPC share-sum, fixed-point
//       encode +/- raw mask words, wrapping survivor column sum.
//   clip_noise_kernel             replaces the TPU kernel
//       repro/kernels/dp/kernel.py:clip_noise_flat (_clip_noise_kernel):
//       per-row L2 clip + Box-Muller Gaussian noise.
//
// Design.  One thread owns one column g of the (P, N) row-major rows, and
// holds the P <= 16 values of that column in registers (P is a template
// parameter, so every per-row array is unrolled into registers).  The PRG
// counter is the global column index g, so no result depends on the block
// size.  The column-independent part of each stream's hash (two of the
// three mix32 rounds of mask_bits) is computed once per block into shared
// memory; each (pair or row, column) then costs one mix32.
//
// Bound on an H100 SXM.  At the main path's shape (P = 10, N = 109,634):
//   bytes   the float and DP kernels read and write (P, N) f32 once:
//           8.8 MB, 2.62 us at 3.35 TB/s; the int kernel reads (P, N) and
//           writes (N,) u32: 4.8 MB, 1.44 us.
//   integer a pad word is key ^ (col * kGolden) and one mix32: 7 shifts
//           and logic ops on the INT32 pipe and 2 multiplies on the FMA
//           pipe per (pair, column); the counter multiply col * kGolden
//           is one per column, shared by every pair.  The float pad adds
//           a shift, the int pad two wrapping adds (either pipe), the
//           int encode a clamp (2) per row.  The INT32 pipe retires 64
//           per clock per SM, 132 SMs x 1.98 GHz = 16.7e12 per second:
//           45 pairs x 8 x N = 2.36 us (float), (45 x 7 + 2 x 10) x N =
//           2.20 us (int), 10 rows x 16 x N = 1.05 us (DP, two words per
//           row).  The FMA pipe's multiplies take 0.6 us or less.
//   So the int kernel is bound by its shifts and logic, the float and
//   DP kernels by bytes, the float one with 90% of that time in ALU
//   work (chip_smoke.py:op_counts counts these per class for the run's
//   inputs and times each kernel against them).
// The simple design keeps every byte read once and written once and the
// pad words in registers; it does nothing yet to overlap the loads with
// the hashing or to raise the integer rate (several columns per thread,
// vectorised loads): that is later work.
//
// Rounding.  Built with -fmad=false, so no multiply-add is contracted and
// every float expression rounds where the plain PyTorch version rounds.
// The encode uses rintf (half to even, as jnp.round and torch.round); the
// DP noise uses the accurate logf / sqrtf / cosf, never the __ intrinsics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;   // Weyl increment
constexpr uint32_t kMulA = 0x7FEB352Du;     // lowbias32 constants
constexpr uint32_t kMulB = 0x846CA68Bu;
constexpr uint32_t kPairMul = 0x85EBCA6Bu;  // decorrelates the streams
constexpr uint32_t kDpTagA = 0xD9A11E5u;    // DP Box-Muller stream tags
constexpr uint32_t kDpTagB = 0x5E11A9Du;
constexpr float kU24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kMaskScale = 1.0f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr int kMaxRows = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMulA;
  x ^= x >> 15;
  x *= kMulB;
  x ^= x >> 16;
  return x;
}

// The column-independent part of mask_bits(seed, stream, col).
__device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                               uint32_t stream) {
  return mix32(mix32(seed ^ kGolden) ^ (stream * kPairMul));
}

// mask_bits(seed, stream, col) given stream_key(seed, stream).
__device__ __forceinline__ uint32_t mask_bits(uint32_t key, uint32_t col) {
  return mix32(key ^ (col * kGolden));
}

__device__ __forceinline__ float mask_value(uint32_t bits) {
  const float u = (float)(bits >> 8) * kU24;
  return kMaskScale * (2.0f * u - 1.0f);
}

// Participation bits: bit p set iff row p survives (mask == nullptr: all).
template <int P>
__device__ __forceinline__ uint32_t alive_bits(const float* mask) {
  uint32_t bits = 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (mask == nullptr || mask[p] > 0.0f) bits |= 1u << p;
  return bits;
}

template <int P>
__device__ __forceinline__ void load_pair_keys(uint32_t* keys,
                                               uint32_t seed) {
  constexpr int kPairs = P * (P - 1) / 2;
  for (int k = threadIdx.x; k < kPairs; k += blockDim.x)
    keys[k] = stream_key(seed, (uint32_t)k);
  __syncthreads();
}

template <int P>
__global__ void __launch_bounds__(kThreads)
masked_rolling_update_kernel(const float* __restrict__ u,
                             float* __restrict__ out,
                             const float* __restrict__ mask, int64_t n,
                             uint32_t seed, float alpha) {
  __shared__ uint32_t keys[P > 1 ? P * (P - 1) / 2 : 1];
  load_pair_keys<P>(keys, seed);
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const uint32_t alive = alive_bits<P>(mask);
  const uint32_t col = (uint32_t)g;
  float x[P], net[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    x[p] = u[p * n + g];
    net[p] = 0.0f;
  }
  // pairs (i, j), i < j, in lexicographic order: row i adds the pad,
  // row j subtracts it, each accumulating in pair order
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      const int k = i * (2 * P - i - 1) / 2 + (j - i - 1);
      if ((alive >> i) & (alive >> j) & 1u) {
        const float m = mask_value(mask_bits(keys[k], col));
        net[i] += m;
        net[j] -= m;
      }
    }
  }
  float total = 0.0f, count = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if ((alive >> p) & 1u) {
      total += x[p] + net[p];  // the share row p publishes
      count += 1.0f;
    }
  }
  const float agg = total / fmaxf(count, 1.0f);
#pragma unroll
  for (int p = 0; p < P; ++p)
    out[p * n + g] = ((alive >> p) & 1u) ? x[p] + alpha * (agg - x[p]) : x[p];
}

// round(x * 2^frac_bits) half to even, saturated at the int32 edge,
// embedded two's-complement into uint32.
__device__ __forceinline__ uint32_t encode(float x, float scale) {
  float s = rintf(x * scale);
  s = fminf(fmaxf(s, -2147483648.0f), 2147483520.0f);
  return (uint32_t)(int32_t)s;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
masked_field_wsum_kernel(const float* __restrict__ u,
                         uint32_t* __restrict__ out,
                         const float* __restrict__ mask, int64_t n,
                         uint32_t seed, float scale) {
  __shared__ uint32_t keys[P > 1 ? P * (P - 1) / 2 : 1];
  load_pair_keys<P>(keys, seed);
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const uint32_t alive = alive_bits<P>(mask);
  const uint32_t col = (uint32_t)g;
  uint32_t q[P];
#pragma unroll
  for (int p = 0; p < P; ++p) q[p] = encode(u[p * n + g], scale);
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      const int k = i * (2 * P - i - 1) / 2 + (j - i - 1);
      if ((alive >> i) & (alive >> j) & 1u) {
        const uint32_t w = mask_bits(keys[k], col);
        q[i] += w;  // wrapping: +w - w == 0 exactly
        q[j] -= w;
      }
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if ((alive >> p) & 1u) sum += q[p];
  out[g] = sum;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
clip_noise_kernel(const float* __restrict__ u, float* __restrict__ out,
                  const float* __restrict__ norms,
                  const float* __restrict__ mask, int64_t n, uint32_t seed,
                  float clip, float sigma) {
  __shared__ uint32_t keys_a[P], keys_b[P];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    keys_a[p] = stream_key(seed ^ kDpTagA, (uint32_t)p);
    keys_b[p] = stream_key(seed ^ kDpTagB, (uint32_t)p);
  }
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const uint32_t alive = alive_bits<P>(mask);
  const uint32_t col = (uint32_t)g;
  const float noise_scale = sigma * clip;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float x = u[p * n + g];
    if (!((alive >> p) & 1u)) {
      out[p * n + g] = x;  // a dropped row publishes nothing
      continue;
    }
    const float factor = fminf(1.0f, clip / fmaxf(norms[p], 1e-12f));
    const uint32_t b1 = mask_bits(keys_a[p], col);
    const uint32_t b2 = mask_bits(keys_b[p], col);
    const float u1 = (float)((b1 >> 8) + 1u) * kU24;  // (0, 1]
    const float u2 = (float)(b2 >> 8) * kU24;         // [0, 1)
    const float z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
    out[p * n + g] = factor * x + noise_scale * z;
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

#define REPRO_DISPATCH_ROWS(P_RUNTIME, LAUNCH)                         \
  switch (P_RUNTIME) {                                                 \
    case 1: LAUNCH(1); break;   case 2: LAUNCH(2); break;              \
    case 3: LAUNCH(3); break;   case 4: LAUNCH(4); break;              \
    case 5: LAUNCH(5); break;   case 6: LAUNCH(6); break;              \
    case 7: LAUNCH(7); break;   case 8: LAUNCH(8); break;              \
    case 9: LAUNCH(9); break;   case 10: LAUNCH(10); break;            \
    case 11: LAUNCH(11); break; case 12: LAUNCH(12); break;            \
    case 13: LAUNCH(13); break; case 14: LAUNCH(14); break;            \
    case 15: LAUNCH(15); break; case 16: LAUNCH(16); break;            \
    default: return (int)cudaErrorInvalidValue;                        \
  }

extern "C" {

int masked_rolling_update_f32(const void* u, void* out, const void* mask,
                              int p, int64_t n, uint32_t seed, float alpha,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(P)                                                        \
  masked_rolling_update_kernel<P><<<blocks_for(n), kThreads, 0, s>>>(    \
      (const float*)u, (float*)out, (const float*)mask, n, seed, alpha)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int masked_field_wsum_f32(const void* u, void* out, const void* mask, int p,
                          int64_t n, uint32_t seed, float scale,
                          void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(P)                                                        \
  masked_field_wsum_kernel<P><<<blocks_for(n), kThreads, 0, s>>>(        \
      (const float*)u, (uint32_t*)out, (const float*)mask, n, seed, scale)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int clip_noise_f32(const void* u, void* out, const void* norms,
                   const void* mask, int p, int64_t n, uint32_t seed,
                   float clip, float sigma, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(P)                                                        \
  clip_noise_kernel<P><<<blocks_for(n), kThreads, 0, s>>>(               \
      (const float*)u, (float*)out, (const float*)norms,                 \
      (const float*)mask, n, seed, clip, sigma)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"

static_assert(kMaxRows <= 32, "participation bits live in one uint32");
