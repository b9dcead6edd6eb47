// Flash attention forward for Hopper (sm_90a), plain C interface.
//
//   flash_attention_kernel  replaces the TPU kernel
//       repro/kernels/flash_attention/kernel.py:flash_attention_bhsd
//       (_flash_kernel): blocked online-softmax attention in fp32 over
//       bf16 or fp32 inputs, causal and sliding-window masks (diff =
//       q_pos - k_pos, both counted from 0; attend iff diff >= 0 when
//       causal and diff < window when window > 0), GQA with kv head =
//       q head / group without expanding kv, output in q's dtype, scale
//       1/sqrt(hd), masked scores at -1e30.
//
// Design.  One block of 256 threads per (64-row q tile, q head, batch).
// The q tile and each 32-row K and V tile are staged in shared memory as
// fp32 (rows padded to hd + 1 words, so neither the q rows nor the k/v
// rows that a warp reads at once share a bank).  Four threads own one q
// row: each computes 8 of the tile's 32 scores and accumulates a quarter
// of the row's hd outputs (dims lane, lane + 4, ...), and the row's
// running max and sum are combined across the four lanes with warp
// shuffles.  The block walks its kv tiles in order, which takes the
// place of the TPU's sequential kv grid axis, and visits only the tiles
// that the causal and window band can reach: every other tile would be
// wholly masked.  Keys at or past Skv and q rows at or past Sq are masked
// here, so nothing is padded.  A masked score contributes exactly 0, so a
// q row that no key may attend to returns 0, as the plain version does.
// The inputs are read through (b, h, s) element strides with a unit
// stride along hd, so the model layout (B, S, H, hd) goes in and out
// without a transpose copy.
//
// Bound on an H100 SXM, at the main path's prefill shape (B = 1, S =
// 1024, Hq = 16, Hkv = 8, hd = 128, bf16, causal): the unmasked pairs
// need 4 * hd * Hq * S(S+1)/2 = 4.3 GFLOP, 4.4 us at the tensor cores'
// 989 TFLOP/s; q, k, v and o move 12.6 MB, 3.8 us at 3.35 TB/s.  So the
// function is bound by operations, but only on the tensor cores.  This
// kernel computes on the fp32 FMA pipes and feeds every multiply-add
// from shared memory (about one shared load per FMA), so shared-memory
// bandwidth, not the bound, limits it: a first kernel that is right and
// simple.  Tensor-core tiles (wgmma over bf16, TMA loads, a ring of kv
// stages) are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;               // q rows per block
constexpr int kBK = 32;               // kv rows per tile
constexpr int kLanes = 4;             // threads per q row
constexpr int kThreads = kBQ * kLanes;
constexpr int kCols = kBK / kLanes;   // scores per thread per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (HD + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int group, int sq, int skv, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       float scale) {
  static_assert(HD % kLanes == 0, "hd must split over the row's lanes");
  constexpr int LD = HD + 1;          // padded row stride of q, k, v
  constexpr int PLD = kBK + 1;        // padded row stride of p
  constexpr int kDims = HD / kLanes;  // outputs per thread
  extern __shared__ float smem[];
  float* sq_tile = smem;              // kBQ x LD
  float* sk = sq_tile + kBQ * LD;     // kBK x LD
  float* sv = sk + kBK * LD;          // kBK x LD
  float* sp = sv + kBK * LD;          // kBQ x PLD

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    sq_tile[r * LD + d] = s < sq ? to_f(qb[s * qs.s + d]) : 0.0f;
  }

  // the kv tiles the band can reach: k <= the tile's last q row when
  // causal, k > its first q row - window when windowed
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  const int qpos = q0 + row;
  float m = kNegInf, l = 0.0f;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's k, v and p are read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int s = k0 + r;
      const bool in = s < skv;
      sk[r * LD + d] = in ? to_f(kb[s * ks.s + d]) : 0.0f;
      sv[r * LD + d] = in ? to_f(vb[s * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) sc[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qd = sq_tile[row * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sc[j] += qd * sk[(lane + kLanes * j) * LD + d];
    }

    bool ok[kCols];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + lane + kLanes * j;
      const int diff = qpos - kpos;
      ok[j] = kpos < skv && (!causal || diff >= 0) &&
              (window <= 0 || diff < window);
      sc[j] = ok[j] ? sc[j] * scale : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.0f;
      sp[row * PLD + lane + kLanes * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes share one warp

#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = sp[row * PLD + c];
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] += p * sv[c * LD + lane + kLanes * i];
    }
  }

  if (qpos < sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int i = 0; i < kDims; ++i) store(ob + lane + kLanes * i,
                                          acc[i] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int group, int sq, int skv, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)hq,
                  (unsigned)b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, group, sq, skv, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* o, int b, int hq, int group, int sq, int skv,
                Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, float scale, cudaStream_t stream) {
#define REPRO_HD(HD)                                                    \
  case HD:                                                              \
    return launch<T, HD>(q, k, v, o, b, hq, group, sq, skv, qs, ks, vs,  \
                         os, causal, window, scale, stream)
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
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b, hq, group, sq, skv,
                                      qs, ks, vs, os, causal, window, scale,
                                      s);
  return dispatch_hd<float>(hd, q, k, v, o, b, hq, group, sq, skv, qs, ks,
                            vs, os, causal, window, scale, s);
}

}  // extern "C"
