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
// flash_attention_f32_kernel (fp32 inputs; off the models' path).  The
// port's first kernel, kept for fp32: 256 threads per 64-row q tile, four
// threads per q row, fp32 FMAs fed from shared memory, so shared-memory
// bandwidth bounds it.
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

// ----------------------------------------------------------------------
// fp32: the first kernel

constexpr int kBQ = 64;               // q rows per block
constexpr int kBK = 32;               // kv rows per tile
constexpr int kLanes = 4;             // threads per q row
constexpr int kThreads = kBQ * kLanes;
constexpr int kCols = kBK / kLanes;   // scores per thread per tile

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (HD + 1) + (size_t)kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int group, int sq, int skv, Strides qs,
                           Strides ks, Strides vs, Strides os, int causal,
                           int window, float scale) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    sq_tile[r * LD + d] = s < sq ? qb[s * qs.s + d] : 0.0f;
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
      sk[r * LD + d] = in ? kb[s * ks.s + d] : 0.0f;
      sv[r * LD + d] = in ? vb[s * vs.s + d] : 0.0f;
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
    float* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int i = 0; i < kDims; ++i) ob[lane + kLanes * i] = acc[i] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int group, int sq, int skv, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  auto kernel = flash_attention_f32_kernel<HD>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)hq,
                  (unsigned)b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, group,
      sq, skv, qs, ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// TMA and the paired bf16 stores need 16-byte aligned rows: every
// pointer aligned and every stride a multiple of 8 elements.  With no key
// (Skv = 0) a tensor map cannot be encoded (a zero dimension), and no
// tile is loaded: the plain-load kernel writes the rows' zeros.
bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int window, float scale,
                cudaStream_t stream) {
  if (skv > 0 && aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) &&
      aligned16(o, os))
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
