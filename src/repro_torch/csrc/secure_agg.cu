// Secure-aggregation and DP kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels share one counter-based PRG (mask_bits of the JAX
// package's kernels/secure_agg/masking.py: the lowbias32 finalizer mix32
// over a Weyl sequence):
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
// Those three hold P <= 16 rows in registers.  Past 16 rows the same C
// entry points launch kernels of the same three functions that walk the
// rows in tiles (masked_rolling_update_wide_kernel,
// masked_field_wsum_wide_kernel; the section "The fused kernels at P >
// 16") or a block for each group of 16 (clip_noise_wide_kernel; "The DP
// kernel past 16 rows").
//
// and the legacy two-stage round's two aggregates of pre-masked shares
// (the explicit-dataflow oracle the fused round was built against; see
// the section "Legacy two-stage round" below for their notes).
//
// Design of the two masked kernels (the fused MPC round in both domains).
// The (P, N) rows are row-major, P <= 16 a template parameter, so every
// per-row array is unrolled into registers.  The PRG counter is the
// global column index, so no block size or column split changes a bit.
//   - One thread owns one column, kAggThreads threads a block, so every
//     load and store of a warp is one coalesced 128-byte row segment,
//     whatever N and the operands' alignment (the main path's N =
//     109,634 is not a multiple of 4, so 16-byte accesses would not apply
//     to it).  At the main path's shape this is the fastest split
//     measured: 26 warps an SM hide the latency better than 2, 4 or 8
//     columns' independent work in fewer warps.
//   - A thread issues its P loads first, predicated on its column lying
//     inside N, and only then leaves if it does not: behind an early exit
//     ptxas spread the loads among the hash, and both kernels ran slower
//     (PERF.md).  No pad depends on the loads, so the pads are hashed
//     while they are in flight.
//   - The hash is split.  mix32's first step distributes over xor, so
//     mask_bits(seed, k, col) = mix32_tail(key'_k ^ c'), key' = key ^ (key
//     >> 16) once per pair (on the host, passed by value in PairKeys: each
//     key is a constant-bank operand), c' = c ^ (c >> 16), c = col x
//     golden, once per column.  A pad word is then 5 logic/shift ops and
//     2 multiplies.
//   - The participation bits come from one warp ballot (lane p reads
//     mask[p]); a pair is gated by the and of its two rows' bit masks,
//     which folds into the last xor of the hash (one LOP3), so no branch
//     splits the unrolled pair loop.
//   - Float pads accumulate in int32: a mask value is exactly (bits >> 8 -
//     2^23) 2^-23, so row i's net pad is (float)(sum of +-(bits >> 8) -
//     2^23 d_i) 2^-23, with d_i its alive pairs' sign sum (the int32 sum
//     stays below 2^28).  One conversion per row, and the net rounds once
//     from the exact sum, as the plain version's float64 product does.
//     Survivor shares are summed in row order 0..P-1, divided by max(count,
//     1) (IEEE division) and blended; kernels/secure_agg/ref.py's
//     masked_rolling_update_kernel_order is this arithmetic in PyTorch.
//   - The int kernel encodes each row once (a clamp to [-2^31, 2^31 - 128],
//     then one round-to-nearest-even conversion: equal to rintf, clamp and
//     truncation) and adds the pad words with wrapping int32 adds.
//
// Bound on an H100 SXM at the main path's shape (P = 10, N = 109,634):
//   bytes   the float kernel reads and writes (P, N) f32 once: 8.8 MB,
//           2.62 us at 3.35 TB/s; the int kernel reads (P, N) and writes
//           (N,) u32: 4.8 MB, 1.44 us.
//   integer the float kernel's 45 pairs x (5 logic/shift + 2
//           multiplies), plus a shift per pair for the float pad and 2
//           logic ops per column for the counter.  The INT32 pipe retires
//           64 per clock per SM, 132 SMs x 1.98 GHz = 16.7e12 per second:
//           (45 x 6 + 2) x N = 1.78 us.  The multiplies and adds share the
//           other pipe (0.6 us or less).  The int kernel's output needs no
//           pad at all (in Z_2^32 the survivors' pads cancel exactly), only
//           each alive row's scale, clamp, conversion and add: 0.26 us at
//           the conversion rate.
//   So both kernels are bound by bytes (chip_smoke.py:op_counts counts the
//   operations per class for a run's inputs).  With all columns in a
//   single wave, the float kernel's time is at best the larger of its
//   byte and integer times, when the loads, the hashing and the stores
//   overlap.
//
// Design of clip_noise_kernel (the DP publication), in the same form: one
// thread owns one column, kAggThreads threads a block, and a thread issues
// its P loads before the range guard.
//   - The 2P stream keys, stream_key(seed ^ tag, p) for tags A and B, are
//     computed on the host in split form and passed by value (DpKeys), so
//     each of a (row, column)'s two words is mix32_tail(key' ^ c'), with
//     the split counter c' computed once per column for both streams of
//     every row.  No shared memory, no barrier.
//   - The row constants are computed once per warp: lane p < P loads
//     norms[p] and mask[p] and computes min(1, clip / max(norm, 1e-12));
//     the alive bits come from one ballot and each row's factor from a
//     shuffle, so no thread divides more than once.
//   - The noise of a column's rows is computed in three passes: the
//     words, the uniforms and -2 logf(u1) of every row, which branch
//     nowhere, so ptxas interleaves the rows; then the cosf of every row;
//     then each row's sqrtf, blend and store.  Each cosf and sqrtf holds a
//     branch to a slow path that no argument here takes, and ptxas moved
//     no work across those branches: with each row's noise written in one
//     piece, one row's dependent chain ran at a time, and on an H100 the
//     kernel took 6.9 us at the main path's shape, not 5.9 (PERF.md).
//   - A dead row passes through bit for bit: its output is selected, not
//     computed, so inf and NaN stay where they are (its noise is
//     computed and thrown away, which keeps the passes free of a branch).
//     An alive row gets factor x + sigma clip z, z = sqrtf(-2 logf(u1))
//     cosf(2 pi u2) with the accurate logf / sqrtf / cosf, each operation
//     in the plain version's order.  kernels/dp/ref.py's
//     clip_noise_kernel_order is this arithmetic in PyTorch.
//   Bound at the main path's shape: bytes, (P, N) f32 read and written
//   once, 2.62 us; its operations per alive (row, column), two words of 5
//   logic/shift ops and 2 multiplies, 2 conversions, log / sqrt / cos on
//   the special-function pipe and 11 float operations, take 0.80 us.  The
//   nearer limit is instruction issue: the accurate log, sqrt and cos are
//   sequences of tens of SASS instructions, and the P = 10 kernel issues
//   about 1,100 a column, 3.7 us at one warp instruction a clock on each
//   scheduler (chip_smoke.py:print_sass_floor counts them).
//
// Rounding.  Built with -fmad=false, so no multiply-add is contracted and
// every float expression rounds where the plain PyTorch version rounds.
// The encode rounds half to even (as jnp.round and torch.round); the DP
// noise uses the accurate logf / sqrtf / cosf, never the __ intrinsics.
#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "smem_allowance.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;   // Weyl increment
constexpr uint32_t kMulA = 0x7FEB352Du;     // lowbias32 constants
constexpr uint32_t kMulB = 0x846CA68Bu;
constexpr uint32_t kPairMul = 0x85EBCA6Bu;  // decorrelates the streams
constexpr uint32_t kDpTagA = 0xD9A11E5u;    // DP Box-Muller stream tags
constexpr uint32_t kDpTagB = 0x5E11A9Du;
constexpr float kU24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr int kMaxRows = 16;
constexpr int kThreads = 256;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMulA;
  x ^= x >> 15;
  x *= kMulB;
  x ^= x >> 16;
  return x;
}

// The column-independent part of mask_bits(seed, stream, col).
__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                                        uint32_t stream) {
  return mix32(mix32(seed ^ kGolden) ^ (stream * kPairMul));
}

// A stream key in split form: its half of mix32's first xor-shift.
__host__ __device__ __forceinline__ uint32_t split_key(uint32_t key) {
  return key ^ (key >> 16);
}

// ---------------------------------------------------------------------
// The fused MPC round (the design notes at the top of this file).

constexpr int kAggThreads = 128;   // threads of a fused kernel's block
constexpr int kMaxPairs = kMaxRows * (kMaxRows - 1) / 2;
constexpr float kU23 = 1.1920928955078125e-07f;  // 2^-23

// A launch's pair keys in split form, key ^ (key >> 16) with key =
// stream_key(seed, k), passed by value: each is a constant-bank operand.
struct PairKeys {
  uint32_t k[kMaxPairs];
};

PairKeys split_pair_keys(uint32_t seed, int p) {
  PairKeys keys{};
  for (int k = 0; k < p * (p - 1) / 2; ++k)
    keys.k[k] = split_key(stream_key(seed, (uint32_t)k));
  return keys;
}

// The counter's half of mix32's first xor-shift: c ^ (c >> 16), c = col
// x golden.
__device__ __forceinline__ uint32_t split_counter(uint32_t col) {
  const uint32_t c = col * kGolden;
  return c ^ (c >> 16);
}

// mix32 after its first xor-shift: mask_bits(seed, k, col) ==
// mix32_tail(key' ^ c') for the split key and counter.
__device__ __forceinline__ uint32_t mix32_tail(uint32_t x) {
  x *= kMulA;
  x ^= x >> 15;
  x *= kMulB;
  return x ^ (x >> 16);
}

// A pair's pad word, and-ed with its gate `on` (all ones or zero).
__device__ __forceinline__ uint32_t pad_word(uint32_t key, uint32_t c,
                                             uint32_t on) {
  return mix32_tail(key ^ c) & on;
}

// Participation bits from one load per warp: lane p < P reads mask[p]
// (mask == nullptr: all).  Every lane of the warp must call it.
template <int P>
__device__ __forceinline__ uint32_t alive_ballot(const float* mask) {
  const int lane = threadIdx.x & 31;
  bool on = lane < P;
  if (on && mask != nullptr) on = mask[lane] > 0.0f;
  return __ballot_sync(0xffffffffu, on);
}

// All ones iff row p survives.
__device__ __forceinline__ uint32_t row_on(uint32_t alive, int p) {
  return 0u - ((alive >> p) & 1u);
}

// The pair index of (i, j), i < j, in lexicographic order.
template <int P>
__device__ __forceinline__ constexpr int pair_index(int i, int j) {
  return i * (2 * P - i - 1) / 2 + (j - i - 1);
}

template <int P>
__global__ void __launch_bounds__(kAggThreads)
masked_rolling_update_kernel(const float* __restrict__ u,
                             float* __restrict__ out,
                             const float* __restrict__ mask, int64_t n,
                             const PairKeys keys, float alpha) {
  const uint32_t alive = alive_ballot<P>(mask);
  const int64_t g = (int64_t)blockIdx.x * kAggThreads + threadIdx.x;
  float x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) x[p] = g < n ? u[p * n + g] : 0.0f;
  if (g >= n) return;  // after the loads (the notes at the top)
  // row p's net pad is sum_k sign (bits_k >> 8) - 2^23 d_p, d_p the sign
  // sum of its alive pairs (+1 as i, -1 as j): the offset starts the sum
  int net[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int above = __popc(alive >> (p + 1));
    const int below = __popc(alive & ((1u << p) - 1u));
    net[p] = ((alive >> p) & 1u) ? (below - above) * (1 << 23) : 0;
  }
  const float denom = fmaxf((float)__popc(alive), 1.0f);
  const uint32_t c = split_counter((uint32_t)g);
  // pair (i, j): row i adds the pad, row j subtracts it; exact in int32
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      const int b = (int)(pad_word(keys.k[pair_index<P>(i, j)], c,
                                   row_on(alive, i) & row_on(alive, j))
                          >> 8);
      net[i] += b;
      net[j] -= b;
    }
  }
  // the survivors' shares in row order; a dead row never enters
  float total = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if ((alive >> p) & 1u) total += x[p] + (float)net[p] * kU23;
  const float agg = total / denom;
#pragma unroll
  for (int p = 0; p < P; ++p)
    out[p * n + g] =
        ((alive >> p) & 1u) ? x[p] + alpha * (agg - x[p]) : x[p];
}

// round(x * scale) half to even, saturated at the int32 edge, embedded
// two's-complement into uint32: the clamp comes before one rounding
// conversion, which equals rintf, the clamp and a truncation (no float
// lies strictly between 2^31 - 128 and 2^31; NaN clamps to -2^31).
__device__ __forceinline__ uint32_t encode_rn(float x, float scale) {
  const float s = fminf(fmaxf(x * scale, -2147483648.0f), 2147483520.0f);
  return (uint32_t)__float2int_rn(s);
}

template <int P>
__global__ void __launch_bounds__(kAggThreads)
masked_field_wsum_kernel(const float* __restrict__ u,
                         uint32_t* __restrict__ out,
                         const float* __restrict__ mask, int64_t n,
                         const PairKeys keys, float scale) {
  const uint32_t alive = alive_ballot<P>(mask);
  const int64_t g = (int64_t)blockIdx.x * kAggThreads + threadIdx.x;
  float x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) x[p] = g < n ? u[p * n + g] : 0.0f;
  if (g >= n) return;  // after the loads (the notes at the top)
  const uint32_t c = split_counter((uint32_t)g);
  // the pads first (they need no data), the encodes after
  uint32_t pad[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pad[p] = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      const uint32_t w = pad_word(keys.k[pair_index<P>(i, j)], c,
                                  row_on(alive, i) & row_on(alive, j));
      pad[i] += w;  // wrapping: +w - w == 0 exactly
      pad[j] -= w;
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    sum += (encode_rn(x[p], scale) + pad[p]) & row_on(alive, p);
  out[g] = sum;
}

inline unsigned agg_blocks(int64_t n) {
  return (unsigned)((n + kAggThreads - 1) / kAggThreads);
}

// A launch's DP stream keys in split form, one per row and tag, passed by
// value: each is a constant-bank operand.
struct DpKeys {
  uint32_t a[kMaxRows], b[kMaxRows];
};

DpKeys split_dp_keys(uint32_t seed, int p) {
  DpKeys keys{};
  for (int r = 0; r < p; ++r) {
    keys.a[r] = split_key(stream_key(seed ^ kDpTagA, (uint32_t)r));
    keys.b[r] = split_key(stream_key(seed ^ kDpTagB, (uint32_t)r));
  }
  return keys;
}

template <int P>
__global__ void __launch_bounds__(kAggThreads)
clip_noise_kernel(const float* __restrict__ u, float* __restrict__ out,
                  const float* __restrict__ norms,
                  const float* __restrict__ mask, int64_t n,
                  const DpKeys keys, float clip, float sigma) {
  // the row constants once per warp: lane p < P computes row p's factor
  const uint32_t alive = alive_ballot<P>(mask);
  const int lane = threadIdx.x & 31;
  const float norm = lane < P ? norms[lane] : 1.0f;
  const float lane_factor = fminf(1.0f, clip / fmaxf(norm, 1e-12f));
  const int64_t g = (int64_t)blockIdx.x * kAggThreads + threadIdx.x;
  float x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) x[p] = g < n ? u[p * n + g] : 0.0f;
  float factor[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    factor[p] = __shfl_sync(0xffffffffu, lane_factor, p);
  if (g >= n) return;  // after the loads and the shuffles
  const uint32_t c = split_counter((uint32_t)g);
  const float noise_scale = sigma * clip;
  // three passes over the rows (the notes at the top): the words, the
  // uniforms and the logs, which branch nowhere; the cosines; the square
  // roots, the blend and the stores
  float r[P], a[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t b1 = mix32_tail(keys.a[p] ^ c);
    const uint32_t b2 = mix32_tail(keys.b[p] ^ c);
    const float u1 = (float)((b1 >> 8) + 1u) * kU24;  // (0, 1]
    const float u2 = (float)(b2 >> 8) * kU24;         // [0, 1)
    r[p] = -2.0f * logf(u1);
    a[p] = kTwoPi * u2;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) a[p] = cosf(a[p]);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float z = sqrtf(r[p]) * a[p];
    // a dropped row publishes nothing: it passes through bit for bit
    out[p * n + g] = ((alive >> p) & 1u) ? factor[p] * x[p] + noise_scale * z
                                         : x[p];
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------
// The fused kernels at P > 16.
//
// The kernels above keep a column's P rows, the launch's keys (by value)
// and the alive bits (one warp ballot) in registers, so they stop at P =
// kMaxRows.  Past it the entry points launch the two pair walks below and
// the DP kernel of the next section, one column a thread, through the
// same split hash.
//
// masked_rolling_update_wide_kernel and masked_field_wsum_wide_kernel walk
// the pairs so that each pair's word is hashed once, added to row i's net
// and subtracted from row j's:
//   - The rows are cut into tiles of kTile = 16.  The tile pairs (I, J), I
//     <= J, are walked I outer, J inner.  A thread keeps tile I's 16 nets
//     in registers across its whole row of tile pairs.  Off the diagonal,
//     row b of tile J takes its 16 words (one per row of I) in one register
//     sum, subtracted from that row's accumulator once; on the diagonal the
//     120 words of the upper triangle are unrolled with constant indices,
//     so every net is a register there too.  The accumulators, one per row
//     and column, live in shared memory (P x kWideThreads x 4 B at most
//     227 KB: P <= 432); each thread touches its own column's only, so they
//     need no barrier.  Where they do not fit (P > 432, or the float
//     kernel's 64-bit nets past 256 rows) they live in a global workspace
//     of the same layout that the wrapper allocates
//     (masked_wide_workspace_bytes).  Rows past P in a ragged last tile
//     have their pairs gated off.
//   - A tile pair's 256 split keys and pair gates are staged in shared
//     memory by the block, two entries a thread (the pair index in 64 bits,
//     then one mix32: stream_key's seed half is computed once), into one of
//     two buffers while the other is read, so one barrier a tile pair.  A
//     warp reads them as 16-byte broadcasts.  No key workspace, no second
//     kernel.
//   - Pair (i, j)'s gate, all ones iff both rows survive, is staged with
//     its key and and-ed into the hash's last xor (one LOP3), so no branch
//     splits the unrolled words; a dead row's words are hashed and dropped.
//   - When tile I's row of tile pairs is done its rows' nets are whole (the
//     accumulator holds what earlier tiles gave them), so the rows are
//     finished there, in row order.  The float kernel converts row p's net,
//     sum sign (bits >> 8) - 2^23 d_p in units of 2^-23, once, and adds the
//     survivor's share to the column total in row order 0..P-1; the int
//     kernel adds each survivor's encode + pad to its wrapping share-sum.
//     Each row is read once: tile I's 16 loads are issued before its walk,
//     and the float kernel keeps each row's value in the accumulator slot
//     it no longer needs, for the blend after the mean.
//   - Width.  The nets are summed in unsigned (wrapping) arithmetic, exact
//     modulo 2^32 in any order; |net| < P 2^23, so up to P = 256 the int32
//     reading of the 32 bits is the net itself, and past 256 rows the float
//     kernel sums in 64 bits.  The int kernel's pads are Z_2^32 words.
//   So the float kernel's arithmetic is masked_rolling_update_kernel_order's
//   and the int kernel's masked_field_wsum_kernel_order's, as at P <= 16;
//   kernels/secure_agg/ref.py's wide_pair_tiles, wide_int_net_pads and
//   wide_field_pads are the walk in PyTorch.
//
// Bound (chip_smoke.py:op_counts) at N = 109,634 with 2 of P rows dead: the
// float kernel's function is bound by its integer operations, 6 logic and
// shift ops an alive pair's word on the INT32 pipe: 17.1 us at P = 32 and
// 310 us at P = 128 (its bytes take 8.4 and 33.5 us).  The walk issues
// about 9.5 instructions a word, for dead pairs too: the hash's 5 logic
// and shift ops with the gate folded in and its 2 multiplies, 2 adds
// that take the shift to 24 bits with them (LEA.HI), and half a 16-byte
// shared load of keys and gates.  7 of them run on the INT32 pipe, so it
// is held to that pipe's rate, as the bound is, with 7 operations for the
// bound's 6 and the dead pairs' 14% more words at P = 32.  The int
// kernel's function needs no pad word (the survivors' pads cancel in
// Z_2^32) and is bound by bytes, 4.3 us at P = 32; the kernel keeps the
// pads, as the TPU kernel and the P <= 16 one do, so it does the float
// kernel's hashing less the shift.  PERF.md has their times.

__device__ __forceinline__ bool row_alive(const float* mask, int p) {
  return mask == nullptr || mask[p] > 0.0f;
}

constexpr int kWideThreads = 128;   // a walk's block (64: slower, PERF.md)
constexpr int kTile = 16;                    // rows of a tile of the walk
constexpr int kTileWords = kTile * kTile;
constexpr int kNet32Rows = 256;              // |net| < P 2^23 <= 2^31
constexpr size_t kBlockSmemBytes = 232448;   // a block's on an H100

// A tile pair (I, J)'s split keys and gates: entry b kTile + a is pair (i,
// j) = (kTile I + a, kTile J + b); zero where not i < j < P.
struct alignas(16) TileKeys {
  uint32_t key[kTileWords];
  uint32_t gate[kTileWords];
};

inline unsigned wide_blocks(int64_t n) {
  return (unsigned)((n + kWideThreads - 1) / kWideThreads);
}

__host__ __device__ __forceinline__ int wide_tiles(int p) {
  return (p + kTile - 1) / kTile;
}

// Bytes of a block's accumulators: one Acc a (padded) row and column.
template <typename Acc>
size_t wide_acc_bytes(int p) {
  return (size_t)wide_tiles(p) * kTile * kWideThreads * sizeof(Acc);
}

// True when a block's accumulators fit in shared memory beside the two
// key buffers.
template <typename Acc>
bool wide_acc_shared(int p) {
  return 2 * sizeof(TileKeys) + wide_acc_bytes<Acc>(p) <= kBlockSmemBytes;
}

// The block stages tile pair (I, J)'s keys and gates into `buf`; h is
// stream_key's seed half, mix32(seed ^ golden).
__device__ __forceinline__ void stage_tile_pair(TileKeys& buf, int I, int J,
                                                int P, uint32_t h,
                                                const float* mask) {
#pragma unroll
  for (int r = 0; r < kTileWords / kWideThreads; ++r) {
    const int e = r * kWideThreads + threadIdx.x;
    const int i = I * kTile + e % kTile, j = J * kTile + e / kTile;
    uint32_t key = 0, gate = 0;
    if (i < j && j < P) {
      const int64_t k =
          (int64_t)i * (2 * (int64_t)P - i - 1) / 2 + (j - i - 1);
      key = split_key(mix32(h ^ ((uint32_t)k * kPairMul)));
      gate = row_alive(mask, i) && row_alive(mask, j) ? ~0u : 0u;
    }
    buf.key[e] = key;
    buf.gate[e] = gate;
  }
}

// A staged pair's gated word at split counter c; the float walk sums its
// top 24 bits.
template <bool kFloat>
__device__ __forceinline__ uint32_t walk_word(uint32_t key, uint32_t gate,
                                              uint32_t c) {
  const uint32_t w = pad_word(key, c, gate);
  return kFloat ? w >> 8 : w;
}

// The pair walk of both kernels (the notes above).  kFloat: the float
// round, `param` alpha, rows out to out_rows; else the share-sum, `param`
// the encode's scale, out to out_sum.  Acc: the nets' unsigned width;
// kSharedAcc: the accumulators in shared memory, else in `work`.
template <bool kFloat, typename Acc, bool kSharedAcc>
__device__ __forceinline__ void masked_wide_walk(
    const float* __restrict__ u, float* __restrict__ out_rows,
    uint32_t* __restrict__ out_sum, const float* __restrict__ mask, int P,
    int64_t n, uint32_t seed, float param, Acc* __restrict__ work) {
  using Net = std::make_signed_t<Acc>;
  extern __shared__ uint4 wide_smem[];
  TileKeys* bufs = reinterpret_cast<TileKeys*>(wide_smem);
  const int tiles = wide_tiles(P);
  const int64_t g = (int64_t)blockIdx.x * kWideThreads + threadIdx.x;
  const bool in = g < n;   // a thread past n walks too: it stages keys
  // row r's accumulator of this thread's column is acc[r * kWideThreads]
  Acc* acc;
  if constexpr (kSharedAcc)
    acc = reinterpret_cast<Acc*>(bufs + 2) + threadIdx.x;
  else
    acc = work + (int64_t)blockIdx.x * tiles * kTile * kWideThreads +
          threadIdx.x;
  for (int r = 0; r < tiles * kTile; ++r) acc[r * kWideThreads] = 0;
  int alive = P;
  if (mask != nullptr) {
    alive = 0;
    for (int p0 = 0; p0 < P; p0 += kWideThreads)
      alive += __syncthreads_count(p0 + (int)threadIdx.x < P &&
                                   mask[p0 + threadIdx.x] > 0.0f);
  }
  const uint32_t c = split_counter((uint32_t)g);
  const uint32_t h = mix32(seed ^ kGolden);
  stage_tile_pair(bufs[0], 0, 0, P, h, mask);
  int cur = 0;
  int below = 0;          // the float round: alive rows before this one
  float total = 0.0f;     // the float round: survivors' shares, row order
  uint32_t sum = 0;       // the share-sum, wrapping
  for (int I = 0; I < tiles; ++I) {
    float x[kTile];       // tile I's rows, in flight during its walk
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int p = I * kTile + a;
      x[a] = in && p < P ? u[p * n + g] : 0.0f;
    }
    Acc net[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) net[a] = 0;
    for (int J = I; J < tiles; ++J) {
      __syncthreads();    // every thread is done reading bufs[cur ^ 1]
      if (J + 1 < tiles)
        stage_tile_pair(bufs[cur ^ 1], I, J + 1, P, h, mask);
      else if (I + 1 < tiles)
        stage_tile_pair(bufs[cur ^ 1], I + 1, I + 1, P, h, mask);
      const TileKeys& k = bufs[cur];
      if (J == I) {
#pragma unroll
        for (int b = 1; b < kTile; ++b) {
          uint32_t s = 0;
#pragma unroll
          for (int a = 0; a < b; ++a) {
            const uint32_t w = walk_word<kFloat>(k.key[b * kTile + a],
                                                 k.gate[b * kTile + a], c);
            net[a] += w;
            s += w;
          }
          net[b] -= s;
        }
      } else {
#pragma unroll 1
        for (int b = 0; b < kTile; ++b) {   // one row of J: 16 words
          const uint4* key4 = reinterpret_cast<const uint4*>(k.key) + b * 4;
          const uint4* gate4 =
              reinterpret_cast<const uint4*>(k.gate) + b * 4;
          uint32_t s = 0;
#pragma unroll
          for (int q = 0; q < kTile / 4; ++q) {
            const uint4 kq = key4[q], gq = gate4[q];
            const uint32_t ks[4] = {kq.x, kq.y, kq.z, kq.w};
            const uint32_t gs[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const uint32_t w = walk_word<kFloat>(ks[r], gs[r], c);
              net[4 * q + r] += w;
              s += w;
            }
          }
          acc[(J * kTile + b) * kWideThreads] -= s;
        }
      }
      cur ^= 1;
    }
    // tile I's nets are whole: finish its rows in row order
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int p = I * kTile + a;
      if (p < P) {
        Acc& slot = acc[p * kWideThreads];
        const Acc whole = net[a] + slot;
        const bool on = row_alive(mask, p);
        if constexpr (kFloat) {
          if (on) {
            // - 2^23 d_p: d_p = (alive rows after p) - (alive rows before)
            const Acc offset = (Acc)(Net)(2 * below + 1 - alive) << 23;
            total += x[a] + (float)(Net)(whole + offset) * kU23;
            ++below;
          }
          slot = __float_as_uint(x[a]);   // for the blend
        } else {
          sum += (encode_rn(x[a], param) + (uint32_t)whole) &
                 (on ? ~0u : 0u);
        }
      }
    }
  }
  if (!in) return;
  if constexpr (kFloat) {
    const float agg = total / fmaxf((float)alive, 1.0f);
    for (int p = 0; p < P; ++p) {
      const float xp = __uint_as_float((uint32_t)acc[p * kWideThreads]);
      out_rows[p * n + g] = row_alive(mask, p) ? xp + param * (agg - xp)
                                               : xp;
    }
  } else {
    out_sum[g] = sum;
  }
}

template <typename Acc, bool kSharedAcc>
__global__ void __launch_bounds__(kWideThreads)
masked_rolling_update_wide_kernel(const float* __restrict__ u,
                                  float* __restrict__ out,
                                  const float* __restrict__ mask, int P,
                                  int64_t n, uint32_t seed, float alpha,
                                  Acc* __restrict__ work) {
  masked_wide_walk<true, Acc, kSharedAcc>(u, out, nullptr, mask, P, n,
                                          seed, alpha, work);
}

template <bool kSharedAcc>
__global__ void __launch_bounds__(kWideThreads)
masked_field_wsum_wide_kernel(const float* __restrict__ u,
                              uint32_t* __restrict__ out,
                              const float* __restrict__ mask, int P,
                              int64_t n, uint32_t seed, float scale,
                              uint32_t* __restrict__ work) {
  masked_wide_walk<false, uint32_t, kSharedAcc>(u, nullptr, out, mask, P,
                                                n, seed, scale, work);
}

// Bytes of the global accumulators a walk kernel with Acc nets needs at
// (p, n): 0 where they fit in shared memory.
template <typename Acc>
int64_t wide_workspace_bytes(int p, int64_t n) {
  return wide_acc_shared<Acc>(p)
             ? 0
             : (int64_t)wide_blocks(n) * (int64_t)wide_acc_bytes<Acc>(p);
}

// Launch a walk kernel's instantiation for Acc: shared accumulators where
// they fit (the allowance raised once per device), else `work`.
template <typename Acc, typename Out, typename SharedKernel,
          typename GlobalKernel>
int launch_wide_walk(SharedKernel shared_kernel, GlobalKernel global_kernel,
                     std::atomic<uint64_t>& allowed, const float* u, Out* out,
                     const float* mask, int p, int64_t n, uint32_t seed,
                     float param, void* work, cudaStream_t s) {
  if (wide_acc_shared<Acc>(p)) {
    const cudaError_t err =
        allow_smem_once(allowed, shared_kernel, kBlockSmemBytes);
    if (err != cudaSuccess) return (int)err;
    shared_kernel<<<wide_blocks(n), kWideThreads,
                    2 * sizeof(TileKeys) + wide_acc_bytes<Acc>(p), s>>>(
        u, out, mask, p, n, seed, param, nullptr);
  } else {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    global_kernel<<<wide_blocks(n), kWideThreads, 2 * sizeof(TileKeys), s>>>(
        u, out, mask, p, n, seed, param, (Acc*)work);
  }
  return (int)cudaGetLastError();
}

template <typename Acc>
int launch_rolling_update_wide(const float* u, float* out, const float* mask,
                               int p, int64_t n, uint32_t seed, float alpha,
                               void* work, cudaStream_t s) {
  static std::atomic<uint64_t> allowed{0};
  return launch_wide_walk<Acc>(masked_rolling_update_wide_kernel<Acc, true>,
                               masked_rolling_update_wide_kernel<Acc, false>,
                               allowed, u, out, mask, p, n, seed, alpha, work,
                               s);
}

int launch_field_wsum_wide(const float* u, uint32_t* out, const float* mask,
                           int p, int64_t n, uint32_t seed, float scale,
                           void* work, cudaStream_t s) {
  static std::atomic<uint64_t> allowed{0};
  return launch_wide_walk<uint32_t>(masked_field_wsum_wide_kernel<true>,
                                    masked_field_wsum_wide_kernel<false>,
                                    allowed, u, out, mask, p, n, seed, scale,
                                    work, s);
}

// ---------------------------------------------------------------------
// The DP kernel past 16 rows.
//
// clip_noise_wide_kernel is clip_noise_kernel's arithmetic on a group of
// kDpGroup rows: one launch, no workspace, a block for each 128 columns
// and row group (blockIdx.y; groups past the grid's 65,535 loop).
//   - A thread issues its column's loads of the group first, before the
//     range guard (which only skips the stores).
//   - The block stages the group's constants in shared memory: warp 0 the
//     split keys of both streams, split_key(stream_key(seed ^ tag, p)),
//     which are arithmetic alone, behind a first barrier; warp 1 the clip
//     factors (one IEEE division a row) and alive bits, whose loads are
//     issued at the start and whose barrier comes after the first two
//     passes, so no thread waits on them.  Threads read a row's constants
//     as shared broadcasts.
//   - The passes are the P <= 16 kernel's three: the words, uniforms and
//     -2 logf(u1); the cosf; the sqrtf, blend and stores.
//   - A whole group (all but a ragged last one) runs a copy of the body
//     with no per-row guard; in the ragged one, rows past P read the
//     group's first row and store nothing.  Dead rows pass through bit for
//     bit.
//   Bound at (P, N) = (32, 109,634) with 2 rows dead: bytes, (P, N) f32
//   read and written once, 8.4 us (33.5 us at P = 128); its operations
//   take 2.4 us.  As at P <= 16 the nearer limit is issue: the body issues
//   about 130 SASS instructions a row and column (2,085 a group outside
//   cosf's large-argument path, counted as chip_smoke.py:print_sass_floor
//   counts, before the whole-group copy), a floor of 13.7 us at P = 32
//   and 54.7 us at P = 128.  What the design left behind: a
//   thread that looped over the groups waited for each group's loads in
//   turn (20.2 us at P = 32), and with the norm loads before the first
//   barrier and a guard on every row the kernel took 18.7 us; capped at
//   64 registers (8 blocks an SM, 80 without the cap) it spilled and took
//   23.8 us (PERF.md).

constexpr int kDpGroup = 16;          // rows a block takes
constexpr int kDpMaxGroups = 65535;   // the grid's y extent

// A row's blend constants: min(1, clip / max(norm, 1e-12)) and 1 iff the
// row survives.
struct alignas(8) DpBlend {
  float factor;
  uint32_t alive;
};

// One row group's noise for one column: the loads (rows past `count`
// read the group's first row), warp 1's norm and participation loads,
// the keys staged by warp 0 behind a first barrier, the words, uniforms
// and logs, the cosines, warp 1's blend constants behind a second
// barrier, then the square roots, blends and stores.  kFull: a whole
// group (count == kDpGroup), with no per-row guard.
template <bool kFull>
__device__ __forceinline__ void noise_group(
    const float* __restrict__ u, float* __restrict__ out,
    const float* __restrict__ norms, const float* __restrict__ mask,
    int64_t p0, int count, int64_t n, int64_t g, bool in, uint32_t c,
    uint32_t seed, float clip, float noise_scale, uint2* keys,
    DpBlend* blend) {
  const float* src = u + p0 * n + g;
  float x[kDpGroup], r[kDpGroup], a[kDpGroup];
#pragma unroll
  for (int k = 0; k < kDpGroup; ++k)
    x[k] = in ? src[(int64_t)(kFull || k < count ? k : 0) * n] : 0.0f;
  // warp 1 loads the rows' norms and participation now and stages the
  // blend constants after the first two passes; warp 0 stages the keys
  // (arithmetic only) behind the first barrier
  const int stager = (int)threadIdx.x - 32;
  float norm = 1.0f;
  bool on = false;
  if (stager >= 0 && stager < count) {
    norm = norms[p0 + stager];
    on = row_alive(mask, (int)(p0 + stager));
  }
  if (threadIdx.x < kDpGroup) {
    const uint32_t stream = (uint32_t)(p0 + threadIdx.x) * kPairMul;
    const uint32_t half_a = mix32(seed ^ kDpTagA ^ kGolden);
    const uint32_t half_b = mix32(seed ^ kDpTagB ^ kGolden);
    keys[threadIdx.x] = make_uint2(split_key(mix32(half_a ^ stream)),
                                   split_key(mix32(half_b ^ stream)));
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kDpGroup; ++k) {
    const uint2 key = keys[k];
    const uint32_t b1 = mix32_tail(key.x ^ c);
    const uint32_t b2 = mix32_tail(key.y ^ c);
    const float u1 = (float)((b1 >> 8) + 1u) * kU24;  // (0, 1]
    const float u2 = (float)(b2 >> 8) * kU24;         // [0, 1)
    r[k] = -2.0f * logf(u1);
    a[k] = kTwoPi * u2;
  }
#pragma unroll
  for (int k = 0; k < kDpGroup; ++k) a[k] = cosf(a[k]);
  if (stager >= 0 && stager < kDpGroup)
    blend[stager] = {fminf(1.0f, clip / fmaxf(norm, 1e-12f)), on ? 1u : 0u};
  __syncthreads();
  if (!in) return;
  float* dst = out + p0 * n + g;
#pragma unroll
  for (int k = 0; k < kDpGroup; ++k) {
    if (!kFull && k >= count) break;
    const float z = sqrtf(r[k]) * a[k];
    // a dropped row publishes nothing: it passes through bit for bit
    const DpBlend row = blend[k];
    dst[(int64_t)k * n] = row.alive ? row.factor * x[k] + noise_scale * z
                                    : x[k];
  }
}

__global__ void __launch_bounds__(kAggThreads)
clip_noise_wide_kernel(const float* __restrict__ u, float* __restrict__ out,
                       const float* __restrict__ norms,
                       const float* __restrict__ mask, int P, int64_t n,
                       uint32_t seed, float clip, float sigma) {
  __shared__ uint2 keys[kDpGroup];       // a row's split keys, A and B
  __shared__ DpBlend blend[kDpGroup];
  const int64_t g = (int64_t)blockIdx.x * kAggThreads + threadIdx.x;
  const bool in = g < n;
  const uint32_t c = split_counter((uint32_t)g);
  const float noise_scale = sigma * clip;
  for (int64_t p0 = (int64_t)blockIdx.y * kDpGroup; p0 < P;
       p0 += (int64_t)gridDim.y * kDpGroup) {
    if (p0 > (int64_t)blockIdx.y * kDpGroup)
      __syncthreads();  // the last group's constants are read
    if (P - p0 >= kDpGroup)
      noise_group<true>(u, out, norms, mask, p0, kDpGroup, n, g, in, c,
                        seed, clip, noise_scale, keys, blend);
    else
      noise_group<false>(u, out, norms, mask, p0, (int)(P - p0), n, g, in,
                         c, seed, clip, noise_scale, keys, blend);
  }
}

// ---------------------------------------------------------------------
// Legacy two-stage round.
//
//   rolling_update_kernel  replaces the TPU kernel
//       repro/kernels/secure_agg/kernel.py:rolling_update_flat
//       (_rolling_update_kernel): mean over P pre-masked f32 shares,
//       blended into one params row, p + alpha * (mean - p), the result
//       in params' type (f32, bf16 or f16).
//   field_wsum_kernel      replaces the TPU kernel
//       repro/kernels/secure_agg/kernel.py:field_wsum_flat
//       (_field_wsum_kernel): wrapping uint32 column sum of (P, N) field
//       shares; the decode and blend stay in the plain int_blend_params.
//
// Design.  One thread owns V adjacent columns (V = 4 when N % 4 == 0 and
// every operand starts on a 4-value boundary, so every row's slice loads
// as one vector; else 1: a contiguous view at an odd storage offset takes
// the scalar path instead of faulting) and loops over any P, summing row by row in fp32 (or uint32, wrapping)
// in registers; nothing is staged in shared memory.  The TPU kernel's
// (P, bn) VMEM tile and its block size have no counterpart: a thread
// masks the ragged edge itself, so the caller pads nothing.  The mean is
// the sum divided by P (IEEE division), and with -fmad=false the blend
// rounds after each operation, as the plain version does.
//
// Bound on an H100 SXM: bytes.  rolling_update reads P x N x 4 B of
// shares and N params and writes N outputs: at the legacy round's P = 3,
// N = 596,049,920 (qwen3-0.6b) with f32 params, 5 x 4 B x N = 11.92 GB,
// 3.56 ms at 3.35 TB/s.  field_wsum reads P x N x 4 B and writes N x 4 B:
// 9.54 GB, 2.85 ms.  Each does P adds per column, far below any pipe's
// rate.  Several loads per thread are in flight (the P loop is unrolled
// by 4), which is what a streaming kernel needs to reach the bound.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// V adjacent values, aligned so that one load or store moves them all.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rolling_update_kernel(const float* __restrict__ shares,
                      const T* __restrict__ params, T* __restrict__ out,
                      int rows, int64_t n, float alpha) {
  const int64_t g =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (int64_t)V;
  if (g >= n) return;
  float sum[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = 0.0f;
#pragma unroll 4
  for (int p = 0; p < rows; ++p) {
    const Pack<float, V> x = load_pack<float, V>(shares + p * n + g);
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] += x.v[v];
  }
  const float count = (float)rows;
  const Pack<T, V> pk = load_pack<T, V>(params + g);
  Pack<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float pv = to_f32(pk.v[v]);
    const float mean = sum[v] / count;
    o.v[v] = from_f32<T>(pv + alpha * (mean - pv));
  }
  *reinterpret_cast<Pack<T, V>*>(out + g) = o;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
field_wsum_kernel(const uint32_t* __restrict__ shares,
                  uint32_t* __restrict__ out, int rows, int64_t n) {
  const int64_t g =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (int64_t)V;
  if (g >= n) return;
  Pack<uint32_t, V> sum;
#pragma unroll
  for (int v = 0; v < V; ++v) sum.v[v] = 0u;
#pragma unroll 4
  for (int p = 0; p < rows; ++p) {
    const Pack<uint32_t, V> x = load_pack<uint32_t, V>(shares + p * n + g);
#pragma unroll
    for (int v = 0; v < V; ++v) sum.v[v] += x.v[v];  // wraps mod 2^32
  }
  *reinterpret_cast<Pack<uint32_t, V>*>(out + g) = sum;
}

// True when n columns split into 4-wide packs of T and every pointer
// starts on a pack boundary.
template <typename T>
bool packs_of_4(int64_t n, std::initializer_list<const void*> ptrs) {
  if (n % 4 != 0) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % (4 * sizeof(T)) != 0) return false;
  return true;
}

template <typename T>
int launch_rolling_update(const void* shares, const void* params, void* out,
                          int rows, int64_t n, float alpha, cudaStream_t s) {
  if (packs_of_4<float>(n, {shares}) && packs_of_4<T>(n, {params, out}))
    rolling_update_kernel<T, 4><<<blocks_for(n / 4), kThreads, 0, s>>>(
        (const float*)shares, (const T*)params, (T*)out, rows, n, alpha);
  else
    rolling_update_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)shares, (const T*)params, (T*)out, rows, n, alpha);
  return (int)cudaGetLastError();
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

// `work`: at p > kMaxRows, the accumulator workspace of
// masked_wide_workspace_bytes(p, n, domain) bytes, or null where that is
// 0; unread otherwise.
int masked_rolling_update_f32(const void* u, void* out, const void* mask,
                              int p, int64_t n, uint32_t seed, float alpha,
                              void* work, void* stream) {
  if (n <= 0 || p < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p > kMaxRows)
    return p <= kNet32Rows
               ? launch_rolling_update_wide<uint32_t>(
                     (const float*)u, (float*)out, (const float*)mask, p, n,
                     seed, alpha, work, s)
               : launch_rolling_update_wide<uint64_t>(
                     (const float*)u, (float*)out, (const float*)mask, p, n,
                     seed, alpha, work, s);
  const PairKeys keys = split_pair_keys(seed, p);
#define LAUNCH(P)                                                        \
  masked_rolling_update_kernel<P><<<agg_blocks(n), kAggThreads, 0, s>>>( \
      (const float*)u, (float*)out, (const float*)mask, n, keys, alpha)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int masked_field_wsum_f32(const void* u, void* out, const void* mask, int p,
                          int64_t n, uint32_t seed, float scale, void* work,
                          void* stream) {
  if (n <= 0 || p < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p > kMaxRows)
    return launch_field_wsum_wide((const float*)u, (uint32_t*)out,
                                  (const float*)mask, p, n, seed, scale, work,
                                  s);
  const PairKeys keys = split_pair_keys(seed, p);
#define LAUNCH(P)                                                        \
  masked_field_wsum_kernel<P><<<agg_blocks(n), kAggThreads, 0, s>>>(     \
      (const float*)u, (uint32_t*)out, (const float*)mask, n, keys, scale)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// Bytes of the accumulator workspace masked_rolling_update_f32 (domain 0)
// or masked_field_wsum_f32 (domain 1) needs at (p, n): 0 where p <=
// kMaxRows or the accumulators fit in shared memory.
int64_t masked_wide_workspace_bytes(int p, int64_t n, int domain) {
  if (p <= kMaxRows || n <= 0) return 0;
  if (domain == 0 && p > kNet32Rows)
    return wide_workspace_bytes<uint64_t>(p, n);
  return wide_workspace_bytes<uint32_t>(p, n);
}

int clip_noise_f32(const void* u, void* out, const void* norms,
                   const void* mask, int p, int64_t n, uint32_t seed,
                   float clip, float sigma, void* stream) {
  if (n <= 0 || p < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p > kMaxRows) {
    const dim3 grid(agg_blocks(n),
                    (unsigned)std::min((p + kDpGroup - 1) / kDpGroup,
                                       kDpMaxGroups));
    clip_noise_wide_kernel<<<grid, kAggThreads, 0, s>>>(
        (const float*)u, (float*)out, (const float*)norms,
        (const float*)mask, p, n, seed, clip, sigma);
    return (int)cudaGetLastError();
  }
  const DpKeys keys = split_dp_keys(seed, p);
#define LAUNCH(P)                                                        \
  clip_noise_kernel<P><<<agg_blocks(n), kAggThreads, 0, s>>>(            \
      (const float*)u, (float*)out, (const float*)norms,                 \
      (const float*)mask, n, keys, clip, sigma)
  REPRO_DISPATCH_ROWS(p, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// params dtype: 0 float32, 1 bfloat16, 2 float16; out has params' type.
int rolling_update_f32(const void* shares, const void* params, void* out,
                       int p, int64_t n, float alpha, int dtype,
                       void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_rolling_update<float>(shares, params, out, p, n, alpha,
                                          s);
    case 1:
      return launch_rolling_update<__nv_bfloat16>(shares, params, out, p, n,
                                                  alpha, s);
    case 2:
      return launch_rolling_update<__half>(shares, params, out, p, n, alpha,
                                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int field_wsum_u32(const void* shares, void* out, int p, int64_t n,
                   void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (packs_of_4<uint32_t>(n, {shares, out}))
    field_wsum_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(
        (const uint32_t*)shares, (uint32_t*)out, p, n);
  else
    field_wsum_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(
        (const uint32_t*)shares, (uint32_t*)out, p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

static_assert(kMaxRows <= 32, "participation bits live in one uint32");
