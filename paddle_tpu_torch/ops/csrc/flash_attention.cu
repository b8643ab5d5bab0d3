// Flash attention forward and backward for Hopper (sm_90a), over the
// JAX package's [B*H, S, D] layout.
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py:
//   * K1a `_fwd_kernel` (launched by `_fwd_call`): O and the fp32 row
//     log-sum-exp LSE of softmax(scale * Q K^T) V;
//   * K1b `_bwd_dq_kernel` (first call of `_bwd_calls`):
//     dq = scale * dS K, dS = P o (dO V^T - delta), P = exp(S - LSE);
//   * K1c `_bwd_dkv_kernel` (second call of `_bwd_calls`): dv = P^T dO and
//     dk = scale * dS^T Q, summed in fp32 over the n_rep query heads that
//     share a kv head (GQA) and cast once.
// delta = rowsum(O * dO) in fp32 is computed by the caller, as in the JAX
// package.  Contract: q [BHq, Sq, D], k/v [BHkv, Sk, D], BHq = BHkv *
// n_rep, query row b reads kv row b / n_rep; `causal` masks key j for
// query i unless q_offset + i >= j (bottom-right alignment with q_offset
// = Sk - Sq); ragged tails (S not a multiple of the tile) are masked, not
// padded.  Every sum is fp32; q, k, v, O and the gradients share one
// dtype (fp32 or bf16).
//
// What bounds it: operations.  At the training shape ([64, 2048, 128]
// bf16, causal) the forward does 4 * BH * S^2 * D / 2 = 69 GFLOP, dq
// 6 * pairs * D = 103 GFLOP and dk/dv 8 * pairs * D = 137 GFLOP against
// ~100 MB of inputs and outputs each: hundreds of operations per byte, so
// the bf16 tensor cores (989 TFLOP/s) set the bound.
//
// fp32 (CUDA cores, the `_fp32` kernels): the TPU kernel walks a
// sequential grid over key blocks with the whole K/V of a head resident
// in VMEM; here the walk is a loop inside a block that owns a 64-row tile.
//   * Tiles of 64 rows x D (D <= 128, zero-filled past D) are staged in
//     shared memory as fp32 with a row stride of D + 1 words, so both row
//     reads (a thread walks d) and column reads (16 threads read 16 rows
//     at one d) hit distinct banks.
//   * 256 threads in a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 i
//     and columns tx + 16 j (i, j < 4) of each 64 x 64 score tile, so a
//     row's max and sum are shuffles over the 16 lanes that share ty.
//   * Masked probabilities: a masked key contributes exactly 0 (never
//     exp(0) of a fully masked tile), and the running max only sees
//     unmasked scores.  The causal loop stops at the last key tile a
//     query tile can see; the dk/dv loop starts at the first query tile
//     that can see its key tile, max(0, k0 - q_offset) / 64.
//   * The products are scalar fp32 FMAs.  fp32 stays there: TF32 keeps
//     ~3 digits and cannot meet fp32 tolerances, and no training path
//     runs fp32 attention.  The serving and decode prefills and the
//     program replays do (the replays at one query row: a decode shape
//     for a prefill kernel, later work).
//
// bf16 (K1a, K1b, K1c) runs on the tensor cores:
//   * mma.sync m16n8k16 bf16 x bf16 -> fp32 (inline PTX), fp32
//     accumulators in registers.  Tiles are bf16 in shared memory, rows
//     padded by 16 bytes (stride D + 8) so the 8 row addresses of every
//     ldmatrix fall in distinct banks; operands come in through ldmatrix,
//     `.trans` where a product needs the transposed tile.
//   * 16-byte cp.async copies, zero-filled past the ragged row edge and
//     past D; a D that is not a multiple of 8 (or an unaligned slab) takes
//     a scalar staging loop.  The streamed tiles are a two-stage ring:
//     the next tile is in flight while the current one multiplies.
//   * 128 threads (4 warps x 16 rows of a 64-row tile), ~104 KB of shared
//     memory (the forward ~87 KB): two blocks (8 warps) resident per SM.
//   * forward (K1a): a block owns a query tile and walks the key tiles it
//     can see, heavy (late, causal) query tiles first.  Q's A fragments
//     are loaded once through ldmatrix and stay in registers; K and V
//     stream through the ring.  S = Q K^T; the online softmax runs on the
//     accumulator layout in registers (a row's max and sum are shuffles
//     over the 4 lanes that share it; exp2 with scale * log2(e) folded
//     in; the scale multiplies the fp32 S, not the bf16 Q, whose rounding
//     the plain version lacks); O += P V with P as two bf16 A fragments
//     in registers, hi = bf16(P) and lo = bf16(P - hi), ~16 bits of P for
//     one more product per V fragment: P rounded once to bf16 puts O a
//     bf16 step from the plain version wherever |O| >= 2, and delta =
//     rowsum(O dO) carries that into every dq of the training step; O /
//     l in fp32, cast once.  A warp skips a key tile that none of its 16
//     rows can see; only a tile that straddles the diagonal or a ragged
//     edge for the warp's rows takes the masked loop (full tiles skip the
//     visibility test and the mask compare).
//     The tile height is the backward's 64 rows x 4 warps, so every part
//     is shared with it; 128 rows x 8 warps would halve the K/V traffic
//     per query row, but at 16 warps per SM the registers (O 64, S 32,
//     Q 32 per thread at D = 128) no longer fit without spills.  ptxas
//     (CUDA 12.8, sm_90a): 225 registers at D = 128, 162 at D = 64, no
//     spills; chip_smoke.py's phase 2 prints the report of each build.
//   * dq (K1b): a block owns a query tile (Q, dO resident) and walks the
//     key tiles it can see (K, V streamed): S = Q K^T, dP = dO V^T,
//     dS = P o (dP - delta), dQ += dS K.  Heavy (late, causal) query
//     tiles first.
//   * dk/dv (K1c): a block owns a key tile (K, V resident) and walks the
//     visible query tiles of each of its n_rep heads (Q, dO, LSE and delta
//     streamed), computing S^T = K Q^T so that the accumulators' rows are
//     keys: P^T, dP^T = V dO^T, dS^T, then dV += P^T dO and dK += dS^T Q.
//     The GQA group sums in fp32 registers.  Heavy (early) key tiles first.
//   * P and dS go from accumulator layout to A-operand fragments in
//     registers (rounded to bf16, as the TPU's default-precision dot
//     rounds its operands), never through shared memory.  The mask is
//     applied only on tiles that straddle the diagonal or a ragged edge.
//   * Two deterministic kernels (no fp32 atomics on dq), as the JAX
//     package splits them: S and dP are computed in both, 7 tile products
//     per (query, key) tile pair against a fused kernel's 5.
// Left on the table: wgmma with TMA (mma.sync reaches only part of the
// card's bf16 rate, and each ldmatrix of K or V feeds two products of a
// 16-row warp), warp specialisation, the fused backward layout, and the
// fp32 forward at one query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kSub = 4;            // rows / columns per thread: 64 / 16
constexpr int kPStride = kTile + 1;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// max / sum over the 16 lanes that share ty (xor offsets < 16 stay in the
// half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [0, rows) of a [*, D] slab into dst [64][kD + 1] as fp32
// times `mul`; rows past `rows` and columns past D are 0.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int rows,
                                          int d, float mul) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    float x = 0.f;
    if (r < rows && c < d) x = to_float(src[static_cast<int64_t>(r) * d + c]) * mul;
    dst[r * (kD + 1) + c] = x;
  }
}

// s[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]
template <int kD>
__device__ __forceinline__ void tile_abt(float s[kSub][kSub],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * (kD + 1) + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * (kD + 1) + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][k] += sum_c P[ty + 16 i][c] * B[c][tx + 16 k]   (P row-major)
template <int kD>
__device__ __forceinline__ void tile_pb(float acc[kSub][kD / 16],
                                        const float* __restrict__ p,
                                        const float* __restrict__ b, int ty,
                                        int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float pv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) pv[i] = p[(ty + 16 * i) * kPStride + c];
#pragma unroll
    for (int k = 0; k < kD / 16; ++k) {
      const float bv = b[c * (kD + 1) + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i][k] = fmaf(pv[i], bv, acc[i][k]);
    }
  }
}

// acc[i][k] += sum_r P[r][ty + 16 i] * B[r][tx + 16 k]   (P^T B)
template <int kD>
__device__ __forceinline__ void tile_ptb(float acc[kSub][kD / 16],
                                         const float* __restrict__ p,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) pv[i] = p[r * kPStride + ty + 16 * i];
#pragma unroll
    for (int k = 0; k < kD / 16; ++k) {
      const float bv = b[r * (kD + 1) + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i][k] = fmaf(pv[i], bv, acc[i][k]);
    }
  }
}

struct Shape {
  int sq, sk, d, n_rep, causal, q_offset;
  float scale;
  int vec = 0;   // bf16 backward: d % 8 == 0 and 16-byte aligned slabs
};

__device__ __forceinline__ bool visible(const Shape& s, int qi, int kj) {
  return qi < s.sq && kj < s.sk && (!s.causal || s.q_offset + qi >= kj);
}

// number of key tiles query tile `qt` can see
__device__ __forceinline__ int key_tiles(const Shape& s, int qt) {
  const int all = (s.sk + kTile - 1) / kTile;
  if (!s.causal) return all;
  const int hi = s.q_offset + (qt + 1) * kTile;   // keys < hi may be visible
  const int n = hi <= 0 ? 0 : (hi + kTile - 1) / kTile;
  return n < all ? n : all;
}

// ---------------------------------------------------------------------------
// K1a: forward, fp32 (CUDA cores)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Shape s) {
  using T = float;
  extern __shared__ float smem[];
  constexpr int kTileWords = kTile * (kD + 1);
  float* sq_ = smem;                    // Q * scale
  float* sk_ = sq_ + kTileWords;
  float* sv_ = sk_ + kTileWords;
  float* sp_ = sv_ + kTileWords;        // P [64][65]

  // heavy (late, causal) query tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kv = bh / s.n_rep;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const T* qb = q + (static_cast<int64_t>(bh) * s.sq + q0) * s.d;
  const T* kb = k + static_cast<int64_t>(kv) * s.sk * s.d;
  const T* vb = v + static_cast<int64_t>(kv) * s.sk * s.d;

  load_tile<T, kD>(sq_, qb, min(kTile, s.sq - q0), s.d, s.scale);

  float acc[kSub][kD / 16];
  float m[kSub], l[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(s, qt);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                    // done with the previous K, V, P
    load_tile<T, kD>(sk_, kb + static_cast<int64_t>(k0) * s.d,
                     min(kTile, s.sk - k0), s.d, 1.f);
    load_tile<T, kD>(sv_, vb + static_cast<int64_t>(k0) * s.d,
                     min(kTile, s.sk - k0), s.d, 1.f);
    __syncthreads();

    float sc[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) sc[i][j] = 0.f;
    tile_abt<kD>(sc, sq_, sk_, ty, tx);

#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (visible(s, qi, k0 + tx + 16 * j)) mx = fmaxf(mx, sc[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(s, qi, k0 + tx + 16 * j) ? expf(sc[i][j] - m_new) : 0.f;
        sp_[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pb<kD>(acc, sp_, sv_, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= s.sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(bh) * s.sq + qi) * s.d;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < s.d) orow[d] = from_float<T>(l[i] > 0.f ? acc[i][c] / lc : 0.f);
    }
    if (tx == 0) lse[static_cast<int64_t>(bh) * s.sq + qi] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// K1b: dq, fp32 (CUDA cores)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Shape s) {
  using T = float;
  extern __shared__ float smem[];
  constexpr int kTileWords = kTile * (kD + 1);
  float* sq_ = smem;                    // Q * scale
  float* sdo = sq_ + kTileWords;
  float* sk_ = sdo + kTileWords;
  float* sv_ = sk_ + kTileWords;
  float* sds = sv_ + kTileWords;        // dS [64][65]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kv = bh / s.n_rep;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int rows = min(kTile, s.sq - q0);
  const int64_t row_base = static_cast<int64_t>(bh) * s.sq + q0;
  const T* kb = k + static_cast<int64_t>(kv) * s.sk * s.d;
  const T* vb = v + static_cast<int64_t>(kv) * s.sk * s.d;

  load_tile<T, kD>(sq_, q + row_base * s.d, rows, s.d, s.scale);
  load_tile<T, kD>(sdo, dout + row_base * s.d, rows, s.d, 1.f);
  float lse_r[kSub], delta_r[kSub];
  float acc[kSub][kD / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    lse_r[i] = r < rows ? lse[row_base + r] : 0.f;
    delta_r[i] = r < rows ? delta[row_base + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(s, qt);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, kD>(sk_, kb + static_cast<int64_t>(k0) * s.d,
                     min(kTile, s.sk - k0), s.d, 1.f);
    load_tile<T, kD>(sv_, vb + static_cast<int64_t>(k0) * s.d,
                     min(kTile, s.sk - k0), s.d, 1.f);
    __syncthreads();

    float sc[kSub][kSub], dp[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) sc[i][j] = dp[i][j] = 0.f;
    tile_abt<kD>(sc, sq_, sk_, ty, tx);
    tile_abt<kD>(dp, sdo, sv_, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(s, qi, k0 + tx + 16 * j) ? expf(sc[i][j] - lse_r[i]) : 0.f;
        sds[(ty + 16 * i) * kPStride + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_pb<kD>(acc, sds, sk_, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    T* drow = dq + (row_base + r) * s.d;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < s.d) drow[d] = from_float<T>(acc[i][c] * s.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K1c: dk, dv, fp32 (CUDA cores)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Shape s) {
  using T = float;
  extern __shared__ float smem[];
  constexpr int kTileWords = kTile * (kD + 1);
  float* sk_ = smem;
  float* sv_ = sk_ + kTileWords;
  float* sq_ = sv_ + kTileWords;        // Q * scale
  float* sdo = sq_ + kTileWords;
  float* sp_ = sdo + kTileWords;        // P, then dS [64][65]

  // heavy (early, causal) key tiles first
  const int kt = blockIdx.x;
  const int bkv = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = kt * kTile;
  const int krows = min(kTile, s.sk - k0);
  const int64_t kv_base = static_cast<int64_t>(bkv) * s.sk + k0;

  load_tile<T, kD>(sk_, k + kv_base * s.d, krows, s.d, 1.f);
  load_tile<T, kD>(sv_, v + kv_base * s.d, krows, s.d, 1.f);

  float dk_acc[kSub][kD / 16], dv_acc[kSub][kD / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (s.sq + kTile - 1) / kTile;
  int lo = 0;
  if (s.causal) {
    const int first = k0 - s.q_offset;  // first query row that sees key k0
    lo = first > 0 ? first / kTile : 0;
  }
  for (int rep = 0; rep < s.n_rep; ++rep) {
    const int bh = bkv * s.n_rep + rep;
    for (int qt = lo; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      const int rows = min(kTile, s.sq - q0);
      const int64_t row_base = static_cast<int64_t>(bh) * s.sq + q0;
      __syncthreads();                  // done with the previous Q, dO, dS
      load_tile<T, kD>(sq_, q + row_base * s.d, rows, s.d, s.scale);
      load_tile<T, kD>(sdo, dout + row_base * s.d, rows, s.d, 1.f);
      __syncthreads();

      float sc[kSub][kSub], dp[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) sc[i][j] = dp[i][j] = 0.f;
      tile_abt<kD>(sc, sq_, sk_, ty, tx);     // rows: queries, cols: keys
      tile_abt<kD>(dp, sdo, sv_, ty, tx);
      float ds[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = ty + 16 * i;
        const float lse_r = r < rows ? lse[row_base + r] : 0.f;
        const float delta_r = r < rows ? delta[row_base + r] : 0.f;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const float p = visible(s, q0 + r, k0 + tx + 16 * j) ? expf(sc[i][j] - lse_r) : 0.f;
          sp_[r * kPStride + tx + 16 * j] = p;
          ds[i][j] = p * (dp[i][j] - delta_r);
        }
      }
      __syncthreads();
      tile_ptb<kD>(dv_acc, sp_, sdo, ty, tx);  // dv += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          sp_[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
      __syncthreads();
      tile_ptb<kD>(dk_acc, sp_, sq_, ty, tx);  // dk += dS^T (Q * scale)
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    if (r >= krows) continue;
    T* krow = dk + (kv_base + r) * s.d;
    T* vrow = dv + (kv_base + r) * s.d;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < s.d) {
        krow[d] = from_float<T>(dk_acc[i][c]);
        vrow[d] = from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1b, K1c: bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;     // 4 warps x 16 rows of a 64-row tile
constexpr int kPad = 8;             // bf16 row padding: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kD>
__host__ __device__ constexpr int tc_row() { return kD + kPad; }
template <int kD>
__host__ __device__ constexpr int tc_tile() {   // bf16 elements
  return kTile * tc_row<kD>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `bytes` = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 address matrix i's rows
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk of a product whose A is a 16 x 64 tile held
// as m16n8 accumulators x[8][4] (columns 8 n + 2 t, + 1; rows g, g + 8).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[8][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Stage rows [0, rows) of a [*, d] bf16 slab into dst [64][kD + kPad];
// rows past `rows` and columns past d are 0.  16-byte cp.async when `vec`
// (d % 8 == 0, 16-byte aligned slab), else a scalar loop.
template <int kD>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int rows, int d, int vec) {
  constexpr int kRow = tc_row<kD>();
  if (vec) {
    constexpr int kChunks = kD / 8;
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kTcThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const bool ok = r < rows && c < d;
      cp_async16(smem_u32(dst + r * kRow + c),
                 ok ? src + static_cast<int64_t>(r) * d + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kD; idx += kTcThreads) {
      const int r = idx / kD;
      const int c = idx % kD;
      dst[r * kRow + c] = r < rows && c < d ? src[static_cast<int64_t>(r) * d + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

// a (d, d + 1) pair of one output row, from fp32
__device__ __forceinline__ void store_pair(bf16* __restrict__ row, int c,
                                           float x0, float x1, int d,
                                           int vec) {
  if (vec) {
    if (c < d)
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < d) row[c] = __float2bfloat16(x0);
    if (c + 1 < d) row[c + 1] = __float2bfloat16(x1);
  }
}

// every (query, key) pair of the 64 x 64 tile at (q0, k0) is visible
__device__ __forceinline__ bool tile_full(const Shape& s, int q0, int k0) {
  return q0 + kTile <= s.sq && k0 + kTile <= s.sk &&
         (!s.causal || s.q_offset + q0 >= k0 + kTile - 1);
}

// ldmatrix lane offsets (bf16 elements) into a [rows][kD + kPad] tile.
// A of a row-major [m][k] tile and B of a row-major [k][n] tile through
// .trans share one map: row lane % 16, column 8 (lane / 16).  B of an
// [n][k] tile (the product takes its transpose) pairs two n8 tiles: row
// lane % 8 + 8 (lane / 16), column 8 (lane / 8 % 2).
template <int kD>
__device__ __forceinline__ int a_offset(int lane) {
  return (lane & 15) * tc_row<kD>() + (lane >> 4) * 8;
}
template <int kD>
__device__ __forceinline__ int bt_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * tc_row<kD>() + ((lane >> 3) & 1) * 8;
}

// x[8][4] (16 rows of this warp x 64 columns) = A[16 x kD] B^T, with A's
// rows at shared address `a` (lane offset applied) and B = rows [0, 64) of
// the [64][kD + kPad] tile at `b` (lane offset applied).
template <int kD>
__device__ __forceinline__ void tile_abt_tc(float (&x)[8][4], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t af[4];
    ldsm(af, a + ks * 32);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm(bf, b + (np * 16 * tc_row<kD>() + ks * 16) * 2);
      mma(x[2 * np], af, bf[0], bf[1]);
      mma(x[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[kD / 8][4] += X B, X a 16 x 64 tile held as accumulators x[8][4],
// B the [64][kD + kPad] tile at `b` (lane offset a_offset applied), read
// through ldmatrix.trans
template <int kD>
__device__ __forceinline__ void tile_xb_tc(float (&acc)[kD / 8][4],
                                           const float (&x)[8][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    acc_to_a(af, x, kk);
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      uint32_t bf[4];
      ldsm_t(bf, b + (kk * 16 * tc_row<kD>() + dn * 16) * 2);
      mma(acc[2 * dn], af, bf[0], bf[1]);
      mma(acc[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

// x[8][4] = A B^T as tile_abt_tc, with A's fragments in registers
template <int kD>
__device__ __forceinline__ void tile_abt_tc(float (&x)[8][4],
                                            const uint32_t (&af)[kD / 16][4],
                                            uint32_t b) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm(bf, b + (np * 16 * tc_row<kD>() + ks * 16) * 2);
      mma(x[2 * np], af[ks], bf[0], bf[1]);
      mma(x[2 * np + 1], af[ks], bf[2], bf[3]);
    }
  }
}

// acc[kD / 8][4] += X B as tile_xb_tc, with X carried as two bf16 terms,
// hi = bf16(x) and lo = bf16(x - hi): ~16 bits of x for one more product
// per B fragment
template <int kD>
__device__ __forceinline__ void tile_xb_tc2(float (&acc)[kD / 8][4],
                                            const float (&x)[8][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* xi = x[2 * kk + (i >> 1)] + 2 * (i & 1);
      const __nv_bfloat162 h = __floats2bfloat162_rn(xi[0], xi[1]);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(xi[0] - hf.x, xi[1] - hf.y);
      hi[i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[i] = *reinterpret_cast<const uint32_t*>(&l);
    }
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      uint32_t bf[4];
      ldsm_t(bf, b + (kk * 16 * tc_row<kD>() + dn * 16) * 2);
      mma(acc[2 * dn], hi, bf[0], bf[1]);
      mma(acc[2 * dn + 1], hi, bf[2], bf[3]);
      mma(acc[2 * dn], lo, bf[0], bf[1]);
      mma(acc[2 * dn + 1], lo, bf[2], bf[3]);
    }
  }
}

// max over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// K1a: forward, bf16 (tensor cores)
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int kT = tc_tile<kD>();
  bf16* sq_ = reinterpret_cast<bf16*>(tc_smem);   // Q, read once
  bf16* sk_ = sq_ + kT;                           // K [2 stages]
  bf16* sv_ = sk_ + 2 * kT;                       // V [2 stages]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heavy (late) tiles first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const int wq0 = q0 + warp * 16;                 // this warp's first row
  const int rows = min(kTile, s.sq - q0);
  const int64_t row_base = static_cast<int64_t>(bh) * s.sq + q0;
  const int64_t kv_base = static_cast<int64_t>(bh / s.n_rep) * s.sk;

  stage_tile<kD>(sq_, q + row_base * s.d, rows, s.d, s.vec);
  cp_async_commit();
  const int n_kt = key_tiles(s, qt);
  auto stage = [&](int kt) {
    const int k0 = kt * kTile;
    const int64_t off = (kv_base + k0) * s.d;
    stage_tile<kD>(sk_ + (kt & 1) * kT, k + off, min(kTile, s.sk - k0), s.d, s.vec);
    stage_tile<kD>(sv_ + (kt & 1) * kT, v + off, min(kTile, s.sk - k0), s.d, s.vec);
  };
  if (n_kt > 0) stage(0);
  cp_async_commit();
  cp_async_wait<1>();                 // Q has landed
  __syncthreads();
  uint32_t qf[kD / 16][4];
  const uint32_t q_a = smem_u32(sq_ + warp * 16 * tc_row<kD>() + a_offset<kD>(lane));
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) ldsm(qf[ks], q_a + ks * 32);

  // this thread's rows wq0 + g and + 8 (g = lane / 4): the running max of
  // scale * log2(e) * S, and this thread's share of the row sum
  const float scale_l2 = s.scale * kLog2e;
  float m2[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kTile;
    // no row of this warp sees a key of the tile: nothing to add
    const bool none = wq0 >= s.sq || (s.causal && s.q_offset + wq0 + 15 < k0);
    if (!none) {
      const bf16* tk = sk_ + (kt & 1) * kT;
      const bf16* tv = sv_ + (kt & 1) * kT;
      float sc[8][4];
      tile_abt_tc<kD>(sc, qf, smem_u32(tk + bt_offset<kD>(lane)));   // S = Q K^T
      const bool full = wq0 + 16 <= s.sq && k0 + kTile <= s.sk &&
                        (!s.causal || s.q_offset + wq0 >= k0 + kTile - 1);
      float mx[2] = {kMaskValue, kMaskValue};
      if (full) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[n][e] *= scale_l2;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float t = sc[n][e] * scale_l2;
            if (!visible(s, wq0 + lane / 4 + 8 * h,
                         k0 + 8 * n + 2 * (lane % 4) + (e & 1)))
              t = kMaskValue;
            sc[n][e] = t;
            mx[h] = fmaxf(mx[h], t);
          }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m2[h], quad_max(mx[h]));
        alpha[h] = exp2f(m2[h] - m_new);
        m2[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key adds exactly 0, also before any key was seen
          const float t = sc[n][e];
          const float p = !full && t == kMaskValue ? 0.f : exp2f(t - m2[e >> 1]);
          sc[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      tile_xb_tc2<kD>(acc, sc, smem_u32(tv + a_offset<kD>(lane)));    // O += P V
    }
    __syncthreads();                  // the next stage() refills this slot
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lr = quad_sum(l[h]);
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (r >= rows) continue;
    const float lc = fmaxf(lr, 1e-30f);
    bf16* orow = o + (row_base + r) * s.d;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float x0 = lr > 0.f ? acc[n][2 * h] / lc : 0.f;
      const float x1 = lr > 0.f ? acc[n][2 * h + 1] / lc : 0.f;
      store_pair(orow, 8 * n + 2 * (lane % 4), x0, x1, s.d, s.vec);
    }
    if (lane % 4 == 0)
      lse[row_base + r] = (lr > 0.f ? m2[h] * kLn2 : kMaskValue) + logf(lc);
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Shape s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int kT = tc_tile<kD>();
  bf16* sq_ = reinterpret_cast<bf16*>(tc_smem);   // Q, resident
  bf16* sdo = sq_ + kT;                           // dO, resident
  bf16* sk_ = sdo + kT;                           // K [2 stages]
  bf16* sv_ = sk_ + 2 * kT;                       // V [2 stages]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heavy (late) tiles first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const int rows = min(kTile, s.sq - q0);
  const int64_t row_base = static_cast<int64_t>(bh) * s.sq + q0;
  const int64_t kv_base = static_cast<int64_t>(bh / s.n_rep) * s.sk;

  stage_tile<kD>(sq_, q + row_base * s.d, rows, s.d, s.vec);
  stage_tile<kD>(sdo, dout + row_base * s.d, rows, s.d, s.vec);
  const int n_kt = key_tiles(s, qt);
  auto stage = [&](int kt) {
    const int k0 = kt * kTile;
    const int64_t off = (kv_base + k0) * s.d;
    stage_tile<kD>(sk_ + (kt & 1) * kT, k + off, min(kTile, s.sk - k0), s.d, s.vec);
    stage_tile<kD>(sv_ + (kt & 1) * kT, v + off, min(kTile, s.sk - k0), s.d, s.vec);
  };
  if (n_kt > 0) stage(0);
  cp_async_commit();

  // this thread's query rows: warp * 16 + g and + 8 (g = lane / 4)
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    lse_l2[h] = r < rows ? lse[row_base + r] * kLog2e : 0.f;
    delta_r[h] = r < rows ? delta[row_base + r] : 0.f;
  }
  const float scale_l2 = s.scale * kLog2e;
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const uint32_t q_a = smem_u32(sq_ + warp * 16 * tc_row<kD>() + a_offset<kD>(lane));
  const uint32_t do_a = smem_u32(sdo + warp * 16 * tc_row<kD>() + a_offset<kD>(lane));
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tk = sk_ + (kt & 1) * kT;
    const bf16* tv = sv_ + (kt & 1) * kT;
    float sc[8][4], dp[8][4];
    tile_abt_tc<kD>(sc, q_a, smem_u32(tk + bt_offset<kD>(lane)));   // S = Q K^T
    tile_abt_tc<kD>(dp, do_a, smem_u32(tv + bt_offset<kD>(lane)));  // dP = dO V^T
    const int k0 = kt * kTile;
    const bool full = tile_full(s, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(fmaf(sc[n][e], scale_l2, -lse_l2[h]));
        if (!full && !visible(s, q0 + warp * 16 + lane / 4 + 8 * h,
                              k0 + 8 * n + 2 * (lane % 4) + (e & 1)))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - delta_r[h]);   // dS
      }
    tile_xb_tc<kD>(acc, dp, smem_u32(tk + a_offset<kD>(lane)));    // dQ += dS K
    __syncthreads();                  // the next stage() refills this slot
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (r >= rows) continue;
    bf16* drow = dq + (row_base + r) * s.d;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      store_pair(drow, 8 * n + 2 * (lane % 4), acc[n][2 * h] * s.scale,
                 acc[n][2 * h + 1] * s.scale, s.d, s.vec);
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Shape s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int kT = tc_tile<kD>();
  bf16* sk_ = reinterpret_cast<bf16*>(tc_smem);   // K, resident
  bf16* sv_ = sk_ + kT;                           // V, resident
  bf16* sq_ = sv_ + kT;                           // Q [2 stages]
  bf16* sdo = sq_ + 2 * kT;                       // dO [2 stages]
  float* srow = reinterpret_cast<float*>(sdo + 2 * kT);  // [2][LSE 64, delta 64]

  const int kt = blockIdx.x;                      // heavy (early) tiles first
  const int bkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = kt * kTile;
  const int krows = min(kTile, s.sk - k0);
  const int64_t kv_base = static_cast<int64_t>(bkv) * s.sk + k0;

  stage_tile<kD>(sk_, k + kv_base * s.d, krows, s.d, s.vec);
  stage_tile<kD>(sv_, v + kv_base * s.d, krows, s.d, s.vec);

  const int n_qt = (s.sq + kTile - 1) / kTile;
  int lo = 0;
  if (s.causal) {
    const int first = k0 - s.q_offset;   // first query row that sees key k0
    lo = first > 0 ? first / kTile : 0;
  }
  const int per_rep = n_qt - lo;         // query tiles of one head
  const int n_it = per_rep > 0 ? s.n_rep * per_rep : 0;
  auto stage = [&](int it) {
    const int q0 = (lo + it % per_rep) * kTile;
    const int rows = min(kTile, s.sq - q0);
    const int64_t row_base =
        static_cast<int64_t>(bkv * s.n_rep + it / per_rep) * s.sq + q0;
    const int buf = it & 1;
    stage_tile<kD>(sq_ + buf * kT, q + row_base * s.d, rows, s.d, s.vec);
    stage_tile<kD>(sdo + buf * kT, dout + row_base * s.d, rows, s.d, s.vec);
    // thread i < 64 stages LSE of row i, thread 64 + i delta of row i
    const int r = threadIdx.x % kTile;
    const float* src = (threadIdx.x < kTile ? lse : delta) + row_base;
    cp_async4(smem_u32(srow + buf * 2 * kTile + threadIdx.x),
              r < rows ? src + r : src, r < rows ? 4 : 0);
  };
  if (n_it > 0) stage(0);
  cp_async_commit();

  const float scale_l2 = s.scale * kLog2e;
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const uint32_t k_a = smem_u32(sk_ + warp * 16 * tc_row<kD>() + a_offset<kD>(lane));
  const uint32_t v_a = smem_u32(sv_ + warp * 16 * tc_row<kD>() + a_offset<kD>(lane));
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1;
    const bf16* tq = sq_ + buf * kT;
    const bf16* tdo = sdo + buf * kT;
    const float* rl = srow + buf * 2 * kTile;
    // rows: this warp's keys warp * 16 + g (+ 8); columns: queries
    float st[8][4], dpt[8][4];
    tile_abt_tc<kD>(st, k_a, smem_u32(tq + bt_offset<kD>(lane)));    // S^T = K Q^T
    tile_abt_tc<kD>(dpt, v_a, smem_u32(tdo + bt_offset<kD>(lane)));  // dP^T = V dO^T
    const int q0 = (lo + it % per_rep) * kTile;
    const bool full = tile_full(s, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * (lane % 4) + (e & 1);
        float p = exp2f(fmaf(st[n][e], scale_l2, -rl[c] * kLog2e));
        if (!full && !visible(s, q0 + c, k0 + warp * 16 + lane / 4 + 8 * (e >> 1)))
          p = 0.f;
        st[n][e] = p;                                  // P^T
        dpt[n][e] = p * (dpt[n][e] - rl[kTile + c]);   // dS^T
      }
    tile_xb_tc<kD>(dv_acc, st, smem_u32(tdo + a_offset<kD>(lane)));  // dV += P^T dO
    tile_xb_tc<kD>(dk_acc, dpt, smem_u32(tq + a_offset<kD>(lane)));  // dK += dS^T Q
    __syncthreads();                  // the next stage() refills this slot
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (r >= krows) continue;
    bf16* krow = dk + (kv_base + r) * s.d;
    bf16* vrow = dv + (kv_base + r) * s.d;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      store_pair(krow, c, dk_acc[n][2 * h] * s.scale,
                 dk_acc[n][2 * h + 1] * s.scale, s.d, s.vec);
      store_pair(vrow, c, dv_acc[n][2 * h], dv_acc[n][2 * h + 1], s.d, s.vec);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int kD>
constexpr size_t smem_bytes(int tiles) {
  return (static_cast<size_t>(tiles) * kTile * (kD + 1) + kTile * kPStride) * sizeof(float);
}

// the tensor-core kernels: bf16 tiles (resident ones and a two-stage ring
// of a pair) + the dk/dv kernel's LSE and delta ring
template <int kD>
constexpr size_t tc_smem_bytes(int tiles, int row_words) {
  return tiles * tc_tile<kD>() * sizeof(bf16) + row_words * sizeof(float);
}

// fp32: the CUDA-core kernel; bf16: the tensor-core kernel.  The shared
// memory attribute is set once per instantiation.
template <typename T, int kD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
        const Shape& s, cudaStream_t st) {
  const dim3 grid((s.sq + kTile - 1) / kTile, bh);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = smem_bytes<kD>(3);
    static const int attr = set_smem(flash_fwd_fp32_kernel<kD>, smem);
    if (attr) return attr;
    flash_fwd_fp32_kernel<kD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), s);
  } else {
    const size_t smem = tc_smem_bytes<kD>(5, 0);
    static const int attr = set_smem(flash_fwd_kernel<kD>, smem);
    if (attr) return attr;
    flash_fwd_kernel<kD><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, const Shape& s,
           cudaStream_t st) {
  const dim3 grid((s.sq + kTile - 1) / kTile, bh);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = smem_bytes<kD>(4);
    static const int attr = set_smem(flash_bwd_dq_fp32_kernel<kD>, smem);
    if (attr) return attr;
    flash_bwd_dq_fp32_kernel<kD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), s);
  } else {
    const size_t smem = tc_smem_bytes<kD>(6, 0);
    static const int attr = set_smem(flash_bwd_dq_kernel<kD>, smem);
    if (attr) return attr;
    flash_bwd_dq_kernel<kD><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bhkv,
            const Shape& s, cudaStream_t st) {
  const dim3 grid((s.sk + kTile - 1) / kTile, bhkv);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = smem_bytes<kD>(4);
    static const int attr = set_smem(flash_bwd_dkv_fp32_kernel<kD>, smem);
    if (attr) return attr;
    flash_bwd_dkv_fp32_kernel<kD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s);
  } else {
    const size_t smem = tc_smem_bytes<kD>(6, 4 * kTile);
    static const int attr = set_smem(flash_bwd_dkv_kernel<kD>, smem);
    if (attr) return attr;
    flash_bwd_dkv_kernel<kD><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int bh, int sq, int sk, int d, int n_rep) {
  return bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || n_rep <= 0 ||
         bh % n_rep != 0;
}

// 16-byte copies of every slab: d % 8 == 0 and 16-byte aligned pointers
bool vec_ok(int d, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return d % 8 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, shared by q, k, v, O, dO and the
// gradients; lse and delta are fp32 [BHq, Sq].  `bh` counts query rows
// (BHq) for the forward and dq, kv rows (BHkv) for dk/dv.  The backward
// sends float32 to the CUDA-core kernels and bfloat16 to the tensor-core
// kernels.  Each returns cudaGetLastError() after its launch (0 on
// success); launches are asynchronous on `stream`.
#define FA_DISPATCH(CALL)                                                    \
  do {                                                                       \
    if (dtype == 0 && d <= 64) return CALL(float, 64);                       \
    if (dtype == 0) return CALL(float, 128);                                 \
    if (dtype == 1 && d <= 64) return CALL(__nv_bfloat16, 64);               \
    if (dtype == 1) return CALL(__nv_bfloat16, 128);                         \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  } while (0)

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, int n_rep,
                         int causal, int q_offset, float scale, int dtype,
                         void* stream) {
  if (bad_args(bh, sq, sk, d, n_rep)) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale, vec_ok(d, {q, k, v, o})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, D) fwd<T, D>(q, k, v, o, lse, bh, s, st)
  FA_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int n_rep, int causal, int q_offset,
                            float scale, int dtype, void* stream) {
  if (bad_args(bh, sq, sk, d, n_rep)) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale,
                vec_ok(d, {q, k, v, dout, dq})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, D) bwd_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, s, st)
  FA_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bhkv,
                             int sq, int sk, int d, int n_rep, int causal,
                             int q_offset, float scale, int dtype,
                             void* stream) {
  if (bad_args(bhkv * n_rep, sq, sk, d, n_rep))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale,
                vec_ok(d, {q, k, v, dout, dk, dv})};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, D) bwd_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bhkv, s, st)
  FA_DISPATCH(CALL);
#undef CALL
}
