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
// bf16, causal) the forward does 4 * BH * S^2 * D / 2 = 69 GFLOP against
// 100 MB of inputs and outputs: hundreds of operations per byte.
//
// Design of this first version: the TPU kernel walks a sequential grid
// over key blocks with the whole K/V of a head resident in VMEM; here the
// walk is a loop inside a block that owns a 64-row tile.
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
//   * The products run on CUDA cores in fp32.  Tensor cores (mma/wgmma),
//     TMA and bf16 tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kSub = 4;            // rows / columns per thread: 64 / 16
constexpr int kPStride = kTile + 1;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
// K1a: forward
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
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
// K1b: dq
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Shape s) {
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
// K1c: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Shape s) {
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

template <typename T, int kD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
        const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes<kD>(3);
  if (const int err = set_smem(flash_fwd_kernel<T, kD>, smem)) return err;
  const dim3 grid((s.sq + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, kD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, const Shape& s,
           cudaStream_t st) {
  const size_t smem = smem_bytes<kD>(4);
  if (const int err = set_smem(flash_bwd_dq_kernel<T, kD>, smem)) return err;
  const dim3 grid((s.sq + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<T, kD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bhkv,
            const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes<kD>(4);
  if (const int err = set_smem(flash_bwd_dkv_kernel<T, kD>, smem)) return err;
  const dim3 grid((s.sk + kTile - 1) / kTile, bhkv);
  flash_bwd_dkv_kernel<T, kD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int bh, int sq, int sk, int d, int n_rep) {
  return bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || n_rep <= 0 ||
         bh % n_rep != 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, shared by q, k, v, O, dO and the
// gradients; lse and delta are fp32 [BHq, Sq].  `bh` counts query rows
// (BHq) for the forward and dq, kv rows (BHkv) for dk/dv.  Each returns
// cudaGetLastError() after its launch (0 on success); launches are
// asynchronous on `stream`.
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
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale};
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
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale};
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
  const Shape s{sq, sk, d, n_rep, causal, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, D) bwd_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bhkv, s, st)
  FA_DISPATCH(CALL);
#undef CALL
}
