// Fused decode-step kernels for Hopper (sm_90a): the per-token body of the
// compiled decode loop, one layer at a time.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_decode.py:
//   K6a `_rope_qkv_kernel` (launched by `_rope_qkv_pallas`): q/k/v
//       projections of one token, fp32 sums, optional bias, q and k rotated
//       by one position's cos/sin row (interleaved or neox);
//   K6b `_attend_kernel` (launched by `_attend_pallas`): append the new k/v
//       row to the [B, S_total, nkv, hd] caches at `pos` and attend q to
//       positions 0..pos (GQA: n_rep query heads share a kv head);
//   K6c `_norm_mlp_kernel` (launched by `_norm_mlp_pallas`): LayerNorm ->
//       w1 + b1 -> gelu -> w2 + b2 (GPT), or RMSNorm -> act(h @ w_gate) *
//       (h @ w1) -> w2 (LLaMA), fp32 statistics;
//   K6d `_norm_matmul_kernel` (launched by `norm_matmul`, the target of the
//       program passes' kernel claim): LayerNorm or RMSNorm of x's rows in
//       fp32, times w [H, N] in fp32, cast to x's dtype, then + bias.
// and computes what the plain versions in paddle_tpu_torch/ops/fused_decode.py
// compute (`rope_qkv_ref`, `attend_cache_append_ref`, `norm_mlp_ref`,
// `norm_matmul_ref`).
//
// What bounds them: bytes.  At decode a weight element read once feeds one
// multiply-add per batch row (8 on the main path), and a cache element one
// per query head sharing it, far below the card's operations per byte.  So
// the least time is the weights (K6a, K6c, K6d) or the live cache rows (K6b)
// over the memory rate.
//
// Design.  The TPU kernels hold every weight tile in VMEM, which is why the
// JAX package gates them to 10 MiB; here nothing is resident and nothing is
// gated by size: the weights and the cache stream from device memory.
//
// K6a and K6c share one weight-streaming GEMV (`gemv_kernel`) for a few
// rows of x [B, K] against row-major weights [K, N] (any row stride, so
// GPT's q/k/v are read as column slices of the packed [H, 3H] projection):
//   * a block owns 32 column pairs (one per lane) of one weight matrix and
//     8 rows of x (grid.y tiles larger batches); each thread owns one pair,
//     (2j, 2j+1), or (j, j + hd/2) for a neox rotation, so the rope
//     epilogue needs no exchange between threads, and a warp reads each
//     weight row as one contiguous run (8-byte pair loads where aligned);
//   * the block's 8 warps split the reduction axis K; x is staged 128 rows
//     at a time in shared memory as fp32, normalised on the way in for
//     K6c's first launch (each block computes its rows' statistics);
//   * 16 weight rows are loaded per warp before their multiply-adds, to
//     keep enough bytes in flight; the 8 warps' sums meet in shared memory;
//   * where the columns alone give fewer blocks than twice the SMs, grid.z
//     splits K as well: each block writes its partial sums, and the last
//     block of a tile to arrive (an atomic counter per tile, reset by that
//     block) adds them in a fixed order, so the result does not depend on
//     the order the blocks ran in, and applies the epilogue.
// K6c is two launches of it: the norm (on the way in) and the up (and gate)
// products into an fp32 scratch [B, I] (the down product needs every
// column of it), then the down product, whose input comes in as the
// activation (gelu of the up output, or act(gate) * up), + bias.
//
// K6d is one launch.  A row-major weight [H, N] (a `linear` weight) takes
// the GEMV above with one problem, the norm on the way in, and the bias
// added after the result is rounded to x's dtype (as the JAX wrapper adds
// it outside the Pallas kernel).  A transposed weight (the tied GPT head
// and LLaMA's head arrive as w.T of a row-major [N, H] tensor) has its
// own loop, `norm_matmul_t_kernel`: read through the GEMV's column pairs,
// every lane's loads would be H elements apart.  Instead a warp owns 4
// output columns and reads each one's weight row of H contiguously, 16
// bytes a lane where aligned, against the normalized rows of x staged in
// shared memory 1024 columns at a time (8 rows x 1024 fp32 = 32 KiB; all
// of H = 4096 would be 128 KiB); the lanes' sums meet by shuffles.
//
// K6b: one block per (kv head, batch row) owns the n_rep query rows of that
// kv head.  It uses the new k/v row from registers at `pos` and writes it to
// the caches (in place: the wrapper returns the same tensors), then its 8
// warps walk positions 0..pos - 1 interleaved, 4 positions per step, each
// warp keeping an online softmax per query row; the warps' states are merged
// in shared memory.  Only rows 0..pos are read, not the S_total rows the
// TPU kernel masks: masked probabilities are exactly 0 there.
//
// Tensor cores, TMA and a split over positions across blocks for long
// contexts at small batch are later work; so is a split of K for K6d's
// transposed loop (its columns give enough blocks on the main path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSplit = 8;                  // warps splitting K in a block
constexpr int kRows = 8;                   // rows of x per block
constexpr int kThreads = kWarp * kSplit;   // 256
constexpr int kChunk = 128;                // K rows staged per step
constexpr int kPerWarp = kChunk / kSplit;  // 16 weight rows per warp per step
constexpr float kMaskValue = -1e30f;       // the eager sdpa mask constant
static_assert(kSplit == kRows, "one warp per x row for the statistics, and "
              "one thread per (row, lane) for the epilogue");

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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// the weight-streaming GEMV (K6a, K6c)
// ---------------------------------------------------------------------------

enum Norm { kNoNorm = 0, kLayerNorm = 1, kRmsNorm = 2 };
enum Act { kNoAct = 0, kSilu = 1, kGeluTanh = 2, kGelu = 3 };

// One weight matrix [K, n], its epilogue and its output.
struct Problem {
  const void* w;
  long long ldw;          // row stride, in elements
  const float* bias;      // [n] fp32, or nullptr
  void* out;              // [batch, n] contiguous
  int n;                  // columns
  int tiles;              // ceil(n / 2 / 32)
  int rope;               // rotate each column pair by cos/sin
};

struct GemvArgs {
  const void* x;          // [batch, k] contiguous
  int batch, k;
  int norm;               // Norm applied to x's rows on the way in
  const float* nw;        // [k] fp32 norm weight
  const float* nb;        // [k] fp32 norm bias, or nullptr
  float eps;
  const float* gate;      // [batch, k] fp32, or nullptr; with it x's rows
  int gate_act;           // come in as act(gate) * x (SwiGLU)
  const float* cos_row;   // [head_dim] fp32 (problems with rope)
  const float* sin_row;
  int neox, head_dim;
  int act;                // Act on each output (after the bias)
  int bias_after_round;   // add the bias to the output rounded to TO (K6d)
  int n_problems;
  Problem p[3];
  int k_splits;           // grid.z
  float* partial;         // [tiles * y-tiles * k_splits * 2 * 256]
  int* counters;          // [tiles * y-tiles], zero; left zero
};

// The norm's statistics of a block's rows (x [n_rows, k], one warp per row
// up to kRows): the mean (LayerNorm; 0 for RMSNorm) and rsqrt(var + eps),
// where var is the mean of (x - mean)^2.
template <typename TX>
__device__ void row_stats(const TX* x, int k, int n_rows, int norm, float eps,
                          float* s_mean, float* s_rstd) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= kRows) return;
  float mean = 0.f, rstd = 0.f;
  if (warp < n_rows) {
    const TX* xr = x + static_cast<int64_t>(warp) * k;
    if (norm == kLayerNorm) {
      float s = 0.f;
      for (int h = lane; h < k; h += kWarp) s += to_float(xr[h]);
      mean = warp_sum(s) / k;
    }
    float v = 0.f;
    for (int h = lane; h < k; h += kWarp) {
      const float d = to_float(xr[h]) - mean;
      v = fmaf(d, d, v);
    }
    rstd = rsqrtf(warp_sum(v) / k + eps);
  }
  if (lane == 0) {
    s_mean[warp] = mean;
    s_rstd[warp] = rstd;
  }
}

__device__ __forceinline__ float activate(float a, int act) {
  switch (act) {
    case kSilu: return a / (1.f + expf(-a));
    case kGeluTanh:
      return 0.5f * a * (1.f + tanhf(0.7978845608028654f *
                                     (a + 0.044715f * a * a * a)));
    case kGelu: return 0.5f * a * (1.f + erff(a * 0.7071067811865476f));
    default: return a;
  }
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ GemvArgs args) {
  __shared__ __align__(16) float xs[kChunk * kRows];   // [kChunk][kRows]
  __shared__ float red[kSplit * 2 * kRows * kWarp];
  __shared__ float s_mean[kRows], s_rstd[kRows];
  __shared__ int s_last;

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, args.batch - row0);
  const int64_t x0 = static_cast<int64_t>(row0) * args.k;
  const TX* x = static_cast<const TX*>(args.x) + x0;

  // which problem and which 32 column pairs this block owns
  int prob = 0, tile = blockIdx.x;
  while (prob + 1 < args.n_problems && tile >= args.p[prob].tiles) {
    tile -= args.p[prob].tiles;
    ++prob;
  }
  const Problem& P = args.p[prob];
  const TW* w = static_cast<const TW*>(P.w);
  const int pair = tile * kWarp + lane;
  const bool ok = pair < (P.n + 1) / 2;   // an odd n ends on a half pair
  const bool neox_pair = P.rope && args.neox;
  int c0, c1;
  if (neox_pair) {
    const int half = args.head_dim / 2;
    c0 = (pair / half) * args.head_dim + pair % half;
    c1 = c0 + half;
  } else {
    c0 = 2 * pair;
    c1 = c0 + 1;
  }
  const bool ok0 = ok && c0 < P.n;
  const bool ok1 = ok && c1 < P.n;
  const bool vec = !neox_pair && ok1 && P.ldw % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (2 * sizeof(TW)) == 0;

  if (args.norm != kNoNorm)
    row_stats(x, args.k, n_rows, args.norm, args.eps, s_mean, s_rstd);

  // this block's share of K
  const int k_len = ((args.k + args.k_splits * kChunk - 1) /
                     (args.k_splits * kChunk)) * kChunk;
  const int k_begin = blockIdx.z * k_len;
  const int k_end = min(args.k, k_begin + k_len);

  float acc[2][kRows];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[c][b] = 0.f;

  for (int h0 = k_begin; h0 < k_end; h0 += kChunk) {
    __syncthreads();   // the statistics are in; the last chunk is consumed
    for (int i = threadIdx.x; i < kChunk * kRows; i += kThreads) {
      const int b = i / kChunk, hh = i % kChunk, h = h0 + hh;
      float v = 0.f;
      if (b < n_rows && h < k_end) {
        const int64_t at = static_cast<int64_t>(b) * args.k + h;
        v = to_float(x[at]);
        if (args.norm != kNoNorm) {
          v = (v - s_mean[b]) * s_rstd[b] * args.nw[h];
          if (args.nb != nullptr) v += args.nb[h];
        }
        if (args.gate != nullptr) v = activate(args.gate[x0 + at], args.gate_act) * v;
      }
      xs[hh * kRows + b] = v;
    }
    __syncthreads();
    float wv[kPerWarp][2];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int h = h0 + warp + j * kSplit;
      float2 pr = make_float2(0.f, 0.f);
      if (h < k_end) {
        const TW* row = w + h * P.ldw;
        if (vec) {
          pr = load2(row + c0);
        } else {
          if (ok0) pr.x = to_float(row[c0]);
          if (ok1) pr.y = to_float(row[c1]);
        }
      }
      wv[j][0] = pr.x;
      wv[j][1] = pr.y;
    }
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const float* xr = xs + (warp + j * kSplit) * kRows;
      const float4 xa = *reinterpret_cast<const float4*>(xr);
      const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
      const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int b = 0; b < kRows; ++b) acc[c][b] = fmaf(xv[b], wv[j][c], acc[c][b]);
    }
  }

  // the warps' sums meet: thread (b, lane) takes row b of its lane's pair
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      red[((warp * 2 + c) * kRows + b) * kWarp + lane] = acc[c][b];
  __syncthreads();
  const int b = warp;
  float s[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float t = 0.f;
    for (int v = 0; v < kSplit; ++v) t += red[((v * 2 + c) * kRows + b) * kWarp + lane];
    s[c] = t;
  }

  if (args.k_splits > 1) {
    // split K: publish this block's sums; the tile's last block adds them
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = args.partial + static_cast<int64_t>(tile_id) * args.k_splits * 2 * kThreads;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      __stcg(part + (static_cast<int64_t>(blockIdx.z) * 2 + c) * kThreads + threadIdx.x,
             s[c]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(args.counters + tile_id, 1) == args.k_splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float t = 0.f;
      for (int z = 0; z < args.k_splits; ++z)
        t += __ldcg(part + (static_cast<int64_t>(z) * 2 + c) * kThreads + threadIdx.x);
      s[c] = t;
    }
    if (threadIdx.x == 0) args.counters[tile_id] = 0;
  }

  if (b >= n_rows || !ok0) return;
  float o0 = s[0], o1 = s[1];
  if (P.bias != nullptr) {
    if (args.bias_after_round) {
      o0 = to_float(from_float<TO>(o0));
      o1 = to_float(from_float<TO>(o1));
    }
    o0 += P.bias[c0];
    if (ok1) o1 += P.bias[c1];
  }
  o0 = activate(o0, args.act);
  o1 = activate(o1, args.act);
  if (P.rope) {
    const int d0 = c0 % args.head_dim, d1 = c1 % args.head_dim;
    const float r0 = o0 * args.cos_row[d0] - o1 * args.sin_row[d0];
    const float r1 = o1 * args.cos_row[d1] + o0 * args.sin_row[d1];
    o0 = r0;
    o1 = r1;
  }
  TO* out = static_cast<TO*>(P.out) + static_cast<int64_t>(row0 + b) * P.n;
  out[c0] = from_float<TO>(o0);
  if (ok1) out[c1] = from_float<TO>(o1);
}

template <typename TX, typename TW, typename TO>
int launch_gemv(const GemvArgs& args, int y_tiles, cudaStream_t stream) {
  int tiles = 0;
  for (int i = 0; i < args.n_problems; ++i) tiles += args.p[i].tiles;
  const dim3 grid(tiles, y_tiles, args.k_splits);
  gemv_kernel<TX, TW, TO><<<grid, kThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int pair_tiles(int n) { return (n / 2 + (n % 2) + kWarp - 1) / kWarp; }

Problem problem(const void* w, long long ldw, const void* bias, void* out, int n,
                int rope) {
  Problem p{};
  p.w = w;
  p.ldw = ldw;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.n = n;
  p.tiles = pair_tiles(n);
  p.rope = rope;
  return p;
}

// ---------------------------------------------------------------------------
// K6d: norm + matmul against a transposed weight
// ---------------------------------------------------------------------------

constexpr int kTChunk = 1024;               // columns of x staged per step
constexpr int kTCols = 4;                   // output columns per warp
constexpr int kTBlockCols = kSplit * kTCols;   // 32 per block

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// out[b, c] = round(sum_h norm(x)[b, h] * w[c * ldw + h]) (+ bias[c]) for
// the kRows rows of blockIdx.y and the 32 columns of blockIdx.x; `vec`: every
// weight row starts 16-byte aligned and k is a multiple of V.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_matmul_t_kernel(const T* __restrict__ x, int batch, int k,
                     const float* __restrict__ nw, const float* __restrict__ nb,
                     int norm, float eps, const T* __restrict__ w, long long ldw,
                     int n, const float* __restrict__ bias, T* __restrict__ out,
                     int vec) {
  constexpr int V = 16 / sizeof(T);         // elements per 16-byte load
  __shared__ __align__(16) float xs[kRows * kTChunk];   // [kRows][kTChunk]
  __shared__ float s_mean[kRows], s_rstd[kRows];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, batch - row0);
  const T* xb = x + static_cast<int64_t>(row0) * k;
  row_stats(xb, k, n_rows, norm, eps, s_mean, s_rstd);
  const int col0 = blockIdx.x * kTBlockCols + warp * kTCols;

  float acc[kTCols][kRows];
#pragma unroll
  for (int c = 0; c < kTCols; ++c)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[c][b] = 0.f;

  for (int h0 = 0; h0 < k; h0 += kTChunk) {
    const int len = min(kTChunk, k - h0);
    __syncthreads();   // the statistics are in; the last chunk is consumed
    for (int i = threadIdx.x; i < kRows * kTChunk; i += kThreads) {
      const int b = i / kTChunk, hh = i % kTChunk;
      float v = 0.f;
      if (b < n_rows && hh < len) {
        const int h = h0 + hh;
        v = (to_float(xb[static_cast<int64_t>(b) * k + h]) - s_mean[b]) *
            s_rstd[b] * nw[h];
        if (nb != nullptr) v += nb[h];
      }
      xs[i] = v;
    }
    __syncthreads();
    for (int hh = lane * V; hh < len; hh += kWarp * V) {
      float wv[kTCols][V];
#pragma unroll
      for (int c = 0; c < kTCols; ++c) {
        const int col = col0 + c;
        const T* wr = w + static_cast<int64_t>(col) * ldw + h0 + hh;
        if (col < n && vec) {
          load_vec(wr, wv[c]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            wv[c][e] = (col < n && hh + e < len) ? to_float(wr[e]) : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        float xv[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xs + b * kTChunk + hh + e);
          xv[e] = a.x; xv[e + 1] = a.y; xv[e + 2] = a.z; xv[e + 3] = a.w;
        }
#pragma unroll
        for (int c = 0; c < kTCols; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[c][b] = fmaf(xv[e], wv[c][e], acc[c][b]);
      }
    }
  }

  // the lanes' sums meet; lane c * kRows + b writes (b, col0 + c)
#pragma unroll
  for (int c = 0; c < kTCols; ++c)
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float t = warp_sum(acc[c][b]);
      if (lane == c * kRows + b && b < n_rows && col0 + c < n) {
        float o = to_float(from_float<T>(t));
        if (bias != nullptr) o += bias[col0 + c];
        out[static_cast<int64_t>(row0 + b) * n + col0 + c] = from_float<T>(o);
      }
    }
}

// ---------------------------------------------------------------------------
// K6b: cache append + decode attention
// ---------------------------------------------------------------------------

constexpr int kAttnWarps = 8;
constexpr int kUnroll = 4;   // positions per warp per step

template <typename T, int PL, int MAXREP>
__global__ void __launch_bounds__(kAttnWarps * kWarp)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
              const T* __restrict__ v_new, T* __restrict__ k_cache,
              T* __restrict__ v_cache, T* __restrict__ ctx, int n_heads,
              int n_kv, int head_dim, int s_total, int pos, float scale) {
  extern __shared__ float smem[];   // [warps][n_rep][head_dim + 2]
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = n_heads / n_kv;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  const int64_t kv_row = static_cast<int64_t>(n_kv) * head_dim;   // one position
  const int64_t cache0 = static_cast<int64_t>(b) * s_total * kv_row +
                         static_cast<int64_t>(g) * head_dim;
  const int64_t new0 = (static_cast<int64_t>(b) * n_kv + g) * head_dim;

  float qr[MAXREP][PL], kn[PL], vn[PL];
#pragma unroll
  for (int e = 0; e < PL; ++e) {
    const int d = lane + e * kWarp;
    const bool in = d < head_dim;
    kn[e] = in ? to_float(k_new[new0 + d]) : 0.f;
    vn[e] = in ? to_float(v_new[new0 + d]) : 0.f;
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      qr[r][e] = (in && r < n_rep)
                     ? to_float(q[(static_cast<int64_t>(b) * n_heads + g * n_rep + r) *
                                      head_dim + d])
                     : 0.f;
  }
  if (warp == 0) {
    // the append: row `pos` of this (batch, kv head); no block reads it
    const int64_t at = cache0 + static_cast<int64_t>(pos) * kv_row;
#pragma unroll
    for (int e = 0; e < PL; ++e) {
      const int d = lane + e * kWarp;
      if (d < head_dim) {
        k_cache[at + d] = k_new[new0 + d];
        v_cache[at + d] = v_new[new0 + d];
      }
    }
  }

  float m[MAXREP], l[MAXREP], acc[MAXREP][PL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < PL; ++e) acc[r][e] = 0.f;
  }

  // positions 0..pos: warp w takes t = w, w + 8, ...; `pos` itself from
  // registers
  for (int t0 = warp * kUnroll; t0 <= pos; t0 += kAttnWarps * kUnroll) {
    float kt[kUnroll][PL], vt[kUnroll][PL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const int64_t at = cache0 + static_cast<int64_t>(t) * kv_row;
#pragma unroll
      for (int e = 0; e < PL; ++e) {
        const int d = lane + e * kWarp;
        if (t == pos) {
          kt[u][e] = kn[e];
          vt[u][e] = vn[e];
        } else if (t < pos && d < head_dim) {
          kt[u][e] = to_float(k_cache[at + d]);
          vt[u][e] = to_float(v_cache[at + d]);
        } else {
          kt[u][e] = 0.f;
          vt[u][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= n_rep) break;
      float sc[kUnroll];
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PL; ++e) dot = fmaf(qr[r][e], kt[u][e], dot);
        sc[u] = warp_sum(dot) * scale;
        if (t0 + u <= pos) m_new = fmaxf(m_new, sc[u]);
      }
      const float alpha = expf(m[r] - m_new);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = t0 + u <= pos ? expf(sc[u] - m_new) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int e = 0; e < PL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vt[u][e], a);
        acc[r][e] = a;
      }
      m[r] = m_new;
    }
  }

  // merge the warps' online-softmax states
  const int stride = head_dim + 2;
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= n_rep) break;
    float* st = smem + (warp * n_rep + r) * stride;
#pragma unroll
    for (int e = 0; e < PL; ++e) {
      const int d = lane + e * kWarp;
      if (d < head_dim) st[d] = acc[r][e];
    }
    if (lane == 0) {
      st[head_dim] = m[r];
      st[head_dim + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * head_dim; i += blockDim.x) {
    const int r = i / head_dim, d = i % head_dim;
    float mx = kMaskValue;
    for (int w = 0; w < kAttnWarps; ++w)
      mx = fmaxf(mx, smem[(w * n_rep + r) * stride + head_dim]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) {
      const float* st = smem + (w * n_rep + r) * stride;
      const float f = expf(st[head_dim] - mx);
      den = fmaf(st[head_dim + 1], f, den);
      num = fmaf(st[d], f, num);
    }
    ctx[(static_cast<int64_t>(b) * n_heads + g * n_rep + r) * head_dim + d] =
        from_float<T>(num / den);
  }
}

template <typename T, int PL, int MAXREP>
int launch_attend(const void* q, const void* k_new, const void* v_new,
                  void* k_cache, void* v_cache, void* ctx, int batch,
                  int n_heads, int n_kv, int head_dim, int s_total, int pos,
                  float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kAttnWarps) * (n_heads / n_kv) *
                      (head_dim + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attend_kernel<T, PL, MAXREP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attend_kernel<T, PL, MAXREP><<<dim3(n_kv, batch), kAttnWarps * kWarp, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<T*>(ctx), n_heads, n_kv, head_dim,
      s_total, pos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PL>
int attend_rep(int n_rep, const void* q, const void* k_new, const void* v_new,
               void* k_cache, void* v_cache, void* ctx, int batch, int n_heads,
               int n_kv, int head_dim, int s_total, int pos, float scale,
               cudaStream_t s) {
  if (n_rep == 1)
    return launch_attend<T, PL, 1>(q, k_new, v_new, k_cache, v_cache, ctx, batch,
                                   n_heads, n_kv, head_dim, s_total, pos, scale, s);
  if (n_rep <= 4)
    return launch_attend<T, PL, 4>(q, k_new, v_new, k_cache, v_cache, ctx, batch,
                                   n_heads, n_kv, head_dim, s_total, pos, scale, s);
  return launch_attend<T, PL, 8>(q, k_new, v_new, k_cache, v_cache, ctx, batch,
                                 n_heads, n_kv, head_dim, s_total, pos, scale, s);
}

template <typename T>
int attend_dispatch(const void* q, const void* k_new, const void* v_new,
                    void* k_cache, void* v_cache, void* ctx, int batch,
                    int n_heads, int n_kv, int head_dim, int s_total, int pos,
                    float scale, cudaStream_t s) {
  const int n_rep = n_heads / n_kv;
  if (head_dim <= 64)
    return attend_rep<T, 2>(n_rep, q, k_new, v_new, k_cache, v_cache, ctx, batch,
                            n_heads, n_kv, head_dim, s_total, pos, scale, s);
  if (head_dim <= 128)
    return attend_rep<T, 4>(n_rep, q, k_new, v_new, k_cache, v_cache, ctx, batch,
                            n_heads, n_kv, head_dim, s_total, pos, scale, s);
  return attend_rep<T, 8>(n_rep, q, k_new, v_new, k_cache, v_cache, ctx, batch,
                          n_heads, n_kv, head_dim, s_total, pos, scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each entry returns
// cudaGetLastError() after its launches (0 on success); the launches are
// asynchronous on `stream`.  Bias, norm and rope vectors are fp32.

// K6a.  x [batch, hidden]; wq [hidden, nq], wk/wv [hidden, nk] with row
// strides ldq/ldk/ldv; q [batch, nq], k/v [batch, nk] contiguous.
extern "C" int fd_rope_qkv(const void* x, int batch, int hidden,
                           const void* wq, const void* wk, const void* wv,
                           long long ldq, long long ldk, long long ldv,
                           const void* bq, const void* bk, const void* bv,
                           const void* cos_row, const void* sin_row, int neox,
                           void* q, void* k, void* v, int nq, int nk,
                           int head_dim, void* partial, void* counters,
                           int k_splits, int dtype, void* stream) {
  if (batch <= 0 || head_dim <= 0 || head_dim % 2 != 0 || k_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  GemvArgs a{};
  a.x = x;
  a.batch = batch;
  a.k = hidden;
  a.norm = kNoNorm;
  a.cos_row = static_cast<const float*>(cos_row);
  a.sin_row = static_cast<const float*>(sin_row);
  a.neox = neox;
  a.head_dim = head_dim;
  a.act = kNoAct;
  a.n_problems = 3;
  const int rope = cos_row != nullptr;
  a.p[0] = problem(wq, ldq, bq, q, nq, rope);
  a.p[1] = problem(wk, ldk, bk, k, nk, rope);
  a.p[2] = problem(wv, ldv, bv, v, nk, 0);
  a.k_splits = k_splits;
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  const int y_tiles = (batch + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemv<float, float, float>(a, y_tiles, s);
  if (dtype == 1)
    return launch_gemv<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a, y_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6b.  q [batch, n_heads, head_dim]; k_new/v_new [batch, n_kv, head_dim];
// caches [batch, s_total, n_kv, head_dim], updated in place at `pos`;
// ctx [batch, n_heads, head_dim].  All contiguous, one dtype.
extern "C" int fd_attend(const void* q, const void* k_new, const void* v_new,
                         void* k_cache, void* v_cache, void* ctx, int batch,
                         int n_heads, int n_kv, int head_dim, int s_total,
                         int pos, float scale, int dtype, void* stream) {
  if (batch <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > 8 ||
      head_dim <= 0 || head_dim > 8 * kWarp || pos < 0 || pos >= s_total)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attend_dispatch<float>(q, k_new, v_new, k_cache, v_cache, ctx, batch,
                                  n_heads, n_kv, head_dim, s_total, pos, scale, s);
  if (dtype == 1)
    return attend_dispatch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, ctx,
                                          batch, n_heads, n_kv, head_dim, s_total,
                                          pos, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6c.  x [batch, hidden]; norm: 1 layer_norm (nw, nb), 2 rms_norm (nw);
// w1 [hidden, inter] (up) with b1 [inter] or nullptr; wg [hidden, inter]
// (gate) or nullptr; act as enum Act: gelu on the up output without a
// gate, act(gate) * up with one; w2 [inter, out_dim], b2 or nullptr;
// scratch fp32 [batch, inter] (two of them with a gate: up, then gate);
// y [batch, out_dim] contiguous.  Two launches: the norm and the up (and
// gate) products into scratch, then the down product of the activation
// (made on the way in) + bias into y.
extern "C" int fd_norm_mlp(const void* x, int batch, int hidden,
                           const void* nw, const void* nb, int norm, float eps,
                           const void* w1, long long ld1, const void* wg,
                           long long ldg, const void* b1, int act,
                           const void* w2, long long ld2, const void* b2,
                           void* scratch, void* y, int inter, int out_dim,
                           void* partial, void* counters, int splits_up,
                           int splits_down, int dtype, void* stream) {
  if (batch <= 0 || (norm != kLayerNorm && norm != kRmsNorm) ||
      splits_up < 1 || splits_down < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const int y_tiles = (batch + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* up_out = static_cast<float*>(scratch);
  float* gate_out = up_out + static_cast<int64_t>(batch) * inter;

  GemvArgs up{};
  up.x = x;
  up.batch = batch;
  up.k = hidden;
  up.norm = norm;
  up.nw = static_cast<const float*>(nw);
  up.nb = static_cast<const float*>(nb);
  up.eps = eps;
  up.act = wg != nullptr ? kNoAct : act;
  up.n_problems = wg != nullptr ? 2 : 1;
  up.p[0] = problem(w1, ld1, b1, up_out, inter, 0);
  if (wg != nullptr) up.p[1] = problem(wg, ldg, nullptr, gate_out, inter, 0);
  up.head_dim = 2;
  up.k_splits = splits_up;
  up.partial = static_cast<float*>(partial);
  up.counters = static_cast<int*>(counters);
  const int rc = dtype == 0
                     ? launch_gemv<float, float, float>(up, y_tiles, s)
                     : launch_gemv<__nv_bfloat16, __nv_bfloat16, float>(up, y_tiles, s);
  if (rc != 0) return rc;

  GemvArgs down{};
  down.x = up_out;
  down.batch = batch;
  down.k = inter;
  down.norm = kNoNorm;
  down.gate = wg != nullptr ? gate_out : nullptr;
  down.gate_act = act;
  down.act = kNoAct;
  down.n_problems = 1;
  down.p[0] = problem(w2, ld2, b2, y, out_dim, 0);
  down.head_dim = 2;
  down.k_splits = splits_down;
  down.partial = static_cast<float*>(partial);
  down.counters = static_cast<int*>(counters);
  if (dtype == 0) return launch_gemv<float, float, float>(down, y_tiles, s);
  return launch_gemv<float, __nv_bfloat16, __nv_bfloat16>(down, y_tiles, s);
}

// K6d.  x [batch, hidden] contiguous; norm: 1 layer_norm (nw, nb or
// nullptr), 2 rms_norm (nw); w: row-major [hidden, n] with row stride ldw
// (transposed = 0), or the transpose of a row-major [n, hidden] with row
// stride ldw (transposed = 1); bias [n] fp32 or nullptr, added to the
// rounded result; y [batch, n] contiguous.  partial/counters/k_splits as
// for K6a (row-major weights only).
extern "C" int fd_norm_matmul(const void* x, int batch, int hidden,
                              const void* nw, const void* nb, int norm,
                              float eps, const void* w, long long ldw,
                              int transposed, const void* bias, void* y, int n,
                              void* partial, void* counters, int k_splits,
                              int dtype, void* stream) {
  if (batch <= 0 || hidden <= 0 || n <= 0 ||
      (norm != kLayerNorm && norm != kRmsNorm) || k_splits < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const int y_tiles = (batch + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) {
    const int v = dtype == 0 ? 4 : 8;
    const int vec = ldw % v == 0 && hidden % v == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid((n + kTBlockCols - 1) / kTBlockCols, y_tiles);
    if (dtype == 0)
      norm_matmul_t_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), batch, hidden,
          static_cast<const float*>(nw), static_cast<const float*>(nb), norm,
          eps, static_cast<const float*>(w), ldw, n,
          static_cast<const float*>(bias), static_cast<float*>(y), vec);
    else
      norm_matmul_t_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), batch, hidden,
          static_cast<const float*>(nw), static_cast<const float*>(nb), norm,
          eps, static_cast<const __nv_bfloat16*>(w), ldw, n,
          static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), vec);
    return static_cast<int>(cudaGetLastError());
  }
  GemvArgs a{};
  a.x = x;
  a.batch = batch;
  a.k = hidden;
  a.norm = norm;
  a.nw = static_cast<const float*>(nw);
  a.nb = static_cast<const float*>(nb);
  a.eps = eps;
  a.act = kNoAct;
  a.bias_after_round = 1;
  a.n_problems = 1;
  a.p[0] = problem(w, ldw, bias, y, n, 0);
  a.head_dim = 2;
  a.k_splits = k_splits;
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  if (dtype == 0) return launch_gemv<float, float, float>(a, y_tiles, s);
  return launch_gemv<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a, y_tiles, s);
}
