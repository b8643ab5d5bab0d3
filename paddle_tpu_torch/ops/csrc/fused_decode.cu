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
// K6a, K6c and K6d take two routes, chosen by shape alone (`fd_qkv_route`,
// `fd_route`): a generic GEMV for any shape, and a stream form for the main
// path's (below).  The generic GEMV (`gemv_kernel`) takes a few rows of
// x [B, K] against row-major weights [K, N] (any row stride, so GPT's
// q/k/v are read as column slices of the packed [H, 3H] projection):
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
//
// On the generic route K6a is one launch of the GEMV above (its three
// problems, the rope in the epilogue), K6c two launches of it (the norm on
// the way in and the up (and gate)
// products into an fp32 scratch [B, I], then the down product of the
// activation, made on the way in, + bias), K6d as one (a row-major weight,
// the bias added after the result is rounded to x's dtype, as the JAX
// wrapper adds it outside the Pallas kernel) or, for a transposed weight
// (the heads arrive as w.T of a row-major [N, H]), `norm_matmul_t_kernel`:
// a warp owns 4 output columns and reads each one's weight row of H
// contiguously against the normalized rows staged 1024 columns at a time.
// It takes the shapes the stream route does not (odd N or K, unaligned
// views, K6a beyond 8 rows).
//
// The stream route takes the main path's shapes: a persistent walk that
// reads each weight byte once per launch, at any of the gate's 1..64 rows
// (K6a: 1..8, its own kernel `qkv_stream_kernel`, described at it).
//   * The grid is the blocks the card holds at once (the SM count times
//     the blocks an SM holds of the form the launch takes).  The weight's
//     (column tile, K step) units are dealt out in tile-major order as in
//     stream-K: block j takes q + (j < r) consecutive units, so shares
//     differ by at most one step.  The wrapper computes the plan.
//   * A unit is 32 rows of 512 bytes of weight: for a row-major [K, N]
//     weight 32 rows of K by 512 bytes of columns, for a transposed one 32
//     output columns by 512 bytes of K.
//   * A tile a block holds whole is written with its epilogue.  A tile cut
//     by a share boundary: each block publishes its fp32 part; the last to
//     arrive (an atomic counter per tile, reset by it) adds the parts in
//     block order, so the result does not depend on which block came last
//     and a relaunch is bitwise equal.  (Waiting for the owner of the
//     tile's last step instead would stall that block for its
//     neighbour's whole share.)
// Two forms, chosen by shape alone:
//   * resident (`stream_resident_kernel`, up to 8 rows: the main path):
//     each block first makes the normalized fp32 rows of x (or act(gate) *
//     up) for every K step its share touches and keeps them in shared
//     memory for the whole launch; then each lane streams its own 4 x 16
//     bytes of every unit through a ring of up to 8 stages with cp.async
//     and reads back only what it copied, so the main loop has no barrier
//     and divides nothing (cursors walk the tiles and steps).  Row-major:
//     warp w takes the unit's K rows 4w..4w+3, a lane 16 bytes of
//     columns, and the warps' sums meet in a fixed tree at a tile's end;
//     transposed: warp w takes the unit's columns 4w..4w+3, a lane 16
//     bytes of K, and the lanes' sums meet by a butterfly.  Two blocks an
//     SM where their windows fit, else one.
//   * staged (`stream_gemv_kernel`, 9..64 rows): x's rows for each step
//     ride in the ring beside the weight and are normalized per step from
//     statistics the block computes once; the row groups of 8 walk each
//     stage in shared memory, the warps splitting the rows, then the K.
// K6c stays two launches of it (up and gate, then down); `fd_route` says
// which route a product takes.  A/B on the card (`chip_smoke.py --ab`,
// PERF.md): a shared ring filled by all threads with two barriers a step
// was issue-bound; bulk copies (cp.async.bulk, a producer warp, mbarriers)
// of 512-byte rows were slower still.
//
// K6b: one block per (kv head, batch row) owns the n_rep query rows of that
// kv head.  It uses the new k/v row from registers at `pos` and writes it to
// the caches (in place: the wrapper returns the same tensors), then its 8
// warps walk positions 0..pos - 1 interleaved, 4 positions per step, each
// warp keeping an online softmax per query row; the warps' states are merged
// in shared memory.  Only rows 0..pos are read, not the S_total rows the
// TPU kernel masks: masked probabilities are exactly 0 there.
//
// Tensor cores, TMA bulk copies and a split over positions across blocks
// for long contexts at small batch are later work.

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

// Four consecutive elements into fp32 (16 or 8 bytes, aligned to that).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
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

// ---------------------------------------------------------------------------
// K6c and K6d on the main path: the persistent weight-streaming GEMV
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / kWarp;   // 8
constexpr int kSegBytes = 512;        // one stage row: 32 lanes x 16 bytes
constexpr int kStageRows = 32;        // rows of a stage
constexpr int kTransPad = 16;         // pad of a transposed stage row (banks)
constexpr int kStreamMaxRows = 64;    // rows of x (the gate's limit)
constexpr int kMaxStages = 4;
constexpr int kResRows = 8;           // the resident form's rows (the main path)
constexpr int kResMaxStages = 8;
constexpr int kSmemBudget = 227 * 1024;   // dynamic shared memory a block may use

// A tile is kTN output columns, a step kKS of the reduction axis.  Row-major
// [K, N]: a stage row is kKS-th of a tile's K (32 rows) and 512 bytes of its
// columns, a lane owns kVec adjacent columns.  Transposed (w.T of a row-major
// [N, K]): a stage row is one output column's 512 contiguous bytes of K, a
// lane owns one column.  Either way a stage is 32 x 512 bytes of weight.
template <typename TW, bool kTrans>
struct Geo {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TW));
  static constexpr int kTN = kTrans ? kStageRows : kWarp * kVec;
  static constexpr int kKS = kTrans ? kSegBytes / static_cast<int>(sizeof(TW)) : kStageRows;
  static constexpr int kRowBytes = kTrans ? kSegBytes + kTransPad : kSegBytes;
  static constexpr int kStage = kStageRows * kRowBytes;
  static constexpr int kAcc = kTrans ? 8 : kVec * 8;   // a lane's columns x 8 rows
};

struct StreamProblem {
  const void* w;
  long long ldw;          // row stride, in elements
  const float* bias;      // [n] fp32, or nullptr
  void* out;              // [batch, n] contiguous, or [n][8] (out_t)
  int n;
  int tiles;              // ceil(n / kTN)
  int out_t;              // the output as [n][8]: a resident down product's x
  int rope;               // K6a: rotate the output's column pairs by cos/sin
};

struct StreamArgs {
  const void* x;          // [batch, k] contiguous (TX)
  const float* gate;      // [batch, k] fp32, or nullptr: x comes in as act(gate) * x
  int batch, k;
  int norm;               // Norm applied to x's rows on the way in
  const float* nw;
  const float* nb;
  float eps;
  int gate_act, act, bias_after_round;
  const float* cos_row;   // K6a: [head_dim] fp32 (problems with rope)
  const float* sin_row;
  int neox, head_dim;
  int n_problems;
  StreamProblem p[3];
  int ksteps;             // ceil(k / kKS)
  int q, r;               // the plan: block j takes q + (j < r) units from j q + min(j, r)
  int groups;             // row groups of 8 (1, 2, 4 or 8)
  int stages;
  int window;             // steps of x the resident form holds: min(q + (r > 0), ksteps)
  int slots;              // tiles a share touches at most: the resident row-major parts
  const float* xn_ready;  // x already normalized, fp32: [batch][k] (transposed) or
                          // [k][8] (row-major); the resident form copies its window
  float* h;               // a gated up launch: act(gate) * up, [n][8], made by the
                          // second of a column tile's up and gate tiles to finish
  float* work;            // fp32 parts: [grid][2][batch][kTN]; the resident
                          // row-major form's [grid][slots][8 warps][batch][kTN]
  int* counters;          // [tiles], zero; left zero
};

struct StreamLayout {
  int x_ring, x_stage, xn, red, stats, total;   // bytes
};

// Shared memory: the weight ring, the x ring (raw rows of each step, and the
// gate's), the step's normalized fp32 x, the warps' sums and the statistics.
template <typename TX, typename TW, bool kTrans>
__host__ __device__ inline StreamLayout stream_layout(int groups, bool gated, int stages) {
  using G = Geo<TW, kTrans>;
  const int rows = groups * 8;
  StreamLayout l;
  l.x_ring = stages * G::kStage;
  l.x_stage = rows * G::kKS * static_cast<int>(sizeof(TX)) * (gated ? 2 : 1);
  l.xn = l.x_ring + stages * l.x_stage;
  l.red = l.xn + rows * G::kKS * 4;
  l.stats = l.red + kStreamWarps * kWarp * G::kAcc * 4;
  l.total = l.stats + 2 * kStreamMaxRows * 4 + 16;
  return l;
}

// 16 bytes (0 past an edge: zeros), with a 256-byte L2 prefetch of the
// source's line (A/B: 2-4 % off K6a's times, K6c's and K6d's unmoved,
// PERF.md)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` groups are in flight (0..kResMaxStages - 1)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Programmatic dependent launch: a kernel launched with it may start while
// the one before it on the stream runs; it waits here before reading what
// that one wrote.  The one before lets it start early.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the block a unit belongs to, under the plan (q >= 1)
__device__ __forceinline__ int block_of(int u, int q, int r) {
  const int big = r * (q + 1);
  return u < big ? u / (q + 1) : r + (u - big) / q;
}
__device__ __forceinline__ int share_start(int j, int q, int r) { return j * q + min(j, r); }

template <typename TX, typename TW, typename TO, bool kTrans>
__global__ void __launch_bounds__(kStreamThreads)
stream_gemv_kernel(const __grid_constant__ StreamArgs a) {
  using G = Geo<TW, kTrans>;
  constexpr int V = G::kVec, TN = G::kTN, KS = G::kKS, ACC = G::kAcc;
  constexpr int XE = 16 / static_cast<int>(sizeof(TX));   // x elements a 16-byte piece
  constexpr int XC = KS / XE;                               // pieces a row of a step
  extern __shared__ __align__(16) unsigned char ring_smem[];
  unsigned char* smem = ring_smem;
  const bool gated = a.gate != nullptr;
  const int rows = a.groups * 8;
  const int S = a.stages;
  const StreamLayout L = stream_layout<TX, TW, kTrans>(a.groups, gated, S);
  unsigned char* w_ring = smem;
  unsigned char* x_ring = smem + L.x_ring;
  float* xn = reinterpret_cast<float*>(smem + L.xn);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* s_mean = reinterpret_cast<float*>(smem + L.stats);
  float* s_rstd = s_mean + kStreamMaxRows;
  int* s_last = reinterpret_cast<int*>(s_rstd + kStreamMaxRows);

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int j = blockIdx.x;
  const int start = share_start(j, a.q, a.r);
  const int end = start + a.q + (j < a.r ? 1 : 0);
  const int first_tile = start / a.ksteps;
  const int tiles0 = a.p[0].tiles;
  const TX* x = static_cast<const TX*>(a.x);
  // warp -> (row group, k group): the row groups' warps split each step's k
  const int kw = kStreamWarps / a.groups;
  const int rg = warp / kw, kg = warp % kw;

  // the copies of one unit (tile t, step s): 32 x 512 weight bytes and the
  // step's rows of x (and of the gate), 16 bytes a copy, 0 past the edges
  auto load_unit = [&](int u, int slot) {
    const int t = u / a.ksteps, s = u % a.ksteps;
    const int pi = (a.n_problems > 1 && t >= tiles0) ? 1 : 0;
    const StreamProblem& P = a.p[pi];
    const int n0 = (t - (pi ? tiles0 : 0)) * TN, k0 = s * KS;
    const TW* w = static_cast<const TW*>(P.w);
    unsigned char* dst = w_ring + slot * G::kStage;
    for (int c = tid; c < kStageRows * kWarp; c += kStreamThreads) {
      const int row = c / kWarp, seg = c % kWarp;
      const int n = kTrans ? n0 + row : n0 + seg * V;
      const int k = kTrans ? k0 + seg * V : k0 + row;
      const bool in = n < P.n && k < a.k;
      const TW* src = !in ? w
                      : kTrans ? w + static_cast<int64_t>(n) * P.ldw + k
                               : w + static_cast<int64_t>(k) * P.ldw + n;
      cp_async16(dst + row * G::kRowBytes + seg * 16, src, in);
    }
    unsigned char* xd = x_ring + slot * L.x_stage;
    for (int c = tid; c < rows * XC; c += kStreamThreads) {
      const int b = c / XC, piece = c % XC, k = k0 + piece * XE;
      const bool in = b < a.batch && k < a.k;
      const int64_t at = static_cast<int64_t>(b) * a.k + k;
      cp_async16(xd + c * 16, in ? x + at : x, in);
      if (gated) cp_async16(xd + (rows * XC + c) * 16, in ? a.gate + at : a.gate, in);
    }
  };

  // the first S - 1 units' copies go out before the statistics
  for (int i = 0; i < S - 1; ++i) {
    if (start + i < end) load_unit(start + i, i);
    cp_async_commit();
  }
  // the norm's statistics of every row, once per block, a warp a row, in
  // the plain version's order: the mean, then the mean of (x - mean)^2
  // (16-byte loads: the route has k % XE == 0 and x aligned)
  if (a.norm != kNoNorm) {
    const int pieces = a.k / XE;
    for (int b = warp; b < a.batch; b += kStreamWarps) {
      const TX* xr = x + static_cast<int64_t>(b) * a.k;
      float mean = 0.f;
      if (a.norm == kLayerNorm) {
        float s = 0.f;
#pragma unroll 4
        for (int i = lane; i < pieces; i += kWarp) {
          float v[XE];
          load_vec(xr + i * XE, v);
#pragma unroll
          for (int e = 0; e < XE; ++e) s += v[e];
        }
        mean = warp_sum(s) / a.k;
      }
      float var = 0.f;
#pragma unroll 4
      for (int i = lane; i < pieces; i += kWarp) {
        float v[XE];
        load_vec(xr + i * XE, v);
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          const float d = v[e] - mean;
          var = fmaf(d, d, var);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / a.k + a.eps);
      if (lane == 0) {
        s_mean[b] = mean;
        s_rstd[b] = rstd;
      }
    }
  }

  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

  for (int u = start; u < end; ++u) {
    const int i = u - start, slot = i % S;
    cp_async_wait(S - 2);   // this unit's copies have landed (this thread's)
    __syncthreads();        // everyone's; the slot of unit u - 1 is free
    if (u + S - 1 < end) load_unit(u + S - 1, (i + S - 1) % S);
    cp_async_commit();
    const int t = u / a.ksteps, s = u % a.ksteps, k0 = s * KS;

    // this step's x, normalized (or act(gate) * up) in fp32, once a block
    {
      const unsigned char* xs = x_ring + slot * L.x_stage;
      for (int e = tid; e < rows * KS; e += kStreamThreads) {
        const int b = e / KS, kk = e % KS, k = k0 + kk;
        float v = 0.f;
        if (b < a.batch && k < a.k) {
          v = to_float(reinterpret_cast<const TX*>(xs)[e]);
          if (a.norm != kNoNorm) {
            v = (v - s_mean[b]) * s_rstd[b] * a.nw[k];
            if (a.nb != nullptr) v += a.nb[k];
          } else if (gated) {
            v = activate(reinterpret_cast<const float*>(xs)[rows * KS + e], a.gate_act) * v;
          }
        }
        if constexpr (kTrans)
          xn[e] = v;                                  // [row][KS]
        else
          xn[((b >> 3) * KS + kk) * 8 + (b & 7)] = v;   // [group][KS][8]
      }
    }
    __syncthreads();

    if (rg * 8 < a.batch) {
      const unsigned char* ws = w_ring + slot * G::kStage;
      if constexpr (kTrans) {
        // lane = column; each warp of the group takes 32 / kw pieces of K
        const int per = (KS / V) / kw;
        for (int ch = kg * per; ch < (kg + 1) * per; ++ch) {
          float wv[V];
          load_vec(reinterpret_cast<const TW*>(ws + lane * G::kRowBytes + ch * 16), wv);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const float* xr = xn + (rg * 8 + b) * KS + ch * V;
            float s2 = acc[b];
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 xv = *reinterpret_cast<const float4*>(xr + e);
              s2 = fmaf(xv.x, wv[e], s2);
              s2 = fmaf(xv.y, wv[e + 1], s2);
              s2 = fmaf(xv.z, wv[e + 2], s2);
              s2 = fmaf(xv.w, wv[e + 3], s2);
            }
            acc[b] = s2;
          }
        }
      } else {
        // lane = V adjacent columns; each warp of the group takes 32 / kw rows
        const int per = KS / kw;
        for (int kk = kg * per; kk < (kg + 1) * per; ++kk) {
          float wv[V];
          load_vec(reinterpret_cast<const TW*>(ws + kk * kSegBytes + lane * 16), wv);
          const float* xr = xn + (rg * KS + kk) * 8;
          const float4 xa = *reinterpret_cast<const float4*>(xr);
          const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int c = 0; c < V; ++c)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[c * 8 + b] = fmaf(xv[b], wv[c], acc[c * 8 + b]);
        }
      }
    }

    if (s != a.ksteps - 1 && u != end - 1) continue;

    // the end of this block's part of tile t: the warps' sums meet
    {
      float* mine = red + warp * ACC * kWarp + lane;   // [warp][ACC][lane]
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        mine[e * kWarp] = acc[e];
        acc[e] = 0.f;
      }
    }
    __syncthreads();
    const int pi = (a.n_problems > 1 && t >= tiles0) ? 1 : 0;
    const StreamProblem& P = a.p[pi];
    const int n0 = (t - (pi ? tiles0 : 0)) * TN;
    const int t_first = t * a.ksteps, t_end = t_first + a.ksteps;
    const int outs = a.batch * TN;
    auto warps_sum = [&](int o) {
      const int b = o / TN, col = o % TN, g = b >> 3, bb = b & 7;
      const int ln = kTrans ? col : col / V, e = kTrans ? bb : (col % V) * 8 + bb;
      float v = 0.f;
      for (int w = 0; w < kw; ++w) v += red[((g * kw + w) * ACC + e) * kWarp + ln];
      return v;
    };
    auto epilogue = [&](int o, float v) {
      const int b = o / TN, n = n0 + o % TN;
      if (n >= P.n) return;
      if (P.bias != nullptr) {
        if (a.bias_after_round) v = to_float(from_float<TO>(v));
        v += P.bias[n];
      }
      v = activate(v, a.act);
      static_cast<TO*>(P.out)[static_cast<int64_t>(b) * P.n + n] = from_float<TO>(v);
    };
    if (start <= t_first && end >= t_end) {   // the whole tile is this block's
      for (int o = tid; o < outs; o += kStreamThreads) epilogue(o, warps_sum(o));
      continue;
    }
    // a tile cut by a share boundary: publish this block's part (slot 0 for
    // its first tile, 1 for its last); the last block to arrive adds every
    // part in block order, so the sum does not depend on who arrived last
    float* part = a.work + static_cast<int64_t>(j * 2 + (t == first_tile ? 0 : 1)) * outs;
    for (int o = tid; o < outs; o += kStreamThreads) __stcg(part + o, warps_sum(o));
    __threadfence();
    __syncthreads();
    const int jlo = block_of(t_first, a.q, a.r), jhi = block_of(t_end - 1, a.q, a.r);
    if (tid == 0) *s_last = atomicAdd(a.counters + t, 1) == jhi - jlo;
    __syncthreads();
    if (!*s_last) continue;
    __threadfence();
    for (int o = tid; o < outs; o += kStreamThreads) {
      float v = 0.f;
      for (int jj = jlo; jj <= jhi; ++jj) {
        const int sl = share_start(jj, a.q, a.r) / a.ksteps == t ? 0 : 1;
        v += __ldcg(a.work + static_cast<int64_t>(jj * 2 + sl) * outs + o);
      }
      epilogue(o, v);
    }
    if (tid == 0) a.counters[t] = 0;
  }
  cp_async_wait(0);
}

// The resident form (rows <= 8, the main path).  x's rows, made once
// beforehand in fp32, stay in shared memory for every step a block's share
// touches (`window` steps, copied in beside the first weight stages), and
// the weight ring is lane-private: each lane copies 4 x 16 bytes of a unit
// and reads back only what it copied, so the main loop has no barrier and
// each warp runs ahead on its own.  Transposed: warp w takes the unit's
// columns 4w..4w+3, a lane 16 bytes of K, and the lanes' sums meet by a
// butterfly at a tile's end.  Row-major: warp w takes the unit's K rows
// 4w..4w+3, a lane 16 bytes of columns; at a tile's end each warp leaves
// its sums in the work buffer, and once the block's copies have drained
// it adds them in warp order (`publish`).
template <typename TW, bool kTrans>
struct ResGeo {
  static constexpr int kAcc = kTrans ? 4 * kResRows : Geo<TW, kTrans>::kVec * kResRows;
};

template <typename TW, bool kTrans>
__host__ __device__ inline StreamLayout resident_layout(int window, int stages) {
  using G = Geo<TW, kTrans>;
  StreamLayout l;
  l.x_ring = 0;
  l.x_stage = 0;
  l.xn = stages * kStageRows * kSegBytes;
  l.red = l.xn + kResRows * window * G::kKS * 4;
  l.stats = l.red;             // s_last
  l.total = l.stats + 16;
  return l;
}

// The resident form's stages (3..kResMaxStages) where it takes the launch
// at `per_sm` blocks an SM, else 0 (more rows, or a window too wide).
constexpr int kSmemPerSm = 228 * 1024;   // an SM's shared memory, 1 KiB a block reserved
// The stages of a ring beside `fixed` bytes of a block at `per_sm` blocks
// an SM, or 0.
int ring_stages(int fixed, int per_sm) {
  const int budget = min(kSmemBudget, kSmemPerSm / per_sm - 1024);
  const int s = (budget - fixed) / (kStageRows * kSegBytes);
  // two blocks an SM only where each keeps a deep ring (A/B: a 3-stage
  // ring at two blocks waits on memory, PERF.md)
  return s < (per_sm > 1 ? 6 : 3) ? 0 : s > kResMaxStages ? kResMaxStages : s;
}
template <typename TW, bool kTrans>
int resident_stages(int batch, int window, int per_sm) {
  if (batch > kResRows) return 0;
  return ring_stages(resident_layout<TW, kTrans>(window, 0).total, per_sm);
}

template <typename TX, typename TW, typename TO, bool kTrans>
__global__ void __launch_bounds__(kStreamThreads)
stream_resident_kernel(const __grid_constant__ StreamArgs a) {
  using G = Geo<TW, kTrans>;
  constexpr int V = G::kVec, TN = G::kTN, KS = G::kKS;
  constexpr int ACC = ResGeo<TW, kTrans>::kAcc;
  extern __shared__ __align__(16) unsigned char res_smem[];
  const int S = a.stages, win = a.window;
  const StreamLayout L = resident_layout<TW, kTrans>(win, S);
  unsigned char* ring = res_smem;
  float* xn = reinterpret_cast<float*>(res_smem + L.xn);
  int* s_last = reinterpret_cast<int*>(res_smem + L.stats);

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int j = blockIdx.x;
  const int start = share_start(j, a.q, a.r);
  const int end = start + a.q + (j < a.r ? 1 : 0);
  const int first_tile = start / a.ksteps;
  const int s_first = start % a.ksteps;
  const int tiles0 = a.p[0].tiles;
  // the copies: a cursor over this block's units (the next to copy: its
  // tile and step) and this lane's 4 source rows at that step, advanced
  // by a step's stride, so the loop divides nothing
  int lu = start, lt = first_tile, ls = s_first, lslot = 0;
  const TW* lp[4];
  bool ln_in[4];
  const TW* lbase = nullptr;
  int64_t lstep = 0;
  auto set_tile = [&]() {
    const int pi = (a.n_problems > 1 && lt >= tiles0) ? 1 : 0;
    const StreamProblem& P = a.p[pi];
    const int n0 = (lt - (pi ? tiles0 : 0)) * TN;
    lbase = static_cast<const TW*>(P.w);
    lstep = kTrans ? KS : static_cast<int64_t>(KS) * P.ldw;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = kTrans ? n0 + warp * 4 + r : n0 + lane * V;
      const int k = kTrans ? ls * KS + lane * V : ls * KS + warp * 4 + r;
      ln_in[r] = n < P.n;
      lp[r] = lbase + (kTrans ? static_cast<int64_t>(n) * P.ldw + k
                              : static_cast<int64_t>(k) * P.ldw + n);
    }
  };
  // this lane's 4 x 16 bytes of the cursor's unit into its own place in
  // slot lslot; then the cursor moves on
  auto issue = [&]() {
    unsigned char* dst = ring + lslot * (kStageRows * kSegBytes) + warp * 4 * kSegBytes + lane * 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kTrans ? ls * KS + lane * V : ls * KS + warp * 4 + r;
      const bool in = ln_in[r] && k < a.k;
      cp_async16(dst + r * kSegBytes, in ? lp[r] : lbase, in);
      lp[r] += lstep;
    }
    ++lu;
    if (++lslot == S) lslot = 0;
    if (++ls == a.ksteps) {
      ls = 0;
      ++lt;
      if (lu < end) set_tile();
    }
  };
  set_tile();
  for (int i = 0; i < S - 1; ++i) {
    if (lu < end) issue();
    else if (++lslot == S) lslot = 0;
    cp_async_commit();
  }
  grid_dep_wait();   // the launch before wrote x's rows
  // x's rows, made once beforehand (`norm_rows_kernel`, or the up launch's
  // act(gate) * up): the window is a copy, 16 bytes a piece, in flight
  // behind the first weight stages; then everything in flight lands
  {
    const int quads = kResRows * win * KS / 4;
    for (int e = tid; e < quads; e += kStreamThreads) {
      int k;
      bool in;
      const float* src;
      float* dst;
      if constexpr (kTrans) {   // [b][k] into [b][wi]
        const int b = e / (win * KS / 4), wi = (e % (win * KS / 4)) * 4;
        k = ((s_first + wi / KS) % a.ksteps) * KS + wi % KS;
        in = b < a.batch && k < a.k;
        src = a.xn_ready + static_cast<int64_t>(b) * a.k + k;
        dst = xn + b * win * KS + wi;
      } else {                  // [k][8] into [wi][8], half a row group a piece
        const int wi = e / 2, h4 = (e % 2) * 4;
        k = ((s_first + wi / KS) % a.ksteps) * KS + wi % KS;
        in = k < a.k;
        src = a.xn_ready + static_cast<int64_t>(k) * kResRows + h4;
        dst = xn + wi * kResRows + h4;
      }
      cp_async16(dst, in ? src : a.xn_ready, in);
    }
    cp_async_commit();
  }

  cp_async_wait(0);
  __syncthreads();

  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

  // tile tt's output (b, col): the bias (after rounding, K6d), the
  // activation, the store
  auto tile_out = [&](int tt, int b, int col, float v) {
    const int pi = (a.n_problems > 1 && tt >= tiles0) ? 1 : 0;
    const StreamProblem& P = a.p[pi];
    const int n = (tt - (pi ? tiles0 : 0)) * TN + col;
    if (b >= a.batch || n >= P.n) return;
    if (P.bias != nullptr) {
      if (a.bias_after_round) v = to_float(from_float<TO>(v));
      v += P.bias[n];
    }
    v = activate(v, a.act);
    static_cast<TO*>(P.out)[P.out_t ? static_cast<int64_t>(n) * kResRows + b
                                    : static_cast<int64_t>(b) * P.n + n] = from_float<TO>(v);
  };
  // A tile whose outputs need other blocks: one cut by a share boundary
  // (the last block to arrive adds every part in block order), and in a
  // gated up launch every tile (the second of a column's up and gate tiles
  // to be written makes act(gate) * up).  Published after this block's
  // copies have drained: thread 0's fence would otherwise wait on them.
  auto publish = [&](int tt, bool whole) {
    const int t_first = tt * a.ksteps, t_end = t_first + a.ksteps;
    const int outs = a.batch * TN;
    const int jlo = block_of(t_first, a.q, a.r), jhi = block_of(t_end - 1, a.q, a.r);
    if (!kTrans) {
      // row-major: every warp on the tile left its part.  This block adds
      // its own in warp order (into warp 0's place); a whole tile is then
      // written, a cut one's last block to arrive adds the blocks' sums in
      // block order
      __syncthreads();   // this block's warps' parts are written
      const int64_t stride = static_cast<int64_t>(kStreamWarps) * outs;
      float* mine = a.work + static_cast<int64_t>(j * a.slots + tt - first_tile) * stride;
#pragma unroll 2
      for (int o = tid; o < outs; o += kStreamThreads) {
        float p[kStreamWarps];
#pragma unroll
        for (int w = 0; w < kStreamWarps; ++w) p[w] = __ldcg(mine + w * outs + o);
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kStreamWarps; ++w) v += p[w];
        if (whole)
          tile_out(tt, o / TN, o % TN, v);
        else
          __stcg(mine + o, v);
      }
      if (!whole) {
        __syncthreads();   // orders this block's sum before thread 0's fence
        if (tid == 0) {
          __threadfence();
          *s_last = atomicAdd(a.counters + tt, 1) == jhi - jlo;
          __threadfence();
        }
        __syncthreads();
        if (!*s_last) return;
#pragma unroll 2
        for (int o = tid; o < outs; o += kStreamThreads) {
          float v = 0.f;
          int jj = jlo;
          auto part_at = [&](int jb) {
            return __ldcg(a.work + static_cast<int64_t>(
                                       jb * a.slots + tt - share_start(jb, a.q, a.r) / a.ksteps) *
                                       stride + o);
          };
          for (; jj + 3 <= jhi; jj += 4) {   // four loads in flight, added in block order
            const float p0 = part_at(jj), p1 = part_at(jj + 1);
            const float p2 = part_at(jj + 2), p3 = part_at(jj + 3);
            v += p0;
            v += p1;
            v += p2;
            v += p3;
          }
          for (; jj <= jhi; ++jj) v += part_at(jj);
          tile_out(tt, o / TN, o % TN, v);
        }
        if (tid == 0) a.counters[tt] = 0;
      }
    } else if (!whole) {
      __syncthreads();   // the barrier orders this block's part before thread 0's fence
      if (tid == 0) {
        __threadfence();
        *s_last = atomicAdd(a.counters + tt, 1) == jhi - jlo;
        __threadfence();
      }
      __syncthreads();
      if (!*s_last) return;
      // slot 0 for the blocks whose first tile this is (all but jlo, whose
      // share began before it)
      auto part_at = [&](int jj, int o) {
        const int sl = (jj == jlo && share_start(jj, a.q, a.r) < t_first) ? 1 : 0;
        return __ldcg(a.work + static_cast<int64_t>(jj * 2 + sl) * outs + o);
      };
#pragma unroll 2
      for (int o = tid; o < outs; o += kStreamThreads) {
        float v = 0.f;
        int jj = jlo;
        for (; jj + 3 <= jhi; jj += 4) {   // four loads in flight, added in block order
          const float p0 = part_at(jj, o), p1 = part_at(jj + 1, o);
          const float p2 = part_at(jj + 2, o), p3 = part_at(jj + 3, o);
          v += p0;
          v += p1;
          v += p2;
          v += p3;
        }
        for (; jj <= jhi; ++jj) v += part_at(jj, o);
        tile_out(tt, o / TN, o % TN, v);
      }
      if (tid == 0) a.counters[tt] = 0;
    }
    if (a.h == nullptr) return;
    const int c = tt < tiles0 ? tt : tt - tiles0;
    int* pair = a.counters + tiles0 + a.p[1].tiles + c;
    __syncthreads();   // the tile's outputs are written
    if (tid == 0) {
      __threadfence();
      *s_last = atomicAdd(pair, 1) == 1;
      __threadfence();
    }
    __syncthreads();
    if (!*s_last) return;
    const float* up = static_cast<const float*>(a.p[0].out);
    const float* gate = static_cast<const float*>(a.p[1].out);
    for (int o = tid; o < TN * kResRows; o += kStreamThreads) {
      const int n = c * TN + o / kResRows, b = o % kResRows;
      if (b < a.batch && n < a.p[0].n) {
        const int64_t at = static_cast<int64_t>(n) * kResRows + b;
        a.h[at] = activate(__ldcg(gate + at), a.gate_act) * __ldcg(up + at);
      }
    }
    if (tid == 0) *pair = 0;
  };
  constexpr int kPending = 8;
  int pending[kPending];
  bool pending_whole[kPending];
  int n_pending = 0;
  auto defer = [&](int tt, bool whole) {
    if (n_pending == kPending) {
      publish(tt, whole);   // a long share of a gated launch: at once
      return;
    }
    pending[n_pending] = tt;
    pending_whole[n_pending] = whole;
    ++n_pending;
  };

  // the consumer's cursor: unit u's tile t, step s, slot and place xw in
  // the window (the share walks the steps in order, so xw counts units)
  int t = first_tile, s = s_first, cslot = 0, xw = 0;
  auto next = [&]() {
    if (++cslot == S) cslot = 0;
    if (++xw == a.ksteps) xw = 0;
    if (++s == a.ksteps) {
      s = 0;
      ++t;
    }
  };
  for (int u = start; u < end; ++u, next()) {
    if (lu < end) issue();   // into the slot of unit u - 1: this lane read it
    else if (++lslot == S) lslot = 0;
    cp_async_commit();
    cp_async_wait(S - 1);   // this lane's copies of unit u have landed
    const unsigned char* ws = ring + cslot * (kStageRows * kSegBytes) + warp * 4 * kSegBytes + lane * 16;
    if constexpr (kTrans) {
      float xv[kResRows][V];
#pragma unroll
      for (int b = 0; b < kResRows; ++b) {
        const float* xr = xn + (b * win + xw) * KS + lane * V;
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xr + e);
          xv[b][e] = q.x; xv[b][e + 1] = q.y; xv[b][e + 2] = q.z; xv[b][e + 3] = q.w;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float wv[V];
        load_vec(reinterpret_cast<const TW*>(ws + c * kSegBytes), wv);
#pragma unroll
        for (int b = 0; b < kResRows; ++b) {
          float s2 = acc[c * kResRows + b];
#pragma unroll
          for (int e = 0; e < V; ++e) s2 = fmaf(xv[b][e], wv[e], s2);
          acc[c * kResRows + b] = s2;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float wv[V];
        load_vec(reinterpret_cast<const TW*>(ws + r * kSegBytes), wv);
        const float* xr = xn + (xw * KS + warp * 4 + r) * kResRows;
        const float4 xa = *reinterpret_cast<const float4*>(xr);
        const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
        const float xv[kResRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int c = 0; c < V; ++c)
#pragma unroll
          for (int b = 0; b < kResRows; ++b)
            acc[c * kResRows + b] = fmaf(xv[b], wv[c], acc[c * kResRows + b]);
      }
    }
    if (s != a.ksteps - 1 && u != end - 1) continue;

    // the end of this block's part of tile t: the sums meet
    const int t_first = t * a.ksteps, t_end = t_first + a.ksteps;
    const bool whole = start <= t_first && end >= t_end;
    float* part = a.work + static_cast<int64_t>(j * 2 + (t == first_tile ? 0 : 1)) *
                               (a.batch * TN);
    if constexpr (kTrans) {
      // butterfly: every lane gets the 32 sums; lane c * 8 + b keeps (c, b)
      // (A/B: a 31-shuffle reduce-scatter was slower: its selects)
      float mine = 0.f;
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        const float v = warp_sum(acc[e]);
        if (e == lane) mine = v;
        acc[e] = 0.f;
      }
      const int b = lane % kResRows, col = warp * 4 + lane / kResRows;
      if (whole)
        tile_out(t, b, col, mine);
      else if (b < a.batch)
        __stcg(part + b * TN + col, mine);
    } else {
      // this warp's sums of tile t (it took 4 of each unit's K rows) into
      // the work buffer: no barrier here; the parts are added after the
      // stream (publish)
      float* wp = a.work + (static_cast<int64_t>(j * a.slots + t - first_tile) * kStreamWarps +
                            warp) * (a.batch * TN);
#pragma unroll
      for (int b = 0; b < kResRows; ++b) {
        if (b >= a.batch) break;
#pragma unroll
        for (int c = 0; c < V; c += 4)
          __stcg(reinterpret_cast<float4*>(wp + b * TN + lane * V + c),
                 make_float4(acc[c * kResRows + b], acc[(c + 1) * kResRows + b],
                             acc[(c + 2) * kResRows + b], acc[(c + 3) * kResRows + b]));
      }
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    }
    if (!kTrans || !whole || a.h != nullptr) defer(t, whole);
  }
  cp_async_wait(0);
  __syncthreads();   // every warp's parts of this block are written
  for (int i = 0; i < n_pending; ++i) publish(pending[i], pending_whole[i]);
}

// The resident form's x, made once: each row's norm in fp32 with the
// plain version's statistics (the mean, then the mean of (x - mean)^2),
// as [batch][k] (a transposed weight's) or [k][8] (a row-major one's).
template <typename TX>
__global__ void __launch_bounds__(kStreamThreads)
norm_rows_kernel(const TX* __restrict__ x, int k, const float* __restrict__ nw,
                 const float* __restrict__ nb, int norm, float eps, float* __restrict__ out,
                 int interleaved) {
  __shared__ float red[kStreamWarps];
  grid_dep_launch();   // the stream kernel may start its weight copies
  const int b = blockIdx.x, tid = threadIdx.x;
  const TX* xr = x + static_cast<int64_t>(b) * k;
  const int quads = k / 4;
  auto block_sum = [&](float v) {
    v = warp_sum(v);
    if (tid % kWarp == 0) red[tid / kWarp] = v;
    __syncthreads();
    float t = 0.f;
    for (int w = 0; w < kStreamWarps; ++w) t += red[w];
    __syncthreads();
    return t;
  };
  float mean = 0.f;
  if (norm == kLayerNorm) {
    float s = 0.f;
#pragma unroll 4
    for (int q = tid; q < quads; q += kStreamThreads) {
      float v[4];
      load4(xr + 4 * q, v);
      s += v[0];
      s += v[1];
      s += v[2];
      s += v[3];
    }
    mean = block_sum(s) / k;
  }
  float var = 0.f;
#pragma unroll 4
  for (int q = tid; q < quads; q += kStreamThreads) {
    float v[4];
    load4(xr + 4 * q, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[e] - mean;
      var = fmaf(d, d, var);
    }
  }
  const float rstd = rsqrtf(block_sum(var) / k + eps);
#pragma unroll 4
  for (int q = tid; q < quads; q += kStreamThreads) {
    float v[4], w4[4], b4[4] = {0.f, 0.f, 0.f, 0.f};
    load4(xr + 4 * q, v);
    load4(nw + 4 * q, w4);
    if (nb != nullptr) load4(nb + 4 * q, b4);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (v[e] - mean) * rstd * w4[e] + b4[e];
    if (interleaved) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[static_cast<int64_t>(4 * q + e) * kResRows + b] = v[e];
    } else {
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(b) * k + 4 * q) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The stages that fit the budget (at most kMaxStages, at least 2), or 0.
template <typename TX, typename TW, bool kTrans>
int stream_stages(int groups, bool gated) {
  for (int s = kMaxStages; s >= 2; --s)
    if (stream_layout<TX, TW, kTrans>(groups, gated, s).total <= kSmemBudget) return s;
  return 0;
}

// The dynamic shared memory attribute, once per kernel.
template <typename K>
int allow_smem(K kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

int row_groups(int batch) {
  const int g = (batch + 7) / 8;
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The window of x a resident launch holds: the steps of the longest share.
int resident_window(int q, int r, int ksteps) {
  const int longest = q + (r > 0 ? 1 : 0);
  return longest < ksteps ? longest : ksteps;
}

// Blocks an SM holds at once of the form a launch of `tiles` x `ksteps`
// units at `batch` rows takes (>= 1), or -error: the resident form runs
// one block an SM (its window and ring fill the shared memory), the
// staged form as many as fit.
template <typename TX, typename TW, typename TO, bool kTrans>
int stream_occupancy(int batch, bool gated, int tiles, int ksteps) {
  const int sms = sm_count();
  const long long units = static_cast<long long>(tiles) * ksteps;
  if (sms < 1 || units < 1) return -static_cast<int>(cudaErrorInvalidValue);
  for (int per_sm = 2; per_sm >= 1; --per_sm) {   // two blocks an SM where their windows fit
    const long long blocks = static_cast<long long>(per_sm) * sms;
    const int grid = static_cast<int>(units < blocks ? units : blocks);
    if (resident_stages<TW, kTrans>(
            batch,
            resident_window(static_cast<int>(units / grid), static_cast<int>(units % grid),
                            ksteps),
            per_sm) > 0)
      return per_sm;
  }
  const int groups = row_groups(batch);
  const int stages = stream_stages<TX, TW, kTrans>(groups, gated);
  if (stages == 0) return -static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  const auto kernel = stream_gemv_kernel<TX, TW, TO, kTrans>;
  const int rc = allow_smem(kernel, &done);
  if (rc != 0) return -rc;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, kStreamThreads, stream_layout<TX, TW, kTrans>(groups, gated, stages).total);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n > 0 ? n : -static_cast<int>(cudaErrorInvalidConfiguration);
}

// Whether the resident form takes a launch of `k` (its reduction axis) at
// `batch` rows under the plan (grid, q, r).
template <typename TW, bool kTrans>
bool resident_takes(int batch, int k, int grid, int q, int r) {
  const int sms = sm_count();
  const int ksteps = (k + Geo<TW, kTrans>::kKS - 1) / Geo<TW, kTrans>::kKS;
  return sms > 0 && grid > 0 &&
         resident_stages<TW, kTrans>(batch, resident_window(q, r, ksteps),
                                     (grid + sms - 1) / sms) > 0;
}

// x's rows made once for a resident launch (`norm_rows_kernel`).
template <typename TX>
int launch_norm_rows(const void* x, int batch, int k, const void* nw, const void* nb,
                     int norm, float eps, float* out, int interleaved, cudaStream_t stream) {
  norm_rows_kernel<TX><<<batch, kStreamThreads, 0, stream>>>(
      static_cast<const TX*>(x), k, static_cast<const float*>(nw),
      static_cast<const float*>(nb), norm, eps, out, interleaved);
  return static_cast<int>(cudaGetLastError());
}

// Fill the plan and the tiles of `a` (its problems set) and launch `grid`
// blocks of the resident form (`resident`; it must take the launch) or of
// the staged one; the plan must cover the tiles' units exactly.
template <typename TX, typename TW, typename TO, bool kTrans>
int launch_stream(StreamArgs& a, int grid, bool resident, cudaStream_t stream) {
  using G = Geo<TW, kTrans>;
  int tiles = 0;
  for (int i = 0; i < a.n_problems; ++i) {
    a.p[i].tiles = (a.p[i].n + G::kTN - 1) / G::kTN;
    tiles += a.p[i].tiles;
  }
  a.ksteps = (a.k + G::kKS - 1) / G::kKS;
  if (grid < 1 || a.q < 1 || a.r < 0 || a.r >= grid ||
      static_cast<long long>(a.q) * grid + a.r != static_cast<long long>(tiles) * a.ksteps)
    return static_cast<int>(cudaErrorInvalidValue);
  a.window = resident_window(a.q, a.r, a.ksteps);
  a.slots = (a.q + a.ksteps) / a.ksteps + 1;   // ceil((q + 1) / ksteps) + 1
  const int sms = sm_count();
  a.stages = !resident || sms < 1
                 ? 0
                 : resident_stages<TW, kTrans>(a.batch, a.window, (grid + sms - 1) / sms);
  if (resident && a.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.stages > 0) {
    static bool done = false;
    const auto kernel = stream_resident_kernel<TX, TW, TO, kTrans>;
    const int rc = allow_smem(kernel, &done);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kStreamThreads);
    cfg.dynamicSmemBytes = resident_layout<TW, kTrans>(a.window, a.stages).total;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  a.groups = row_groups(a.batch);
  a.stages = stream_stages<TX, TW, kTrans>(a.groups, a.gate != nullptr);
  if (a.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  const auto kernel = stream_gemv_kernel<TX, TW, TO, kTrans>;
  const int rc = allow_smem(kernel, &done);
  if (rc != 0) return rc;
  kernel<<<grid, kStreamThreads, stream_layout<TX, TW, kTrans>(a.groups, a.gate != nullptr,
                                                                a.stages).total,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The route of one product: the stream kernel takes rows 1..64 of fp32 or
// bf16 where every pointer is 16-byte aligned and n, k and the row stride
// are multiples of the 16-byte vector; the generic GEMV takes the rest.
int stream_route(int transposed, int rows, int n, int k, long long ldw, int dtype,
                 bool aligned) {
  if (dtype != 0 && dtype != 1) return 0;
  const int v = dtype == 0 ? 4 : 8;
  return aligned && rows >= 1 && rows <= kStreamMaxRows && n > 0 && k > 0 &&
         n % v == 0 && k % v == 0 && ldw % v == 0 && ldw >= (transposed ? k : n);
}

// ---------------------------------------------------------------------------
// K6a on the main path: the resident stream form over q, k and v
// ---------------------------------------------------------------------------
//
// Replaces K6a's TPU kernel for the main path's shapes (fd_qkv_route).
// Bound: the weights' bytes (fp32 llama2-7b: 201 MB, 0.060 ms at
// 3.35 TB/s).  One stream launch deals the three products' (tile, step)
// units out as K6d's plan does (a tile is 512 bytes of columns, a step 32
// rows of K), one block an SM with an 8-stage lane-private cp.async ring.
// x's rows come in as they lie ([b][k]; no pre-pass, nothing to
// normalize) into a window kept for the whole launch, behind the first
// weight stages.  Unlike the resident form above, a warp owns 64 bytes of
// every stage row's columns and all 32 rows, so the warps never add each
// other's sums: lane (grp, chunk) copies rows 4 grp .. 4 grp + 3 of the
// warp's 16-byte `chunk`, 8 rows x 64 bytes in each copy instruction.
//   * fp32, on CUDA cores: each lane multiplies only what it copied (its 4
//     columns x 4 rows against x's 8 rows, 4 rows a 16-byte load of the
//     window); at a tile's end the 8 lanes of a chunk meet by a butterfly.
//     (TF32 would miss the fp32 tolerance.)
//   * bf16, on the tensor cores: outT [TN, 8] = wT x xT with
//     mma.m16n8k16 (the 8 rows of x are its n = 8 side).  The warp's
//     32 x 64 bytes are kept XOR-swizzled by 16-byte chunk so that
//     ldmatrix.trans reads the weight rows as A fragments without bank
//     conflicts; ldmatrix reads x's k-contiguous rows as B fragments (the
//     window's rows padded by 16 bytes).  No element is converted and no
//     product is made on the CUDA cores.
// A tile's sums go to the block's part in the work buffer.  A second
// launch (`qkv_epilogue_kernel`, one block a tile, programmatic dependent
// launch) adds each tile's parts in block order, so a relaunch is bitwise
// equal, then the bias and the rope of each column pair, one rounding.
// Column pairs lie inside a tile: (2i, 2i + 1), or neox (j, j + hd / 2)
// where hd divides the tile's columns (the route's rule).
// A warp takes 2 KiB of a 16 KiB stage: its 64 bytes of each of the
// step's 32 rows (A/B: 16 rows of 128 bytes streamed faster but cost more
// in parts and cut tiles, 4-22 % slower, PERF.md).
template <typename T>
struct QkvGeo {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kItem = static_cast<int>(sizeof(T));
  static constexpr int kVec = 16 / kItem;
  static constexpr int kKS = kStageRows;                     // rows of K a step
  static constexpr int kStage = kStageRows * kSegBytes;      // 16 KiB
  static constexpr int kWarpBytes = kStage / kStreamWarps;   // 2 KiB
  static constexpr int kWarpCols = 64 / kItem;               // a warp's columns
  static constexpr int kTN = kStreamWarps * kWarpCols;       // 128 fp32, 256 bf16
  // x's window: 8 rows of `window` steps (bf16: + 16 bytes, for ldmatrix)
  __host__ __device__ static int x_stride(int window) {
    return window * kKS * kItem + (kMma ? 16 : 0);
  }
  __host__ __device__ static int fixed(int window) { return kResRows * x_stride(window); }
  // a byte offset in a warp's part of a bf16 stage: each 64-byte row's
  // 16-byte chunks XOR (row / 2) % 4, so that ldmatrix's 8 rows of one
  // chunk fall in 8 distinct bank groups
  __host__ __device__ static int swizzled(int row, int chunk) {
    return row * 64 + 16 * (chunk ^ ((row >> 1) & 3));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the problem of tile t (of all the launch's tiles) and its first column
__device__ __forceinline__ int tile_problem(const StreamArgs& a, int t, int tn, int* n0) {
  int pi = 0;
  while (pi + 1 < a.n_problems && t >= a.p[pi].tiles) {
    t -= a.p[pi].tiles;
    ++pi;
  }
  *n0 = t * tn;
  return pi;
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
qkv_stream_kernel(const __grid_constant__ StreamArgs a) {
  using G = QkvGeo<T>;
  constexpr int V = G::kVec, TN = G::kTN, KS = G::kKS, STAGE = G::kStage;
  constexpr int WARP_BYTES = G::kWarpBytes;
  constexpr int MT = G::kWarpCols / 16, KH = KS / 16;   // bf16: 2 m16 tiles, 2 k16 steps
  extern __shared__ __align__(16) unsigned char qkv_smem[];
  const int S = a.stages, win = a.window;
  const int xstride = G::x_stride(win);
  unsigned char* ring = qkv_smem;
  unsigned char* xs = qkv_smem + S * STAGE;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  // the copies: lane (grp, chunk) takes rows 4 grp .. 4 grp + 3 of the
  // warp's 16-byte `chunk`; the mma fragments: lane (g, tq), the same split
  const int grp = lane / 4, chunk = lane % 4;
  const int g = grp, tq = chunk;
  const int j = blockIdx.x;
  const int start = share_start(j, a.q, a.r);
  const int end = start + a.q + (j < a.r ? 1 : 0);
  const int first_tile = start / a.ksteps;
  const int s_first = start % a.ksteps;
  grid_dep_launch();   // the epilogue kernel may be scheduled

  // x's window: [8][window steps x KS], row b's step s_first + i at i;
  // rows past the batch and K past k are zeros
  auto fill_window = [&]() {
    const T* x = static_cast<const T*>(a.x);
    const int per_row = win * KS / V;
    for (int e = tid; e < kResRows * per_row; e += kStreamThreads) {
      const int b = e / per_row, wi = (e % per_row) * V;
      const int k = ((s_first + wi / KS) % a.ksteps) * KS + wi % KS;
      const bool in = b < a.batch && k < a.k;
      cp_async16(xs + b * xstride + wi * static_cast<int>(sizeof(T)),
                 in ? x + static_cast<int64_t>(b) * a.k + k : x, in);
    }
    cp_async_commit();
  };

  // the copies: a cursor over this block's units and this lane's 4 rows
  int lu = start, lt = first_tile, ls = s_first, lslot = 0;
  const T* lp[4];
  bool l_in = false;
  const T* lbase = nullptr;
  int64_t lstep = 0;
  auto set_tile = [&]() {
    int n0;
    const StreamProblem& P = a.p[tile_problem(a, lt, TN, &n0)];
    const int n = n0 + warp * G::kWarpCols + chunk * V;
    lbase = static_cast<const T*>(P.w);
    lstep = static_cast<int64_t>(KS) * P.ldw;
    l_in = n < P.n;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      lp[r] = lbase + static_cast<int64_t>(ls * KS + 4 * grp + r) * P.ldw + n;
  };
  auto issue = [&]() {
    unsigned char* dst = ring + lslot * STAGE + warp * WARP_BYTES;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * grp + r;
      const bool in = l_in && ls * KS + row < a.k;
      const int off = G::kMma ? G::swizzled(row, chunk) : (r * kWarp + lane) * 16;
      cp_async16(dst + off, in ? lp[r] : lbase, in);
      lp[r] += lstep;
    }
    ++lu;
    if (++lslot == S) lslot = 0;
    if (++ls == a.ksteps) {
      ls = 0;
      ++lt;
      if (lu < end) set_tile();
    }
  };
  // the first weight stages go out before the window (A/B: the window
  // first waits on its L2 reads before the stream starts, PERF.md); then
  // everything in flight lands
  set_tile();
  for (int i = 0; i < S - 1; ++i) {
    if (lu < end) issue();
    else if (++lslot == S) lslot = 0;
    cp_async_commit();
  }
  fill_window();
  cp_async_wait(0);
  __syncthreads();

  // this block's sums of tile t: its part in the work buffer, [batch][TN]
  float* const work = a.work + static_cast<int64_t>(j) * a.slots * (a.batch * TN);

  constexpr int ACC = G::kMma ? 4 * MT : 4 * kResRows;
  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
  // bf16: this lane's ldmatrix addresses.  A (mt, h): matrix mi = lane / 8
  // holds K rows 16 h + 8 (mi / 2) .. + 7 of columns 16 mt + 8 (mi % 2) .. + 7;
  // B: matrix mi holds x's 8 rows at K 8 mi .. 8 mi + 7 of the step
  uint32_t a_off[MT][KH] = {}, x_off = 0;
  if constexpr (G::kMma) {
    const int mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < KH; ++h)
        a_off[mt][h] = warp * WARP_BYTES +
                       G::swizzled(16 * h + 8 * (mi >> 1) + ri, 2 * mt + (mi & 1));
    x_off = ri * xstride + 16 * mi;
  }
  const uint32_t ring_s = smem_u32(ring), xs_s = smem_u32(xs);
  const float* xf = reinterpret_cast<const float*>(xs);

  // the consumer's cursor: unit u's tile t, step s, slot, place xw in the window
  int t = first_tile, s = s_first, cslot = 0, xw = 0;
  for (int u = start; u < end; ++u) {
    if (lu < end) issue();   // into the slot of unit u - 1, read by now
    else if (++lslot == S) lslot = 0;
    cp_async_commit();
    cp_async_wait(S - 1);   // this lane's copies of unit u have landed
    if constexpr (G::kMma) {
      __syncwarp();          // and the warp's
      uint32_t xb[4];
      ldsm(xb, xs_s + x_off + xw * KS * 2);
      const uint32_t st = ring_s + cslot * STAGE;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          uint32_t af[4];
          ldsm_t(af, st + a_off[mt][h]);
          mma_bf16(acc + 4 * mt, af, xb[2 * h], xb[2 * h + 1]);
        }
    } else {
      // this lane's 4 rows x 4 columns, then each row of x's 4 values at them
      const unsigned char* ws = ring + cslot * STAGE + warp * WARP_BYTES + lane * 16;
      float wv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) load_vec(reinterpret_cast<const float*>(ws + r * kWarp * 16), wv[r]);
#pragma unroll
      for (int b = 0; b < kResRows; ++b) {
        const float4 xq =
            *reinterpret_cast<const float4*>(xf + b * (xstride / 4) + xw * KS + 4 * grp);
        const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[c * kResRows + b] = fmaf(xv[r], wv[r][c], acc[c * kResRows + b]);
      }
    }
    const bool tile_end = s == a.ksteps - 1 || u == end - 1;
    if (tile_end) {
      // this block's sums of tile t into its part (slot: t's place among
      // the share's tiles); qkv_epilogue_kernel writes the tile
      float* part = work + (t - first_tile) * (a.batch * TN);
      if constexpr (G::kMma) {
        // accumulator e of m-tile mt: column 16 mt + g (+ 8 for e >= 2),
        // row 2 tq + e % 2
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = warp * G::kWarpCols + 16 * mt + g + 8 * (e >> 1);
            const int b = 2 * tq + (e & 1);
            if (b < a.batch) __stcg(part + b * TN + col, acc[4 * mt + e]);
          }
      } else {
        // the 8 groups of a chunk took other rows of the same columns
#pragma unroll
        for (int e = 0; e < ACC; ++e) {
          float v = acc[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          acc[e] = v;
        }
        // group grp writes row grp's 4 columns
#pragma unroll
        for (int b = 0; b < kResRows; ++b)
          if (b == grp && b < a.batch)
            __stcg(reinterpret_cast<float4*>(part + b * TN + warp * G::kWarpCols + chunk * V),
                   make_float4(acc[b], acc[kResRows + b], acc[2 * kResRows + b],
                               acc[3 * kResRows + b]));
      }
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    }
    if (++cslot == S) cslot = 0;
    if (++xw == a.ksteps) xw = 0;
    if (++s == a.ksteps) {
      s = 0;
      ++t;
    }
  }
  cp_async_wait(0);
}

// K6a's epilogue: tile blockIdx.x's sums (the parts of the blocks whose
// shares cover it, added in block order), the bias, the rope of each
// column pair, one rounding to T.  Launched behind the stream kernel with
// programmatic dependent launch, so that its blocks wait on the device,
// not behind a fence: the stream kernel's tail pays no fence or counter
// under a full memory load (A/B, PERF.md).
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
qkv_epilogue_kernel(const __grid_constant__ StreamArgs a) {
  constexpr int TN = QkvGeo<T>::kTN;
  const int tt = blockIdx.x, t_first = tt * a.ksteps;
  const int jlo = block_of(t_first, a.q, a.r), jhi = block_of(t_first + a.ksteps - 1, a.q, a.r);
  int n0;
  const StreamProblem& P = a.p[tile_problem(a, tt, TN, &n0)];
  const bool neox = P.rope && a.neox;
  const int half = a.head_dim / 2;
  T* out = static_cast<T*>(P.out);
  grid_dep_wait();   // the stream kernel's parts are written
  for (int p = threadIdx.x; p < a.batch * (TN / 2); p += kStreamThreads) {
    const int b = p / (TN / 2), i = p % (TN / 2);
    const int c0 = neox ? (i / half) * a.head_dim + i % half : 2 * i;
    const int c1 = neox ? c0 + half : c0 + 1;
    const int n = n0 + c0, m = n0 + c1;
    if (m >= P.n) continue;   // a pair lies inside one head: both or neither
    float v0 = 0.f, v1 = 0.f;
    for (int jb = jlo; jb <= jhi; ++jb) {
      const float* part = a.work +
          (static_cast<int64_t>(jb) * a.slots + tt - share_start(jb, a.q, a.r) / a.ksteps) *
              (a.batch * TN) + b * TN;
      v0 += part[c0];
      v1 += part[c1];
    }
    if (P.bias != nullptr) {
      v0 += P.bias[n];
      v1 += P.bias[m];
    }
    if (P.rope) {
      const int d0 = n % a.head_dim, d1 = m % a.head_dim;
      const float r0 = v0 * a.cos_row[d0] - v1 * a.sin_row[d0];
      const float r1 = v1 * a.cos_row[d1] + v0 * a.sin_row[d1];
      v0 = r0;
      v1 = r1;
    }
    out[static_cast<int64_t>(b) * P.n + n] = from_float<T>(v0);
    out[static_cast<int64_t>(b) * P.n + m] = from_float<T>(v1);
  }
}

// Blocks an SM holds at once of K6a's stream form for `tiles` x `ksteps`
// units: one (A/B: two blocks an SM, each with a 6-stage ring, were 5-10 %
// slower at every main-path shape, PERF.md), or -error.
template <typename T>
int qkv_occupancy(int tiles, int ksteps) {
  const int sms = sm_count();
  const long long units = static_cast<long long>(tiles) * ksteps;
  if (sms < 1 || units < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms ? units : sms);
  const int window = resident_window(static_cast<int>(units / grid),
                                     static_cast<int>(units % grid), ksteps);
  return ring_stages(QkvGeo<T>::fixed(window), 1) > 0 ? 1
                                                      : -static_cast<int>(cudaErrorInvalidValue);
}

// Fill the plan of `a` (its three problems set) and launch `grid` blocks
// of K6a's stream form; the plan must cover the tiles' units exactly.
template <typename T>
int launch_qkv(StreamArgs& a, int grid, cudaStream_t stream) {
  using G = QkvGeo<T>;
  int tiles = 0;
  for (int i = 0; i < a.n_problems; ++i) {
    a.p[i].tiles = (a.p[i].n + G::kTN - 1) / G::kTN;
    tiles += a.p[i].tiles;
  }
  a.ksteps = (a.k + G::kKS - 1) / G::kKS;
  if (grid < 1 || a.q < 1 || a.r < 0 || a.r >= grid ||
      static_cast<long long>(a.q) * grid + a.r != static_cast<long long>(tiles) * a.ksteps)
    return static_cast<int>(cudaErrorInvalidValue);
  a.window = resident_window(a.q, a.r, a.ksteps);
  a.slots = (a.q + a.ksteps) / a.ksteps + 1;   // ceil((q + 1) / ksteps) + 1
  const int sms = sm_count();
  a.stages = sms < 1 ? 0 : ring_stages(G::fixed(a.window), (grid + sms - 1) / sms);
  if (a.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  const auto kernel = qkv_stream_kernel<T>;
  const int rc = allow_smem(kernel, &done);
  if (rc != 0) return rc;
  kernel<<<grid, kStreamThreads, a.stages * G::kStage + G::fixed(a.window), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(tiles);
  cfg.blockDim = dim3(kStreamThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qkv_epilogue_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The route of K6a: the stream form takes 1..8 rows where each of the
// three products is on the stream kernel's rule (stream_route), a neox
// rotation's column pairs lie inside a tile (the head dim divides the
// tile's 512 bytes of columns) and the window of all of K fits beside a
// 3-stage ring; the generic GEMV takes the rest.  (GPT-3 1.3B's 50 MB
// product, the smallest on the main path, is faster on the stream form:
// A/B, PERF.md.)
int qkv_route(int rows, int nq, int nk, int k, long long ldq, long long ldk, long long ldv,
              int head_dim, int neox_rope, int dtype, bool aligned) {
  if (dtype != 0 && dtype != 1) return 0;
  const int item = dtype == 0 ? 4 : 2;
  const int tn = dtype == 0 ? QkvGeo<float>::kTN : QkvGeo<__nv_bfloat16>::kTN;
  const long long ksteps = (k + kStageRows - 1) / kStageRows;
  const long long window = kResRows * (ksteps * kStageRows * item + (dtype == 1 ? 16 : 0));
  return rows >= 1 && rows <= kResRows && head_dim > 0 && head_dim % 2 == 0 &&
         (!neox_rope || tn % head_dim == 0) &&
         stream_route(0, rows, nq, k, ldq, dtype, aligned) &&
         stream_route(0, rows, nk, k, ldk, dtype, aligned) &&
         stream_route(0, rows, nk, k, ldv, dtype, aligned) &&
         window + 3LL * kStageRows * kSegBytes <= kSmemBudget;
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

// K6a on the stream route: arguments as fd_rope_qkv's, with the plan in
// place of the split (`grid` blocks, block j taking q + (j < r) units from
// j q + min(j, r) of the tiles of q, k and v in that order); work fp32
// [grid][ceil((q + 1) / ksteps) + 1][batch][tile columns].  Two launches:
// the stream kernel, then its epilogue.  The call must be on fd_qkv_route.
extern "C" int fd_rope_qkv_stream(const void* x, int batch, int hidden,
                                  const void* wq, const void* wk, const void* wv,
                                  long long ldq, long long ldk, long long ldv,
                                  const void* bq, const void* bk, const void* bv,
                                  const void* cos_row, const void* sin_row, int neox,
                                  void* q, void* k, void* v, int nq, int nk,
                                  int head_dim, void* work, int grid,
                                  int plan_q, int plan_r, int dtype, void* stream) {
  const bool aligned = [&] {
    for (const void* p : {x, wq, wk, wv})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    return true;
  }();
  const int rope = cos_row != nullptr;
  if (!qkv_route(batch, nq, nk, hidden, ldq, ldk, ldv, head_dim, rope && neox, dtype, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  StreamArgs a{};
  a.x = x;
  a.batch = batch;
  a.k = hidden;
  a.norm = kNoNorm;
  a.act = kNoAct;
  a.cos_row = static_cast<const float*>(cos_row);
  a.sin_row = static_cast<const float*>(sin_row);
  a.neox = neox;
  a.head_dim = head_dim;
  a.n_problems = 3;
  a.p[0] = StreamProblem{wq, ldq, static_cast<const float*>(bq), q, nq, 0, 0, rope};
  a.p[1] = StreamProblem{wk, ldk, static_cast<const float*>(bk), k, nk, 0, 0, rope};
  a.p[2] = StreamProblem{wv, ldv, static_cast<const float*>(bv), v, nk, 0, 0, 0};
  a.q = plan_q;
  a.r = plan_r;
  a.work = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_qkv<float>(a, grid, s) : launch_qkv<__nv_bfloat16>(a, grid, s);
}

// K6a's route (1: the stream form, 0: the generic GEMV) of a call of
// `rows` rows of x [rows, k] against q/k/v weights of nq / nk / nk columns
// and row strides ldq / ldk / ldv; neox_rope: a neox rotation is applied;
// aligned: every pointer 16-byte aligned.
extern "C" int fd_qkv_route(int rows, int nq, int nk, int k, long long ldq, long long ldk,
                            long long ldv, int head_dim, int neox_rope, int dtype,
                            int aligned) {
  return qkv_route(rows, nq, nk, k, ldq, ldk, ldv, head_dim, neox_rope, dtype, aligned != 0);
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

// The stream kernel's route of one product (1) or the generic GEMV's (0):
// rows 1..64 of x, fp32 or bf16, every pointer 16-byte aligned (`aligned`),
// n, k and the weight's row stride multiples of the 16-byte vector.
extern "C" int fd_route(int transposed, int rows, int n, int k, long long ldw,
                        int dtype, int aligned) {
  return stream_route(transposed, rows, n, k, ldw, dtype, aligned != 0);
}

// Blocks of the stream kernel an SM holds at once, for the instantiation a
// launch of `kind` takes (0: K6d; 1: K6c's up and gate products into fp32;
// 2: K6c's down product of the fp32 scratch; 3: K6a) at `rows` rows of x (and a
// gate for kind 2) over `tiles` x `ksteps` units; a negative CUDA error
// where none fits.
extern "C" int fd_stream_occupancy(int kind, int transposed, int rows, int gated,
                                   int dtype, int tiles, int ksteps) {
  using bf = __nv_bfloat16;
  if (rows < 1 || rows > kStreamMaxRows || kind < 0 || kind > 3 ||
      (transposed && kind != 0))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (kind == 3) {   // K6a's stream form (1..8 rows)
    if (rows > kResRows) return -static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0 ? qkv_occupancy<float>(tiles, ksteps)
         : dtype == 1 ? qkv_occupancy<bf>(tiles, ksteps)
                      : -static_cast<int>(cudaErrorInvalidValue);
  }
  const bool gt = gated != 0;
  if (dtype == 0)
    return transposed ? stream_occupancy<float, float, float, true>(rows, gt, tiles, ksteps)
                      : stream_occupancy<float, float, float, false>(rows, gt, tiles, ksteps);
  if (dtype != 1) return -static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0)
    return transposed ? stream_occupancy<bf, bf, bf, true>(rows, gt, tiles, ksteps)
                      : stream_occupancy<bf, bf, bf, false>(rows, gt, tiles, ksteps);
  if (kind == 1) return stream_occupancy<bf, bf, float, false>(rows, gt, tiles, ksteps);
  return stream_occupancy<float, bf, bf, false>(rows, gt, tiles, ksteps);
}

// K6d on the stream route: arguments as fd_norm_matmul's, with the plan in
// place of the split: `grid` blocks, block j taking q + (j < r) units
// (tile, K step) from j q + min(j, r); work fp32 [grid][2][batch][tile
// columns]; counters int [tiles], zero; xbuf fp32 [8 * hidden] (x's
// normalized rows for the resident form, up to 8 rows).
extern "C" int fd_norm_matmul_stream(const void* x, int batch, int hidden,
                                     const void* nw, const void* nb, int norm,
                                     float eps, const void* w, long long ldw,
                                     int transposed, const void* bias, void* y,
                                     int n, void* work, void* counters, void* xbuf,
                                     int grid, int q, int r, int dtype, void* stream) {
  if (batch <= 0 || batch > kStreamMaxRows || hidden <= 0 || n <= 0 ||
      (norm != kLayerNorm && norm != kRmsNorm) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  StreamArgs a{};
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
  a.p[0] = StreamProblem{w, ldw, static_cast<const float*>(bias), y, n, 0, 0};
  a.q = q;
  a.r = r;
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool res = dtype == 0 ? (transposed ? resident_takes<float, true>(batch, hidden, grid, q, r)
                                            : resident_takes<float, false>(batch, hidden, grid, q, r))
                              : (transposed ? resident_takes<bf, true>(batch, hidden, grid, q, r)
                                            : resident_takes<bf, false>(batch, hidden, grid, q, r));
  if (res) {
    const int rc = dtype == 0
        ? launch_norm_rows<float>(x, batch, hidden, nw, nb, norm, eps, static_cast<float*>(xbuf),
                                  !transposed, s)
        : launch_norm_rows<bf>(x, batch, hidden, nw, nb, norm, eps, static_cast<float*>(xbuf),
                               !transposed, s);
    if (rc != 0) return rc;
    a.xn_ready = static_cast<const float*>(xbuf);
  }
  if (dtype == 0)
    return transposed ? launch_stream<float, float, float, true>(a, grid, res, s)
                      : launch_stream<float, float, float, false>(a, grid, res, s);
  return transposed ? launch_stream<bf, bf, bf, true>(a, grid, res, s)
                    : launch_stream<bf, bf, bf, false>(a, grid, res, s);
}

// K6c on the stream route: arguments as fd_norm_mlp's, with a plan for each
// launch (grid_up/q_up/r_up over the up and gate products' tiles, then
// grid_down/q_down/r_down over the down product's); work and counters as
// for fd_norm_matmul_stream, sized for the larger launch (counters for the
// up launch's tiles and column tiles once more).  scratch fp32, at least
// max(24 inter + 8 hidden, n_up batch inter): where the resident form takes
// both launches, up, gate and act(gate) * up as [inter][8] and x's rows as
// [hidden][8]; else up and gate as [batch][inter].
extern "C" int fd_norm_mlp_stream(const void* x, int batch, int hidden,
                                  const void* nw, const void* nb, int norm,
                                  float eps, const void* w1, long long ld1,
                                  const void* wg, long long ldg, const void* b1,
                                  int act, const void* w2, long long ld2,
                                  const void* b2, void* scratch, void* y,
                                  int inter, int out_dim, void* work,
                                  void* counters, int grid_up, int q_up,
                                  int r_up, int grid_down, int q_down,
                                  int r_down, int dtype, void* stream) {
  if (batch <= 0 || batch > kStreamMaxRows ||
      (norm != kLayerNorm && norm != kRmsNorm) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool res = dtype == 0
      ? resident_takes<float, false>(batch, hidden, grid_up, q_up, r_up) &&
            resident_takes<float, false>(batch, inter, grid_down, q_down, r_down)
      : resident_takes<bf, false>(batch, hidden, grid_up, q_up, r_up) &&
            resident_takes<bf, false>(batch, inter, grid_down, q_down, r_down);
  float* f = static_cast<float*>(scratch);
  const int64_t il = static_cast<int64_t>(kResRows) * inter;
  float* up_out = f;
  float* gate_out = res ? f + il : f + static_cast<int64_t>(batch) * inter;
  float* h = f + 2 * il;
  float* xn = f + 3 * il;

  StreamArgs up{};
  up.x = x;
  up.batch = batch;
  up.k = hidden;
  up.norm = norm;
  up.nw = static_cast<const float*>(nw);
  up.nb = static_cast<const float*>(nb);
  up.eps = eps;
  up.act = wg != nullptr ? kNoAct : act;
  up.n_problems = wg != nullptr ? 2 : 1;
  up.p[0] = StreamProblem{w1, ld1, static_cast<const float*>(b1), up_out, inter, 0, res};
  if (wg != nullptr) up.p[1] = StreamProblem{wg, ldg, nullptr, gate_out, inter, 0, res};
  up.q = q_up;
  up.r = r_up;
  up.work = static_cast<float*>(work);
  up.counters = static_cast<int*>(counters);
  if (res) {
    const int rc = dtype == 0
        ? launch_norm_rows<float>(x, batch, hidden, nw, nb, norm, eps, xn, 1, s)
        : launch_norm_rows<bf>(x, batch, hidden, nw, nb, norm, eps, xn, 1, s);
    if (rc != 0) return rc;
    up.xn_ready = xn;
    if (wg != nullptr) {
      up.h = h;
      up.gate_act = act;
    }
  }
  const int rc = dtype == 0 ? launch_stream<float, float, float, false>(up, grid_up, res, s)
                            : launch_stream<bf, bf, float, false>(up, grid_up, res, s);
  if (rc != 0) return rc;

  StreamArgs down{};
  down.batch = batch;
  down.k = inter;
  down.norm = kNoNorm;
  down.act = kNoAct;
  down.n_problems = 1;
  down.p[0] = StreamProblem{w2, ld2, static_cast<const float*>(b2), y, out_dim, 0, 0};
  down.q = q_down;
  down.r = r_down;
  down.work = static_cast<float*>(work);
  down.counters = static_cast<int*>(counters);
  if (res) {   // x: act(gate) * up, or GPT's activated up, made by the up launch
    down.x = wg != nullptr ? h : up_out;
    down.xn_ready = static_cast<const float*>(down.x);
  } else {     // x comes in as act(gate) * up, made per step
    down.x = up_out;
    down.gate = wg != nullptr ? gate_out : nullptr;
    down.gate_act = act;
  }
  return dtype == 0 ? launch_stream<float, float, float, false>(down, grid_down, res, s)
                    : launch_stream<float, bf, bf, false>(down, grid_down, res, s);
}
