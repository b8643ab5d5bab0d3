// LayerNorm forward and dx backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/layer_norm.py:
//   * K2a `_fwd_kernel`, launched by `_fwd`: y = (x - mean) * rstd * w + b
//     over the last axis, with fp32 statistics; also writes the fp32 row
//     `mean` and `rstd` that the backward reuses;
//   * K2b `_bwd_kernel`, launched by `_bwd_dx`:
//     dx = rstd * (wg - mean(wg) - xhat * mean(wg * xhat)), wg = g * w,
//     xhat = (x - mean) * rstd.
// dw and db are cross-row reductions left to the caller (torch), as the
// JAX package leaves them to XLA.  Every sum is fp32; x, y, g and dx share
// one dtype (fp32 or bf16), w and b another.
//
// What bounds it: bytes.  Each element is read once and written once with
// a handful of operations (x, y: 8 B/elem in fp32; x, g, dx: 12 B/elem),
// far below the card's ~20 fp32 operations per byte of memory traffic.
//
// Design.  The TPU kernel normalises a (256, H) row block held in VMEM.
// Here a row is held in registers by the threads that own it: a warp at
// H = 768, a block of 128 threads at 2048 and of 256 at 4096 (the vector
// route).  Each thread owns kChunks chunks of 16 bytes (4 fp32 or 8 bf16
// elements), chunk i of thread t at element (i * kThreads + t) * kVec, so
// neighbouring threads load neighbouring 16 bytes, and it issues all of a
// row's loads before the first sum uses them.  The elements per thread are
// compile-time constants, so the loads unroll into registers and nothing
// goes through shared memory but the per-warp partial sums.
//
// Each thread loads its columns of w (and b) once and keeps them in
// registers across the rows its block takes: kRowsPerBlock rows (or row
// groups of a block's warps) where the rows outnumber the blocks the card
// holds at once, else one.  A grid of only the resident blocks, striding
// over every row, holds w longer but measured 2-6 % slower on the H100
// at [8192, 2048] (`chip_smoke.py --ab`, the constants below).
//
// Statistics in the plain version's order: the mean first, then the sum
// of squared deviations from the registers (two passes, not E[x^2] - m^2).
// The backward reduces sum(wg) and sum(wg * xhat) as one pair.  A row's
// sum is a butterfly of shuffles in each warp, then the warps' partials
// added in warp order by every thread, so every thread gets the same bits
// and every launch the same result: no atomics.  The partials alternate
// between two shared-memory slots, which makes one barrier per reduction
// enough.
//
// Widths without an instantiation, and pointers that are not 16-byte
// aligned, take the generic route: the same kernel with one element per
// chunk (scalar loads), 256 threads a row, a runtime tail, and 1-32
// elements per thread (H <= 8192).  Wider rows take the wide route: a block
// of 1024 threads per row streams it from device memory (scalar loads, any
// alignment), once for the mean, again for the squared deviations and a
// third time for the output (the dx: once for the pair of sums, again for
// dx), the row staying in L1 between passes; the same statistics, sums and
// fixed reduction order as the other routes.  `ln_route` says which route a
// call takes; the launches below follow it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarp = 32;

// The vector route: threads per row at each instantiated width (A/B on the
// card, `chip_smoke.py --ab`), and rows per block where a warp owns a row.
constexpr int kThreads768 = 32;
constexpr int kRows768 = 4;
constexpr int kThreads2048 = 128;
constexpr int kThreads4096 = 256;
// Rows each block takes where the rows outnumber the blocks the card holds
// at once (A/B on the card: 1, 2, 4, 8, or a grid of the card's resident
// blocks striding over every row).
constexpr int kRowsPerBlock = 2;
// The generic route: threads per row, and the most elements per thread.
constexpr int kGenericThreads = 256;
constexpr int kGenericMaxItems = 32;
// The wide route: threads per row.
constexpr int kWideThreads = 1024;

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

// One 32-bit word holds one fp32 or two bf16 (the first in the low half).
template <typename T>
__device__ __forceinline__ void unpack(uint32_t u, float* v);
template <>
__device__ __forceinline__ void unpack<float>(uint32_t u, float* v) {
  v[0] = __uint_as_float(u);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ uint32_t pack(const float* v);
template <>
__device__ __forceinline__ uint32_t pack<float>(const float* v) {
  return __float_as_uint(v[0]);
}
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(const float* v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[0]))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[1])))
          << 16);
}

// N consecutive elements at p into fp32 registers: one scalar, or 16-byte
// (8- or 4-byte where N elements are fewer bytes) loads; p is aligned to
// min(16, N * sizeof(T)) bytes.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // elements a word
  if constexpr (N == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (kBytes % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 u = __ldg(q + k);
      unpack<T>(u.x, v + (4 * k + 0) * kPer);
      unpack<T>(u.y, v + (4 * k + 1) * kPer);
      unpack<T>(u.z, v + (4 * k + 2) * kPer);
      unpack<T>(u.w, v + (4 * k + 3) * kPer);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    unpack<T>(u.x, v);
    unpack<T>(u.y, v + kPer);
  } else {
    static_assert(kBytes == 4, "4, 8 or a multiple of 16 bytes");
    unpack<T>(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
  }
}

// N fp32 registers to N consecutive elements at p (16-byte stores for the
// vector route, one scalar for the generic one).
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[N]) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  if constexpr (N == 1) {
    p[0] = from_float<T>(v[0]);
  } else {
    static_assert(N * sizeof(T) == 16, "x moves in 16-byte chunks");
    uint4 u;
    u.x = pack<T>(v + 0 * kPer);
    u.y = pack<T>(v + 1 * kPer);
    u.z = pack<T>(v + 2 * kPer);
    u.w = pack<T>(v + 3 * kPer);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of the K values v[k] over the kThreads threads of a row; every
// thread gets the same bits.  A warp's butterfly gives each lane the same
// sum; with more than one warp a row, lane 0 of each writes its partials
// to `red` ([kThreads / 32][K] floats, one of two slots that the caller
// alternates) and every thread adds them in warp order after one barrier.
// The slot written here is next written two reductions later, after the
// barrier of the reduction in between, which every thread reaches only
// once it has read this one.
template <int kThreads, int K>
__device__ __forceinline__ void row_sum(float (&v)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if constexpr (kThreads > kWarp) {
    constexpr int kWarps = kThreads / kWarp;
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = red[k];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) s += red[i * K + k];
      v[k] = s;
    }
  }
}

// The threads of one row: a warp (kRows rows per block) or the whole
// block (kRows = 1).  Thread t of the row owns kChunks chunks of kVec
// elements, chunk i at element (i * kThreads + t) * kVec.  kTail: the
// generic route, where a chunk (of one element) may lie past h.
template <int kVec, int kThreads, int kChunks, int kRows, bool kTail>
struct Layout {
  static_assert(kThreads % kWarp == 0 && kThreads <= 1024, "whole warps");
  static_assert(kRows == 1 || kThreads == kWarp, "rows share a block only "
                "when a warp owns each");
  static_assert(!kTail || kVec == 1, "the tail is scalar");
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kWarps = kThreads / kWarp;
  static __device__ __forceinline__ int thread() {
    return kThreads == kWarp ? threadIdx.x % kWarp : threadIdx.x;
  }
  static __device__ __forceinline__ int first_row() {
    return blockIdx.x * kRows + (kThreads == kWarp ? threadIdx.x / kWarp : 0);
  }
  static __device__ __forceinline__ int col(int i, int t) {
    return (i * kThreads + t) * kVec;
  }
  static __device__ __forceinline__ bool live(int c, int h) {
    return !kTail || c < h;
  }
};

// Thread t's chunks of the row at src into registers (0 past the tail).
template <typename L, int kChunks, int kVec, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int t,
                                         int h, float (&v)[kChunks][kVec]) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = L::col(i, t);
    if (L::live(c, h)) {
      load<T, kVec>(src + c, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[i][e] = 0.f;
    }
  }
}

template <typename T, typename TW, int kVec, int kThreads, int kChunks,
          int kRows, bool kTail>
__global__ void __launch_bounds__(kThreads * kRows)
layer_norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                      const TW* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int n_rows, int h, float eps) {
  using L = Layout<kVec, kThreads, kChunks, kRows, kTail>;
  __shared__ float red[2][L::kWarps];
  const int t = L::thread();
  float wr[kChunks][kVec], br[kChunks][kVec];
  load_row<L>(w, t, h, wr);
  load_row<L>(b, t, h, br);
  for (int row = L::first_row(); row < n_rows; row += gridDim.x * kRows) {
    const int64_t off = static_cast<int64_t>(row) * h;
    float v[kChunks][kVec];
    load_row<L>(x + off, t, h, v);
    float s[1] = {0.f};
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) s[0] += v[i][e];
    row_sum<kThreads>(s, red[0]);
    const float m = s[0] / h;
    float ss[1] = {0.f};
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (L::live(L::col(i, t), h)) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = v[i][e] - m;
          ss[0] += d * d;
        }
      }
    }
    row_sum<kThreads>(ss, red[1]);
    const float r = rsqrtf(ss[0] / h + eps);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = L::col(i, t);
      if (L::live(c, h)) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          o[e] = (v[i][e] - m) * r * wr[i][e] + br[i][e];
        store<T, kVec>(y + off + c, o);
      }
    }
    if (t == 0) {
      mean[row] = m;
      rstd[row] = r;
    }
  }
}

template <typename T, typename TW, int kVec, int kThreads, int kChunks,
          int kRows, bool kTail>
__global__ void __launch_bounds__(kThreads * kRows)
layer_norm_bwd_dx_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ g, T* __restrict__ dx,
                         int n_rows, int h) {
  using L = Layout<kVec, kThreads, kChunks, kRows, kTail>;
  // two slots of (sum wg, sum wg * xhat) per warp; one reduction a row
  __shared__ float red[2][L::kWarps * 2];
  const int t = L::thread();
  float wr[kChunks][kVec];
  load_row<L>(w, t, h, wr);
  int slot = 0;
  for (int row = L::first_row(); row < n_rows; row += gridDim.x * kRows) {
    const int64_t off = static_cast<int64_t>(row) * h;
    const float m = mean[row];
    const float r = rstd[row];
    float xv[kChunks][kVec], gv[kChunks][kVec];
    load_row<L>(x + off, t, h, xv);
    load_row<L>(g + off, t, h, gv);
    // xv becomes xhat and gv becomes wg (0 past the tail: w is 0 there)
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        xv[i][e] = (xv[i][e] - m) * r;
        gv[i][e] *= wr[i][e];
        s[0] += gv[i][e];
        s[1] += gv[i][e] * xv[i][e];
      }
    row_sum<kThreads>(s, red[slot]);
    slot ^= 1;
    const float mu1 = s[0] / h;
    const float mu2 = s[1] / h;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = L::col(i, t);
      if (L::live(c, h)) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          o[e] = r * (gv[i][e] - mu1 - xv[i][e] * mu2);
        store<T, kVec>(dx + off + c, o);
      }
    }
  }
}

// The wide route: one block of kWideThreads per row, any width, the row
// read again for each pass (statistics as above: the mean, then the sum of
// squared deviations; every thread gets the same bits).
template <typename T, typename TW>
__global__ void __launch_bounds__(kWideThreads)
layer_norm_wide_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                           const TW* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ mean, float* __restrict__ rstd,
                           int n_rows, int h, float eps) {
  __shared__ float red[2][kWideThreads / kWarp];
  for (int row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * h;
    const T* xr = x + off;
    float s[1] = {0.f};
    for (int c = threadIdx.x; c < h; c += kWideThreads) s[0] += to_float(xr[c]);
    row_sum<kWideThreads>(s, red[0]);
    const float m = s[0] / h;
    float ss[1] = {0.f};
    for (int c = threadIdx.x; c < h; c += kWideThreads) {
      const float d = to_float(xr[c]) - m;
      ss[0] += d * d;
    }
    row_sum<kWideThreads>(ss, red[1]);
    const float r = rsqrtf(ss[0] / h + eps);
    for (int c = threadIdx.x; c < h; c += kWideThreads)
      y[off + c] = from_float<T>((to_float(xr[c]) - m) * r * to_float(w[c]) +
                                 to_float(b[c]));
    if (threadIdx.x == 0) {
      mean[row] = m;
      rstd[row] = r;
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kWideThreads)
layer_norm_wide_bwd_dx_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const T* __restrict__ g, T* __restrict__ dx,
                              int n_rows, int h) {
  __shared__ float red[2][kWideThreads / kWarp * 2];
  int slot = 0;
  for (int row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * h;
    const float m = mean[row];
    const float r = rstd[row];
    float s[2] = {0.f, 0.f};
    for (int c = threadIdx.x; c < h; c += kWideThreads) {
      const float xhat = (to_float(x[off + c]) - m) * r;
      const float wg = to_float(g[off + c]) * to_float(w[c]);
      s[0] += wg;
      s[1] += wg * xhat;
    }
    row_sum<kWideThreads>(s, red[slot]);
    slot ^= 1;
    const float mu1 = s[0] / h;
    const float mu2 = s[1] / h;
    for (int c = threadIdx.x; c < h; c += kWideThreads) {
      const float xhat = (to_float(x[off + c]) - m) * r;
      const float wg = to_float(g[off + c]) * to_float(w[c]);
      dx[off + c] = from_float<T>(r * (wg - mu1 - xhat * mu2));
    }
  }
}

int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// Blocks of `kernel` to launch over n_rows, kRows to a block: one per row
// group while the card holds them all at once (looked up once per
// kernel), else enough for kRowsPerBlock groups each.
template <typename K>
int grid_for(K kernel, int block, int rows, int n_rows, int* resident) {
  if (*resident == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, block, 0) !=
        cudaSuccess)
      n = 1;
    *resident = n > 0 ? n : 1;
  }
  const int need = (n_rows + rows - 1) / rows;
  const int most = *resident * sm_count();
  if (need <= most) return need;
  const int spread = (need + kRowsPerBlock - 1) / kRowsPerBlock;
  return spread > most ? spread : most;
}

struct Args {
  const void* x;
  const void* w;
  const void* b;      // forward only
  const void* mean;   // backward only
  const void* rstd;
  const void* g;
  void* out;          // y or dx
  void* mean_out;     // forward only
  void* rstd_out;
  int n_rows;
  int h;
  float eps;
  cudaStream_t stream;
};

template <bool kFwd, typename T, typename TW, int kVec, int kThreads,
          int kChunks, int kRows, bool kTail>
int launch(const Args& a) {
  using L = Layout<kVec, kThreads, kChunks, kRows, kTail>;
  static int resident = 0;   // blocks per SM, per instantiation
  if constexpr (kFwd) {
    const auto kernel =
        layer_norm_fwd_kernel<T, TW, kVec, kThreads, kChunks, kRows, kTail>;
    const int grid = grid_for(kernel, L::kBlock, kRows, a.n_rows, &resident);
    kernel<<<grid, L::kBlock, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w),
        static_cast<const TW*>(a.b), static_cast<T*>(a.out),
        static_cast<float*>(a.mean_out), static_cast<float*>(a.rstd_out),
        a.n_rows, a.h, a.eps);
  } else {
    const auto kernel =
        layer_norm_bwd_dx_kernel<T, TW, kVec, kThreads, kChunks, kRows, kTail>;
    const int grid = grid_for(kernel, L::kBlock, kRows, a.n_rows, &resident);
    kernel<<<grid, L::kBlock, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w),
        static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
        static_cast<const T*>(a.g), static_cast<T*>(a.out), a.n_rows, a.h);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kFwd, typename T, typename TW, int kItems>
int launch_generic(const Args& a) {
  return launch<kFwd, T, TW, 1, kGenericThreads, kItems, 1, true>(a);
}

template <bool kFwd, typename T, typename TW>
int launch_wide(const Args& a) {
  static int resident = 0;
  if constexpr (kFwd) {
    const auto kernel = layer_norm_wide_fwd_kernel<T, TW>;
    const int grid = grid_for(kernel, kWideThreads, 1, a.n_rows, &resident);
    kernel<<<grid, kWideThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w),
        static_cast<const TW*>(a.b), static_cast<T*>(a.out),
        static_cast<float*>(a.mean_out), static_cast<float*>(a.rstd_out),
        a.n_rows, a.h, a.eps);
  } else {
    const auto kernel = layer_norm_wide_bwd_dx_kernel<T, TW>;
    const int grid = grid_for(kernel, kWideThreads, 1, a.n_rows, &resident);
    kernel<<<grid, kWideThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w),
        static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
        static_cast<const T*>(a.g), static_cast<T*>(a.out), a.n_rows, a.h);
  }
  return static_cast<int>(cudaGetLastError());
}

// The route of a row of h elements: h itself for a vector instantiation
// (every pointer 16-byte aligned), 0 for the generic route (h <= 8192), 1
// for the wide route (h > 8192), -1 for none (h <= 0).
int route(int h, bool aligned) {
  if (h <= 0) return -1;
  if (aligned && (h == 768 || h == 2048 || h == 4096)) return h;
  if (h <= kGenericThreads * kGenericMaxItems) return 0;
  return 1;
}

template <bool kFwd, typename T, typename TW>
int dispatch(const Args& a, bool aligned) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  switch (route(a.h, aligned)) {
    case 768:
      return launch<kFwd, T, TW, kVec, kThreads768,
                    768 / kVec / kThreads768, kRows768, false>(a);
    case 2048:
      return launch<kFwd, T, TW, kVec, kThreads2048,
                    2048 / kVec / kThreads2048, 1, false>(a);
    case 4096:
      return launch<kFwd, T, TW, kVec, kThreads4096,
                    4096 / kVec / kThreads4096, 1, false>(a);
    case 0: {
      const int items = (a.h + kGenericThreads - 1) / kGenericThreads;
      if (items <= 1) return launch_generic<kFwd, T, TW, 1>(a);
      if (items <= 2) return launch_generic<kFwd, T, TW, 2>(a);
      if (items <= 4) return launch_generic<kFwd, T, TW, 4>(a);
      if (items <= 8) return launch_generic<kFwd, T, TW, 8>(a);
      if (items <= 16) return launch_generic<kFwd, T, TW, 16>(a);
      return launch_generic<kFwd, T, TW, kGenericMaxItems>(a);
    }
    case 1:
      return launch_wide<kFwd, T, TW>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kFwd>
int dispatch_dtypes(const Args& a, int x_dtype, int w_dtype, bool aligned) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0) return dispatch<kFwd, float, float>(a, aligned);
  if (x_dtype == 0 && w_dtype == 1) return dispatch<kFwd, float, bf16>(a, aligned);
  if (x_dtype == 1 && w_dtype == 0) return dispatch<kFwd, bf16, float>(a, aligned);
  if (x_dtype == 1 && w_dtype == 1) return dispatch<kFwd, bf16, bf16>(a, aligned);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

}  // namespace

// The route a call with rows of h elements takes: h (768, 2048 or 4096:
// the vector route) when `aligned` (every pointer of the call 16-byte
// aligned), 0 for the generic route (h <= 8192), 1 for the wide route (h >
// 8192), -1 when none takes it (h <= 0).
extern "C" int ln_route(int h, int aligned) { return route(h, aligned != 0); }

// dtype codes: 0 = float32, 1 = bfloat16 (x/y/g/dx share `x_dtype`, w/b
// share `w_dtype`).  Each returns cudaGetLastError() after its launch (0
// on success); the launch is asynchronous on `stream`.
extern "C" int ln_forward(const void* x, const void* w, const void* b, void* y,
                          void* mean, void* rstd, int n_rows, int h, float eps,
                          int x_dtype, int w_dtype, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  Args a{x, w, b, nullptr, nullptr, nullptr, y, mean, rstd, n_rows, h, eps,
         static_cast<cudaStream_t>(stream)};
  return dispatch_dtypes<true>(a, x_dtype, w_dtype, aligned16({x, w, b, y}));
}

extern "C" int ln_backward_dx(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* g, void* dx,
                              int n_rows, int h, int x_dtype, int w_dtype,
                              void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  Args a{x, w, nullptr, mean, rstd, g, dx, nullptr, nullptr, n_rows, h, 0.f,
         static_cast<cudaStream_t>(stream)};
  return dispatch_dtypes<false>(a, x_dtype, w_dtype, aligned16({x, w, g, dx}));
}
