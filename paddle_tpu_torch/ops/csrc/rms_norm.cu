// RMSNorm forward and dx backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
//   * K4a `_fwd_kernel`, launched by `_fwd`:
//     y = x * r * w over the last axis, r = rsqrt(mean(x^2) + eps), and
//     the fp32 row `r` that the backward reuses;
//   * K4b `_bwd_kernel`, launched by `_bwd_dx`:
//     dx = r * wg - r^3 * x * mean(x * wg), wg = g * w.
// dw is a cross-row reduction left to the caller (torch), as the JAX
// package leaves it to XLA.  Every sum and product is fp32, in the TPU
// kernel's order; x, y, g and dx share one dtype (fp32 or bf16), w
// another, and y and dx are rounded once to their dtype.
//
// What bounds it: bytes.  Each element is read once and written once with
// a handful of operations (x, y: 8 B/elem in fp32; x, g, dx: 12 B/elem),
// far below the card's ~20 fp32 operations per byte of memory traffic.
//
// Design.  The TPU kernel normalises a (256, H) row block held in VMEM;
// here one block of threads owns one row.  Each thread moves 16 bytes at
// a time (4 fp32 or 8 bf16 values; scalars when H or the base address
// does not allow it), consecutive threads on consecutive 16-byte words,
// so every access is coalesced.  The first pass sums the row's squares
// (fp32, warp shuffles, then one value per warp in shared memory); the
// second pass reads the row again and writes the result.  A row is at
// most a few tens of KB and the block has just read it, so the second
// read comes from L1/L2, not from device memory, and the kernel needs no
// shared-memory row buffer: it takes any H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

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

// The unsigned type of `Bytes` bytes, for one load or store of a vector.
template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// N consecutive values of T from `p` (aligned to N * sizeof(T) bytes) as
// fp32, in one load.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  using R = typename Raw<N * sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = to_float(e[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  using R = typename Raw<N * sizeof(T)>::type;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) e[k] = from_float<T>(v[k]);
  *reinterpret_cast<R*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x / kWarp;
  return warp_sum(lane < n_warps ? red[lane] : 0.f);
}

// N: values per thread per access (16 bytes of T, or 1).
template <typename T, typename TW, int N>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ r_out, int h,
                    float eps) {
  __shared__ float red[kWarp];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  const T* xr = x + off;
  float ss = 0.f;
  for (int j = threadIdx.x * N; j < h; j += blockDim.x * N) {
    float v[N];
    load<T, N>(xr + j, v);
#pragma unroll
    for (int k = 0; k < N; ++k) ss += v[k] * v[k];
  }
  const float r = rsqrtf(block_sum(ss, red) / h + eps);
  T* yr = y + off;
  for (int j = threadIdx.x * N; j < h; j += blockDim.x * N) {
    float v[N];
    load<T, N>(xr + j, v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v[k] * r * to_float(w[j + k]);
    store<T, N>(yr + j, v);
  }
  if (threadIdx.x == 0) r_out[blockIdx.x] = r;
}

template <typename T, typename TW, int N>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_dx_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                       const float* __restrict__ r_in,
                       const T* __restrict__ g, T* __restrict__ dx, int h) {
  __shared__ float red[kWarp];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  const T* xr = x + off;
  const T* gr = g + off;
  float s = 0.f;
  for (int j = threadIdx.x * N; j < h; j += blockDim.x * N) {
    float xv[N], gv[N];
    load<T, N>(xr + j, xv);
    load<T, N>(gr + j, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) s += xv[k] * (gv[k] * to_float(w[j + k]));
  }
  const float mu = block_sum(s, red) / h;
  const float r = r_in[blockIdx.x];
  const float r3 = r * r * r;
  T* dr = dx + off;
  for (int j = threadIdx.x * N; j < h; j += blockDim.x * N) {
    float xv[N], gv[N];
    load<T, N>(xr + j, xv);
    load<T, N>(gr + j, gv);
#pragma unroll
    for (int k = 0; k < N; ++k)
      gv[k] = r * (gv[k] * to_float(w[j + k])) - r3 * xv[k] * mu;
    store<T, N>(dr + j, gv);
  }
}

int threads_for(int h) { return h >= 2048 ? 256 : (h >= 512 ? 128 : 64); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, typename TW>
int launch_fwd(const void* x, const void* w, void* y, void* r, int n_rows,
               int h, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int threads = threads_for(h);
  if (h % kVec == 0 && aligned16(x) && aligned16(y))
    rms_norm_fwd_kernel<T, TW, kVec><<<n_rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<T*>(y), static_cast<float*>(r), h, eps);
  else
    rms_norm_fwd_kernel<T, TW, 1><<<n_rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<T*>(y), static_cast<float*>(r), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_bwd(const void* x, const void* w, const void* r, const void* g,
               void* dx, int n_rows, int h, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int threads = threads_for(h);
  if (h % kVec == 0 && aligned16(x) && aligned16(g) && aligned16(dx))
    rms_norm_bwd_dx_kernel<T, TW, kVec><<<n_rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<const float*>(r), static_cast<const T*>(g),
        static_cast<T*>(dx), h);
  else
    rms_norm_bwd_dx_kernel<T, TW, 1><<<n_rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<const float*>(r), static_cast<const T*>(g),
        static_cast<T*>(dx), h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x/y/g/dx share `x_dtype`, w has
// `w_dtype`); `r` is fp32 [n_rows].  Each returns cudaGetLastError() after
// its launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int rms_forward(const void* x, const void* w, void* y, void* r,
                           int n_rows, int h, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RMS_ARGS x, w, y, r, n_rows, h, eps, s
  if (x_dtype == 0 && w_dtype == 0) return launch_fwd<float, float>(RMS_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return launch_fwd<float, __nv_bfloat16>(RMS_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return launch_fwd<__nv_bfloat16, float>(RMS_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(RMS_ARGS);
#undef RMS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rms_backward_dx(const void* x, const void* w, const void* r,
                               const void* g, void* dx, int n_rows, int h,
                               int x_dtype, int w_dtype, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RMS_ARGS x, w, r, g, dx, n_rows, h, s
  if (x_dtype == 0 && w_dtype == 0) return launch_bwd<float, float>(RMS_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return launch_bwd<float, __nv_bfloat16>(RMS_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return launch_bwd<__nv_bfloat16, float>(RMS_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(RMS_ARGS);
#undef RMS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
