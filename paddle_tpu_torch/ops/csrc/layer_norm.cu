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
// Design.  The TPU kernel normalises a (256, H) row block held in VMEM;
// here one block of threads owns one row.  The row is staged once in
// shared memory as fp32, so the two-pass mean and variance (and the two
// backward means) read it from there, not from device memory again.
// Each reduction is a warp-shuffle sum followed by a sum over the
// block's warps in shared memory.  Consecutive threads touch consecutive
// elements, so every device-memory access is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block; every thread gets the result.  `red` holds
// one float per warp; the leading barrier lets a caller reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x / kWarp;
  return warp_sum(lane < n_warps ? red[lane] : 0.f);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(256)
layer_norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                      const TW* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int h, float eps) {
  extern __shared__ float row[];            // [h] fp32 copy of the row
  __shared__ float red[kWarp];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  float s = 0.f;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float v = to_float(x[off + j]);
    row[j] = v;
    s += v;
  }
  const float m = block_sum(s, red) / h;
  // each thread re-reads only the elements it wrote: no barrier needed
  float ss = 0.f;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float d = row[j] - m;
    ss += d * d;
  }
  const float r = rsqrtf(block_sum(ss, red) / h + eps);
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    y[off + j] = from_float<T>((row[j] - m) * r * to_float(w[j]) + to_float(b[j]));
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = m;
    rstd[blockIdx.x] = r;
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(256)
layer_norm_bwd_dx_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ g, T* __restrict__ dx, int h) {
  extern __shared__ float buf[];            // xhat [h], then wg [h]
  __shared__ float red[kWarp];
  float* xhat = buf;
  float* wg = buf + h;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  const float m = mean[blockIdx.x];
  const float r = rstd[blockIdx.x];
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float xh = (to_float(x[off + j]) - m) * r;
    const float gw = to_float(g[off + j]) * to_float(w[j]);
    xhat[j] = xh;
    wg[j] = gw;
    s1 += gw;
    s2 += gw * xh;
  }
  const float mu1 = block_sum(s1, red) / h;
  const float mu2 = block_sum(s2, red) / h;
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    dx[off + j] = from_float<T>(r * (wg[j] - mu1 - xhat[j] * mu2));
}

int threads_for(int h) { return h >= 256 ? 256 : (h >= 128 ? 128 : 64); }

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, typename TW>
int launch_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
               void* rstd, int n_rows, int h, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  if (const int err = set_smem(layer_norm_fwd_kernel<T, TW>, smem)) return err;
  layer_norm_fwd_kernel<T, TW><<<n_rows, threads_for(h), smem, s>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_bwd(const void* x, const void* w, const void* mean, const void* rstd,
               const void* g, void* dx, int n_rows, int h, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(h) * sizeof(float);
  if (const int err = set_smem(layer_norm_bwd_dx_kernel<T, TW>, smem)) return err;
  layer_norm_bwd_dx_kernel<T, TW><<<n_rows, threads_for(h), smem, s>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x/y/g/dx share `x_dtype`, w/b
// share `w_dtype`).  Each returns cudaGetLastError() after its launch (0
// on success); the launch is asynchronous on `stream`.
extern "C" int ln_forward(const void* x, const void* w, const void* b, void* y,
                          void* mean, void* rstd, int n_rows, int h, float eps,
                          int x_dtype, int w_dtype, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_ARGS x, w, b, y, mean, rstd, n_rows, h, eps, s
  if (x_dtype == 0 && w_dtype == 0) return launch_fwd<float, float>(LN_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return launch_fwd<float, __nv_bfloat16>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return launch_fwd<__nv_bfloat16, float>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(LN_ARGS);
#undef LN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ln_backward_dx(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* g, void* dx,
                              int n_rows, int h, int x_dtype, int w_dtype,
                              void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_ARGS x, w, mean, rstd, g, dx, n_rows, h, s
  if (x_dtype == 0 && w_dtype == 0) return launch_bwd<float, float>(LN_ARGS);
  if (x_dtype == 0 && w_dtype == 1) return launch_bwd<float, __nv_bfloat16>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 0) return launch_bwd<__nv_bfloat16, float>(LN_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(LN_ARGS);
#undef LN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
