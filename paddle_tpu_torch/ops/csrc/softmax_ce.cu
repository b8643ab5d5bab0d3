// Softmax cross-entropy forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/softmax_ce.py:
//   * K8a `_fwd_kernel`, launched by `_fwd`: per row of x [N, V]
//     lse = max + log sum exp(x - max) and loss = lse - x[label], 0 where
//     label == ignore_index.  A label outside [0, V) that is not ignored
//     picks no column (the Pallas one-hot matches none): loss = lse.
//     Writes the fp32 loss and lse, [N] each.  An ignored row is not
//     read: its loss and lse are written as 0 (the backward reads no lse
//     of an ignored row);
//   * K8b `_bwd_kernel`, launched by `_bwd`:
//     dx = (exp(x - lse) - onehot(label)) * g, 0 on ignored rows, in x's
//     dtype.
// x is fp32 or bf16, read as fp32; every sum is fp32.
//
// What bounds it: bytes.  The forward reads x once (4 or 2 B/elem) with
// one exp per element; the backward reads x and writes dx.  Both sit far
// below the card's ~20 fp32 operations per byte of memory traffic.
//
// Design.  The TPU kernel holds a (16, V) row block in VMEM and makes two
// passes over it (max, then the exp sum) plus an iota one-hot contraction
// for the picked logit.  Here one block of threads owns one row in the
// forward and reads it once (an ignored row not at all): each thread
// keeps an online (max, sum) over its strided columns, taking a chunk of
// kUnroll loads at a time so that the chunk's max rescales the sum once
// and every element costs one exp.
// The partial (max, sum) pairs merge by warp shuffles, then across warps
// in shared memory.  One thread reads x[row, label] directly: a single
// scalar load, so no one-hot is needed.  The backward is elementwise, a
// grid over (row, chunk of columns); an ignored row is written as zeros
// without reading x.
//
// Rows start at row * V elements; with an odd V (50265) no row start is
// 16-byte aligned, so every load and store is a scalar one, consecutive
// threads on consecutive columns (coalesced).  Offsets are 64-bit:
// row * V passes 2^31 at N * V > 2^31 (row 42722 at V = 50265).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;                       // loads in flight a thread
constexpr int kChunk = kThreads * kUnroll;       // backward columns a block

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

// (m, s) <- the (max, sum of exp(. - max)) of the union of two partials.
// An empty partial is (-inf, 0) and contributes nothing.
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float mx = fmaxf(m, om);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + os * expf(om - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                      float* __restrict__ loss, float* __restrict__ lse_out,
                      int v, int ignore_index) {
  __shared__ float red_m[kThreads / kWarp];
  __shared__ float red_s[kThreads / kWarp];
  const int64_t row = blockIdx.x;
  const int lab = labels[row];
  if (lab == ignore_index) {
    if (threadIdx.x == 0) {
      loss[row] = 0.f;
      lse_out[row] = 0.f;
    }
    return;
  }
  const T* xr = x + row * static_cast<int64_t>(v);
  float m = -INFINITY, s = 0.f;
  for (int base = 0; base < v; base += kChunk) {
    float vals[kUnroll];
    float cm = -INFINITY;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = base + k * kThreads + threadIdx.x;
      vals[k] = j < v ? to_float(xr[j]) : -INFINITY;
      cm = fmaxf(cm, vals[k]);
    }
    if (cm > m) {
      s *= expf(m - cm);
      m = cm;
    }
    if (m != -INFINITY) {               // else every value so far is -inf
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) s += expf(vals[k] - m);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, om, os);
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / kWarp; ++w) merge(m, s, red_m[w], red_s[w]);
    const float lse = m + logf(s);
    const float picked = (lab >= 0 && lab < v) ? to_float(xr[lab]) : 0.f;
    loss[row] = lse - picked;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                      const float* __restrict__ lse, const float* __restrict__ g,
                      T* __restrict__ dx, int v, int ignore_index) {
  const int64_t row = blockIdx.x;
  const int64_t off = row * static_cast<int64_t>(v);
  const int col0 = blockIdx.y * kChunk + threadIdx.x;
  const int lab = labels[row];
  if (lab == ignore_index) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = col0 + k * kThreads;
      if (j < v) dx[off + j] = from_float<T>(0.f);
    }
    return;
  }
  const float l = lse[row];
  const float gr = g[row];
  float vals[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = col0 + k * kThreads;
    vals[k] = j < v ? to_float(x[off + j]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = col0 + k * kThreads;
    if (j < v)
      dx[off + j] = from_float<T>((expf(vals[k] - l) - (j == lab ? 1.f : 0.f)) * gr);
  }
}

template <typename T>
int launch_fwd(const void* x, const void* labels, void* loss, void* lse,
               int n_rows, int v, int ignore_index, cudaStream_t s) {
  softmax_ce_fwd_kernel<T><<<n_rows, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), v, ignore_index);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* labels, const void* lse,
               const void* g, void* dx, int n_rows, int v, int ignore_index,
               cudaStream_t s) {
  const dim3 grid(n_rows, (v + kChunk - 1) / kChunk);
  softmax_ce_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), v, ignore_index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code of x (and dx): 0 = float32, 1 = bfloat16.  labels are int32
// [n_rows]; loss, lse and g fp32 [n_rows].  Each returns
// cudaGetLastError() after its launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int softmax_ce_forward(const void* x, const void* labels, void* loss,
                                  void* lse, int n_rows, int v,
                                  int ignore_index, int x_dtype, void* stream) {
  if (n_rows <= 0 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_fwd<float>(x, labels, loss, lse, n_rows, v, ignore_index, s);
  if (x_dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, labels, loss, lse, n_rows, v,
                                     ignore_index, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int softmax_ce_backward(const void* x, const void* labels,
                                   const void* lse, const void* g, void* dx,
                                   int n_rows, int v, int ignore_index,
                                   int x_dtype, void* stream) {
  if (n_rows <= 0 || v <= 0 || (v + kChunk - 1) / kChunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_bwd<float>(x, labels, lse, g, dx, n_rows, v, ignore_index, s);
  if (x_dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, labels, lse, g, dx, n_rows, v,
                                     ignore_index, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
