// Rotary position embedding for Hopper (sm_90a).
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/rope.py: K5
// `_rope_kernel`, launched by `_rope_call`, out = x * cos + rot(x) * sin
// with
//   interleaved: rot[2i] = -x[2i+1], rot[2i+1] = x[2i];
//   neox:        rot[i]  = -x[i+D/2], rot[i+D/2] = x[i].
// The backward is the same kernel with sin negated (`sin_sign` = -1): with
// tables that repeat each frequency across its rotated pair, that is the
// rotation's transpose.  x and out share one dtype (fp32 or bf16), the
// tables another; every product and sum is fp32 and out is rounded once.
//
// What bounds it: bytes.  Two multiplies and an add per element read and
// written once (4 B/elem in bf16), far below the card's operations per
// byte.
//
// Design.  The TPU kernel works on [B*H, S, D] blocks, which the JAX
// route makes by transposing q/k there and back; those two copies are the
// TPU's tiling need.  Here x is read in its [B, S, H, D] layout through
// its strides (the last axis contiguous), so a gradient that arrives as a
// transposed view is read in place, and out is written contiguous
// [B, S, H, D].  One block owns one (batch, position): it stages that
// position's cos and sin rows once in shared memory as fp32 (sin times
// `sin_sign`), then its threads walk every head's pairs, one pair per
// thread per step.  Consecutive threads take consecutive pairs, so a warp
// reads and writes contiguous runs of each head's row.  out is a new
// tensor: autograd needs x untouched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// x: [B, S, H, D] with strides (sxb, sxs, sxh, 1) in elements; cos, sin:
// [S, D] contiguous; out: [B, S, H, D] contiguous.  grid (S, B).
template <typename T, typename TT, bool kNeox>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const TT* __restrict__ cos_t,
            const TT* __restrict__ sin_t, T* __restrict__ out, int s_len,
            int n_heads, int d, int64_t sxb, int64_t sxs, int64_t sxh,
            float sin_sign) {
  extern __shared__ float tab[];            // cos [d], then sign * sin [d]
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t trow = static_cast<int64_t>(s) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    tab[j] = to_float(cos_t[trow + j]);
    tab[d + j] = sin_sign * to_float(sin_t[trow + j]);
  }
  __syncthreads();
  const int half = d / 2;
  const int n_pairs = n_heads * half;
  const T* xs = x + b * sxb + s * sxs;
  T* os = out + (static_cast<int64_t>(b) * s_len + s) * n_heads * d;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int head = p / half;
    const int i = p - head * half;
    const int j0 = kNeox ? i : 2 * i;
    const int j1 = kNeox ? i + half : 2 * i + 1;
    const T* xh = xs + head * sxh;
    const float x0 = to_float(xh[j0]);
    const float x1 = to_float(xh[j1]);
    T* oh = os + head * d;
    oh[j0] = from_float<T>(x0 * tab[j0] + (-x1) * tab[d + j0]);
    oh[j1] = from_float<T>(x1 * tab[j1] + x0 * tab[d + j1]);
  }
}

template <typename T, typename TT>
int launch(const void* x, const void* cos_t, const void* sin_t, void* out,
           int b, int s_len, int n_heads, int d, int64_t sxb, int64_t sxs,
           int64_t sxh, int neox, float sin_sign, cudaStream_t st) {
  const dim3 grid(s_len, b);
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  const int threads = n_heads * (d / 2) >= kThreads ? kThreads : 64;
#define ROPE_ARGS                                                         \
  static_cast<const T*>(x), static_cast<const TT*>(cos_t),               \
      static_cast<const TT*>(sin_t), static_cast<T*>(out), s_len, n_heads, \
      d, sxb, sxs, sxh, sin_sign
  if (neox)
    rope_kernel<T, TT, true><<<grid, threads, smem, st>>>(ROPE_ARGS);
  else
    rope_kernel<T, TT, false><<<grid, threads, smem, st>>>(ROPE_ARGS);
#undef ROPE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x/out share `x_dtype`, cos/sin
// share `t_dtype`).  `d` is even and at most 6144 (the two fp32 table
// rows fit the 48 KB a block gets without opting in).  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int rope_forward(const void* x, const void* cos_t,
                            const void* sin_t, void* out, int b, int s_len,
                            int n_heads, int d, int64_t sxb, int64_t sxs,
                            int64_t sxh, int neox, float sin_sign,
                            int x_dtype, int t_dtype, void* stream) {
  if (b <= 0 || s_len <= 0 || n_heads <= 0 || d <= 0 || d % 2 != 0 ||
      d > 6144 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ROPE_ARGS x, cos_t, sin_t, out, b, s_len, n_heads, d, sxb, sxs, sxh, \
                  neox, sin_sign, st
  if (x_dtype == 0 && t_dtype == 0) return launch<float, float>(ROPE_ARGS);
  if (x_dtype == 0 && t_dtype == 1) return launch<float, __nv_bfloat16>(ROPE_ARGS);
  if (x_dtype == 1 && t_dtype == 0) return launch<__nv_bfloat16, float>(ROPE_ARGS);
  if (x_dtype == 1 && t_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(ROPE_ARGS);
#undef ROPE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
