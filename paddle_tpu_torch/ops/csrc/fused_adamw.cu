// Fused AdamW update for Hopper (sm_90a): one pass over a parameter's
// flat storage updates the parameter, both moments and, for a bf16
// parameter trained on an fp32 master copy, the bf16 copy too.
//
// Replaces the TPU kernel `_adamw_kernel`, launched by `fused_adamw_update`
// in paddle_tpu/ops/pallas/fused_adamw.py.  It computes the unfused
// sequence of `Adam._adam_update` (paddle_tpu/optimizer/optimizers.py),
// which that kernel stands in for, step by step and in the same order:
// every multiply and add is rounded on its own (no fused multiply-add),
// so the plain torch sequence gives the same bits.  (The TPU kernel
// rounds `(1 - b2) * g * g` left to right; the sequence squares g first:
// at most one ulp of v apart.)
//
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * (g * g)
//   m_hat = m / (1 - b1p),  v_hat = v / (1 - b2p)
//   p = p * (1 - lr * wd)                      (only when wd != 0)
//   p = p - (lr * m_hat) / (sqrt(v_hat) + eps)
//
// in fp32.  lr, b1p and b2p are read from device memory (the optimizer
// keeps them as device scalars: no host read per parameter), the betas,
// eps and wd come by value.  m and v are fp32; p is fp32 (a master copy
// or an fp32 parameter) or bf16; g is fp32 or bf16.
//
// What bounds it: bytes.  With an fp32 master and a bf16 gradient each
// element moves 28 bytes (master r/w, g read, m r/w, v r/w, bf16 copy
// write) for ~15 operations.
//
// Design.  The TPU kernel pads the parameter to (rows, 128) lanes and
// walks a grid of row blocks.  Here a grid-stride loop walks the flat
// storage four elements per thread per step, with 16-byte loads and
// stores of fp32 data (8-byte ones of bf16) when every pointer is
// aligned for them; the tail and any misaligned storage go element by
// element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// four consecutive elements, as one vector access
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, float out[4]) {
  const typename Vec4<T>::type raw = *reinterpret_cast<const typename Vec4<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = to_float(e[k]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float in[4]) {
  typename Vec4<T>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = from_float<T>(in[k]);
  *reinterpret_cast<typename Vec4<T>::type*>(p) = raw;
}

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

struct Scalars {
  float lr, one_minus_b1p, one_minus_b2p, decay;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m, s.one_minus_b1p);
  const float v_hat = __fdiv_rn(v, s.one_minus_b2p);
  if (h.wd != 0.f) p = __fmul_rn(p, s.decay);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat),
                             __fadd_rn(__fsqrt_rn(v_hat), h.eps)));
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(256)
adamw_kernel(TP* __restrict__ p, const TG* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, __nv_bfloat16* __restrict__ p_low,
             const float* __restrict__ lr, const float* __restrict__ b1p,
             const float* __restrict__ b2p, int64_t n, Hyper h, bool vec) {
  Scalars s;
  s.lr = *lr;
  s.one_minus_b1p = __fsub_rn(1.f, *b1p);
  s.one_minus_b2p = __fsub_rn(1.f, *b2p);
  s.decay = __fsub_rn(1.f, __fmul_rn(s.lr, h.wd));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const int64_t e = 4 * i;
      float pf[4], gf[4], mf[4], vf[4];
      load4(p + e, pf);
      load4(g + e, gf);
      load4(m + e, mf);
      load4(v + e, vf);
#pragma unroll
      for (int k = 0; k < 4; ++k) update(pf[k], gf[k], mf[k], vf[k], h, s);
      store4(p + e, pf);
      store4(m + e, mf);
      store4(v + e, vf);
      if (p_low != nullptr) store4(p_low + e, pf);
    }
    done = 4 * n4;
  }
  for (int64_t e = done + tid; e < n; e += stride) {
    float pf = to_float(p[e]);
    float mf = m[e];
    float vf = v[e];
    update(pf, to_float(g[e]), mf, vf, h, s);
    p[e] = from_float<TP>(pf);
    m[e] = mf;
    v[e] = vf;
    if (p_low != nullptr) p_low[e] = __float2bfloat16(pf);
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename TP, typename TG>
int launch(void* p, const void* g, void* m, void* v, void* p_low, const void* lr,
           const void* b1p, const void* b2p, int64_t n, const Hyper& h,
           cudaStream_t stream) {
  const bool vec = aligned(p, 4 * sizeof(TP)) && aligned(g, 4 * sizeof(TG)) &&
                   aligned(m, 16) && aligned(v, 16) &&
                   (p_low == nullptr || aligned(p_low, 8));
  const int threads = 256;
  const int64_t work = vec ? (n + 3) / 4 : n;
  // enough blocks to fill the card several times over; the loop strides
  const int64_t blocks = work < 1 ? 1 : (work + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  adamw_kernel<TP, TG><<<grid, threads, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<__nv_bfloat16*>(p_low),
      static_cast<const float*>(lr), static_cast<const float*>(b1p),
      static_cast<const float*>(b2p), n, h, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `p_low` (bf16, may be null)
// receives the updated p rounded to bf16.  `one_minus_b1/b2` are computed
// by the caller in double and rounded to float, as a Python float
// constant is.  Returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int adamw_update(void* p, const void* g, void* m, void* v,
                            void* p_low, const void* lr, const void* b1p,
                            const void* b2p, long long n, float b1, float b2,
                            float one_minus_b1, float one_minus_b2, float eps,
                            float wd, int p_dtype, int g_dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  const Hyper h{b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADAMW_ARGS p, g, m, v, p_low, lr, b1p, b2p, n, h, s
  if (p_dtype == 0 && g_dtype == 0) return launch<float, float>(ADAMW_ARGS);
  if (p_dtype == 0 && g_dtype == 1) return launch<float, __nv_bfloat16>(ADAMW_ARGS);
  if (p_dtype == 1 && g_dtype == 0) return launch<__nv_bfloat16, float>(ADAMW_ARGS);
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(ADAMW_ARGS);
#undef ADAMW_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
