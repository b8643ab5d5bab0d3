// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against the paged KV pools of a decode batch.
//
// Replaces the TPU kernel that `paged_attention` in
// paddle_tpu/ops/paged_attention.py:71 reaches at :88-108 (the Pallas TPU
// kernel jax.experimental.pallas.ops.tpu.paged_attention, with q
// pre-scaled by 1/sqrt(hd) and zero-length rows set to 0 after it), and
// computes what `paged_attention_ref` in
// paddle_tpu_torch/ops/paged_attention.py computes:
//
//   q [B, nh, hd], k/v pages [nkv, P, ps, hd] (one dtype, fp32 or bf16),
//   int32 lengths [B] and page_indices [B, ppseq].  Head h attends, for kv
//   head g = h / (nh / nkv), to the positions t < lengths[b] of its
//   sequence; position t lives in page page_indices[b, t / ps] at slot
//   t % ps.  fp32 scores scaled by 1/sqrt(hd) inside the kernel, fp32
//   softmax and sums, the output in q's dtype; a zero-length row is
//   exactly 0.
//
// What bounds it: bytes.  Each K/V element of a live position feeds one
// multiply-add per query head sharing it (1 for MHA, nh/nkv for GQA), far
// below the card's operations per byte, so the least time is the live K/V
// rows over the memory rate.
//
// Design.  The TPU kernel walks a (B, nkv, page blocks) grid in order,
// copies `pages_per_compute_block` pages per step, carries the online
// softmax in VMEM across steps, and reads every page of the table, masking
// positions past the length.  Hopper runs blocks in parallel and in no
// order, so here the walk over a sequence is a loop inside one block:
//   * one block per (kv head, batch row) owns the nh/nkv query heads of
//     that kv head, so each K/V row is read once for all of them;
//   * the row's live page ids, ceil(length / ps) of them, are staged in
//     shared memory; table slots past them and positions at or past the
//     length are never read (no mask: nothing dead is loaded);
//   * the 8 warps stride over positions 0..length-1, 4 positions per warp
//     per step; a lane holds hd/32 consecutive elements of a row (one
//     16-byte load per row for fp32 at hd 128, 8 bytes for bf16), and each
//     score is a warp-shuffle sum;
//   * each warp keeps an fp32 online softmax per query head; the warps'
//     states are merged in shared memory in warp order, so the result does
//     not depend on timing.
// Splitting a row's pages over several blocks (long contexts at small
// B * nkv), tensor cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;            // positions per warp per step
constexpr float kNoScore = -1e30f;    // a warp's running max before any score

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

// PL consecutive elements at `p` as fp32, in vector loads as wide as the
// chunk allows (the caller keeps `p` aligned to the chunk's bytes, up to 16).
template <typename T, int PL>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&out)[PL]) {
  constexpr int kBytes = PL * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < PL; ++i) out[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < PL; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < PL; ++i) out[i] = to_float(p[i]);
  }
}

template <typename T, int PL, int MAXREP>
__global__ void __launch_bounds__(kWarps * kWarp)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ lengths,
                       const int* __restrict__ page_indices, T* __restrict__ out,
                       int n_heads, int n_kv, int n_pages, int page_size,
                       int head_dim, int pages_per_seq, float scale) {
  // [kWarps][n_rep][head_dim + 2] merge states, then the live page ids
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = n_heads / n_kv;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int stride = head_dim + 2;
  const int64_t q0 =
      (static_cast<int64_t>(b) * n_heads + static_cast<int64_t>(g) * n_rep) *
      head_dim;

  // positions past the table cannot exist; the plain version masks them
  const int n = min(lengths[b], pages_per_seq * page_size);
  if (n <= 0) {
    for (int i = threadIdx.x; i < n_rep * head_dim; i += blockDim.x)
      out[q0 + i] = from_float<T>(0.f);
    return;
  }
  int* s_pages = reinterpret_cast<int*>(smem + kWarps * n_rep * stride);
  const int live_pages = (n + page_size - 1) / page_size;
  for (int i = threadIdx.x; i < live_pages; i += blockDim.x)
    s_pages[i] = page_indices[static_cast<int64_t>(b) * pages_per_seq + i];

  const int d0 = lane * PL;
  const bool in = d0 < head_dim;    // head_dim % PL == 0: whole chunks
  float qr[MAXREP][PL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < PL; ++e)
      qr[r][e] = (in && r < n_rep) ? to_float(q[q0 + r * head_dim + d0 + e]) : 0.f;

  float m[MAXREP], l[MAXREP], acc[MAXREP][PL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = kNoScore;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < PL; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();   // the page ids are staged

  // kv head g's pool: [P, ps, hd]
  const int64_t head0 =
      static_cast<int64_t>(g) * n_pages * page_size * head_dim;
  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kt[kUnroll][PL], vt[kUnroll][PL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < n && in) {
        const int64_t row =
            head0 + (static_cast<int64_t>(s_pages[t / page_size]) * page_size +
                     t % page_size) * head_dim + d0;
        load_chunk<T, PL>(k_pages + row, kt[u]);
        load_chunk<T, PL>(v_pages + row, vt[u]);
      } else {
#pragma unroll
        for (int e = 0; e < PL; ++e) {
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
        if (t0 + u < n) m_new = fmaxf(m_new, sc[u]);
      }
      const float alpha = expf(m[r] - m_new);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = t0 + u < n ? expf(sc[u] - m_new) : 0.f;
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

  // merge the warps' online-softmax states in warp order
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= n_rep) break;
    float* st = smem + (warp * n_rep + r) * stride;
    if (in) {
#pragma unroll
      for (int e = 0; e < PL; ++e) st[d0 + e] = acc[r][e];
    }
    if (lane == 0) {
      st[head_dim] = m[r];
      st[head_dim + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * head_dim; i += blockDim.x) {
    const int r = i / head_dim, d = i % head_dim;
    float mx = kNoScore;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[(w * n_rep + r) * stride + head_dim]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* st = smem + (w * n_rep + r) * stride;
      const float f = expf(st[head_dim] - mx);   // 0 for a warp with no position
      den = fmaf(st[head_dim + 1], f, den);
      num = fmaf(st[d], f, num);
    }
    out[q0 + i] = from_float<T>(num / den);
  }
}

template <typename T, int PL, int MAXREP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* lengths, const void* page_indices, void* out, int batch,
           int n_heads, int n_kv, int n_pages, int page_size, int head_dim,
           int pages_per_seq, float scale, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kWarps) * (n_heads / n_kv) * (head_dim + 2) *
          sizeof(float) +
      static_cast<size_t>(pages_per_seq) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, PL, MAXREP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_attention_kernel<T, PL, MAXREP>
      <<<dim3(n_kv, batch), kWarps * kWarp, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), static_cast<const int*>(lengths),
          static_cast<const int*>(page_indices), static_cast<T*>(out), n_heads,
          n_kv, n_pages, page_size, head_dim, pages_per_seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PL>
int by_rep(const void* q, const void* k, const void* v, const void* lengths,
           const void* pages, void* out, int batch, int n_heads, int n_kv,
           int n_pages, int ps, int hd, int ppseq, float scale, cudaStream_t s) {
  const int n_rep = n_heads / n_kv;
  if (n_rep == 1)
    return launch<T, PL, 1>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                            n_pages, ps, hd, ppseq, scale, s);
  if (n_rep <= 4)
    return launch<T, PL, 4>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                            n_pages, ps, hd, ppseq, scale, s);
  return launch<T, PL, 8>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                          n_pages, ps, hd, ppseq, scale, s);
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v,
                const void* lengths, const void* pages, void* out, int batch,
                int n_heads, int n_kv, int n_pages, int ps, int hd, int ppseq,
                float scale, cudaStream_t s) {
  if (hd <= 32)
    return by_rep<T, 1>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                        n_pages, ps, hd, ppseq, scale, s);
  if (hd <= 64)
    return by_rep<T, 2>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                        n_pages, ps, hd, ppseq, scale, s);
  if (hd <= 128)
    return by_rep<T, 4>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                        n_pages, ps, hd, ppseq, scale, s);
  return by_rep<T, 8>(q, k, v, lengths, pages, out, batch, n_heads, n_kv,
                      n_pages, ps, hd, ppseq, scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// q [batch, n_heads, head_dim]; k/v_pages [n_kv, n_pages, page_size,
// head_dim], 16-byte aligned; lengths int32 [batch]; page_indices int32
// [batch, pages_per_seq], every id below n_pages; out [batch, n_heads,
// head_dim].  All contiguous.  head_dim a multiple of 8 up to 256, at most
// 8 query heads per kv head.  Returns cudaGetLastError() after the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int pa_forward(const void* q, const void* k_pages,
                          const void* v_pages, const void* lengths,
                          const void* page_indices, void* out, int batch,
                          int n_heads, int n_kv, int n_pages, int page_size,
                          int head_dim, int pages_per_seq, float scale,
                          int dtype, void* stream) {
  if (batch <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > 8 ||
      head_dim <= 0 || head_dim > 8 * kWarp || head_dim % 8 != 0 ||
      page_size <= 0 || n_pages <= 0 || pages_per_seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(q, k_pages, v_pages, lengths, page_indices, out,
                              batch, n_heads, n_kv, n_pages, page_size, head_dim,
                              pages_per_seq, scale, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(q, k_pages, v_pages, lengths,
                                      page_indices, out, batch, n_heads, n_kv,
                                      n_pages, page_size, head_dim,
                                      pages_per_seq, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
