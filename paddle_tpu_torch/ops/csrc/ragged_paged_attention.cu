// Ragged paged attention for Hopper (sm_90a): ONE launch attends a whole
// mixed prefill/decode serving batch over the shared paged KV pools.
//
// Replaces the TPU kernel `_ragged_kernel`, launched by `_ragged_pallas`
// in paddle_tpu/ops/pallas/ragged_paged_attention.py, and computes exactly
// what `ragged_paged_attention_ref` in
// paddle_tpu_torch/ops/ragged_paged_attention.py computes:
//
//   q [B, Q, nh, hd] (fp32 or bf16), k/v pages [nkv, P, ps, hd] (fp32 or
//   bf16), int32 kv_lens [B], q_lens [B], page_tables [B, ppseq].
//   Query row i < q_lens[b] of head h attends, for kv head g = h / (nh/nkv),
//   to positions t <= kv_lens[b] - q_lens[b] + i and t < kv_lens[b].
//   fp32 statistics and accumulation; output in q's dtype; rows
//   i >= q_lens[b] (and rows with nothing to attend to) are exactly 0.
//
// What bounds it: the bytes of the live K/V pages.  At decode (one query
// row per sequence) every K/V element read feeds one multiply-add per
// query head sharing it, far below the card's ~20 fp32 operations per
// byte, so the least time is the live pages over the memory rate.
//
// Design.  The TPU kernel walks a static (B, ppseq) grid in order and
// carries the online-softmax state in VMEM across grid steps; Hopper
// runs blocks in parallel and in no order, so here the page walk is a
// loop inside the block:
//   * grid (ceil(n_rep*Q / R), nkv, B): a block owns R query rows of one
//     kv head of one sequence; rows are ordered (query index, head in the
//     GQA group), so the R rows share the kv head and the block's last
//     query position bounds its page loop;
//   * the block reads its own kv_len, q_len and page ids and loops ONLY
//     over live pages, p < ceil(min(kv_len, last_qpos + 1) / ps);
//   * each page's K and V tiles [ps, hd] are converted to fp32 once into
//     shared memory for all R warps (GQA costs no copy);
//   * one warp owns one query row: lanes split hd, the running max,
//     denominator and accumulator stay in registers, each slot's logit is
//     a warp-shuffle sum, and the online-softmax update only ever sees
//     attended slots (masked probabilities: a masked slot contributes 0,
//     never exp(0)), so a row with nothing to attend to ends at d == 0
//     and is written as exactly 0.
// Tensor cores (wgmma), TMA and split-K over the pages of long decode
// contexts are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;          // head_dim <= 256
constexpr float kMaskValue = -1e30f;    // the eager sdpa mask constant

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

// Copy one [ps, hd] page tile of k and v into shared memory as fp32:
// 16-byte vector loads where the tile is aligned, else element by element.
template <typename TKV>
__device__ __forceinline__ void load_page(const TKV* __restrict__ k,
                                          const TKV* __restrict__ v,
                                          float* __restrict__ sk,
                                          float* __restrict__ sv, int tile) {
  constexpr int kPerVec = 16 / sizeof(TKV);
  const bool aligned = ((reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                       tile % kPerVec == 0;
  if (aligned) {
    const uint4* k4 = reinterpret_cast<const uint4*>(k);
    const uint4* v4 = reinterpret_cast<const uint4*>(v);
    for (int j = threadIdx.x; j < tile / kPerVec; j += blockDim.x) {
      const uint4 kr = __ldg(k4 + j);
      const uint4 vr = __ldg(v4 + j);
      const TKV* ke = reinterpret_cast<const TKV*>(&kr);
      const TKV* ve = reinterpret_cast<const TKV*>(&vr);
#pragma unroll
      for (int e = 0; e < kPerVec; ++e) {
        sk[j * kPerVec + e] = to_float(ke[e]);
        sv[j * kPerVec + e] = to_float(ve[e]);
      }
    }
  } else {
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      sk[j] = to_float(k[j]);
      sv[j] = to_float(v[j]);
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(256)
ragged_paged_attention_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pages,
                              const TKV* __restrict__ v_pages,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ page_tables,
                              TQ* __restrict__ out, int q_width, int n_heads,
                              int n_kv, int n_pages, int page_size,
                              int head_dim, int pages_per_seq, float scale) {
  extern __shared__ float smem[];
  const int tile = page_size * head_dim;
  float* sk = smem;           // [page_size, head_dim]
  float* sv = smem + tile;    // [page_size, head_dim]

  const int n_rep = n_heads / n_kv;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_per_block = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.x * rows_per_block;
  const int row = row0 + warp;
  const int kv_len = kv_lens[b];
  const int q_len = q_lens[b];

  const int i = row / n_rep;                 // query index in the chunk
  const int h = g * n_rep + row % n_rep;     // query head
  const bool row_exists = row < n_rep * q_width;
  const bool live = row_exists && i < q_len;
  const int qpos = kv_len - q_len + i;
  // attended positions of this row: [0, attend_end)
  const int attend_end = min(kv_len, qpos + 1);

  // pages any row of the block attends: bounded by its last live row
  int n_live_pages = 0;
  if (row0 / n_rep < q_len) {
    const int i_last = min((row0 + rows_per_block - 1) / n_rep, q_len - 1);
    const int block_end = min(kv_len, kv_len - q_len + i_last + 1);
    n_live_pages = max(0, (block_end + page_size - 1) / page_size);
  }

  const int64_t row_off =
      ((static_cast<int64_t>(b) * q_width + i) * n_heads + h) * head_dim;
  float qr[kMaxPerLane];
  float acc[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int d = lane + k * kWarp;
    qr[k] = (live && d < head_dim) ? to_float(q[row_off + d]) : 0.f;
    acc[k] = 0.f;
  }
  float m = kMaskValue;
  float denom = 0.f;

  const int* table = page_tables + static_cast<int64_t>(b) * pages_per_seq;
  for (int p = 0; p < n_live_pages; ++p) {
    const int64_t base =
        (static_cast<int64_t>(g) * n_pages + table[p]) * tile;
    __syncthreads();          // every warp is done with the last page
    load_page(k_pages + base, v_pages + base, sk, sv, tile);
    __syncthreads();
    if (!live) continue;
    const int t_end = min(page_size, attend_end - p * page_size);
    for (int t = 0; t < t_end; ++t) {
      const float* kt = sk + t * head_dim;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        const int d = lane + k * kWarp;
        if (d < head_dim) dot = fmaf(qr[k], kt[d], dot);
      }
      const float s = warp_sum(dot) * scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float prob = expf(s - m_new);
      denom = denom * alpha + prob;
      const float* vt = sv + t * head_dim;
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        const int d = lane + k * kWarp;
        if (d < head_dim) acc[k] = fmaf(prob, vt[d], acc[k] * alpha);
      }
      m = m_new;
    }
  }

  if (!row_exists) return;
  const bool any = live && denom > 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int d = lane + k * kWarp;
    if (d < head_dim) out[row_off + d] = from_float<TQ>(any ? acc[k] / denom : 0.f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* kv_lens, const void* q_lens, const void* page_tables,
           void* out, int batch, int q_width, int n_heads, int n_kv,
           int n_pages, int page_size, int head_dim, int pages_per_seq,
           float scale, cudaStream_t stream) {
  const int n_rows = (n_heads / n_kv) * q_width;
  // 4 warps at least, so a one-row (decode) block still has 128 threads
  // loading each page tile
  const int warps = n_rows >= 8 ? 8 : 4;
  const dim3 grid((n_rows + warps - 1) / warps, n_kv, batch);
  const size_t smem = 2 * static_cast<size_t>(page_size) * head_dim * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ragged_paged_attention_kernel<TQ, TKV><<<grid, warps * kWarp, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<const int*>(page_tables),
      static_cast<TQ*>(out), q_width, n_heads, n_kv, n_pages, page_size,
      head_dim, pages_per_seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const void* kv_lens,
                           const void* q_lens, const void* page_tables,
                           void* out, int batch, int q_width, int n_heads,
                           int n_kv, int n_pages, int page_size, int head_dim,
                           int pages_per_seq, float scale, int q_dtype,
                           int kv_dtype, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim > kMaxPerLane * kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_ARGS q, k_pages, v_pages, kv_lens, q_lens, page_tables, out, batch, \
    q_width, n_heads, n_kv, n_pages, page_size, head_dim, pages_per_seq, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(RPA_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return launch<float, __nv_bfloat16>(RPA_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return launch<__nv_bfloat16, float>(RPA_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
#undef RPA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
