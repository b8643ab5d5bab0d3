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
// What bounds it: at decode, the bytes of the live K/V pages.  One query
// row per sequence makes every K/V element read feed one multiply-add per
// query head sharing it, far below the card's ~20 fp32 operations per
// byte, so the least time is the live pages over the memory rate.  A long
// prefill chunk does ~hd operations per key per query row: there the
// operations bound it, and CUDA cores reach only the fp32 rate.
//
// Design.  The TPU kernel walks a static (B, ppseq) grid in order and
// carries the online-softmax state in VMEM across grid steps; Hopper
// runs blocks in parallel and in no order:
//   * grid (ceil(n_rep*Q / 8), nkv, B * splits): a block owns up to 8
//     query rows of one kv head of one sequence (a row group; rows are
//     ordered (query index, head in the GQA group), so they share the kv
//     head, and the live rows are the group's first ones) and one of
//     `splits` contiguous runs of the group's live pages (those its last
//     live row attends), ceil(live / splits) pages each.  The wrapper
//     fixes `splits` from the static shapes so that the grid holds about
//     two blocks per SM; a block whose run starts past the live pages
//     reads nothing and publishes an empty state (m = -1e30, l = 0,
//     acc = 0).
//   * a block with at most 4 live rows (decode: one row per MHA block,
//     n_rep per GQA block) lets its 8 warps stride over the run's
//     positions, 4 positions per warp per step.  A lane reads 16
//     consecutive bytes of a K/V row straight from the pool (hd/32
//     elements where that is more), so at hd 128 a bf16 row takes half a
//     warp and the warp's two lane groups take different positions: the
//     same loads and shuffles per byte as fp32.  Each lane group keeps
//     its own fp32 online softmax for every live row; the groups' states
//     merge in group order.
//   * a block with more live rows (prefill chunks) gives each its own
//     warp; the run's pages are staged in their own dtype through a
//     two-stage ring of 16-byte cp.async copies (one stage when two do not
//     fit in shared memory), converted to fp32 in registers, and each warp
//     walks its row's positions of the page, 4 per step.
//   * masked probabilities: a position a row does not attend contributes
//     exactly 0 (never exp(0)), and only positions below the row's end are
//     ever loaded, so dead pages and slots are never read.
//   * splits > 1: each block writes its rows' (m, l, acc[hd]) to an fp32
//     scratch, and the row group's last block to arrive (an atomic counter
//     per row group, reset by that block) merges the splits in split
//     order and writes the output: one launch, and a result that does not
//     depend on the order the blocks ran in.  A row whose splits are all
//     empty merges to l = 0 and is written as exactly 0.
// Later work: tensor cores (mma / wgmma) for long prefill chunks, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 8;               // query rows per block (row group)
constexpr int kPosRows = 4;            // at most this many live rows: warps over positions
constexpr int kUnroll = 4;             // positions per warp per step
constexpr float kMaskValue = -1e30f;   // the eager sdpa mask constant

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

// sum over the kG lanes of an aligned lane group (kG = 32: the warp)
template <int kG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// PL consecutive elements d0 .. d0 + PL - 1 of a row at `p` (d0 applied)
// as fp32, 0 past hd.  `vec`: hd % PL == 0 and the row is aligned to the
// chunk's bytes, so the chunk is whole and read in vector loads; a pool
// row is read through the read-only path, a staged one from shared memory.
template <bool kPool, typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  if constexpr (kPool) return __ldg(reinterpret_cast<const uint4*>(p));
  else return *reinterpret_cast<const uint4*>(p);
}
template <bool kPool, typename T, int PL>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int d0,
                                           int hd, bool vec, float (&out)[PL]) {
  constexpr int kBytes = PL * static_cast<int>(sizeof(T));
  if (vec) {
    if constexpr (kBytes % 16 == 0) {
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const uint4 u = load16<kPool>(p + c * kPer);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(e[i]);
      }
      return;
    } else if constexpr (kBytes == 8) {
      const uint2 u = kPool ? __ldg(reinterpret_cast<const uint2*>(p))
                            : *reinterpret_cast<const uint2*>(p);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PL; ++i) out[i] = to_float(e[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < PL; ++i) out[i] = d0 + i < hd ? to_float(p[i]) : 0.f;
}

struct Dims {
  int q_width, n_heads, n_kv, n_pages, page_size, head_dim, pages_per_seq;
  int n_splits;
  int stages;   // the prefill ring: 2, or 1 where two do not fit
  int vec;      // whole 16-byte lane chunks: hd % kPL == 0, hd * sizeof(kv) % 16 == 0,
                // pools 16-byte aligned
  float scale;
};

// One online-softmax step of one row over up to U positions: scores sc[u]
// (valid where ok[u]) and their V chunks.
template <int PL, int U>
__device__ __forceinline__ void online_step(float& m, float& l, float (&acc)[PL],
                                            const float (&sc)[U],
                                            const bool (&ok)[U],
                                            const float (&vt)[U][PL]) {
  float m_new = m;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) m_new = fmaxf(m_new, sc[u]);
  const float alpha = expf(m - m_new);
  float p[U];
  float psum = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    p[u] = ok[u] ? expf(sc[u] - m_new) : 0.f;
    psum += p[u];
  }
  l = l * alpha + psum;
#pragma unroll
  for (int e = 0; e < PL; ++e) {
    float a = acc[e] * alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) a = fmaf(p[u], vt[u][e], a);
    acc[e] = a;
  }
  m = m_new;
}

// Position mode's lane groups: a lane reads 16 bytes of a K/V row (PL
// elements where those are wider), so kG = 32 / kGroups lanes cover a row
// and a warp's groups take different positions.
template <typename TKV, int PL>
struct PosLayout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kPL = PL > kVec ? PL : kVec;    // elements per lane
  static constexpr int kGroups = kPL / PL;             // groups per warp
  static constexpr int kG = kWarp / kGroups;           // lanes per group
  static constexpr int kU = kUnroll / kGroups;         // positions per group per step
  static constexpr int kStates = kWarps * kGroups;     // online-softmax states per row
};

// PL: elements of a K/V row per lane (hd <= 32 PL); MAXR: live rows a
// position-mode block can hold (1 for MHA decode, else kPosRows).
template <typename TQ, typename TKV, int PL, int MAXR>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pages,
                              const TKV* __restrict__ v_pages,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ page_tables,
                              TQ* __restrict__ out, float* __restrict__ partial,
                              int* __restrict__ counters, Dims dm) {
  // [page ids of the run, padded to 16 bytes] then the K/V ring (row mode)
  // or the lane groups' states [kStates][MAXR][hd + 2] (position mode)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_last;
  const int hd = dm.head_dim;
  const int ps = dm.page_size;
  const int n_rep = dm.n_heads / dm.n_kv;
  const int n_rows = n_rep * dm.q_width;
  const int g = blockIdx.y;
  const int b = blockIdx.z / dm.n_splits;
  const int split = blockIdx.z % dm.n_splits;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.x * kRows;
  const int kv_len = kv_lens[b];
  const int q_len = q_lens[b];
  const int n_exist = min(kRows, n_rows - row0);
  const int n_live = max(0, min(n_exist, q_len * n_rep - row0));

  // output offset of the block's row r
  auto row_off = [&](int r) {
    const int row = row0 + r;
    return ((static_cast<int64_t>(b) * dm.q_width + row / n_rep) * dm.n_heads +
            g * n_rep + row % n_rep) * hd;
  };
  // positions row r attends: [0, end)
  auto attend_end = [&](int r) {
    return min(kv_len, kv_len - q_len + (row0 + r) / n_rep + 1);
  };

  if (n_live == 0) {   // every split of the group sees this: split 0 writes
    if (split == 0)
      for (int i = threadIdx.x; i < n_exist * hd; i += blockDim.x)
        out[row_off(i / hd) + i % hd] = from_float<TQ>(0.f);
    return;
  }

  // this split's run of the live pages, and its positions [t_lo, t_hi)
  const int last_end = attend_end(n_live - 1);
  // (positions past the table cannot exist; the plain version masks them)
  const int live_pages = last_end > 0 ? min(dm.pages_per_seq, (last_end + ps - 1) / ps) : 0;
  const int per = (live_pages + dm.n_splits - 1) / dm.n_splits;
  const int p_lo = min(live_pages, split * per);
  const int p_hi = min(live_pages, p_lo + per);
  const int t_lo = p_lo * ps;
  const int t_hi = min(last_end, p_hi * ps);

  int* s_pages = reinterpret_cast<int*>(smem_raw);
  float* region = reinterpret_cast<float*>(
      smem_raw + ((dm.pages_per_seq * sizeof(int) + 15) / 16) * 16);
  const int* table = page_tables + static_cast<int64_t>(b) * dm.pages_per_seq;
  for (int i = threadIdx.x; i < p_hi - p_lo; i += blockDim.x) s_pages[i] = table[p_lo + i];
  __syncthreads();

  const int64_t head0 = static_cast<int64_t>(g) * dm.n_pages * ps * hd;
  const bool pos_mode = n_live <= kPosRows;
  using L = PosLayout<TKV, PL>;
  constexpr int PLP = L::kPL;
  // row mode: warp w's state of row w
  const int d0 = lane * PL;
  float m_row = kMaskValue, l_row = 0.f, acc_row[PL];
#pragma unroll
  for (int e = 0; e < PL; ++e) acc_row[e] = 0.f;

  if (pos_mode) {
    // lane group grp takes positions tw + kU * (lane / kG) + [0, kU) of its
    // warp's step tw; every lane of a warp runs the same steps
    const int grp = warp * L::kGroups + lane / L::kG;
    const int dp = lane % L::kG * PLP;
    float m[MAXR], l[MAXR], acc[MAXR][PLP], qr[MAXR][PLP];
    int end[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      m[r] = kMaskValue;
      l[r] = 0.f;
      end[r] = r < n_live ? min(attend_end(r), t_hi) : 0;
#pragma unroll
      for (int e = 0; e < PLP; ++e) {
        acc[r][e] = 0.f;
        qr[r][e] = r < n_live && dp + e < hd ? to_float(q[row_off(r) + dp + e]) : 0.f;
      }
    }
    for (int tw = t_lo + warp * kUnroll; tw < t_hi; tw += kWarps * kUnroll) {
      const int t0 = tw + lane / L::kG * L::kU;
      float kt[L::kU][PLP], vt[L::kU][PLP];
#pragma unroll
      for (int u = 0; u < L::kU; ++u) {
        const int t = t0 + u;
        if (t < t_hi && dp < hd) {
          const int64_t row =
              head0 + (static_cast<int64_t>(s_pages[t / ps - p_lo]) * ps + t % ps) * hd + dp;
          load_chunk<true, TKV, PLP>(k_pages + row, dp, hd, dm.vec, kt[u]);
          load_chunk<true, TKV, PLP>(v_pages + row, dp, hd, dm.vec, vt[u]);
        } else {
#pragma unroll
          for (int e = 0; e < PLP; ++e) kt[u][e] = vt[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= n_live) break;
        float sc[L::kU];
        bool ok[L::kU];
#pragma unroll
        for (int u = 0; u < L::kU; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < PLP; ++e) dot = fmaf(qr[r][e], kt[u][e], dot);
          sc[u] = group_sum<L::kG>(dot) * dm.scale;
          ok[u] = t0 + u < end[r];
        }
        online_step<PLP, L::kU>(m[r], l[r], acc[r], sc, ok, vt);
      }
    }
    // merge the groups' states in group order
    const int stride = hd + 2;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= n_live) break;
      float* st = region + (grp * MAXR + r) * stride;
#pragma unroll
      for (int e = 0; e < PLP; ++e)
        if (dp + e < hd) st[dp + e] = acc[r][e];
      if (lane % L::kG == 0) {
        st[hd] = m[r];
        st[hd + 1] = l[r];
      }
    }
    __syncthreads();
  } else {
    // row mode: warp w owns row w (rows past n_live only help stage)
    TKV* sk = reinterpret_cast<TKV*>(region);        // [stages][ps * hd]
    TKV* sv = sk + dm.stages * ps * hd;
    const int tile = ps * hd;
    float qr[PL];
    const bool mine = warp < n_live;
    const int end = mine ? min(attend_end(warp), t_hi) : 0;
#pragma unroll
    for (int e = 0; e < PL; ++e)
      qr[e] = mine && d0 + e < hd ? to_float(q[row_off(warp) + d0 + e]) : 0.f;
    auto stage = [&](int p, int buf) {
      const int64_t base = head0 + static_cast<int64_t>(s_pages[p - p_lo]) * tile;
      TKV* dk = sk + buf * tile;
      TKV* dv = sv + buf * tile;
      if (dm.vec) {
        constexpr int kPer = 16 / sizeof(TKV);
        for (int j = threadIdx.x; j < tile / kPer; j += blockDim.x) {
          cp_async16(smem_u32(dk + j * kPer), k_pages + base + j * kPer);
          cp_async16(smem_u32(dv + j * kPer), v_pages + base + j * kPer);
        }
      } else {
        for (int j = threadIdx.x; j < tile; j += blockDim.x) {
          dk[j] = k_pages[base + j];
          dv[j] = v_pages[base + j];
        }
      }
    };
    if (dm.stages == 2 && p_lo < p_hi) stage(p_lo, 0);
    cp_async_commit();
    for (int p = p_lo; p < p_hi; ++p) {
      const int buf = dm.stages == 2 ? (p - p_lo) & 1 : 0;
      if (dm.stages == 2) {
        if (p + 1 < p_hi) stage(p + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        stage(p, 0);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      const TKV* tk = sk + buf * tile;
      const TKV* tv = sv + buf * tile;
      const int n_t = min(ps, end - p * ps);    // this row's slots of the page
      for (int j0 = 0; j0 < n_t; j0 += kUnroll) {
        float kt[kUnroll][PL], vt[kUnroll][PL], sc[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ok[u] = j0 + u < n_t;
          if (ok[u] && d0 < hd) {
            load_chunk<false, TKV, PL>(tk + (j0 + u) * hd + d0, d0, hd, dm.vec, kt[u]);
            load_chunk<false, TKV, PL>(tv + (j0 + u) * hd + d0, d0, hd, dm.vec, vt[u]);
          } else {
#pragma unroll
            for (int e = 0; e < PL; ++e) kt[u][e] = vt[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < PL; ++e) dot = fmaf(qr[e], kt[u][e], dot);
          sc[u] = group_sum<kWarp>(dot) * dm.scale;
        }
        online_step<PL, kUnroll>(m_row, l_row, acc_row, sc, ok, vt);
      }
      __syncthreads();                  // the next stage refills this slot
    }
    cp_async_wait<0>();
  }

  // The block's state of row r < n_live at element d: (m, l, acc[d]).
  auto state = [&](int r, int d, float& mr, float& lr, float& ar) {
    const float* st = region + r * (hd + 2);
    const int stride = MAXR * (hd + 2);
    float mx = kMaskValue;
    for (int w = 0; w < L::kStates; ++w) mx = fmaxf(mx, st[w * stride + hd]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < L::kStates; ++w) {
      const float f = expf(st[w * stride + hd] - mx);   // 0 for a group with no position
      den = fmaf(st[w * stride + hd + 1], f, den);
      num = fmaf(st[w * stride + d], f, num);
    }
    mr = mx;
    lr = den;
    ar = num;
  };

  if (dm.n_splits == 1) {
    if (pos_mode) {
      for (int i = threadIdx.x; i < n_exist * hd; i += blockDim.x) {
        const int r = i / hd, d = i % hd;
        float mr, lr, ar;
        if (r < n_live) state(r, d, mr, lr, ar);
        out[row_off(r) + d] = from_float<TQ>(r < n_live && lr > 0.f ? ar / lr : 0.f);
      }
    } else if (warp < n_exist) {
      const bool any = warp < n_live && l_row > 0.f;
#pragma unroll
      for (int e = 0; e < PL; ++e)
        if (d0 + e < hd)
          out[row_off(warp) + d0 + e] = from_float<TQ>(any ? acc_row[e] / l_row : 0.f);
    }
    return;
  }

  // splits > 1: publish, and the row group's last block merges in split order
  const int64_t group = (static_cast<int64_t>(b) * dm.n_kv + g) * gridDim.x + blockIdx.x;
  const int stride = hd + 2;
  float* part = partial + group * dm.n_splits * kRows * stride;
  float* mine = part + static_cast<int64_t>(split) * kRows * stride;
  if (pos_mode) {
    for (int i = threadIdx.x; i < n_live * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      float mr, lr, ar;
      state(r, d, mr, lr, ar);
      __stcg(mine + r * stride + d, ar);
      if (d == 0) {
        __stcg(mine + r * stride + hd, mr);
        __stcg(mine + r * stride + hd + 1, lr);
      }
    }
  } else if (warp < n_live) {
#pragma unroll
    for (int e = 0; e < PL; ++e)
      if (d0 + e < hd) __stcg(mine + warp * stride + d0 + e, acc_row[e]);
    if (lane == 0) {
      __stcg(mine + warp * stride + hd, m_row);
      __stcg(mine + warp * stride + hd + 1, l_row);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counters + group, 1) == dm.n_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n_exist * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    float o = 0.f;
    if (r < n_live) {
      const float* pr = part + r * stride;
      const int64_t step = static_cast<int64_t>(kRows) * stride;
      float mx = kMaskValue;
      for (int z = 0; z < dm.n_splits; ++z) mx = fmaxf(mx, __ldcg(pr + z * step + hd));
      float den = 0.f, num = 0.f;
      for (int z = 0; z < dm.n_splits; ++z) {
        const float f = expf(__ldcg(pr + z * step + hd) - mx);   // 0 for an empty split
        den = fmaf(__ldcg(pr + z * step + hd + 1), f, den);
        num = fmaf(__ldcg(pr + z * step + d), f, num);
      }
      o = den > 0.f ? num / den : 0.f;
    }
    out[row_off(r) + d] = from_float<TQ>(o);
  }
  if (threadIdx.x == 0) counters[group] = 0;
}

template <typename TQ, typename TKV, int PL, int MAXR>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* kv_lens, const void* q_lens, const void* page_tables,
           void* out, void* partial, void* counters, int batch, Dims dm,
           cudaStream_t stream) {
  const int n_rows = (dm.n_heads / dm.n_kv) * dm.q_width;
  const dim3 grid((n_rows + kRows - 1) / kRows, dm.n_kv, batch * dm.n_splits);
  const size_t ids = ((dm.pages_per_seq * sizeof(int) + 15) / 16) * 16;
  const size_t states = static_cast<size_t>(PosLayout<TKV, PL>::kStates) * MAXR *
                        (dm.head_dim + 2) * sizeof(float);
  const size_t page = 2 * static_cast<size_t>(dm.page_size) * dm.head_dim * sizeof(TKV);
  const size_t limit = 227 * 1024 - 64;   // the opt-in maximum less s_last
  dm.stages = ids + 2 * page <= limit ? 2 : 1;
  const size_t smem = ids + (dm.stages * page > states ? dm.stages * page : states);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ragged_paged_attention_kernel<TQ, TKV, PL, MAXR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<const int*>(page_tables),
      static_cast<TQ*>(out), static_cast<float*>(partial),
      static_cast<int*>(counters), dm);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int PL>
int by_rows(const void* q, const void* k, const void* v, const void* kv_lens,
            const void* q_lens, const void* tables, void* out, void* partial,
            void* counters, int batch, Dims dm, cudaStream_t s) {
  if (dm.n_heads / dm.n_kv * dm.q_width == 1)
    return launch<TQ, TKV, PL, 1>(q, k, v, kv_lens, q_lens, tables, out, partial,
                                  counters, batch, dm, s);
  return launch<TQ, TKV, PL, kPosRows>(q, k, v, kv_lens, q_lens, tables, out,
                                       partial, counters, batch, dm, s);
}

template <typename TQ, typename TKV>
int by_head_dim(const void* q, const void* k, const void* v, const void* kv_lens,
                const void* q_lens, const void* tables, void* out, void* partial,
                void* counters, int batch, Dims dm, cudaStream_t s) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
      dm.head_dim * sizeof(TKV) % 16 == 0;
#define RPA_PL(PL)                                                          \
  do {                                                                      \
    dm.vec = aligned && dm.head_dim % PosLayout<TKV, PL>::kPL == 0;         \
    return by_rows<TQ, TKV, PL>(q, k, v, kv_lens, q_lens, tables, out,      \
                                partial, counters, batch, dm, s);           \
  } while (0)
  if (dm.head_dim <= 2 * kWarp) RPA_PL(2);
  if (dm.head_dim <= 4 * kWarp) RPA_PL(4);
  RPA_PL(8);
#undef RPA_PL
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `n_splits` runs of pages per
// row group; with n_splits > 1, `partial` holds ceil(n_rep * q_width / 8)
// * n_kv * batch * n_splits * 8 * (head_dim + 2) floats and `counters` as
// many ints per row group, all 0 (the kernel leaves them 0).  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const void* kv_lens,
                           const void* q_lens, const void* page_tables,
                           void* out, void* partial, void* counters,
                           int batch, int q_width, int n_heads, int n_kv,
                           int n_pages, int page_size, int head_dim,
                           int pages_per_seq, int n_splits, float scale,
                           int q_dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || q_width <= 0 || n_kv <= 0 || n_heads % n_kv != 0 ||
      head_dim <= 0 || head_dim > 8 * kWarp || page_size <= 0 ||
      pages_per_seq <= 0 || n_splits <= 0 ||
      static_cast<int64_t>(batch) * n_splits > 65535 ||
      (n_splits > 1 && (partial == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();   // report this launch, not an older error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims dm{q_width, n_heads, n_kv, n_pages, page_size, head_dim,
                pages_per_seq, n_splits, 0, 0, scale};
#define RPA_ARGS q, k_pages, v_pages, kv_lens, q_lens, page_tables, out, \
    partial, counters, batch, dm, s
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(RPA_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return by_head_dim<float, __nv_bfloat16>(RPA_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(RPA_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
#undef RPA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
