// Device code shared by the CUDA-core bodies of the dense and the paged
// flash-attention kernels (flash_attn.cu): the online-softmax update of one
// KV block, in the reference kernels' operation order, literally:
//
//   s = (q . k) * sm_scale;  s *= k_scale;  s = mask ? s : NEG_INF
//   m_new = max(m_prev, rowmax s);  p = exp(s - m_new);  alpha = exp(m_prev - m_new)
//   l = alpha * l + sum p;  p *= v_scale;  acc = acc * alpha + p . v
//
// Every reduction runs in one fixed order that does not depend on how many
// rows a block holds or which thread computes them: a score is one thread's
// sequential sum over d, the row sum of p and the value products run over
// the block's positions in order. The dense kernel calls this per block_k
// block and the paged kernel per page, so on gathered pools (block_k ==
// page_size) the two give the same bits. Built with -fmad=false: every
// product and sum rounds on its own, as the plain versions' do.
//
// These bodies take the calls the tensor cores do not: float32 q or K/V,
// head dims other than 64 and 128, causal or static-length dense calls at
// block_q < 16, and paged calls with more than 8 query rows a KV head. A bf16
// decode call with int8 K/V (the serving path, and the dense call that is its
// twin) runs the split-KV body of attn_decode.cuh instead.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace attn {

constexpr int kThreads = 128;
constexpr int kRowTile = 32;  // query rows a block holds at most
constexpr int kSubTile = 32;  // K/V positions staged in shared memory at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared-memory working set of one block (dynamic shared memory, carved by
// carve()). R query rows, D head dim, BK positions per KV block.
struct Smem {
  float* q;      // [R][D]
  float* kt;     // [kSubTile][D + 1]  (padded: lanes read one column of many rows)
  float* vt;     // [kSubTile][D]
  float* s;      // [R][BK] scores, then the scaled probabilities
  float* acc;    // [R][D]
  float* pv;     // [R][D] the block's value products
  float* ksc;    // [BK]
  float* vsc;    // [BK]
  float* m;      // [R]
  float* l;      // [R]
  float* alpha;  // [R]
};

__host__ __device__ inline size_t smem_floats(int R, int D, int BK) {
  const int tk = BK < kSubTile ? BK : kSubTile;
  return (size_t)R * D * 3 + (size_t)tk * (D + 1) + (size_t)tk * D + (size_t)R * BK +
         2 * (size_t)BK + 3 * (size_t)R;
}

__device__ inline Smem carve(float* base, int R, int D, int BK) {
  const int tk = BK < kSubTile ? BK : kSubTile;
  Smem sm;
  sm.q = base;
  sm.acc = sm.q + (size_t)R * D;
  sm.pv = sm.acc + (size_t)R * D;
  sm.kt = sm.pv + (size_t)R * D;
  sm.vt = sm.kt + (size_t)tk * (D + 1);
  sm.s = sm.vt + (size_t)tk * D;
  sm.ksc = sm.s + (size_t)R * BK;
  sm.vsc = sm.ksc + BK;
  sm.m = sm.vsc + BK;
  sm.l = sm.m + R;
  sm.alpha = sm.l + R;
  return sm;
}

// Reset the running (m, l, acc) of the block's rows.
__device__ inline void reset(const Smem& sm, int R, int D) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// Stage rows [0, n) of a K or V block in shared memory as float32, row j of
// the block at src + j * stride (elements). vec: 16-byte loads (every row
// 16-byte aligned and D * sizeof(T) a multiple of 16).
template <typename T>
__device__ inline void stage_rows(float* dst, int dst_stride, const T* __restrict__ src,
                                  long long stride, int n, int D, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    const int chunks = D / kVec;
    for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
      const int j = i / chunks;
      const int c = i - j * chunks;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + j * stride + (long long)c * kVec);
      const T* vals = reinterpret_cast<const T*>(&raw);
      float* out = dst + (size_t)j * dst_stride + c * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      dst[(size_t)j * dst_stride + d] = to_f32(src[j * stride + d]);
    }
  }
}

// One KV block of BK positions for the block's R query rows. Position j of
// the block is k[j * kv_stride .. + D) (and v likewise), its scales
// ksc[j * sc_stride] / vsc[j * sc_stride] (nullptr: no scale), its absolute
// index k_pos0 + j. Query row r sits at q_pos0 + r. A score is kept when
// (!causal || q_pos >= k_pos) && k_pos < limit.
template <typename KVT>
__device__ void attend_block(const Smem& sm, int R, int D, int BK,
                             const KVT* __restrict__ k, const KVT* __restrict__ v,
                             long long kv_stride, const float* __restrict__ ksc,
                             const float* __restrict__ vsc, long long sc_stride, int k_pos0,
                             bool causal, int q_pos0, int limit, bool vec, float sm_scale) {
  const int tid = threadIdx.x;
  for (int j = tid; j < BK; j += kThreads) {
    sm.ksc[j] = ksc ? ksc[j * sc_stride] : 1.f;
    sm.vsc[j] = vsc ? vsc[j * sc_stride] : 1.f;
  }
  // scores, one staged sub-tile of K at a time
  for (int t0 = 0; t0 < BK; t0 += kSubTile) {
    const int tk = BK - t0 < kSubTile ? BK - t0 : kSubTile;
    __syncthreads();  // the previous sub-tile (or the scales) are consumed
    stage_rows(sm.kt, D + 1, k + t0 * kv_stride, kv_stride, tk, D, vec);
    __syncthreads();
    for (int i = tid; i < R * tk; i += kThreads) {
      const int r = i / tk;
      const int jj = i - r * tk;
      const float* qr = sm.q + (size_t)r * D;
      const float* kr = sm.kt + (size_t)jj * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = dot + qr[d] * kr[d];
      float s = dot * sm_scale;
      if (ksc) s = s * sm.ksc[t0 + jj];
      const int kp = k_pos0 + t0 + jj;
      const bool keep = (!causal || q_pos0 + r >= kp) && kp < limit;
      sm.s[(size_t)r * BK + t0 + jj] = keep ? s : kNegInf;
    }
  }
  __syncthreads();
  // row statistics: one thread per row, positions in order
  for (int r = tid; r < R; r += kThreads) {
    float* sr = sm.s + (size_t)r * BK;
    float m_cur = sr[0];
    for (int j = 1; j < BK; ++j) m_cur = fmaxf(m_cur, sr[j]);
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, m_cur);
    float sum = 0.f;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sr[j] - m_new);
      sum = sum + p;
      sr[j] = vsc ? p * sm.vsc[j] : p;
    }
    const float alpha = expf(m_prev - m_new);
    sm.l[r] = alpha * sm.l[r] + sum;
    sm.m[r] = m_new;
    sm.alpha[r] = alpha;
  }
  // value products, one staged sub-tile of V at a time; each (r, d) is
  // summed by one thread over the positions in order
  for (int i = tid; i < R * D; i += kThreads) sm.pv[i] = 0.f;
  for (int t0 = 0; t0 < BK; t0 += kSubTile) {
    const int tk = BK - t0 < kSubTile ? BK - t0 : kSubTile;
    __syncthreads();
    stage_rows(sm.vt, D, v + t0 * kv_stride, kv_stride, tk, D, vec);
    __syncthreads();
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = sm.s + (size_t)r * BK + t0;
      float part = sm.pv[i];
      for (int jj = 0; jj < tk; ++jj) part = part + pr[jj] * sm.vt[(size_t)jj * D + d];
      sm.pv[i] = part;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    sm.acc[i] = sm.acc[i] * sm.alpha[r] + sm.pv[i];
  }
  __syncthreads();
}

}  // namespace attn
