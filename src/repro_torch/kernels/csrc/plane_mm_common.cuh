// Device code shared by the fused and the packed plane-pair kernels
// (plane_mm_fused.cu, plane_mm_packed.cu). Both fold the activation planes
// into u_j[m, (w,t)] = sum_i pw[i*P_w + j] * a_i[m, (w,t)] in shared memory
// first, each from its own input (raw int8 or packed plane words); what
// follows is this: the weight words of one K chunk, read once per block by
// the thread that owns their output column, times the folded rows, then the
// cross-warp reduction. All sums are uint32, modulo 2^32.
#pragma once

#include <cstdint>

namespace plane_mm {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32;  // output columns per block, one per lane

// The column loop of accumulate_column, for signed or binary planes.
template <int BM, bool kSigned>
__device__ __forceinline__ void accumulate_words(uint32_t (&acc)[BM],
                                                 const uint32_t* __restrict__ mag_col,
                                                 const uint32_t* __restrict__ sign_col,
                                                 int N, int nwords,
                                                 const uint32_t (*us)[BM], int stride,
                                                 bool skip_zero) {
  for (int w = threadIdx.x >> 5; w < nwords; w += kWarps) {
    const uint32_t mag = mag_col[(size_t)w * N];
    if (skip_zero && mag == 0u) continue;
    const uint32_t sgn = kSigned ? sign_col[(size_t)w * N] : 0u;
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const int wv = (int)((mag >> t) & 1u) - 2 * (int)((sgn >> t) & 1u);
      const uint32_t* urow = us[t * stride + w];
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m] += (uint32_t)wv * urow[m];
    }
  }
}

// acc[m] += sum over the chunk's words w and bits t of
// (mag_t - 2*sign_t) * us[t*stride + w][m], for the column whose first word
// of the chunk is mag_col[0] (words of one column lie N apart; sign_col is
// null for binary planes). The block's warps split the words. skip_zero
// skips all-zero magnitude words, which add nothing in any valid plane
// encoding (sign bits are a subset). Binary planes (SBMwC, unsigned) take
// a loop of their own, with no sign load or term.
template <int BM>
__device__ __forceinline__ void accumulate_column(uint32_t (&acc)[BM],
                                                  const uint32_t* __restrict__ mag_col,
                                                  const uint32_t* __restrict__ sign_col,
                                                  int N, int nwords,
                                                  const uint32_t (*us)[BM], int stride,
                                                  bool skip_zero) {
  if (sign_col != nullptr) {
    accumulate_words<BM, true>(acc, mag_col, sign_col, N, nwords, us, stride, skip_zero);
  } else {
    accumulate_words<BM, false>(acc, mag_col, nullptr, N, nwords, us, stride, skip_zero);
  }
}

// Sums the warps' partial accumulators through shared memory `red` (at
// least kWarps * BM * kBN words; the caller's staging buffer, free once its
// readers are done) and calls store(sum, m, c) for every row m < BM and
// column c < kBN of the block's tile.
template <int BM, typename Store>
__device__ __forceinline__ void reduce_warps(const uint32_t (&acc)[BM], uint32_t* red,
                                             Store store) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // the staging buffer's readers are done
#pragma unroll
  for (int m = 0; m < BM; ++m) red[(warp * BM + m) * kBN + lane] = acc[m];
  __syncthreads();
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int m = idx / kBN, c = idx - m * kBN;
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * BM + m) * kBN + c];
    store(s, m, c);
  }
}

}  // namespace plane_mm
