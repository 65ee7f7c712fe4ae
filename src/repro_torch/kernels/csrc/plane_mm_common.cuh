// The int8 tensor-core main loop shared by the fused and the packed
// plane-pair kernels (plane_mm_fused.cu, which replaces the TPU kernel
// src/repro/kernels/plane_mm_fused.py::fused_plane_linear, and
// plane_mm_packed.cu, which replaces plane_mm_packed.py::plane_matmul_packed).
//
// What bounds it on the H100: at decode the packed weight words, 2 bytes per
// weight at 8 Booth planes, read once (memory); their bit transposes run
// beside the loads. At prefill each 32-row tile reads and transposes the
// words again, and the transposes, not the products, are the larger share
// of the instructions.
//
// Both kernels compute, modulo 2^32,
//
//   out[m, n] = sum_{i,j} pw[i*P_w + j] * sum_k a_i[m, k] * w_j[k, n]
//
// and every pair-weight vector the port builds is a wrapped outer product,
// pw[i*P_w + j] = wrap32(wa_i * ww_j). Then the sum regroups exactly into
// A @ W with A = sum_i wa_i a_i and W = sum_j ww_j w_j, and both are written
// in bytes that int8 tensor cores multiply exactly:
//
// * The weight side. A plane value is mag - 2*sign, in {-2, -1, 0, 1} for
//   any words (a flipped bit, a sign bit without its magnitude bit). Planes
//   whose weights are c * 2^p (p < 8, one shared c per group) put their
//   magnitude bits into one byte and their sign bits into another: bit p of
//   the byte is plane p's bit, so the byte is sum_p 2^p bit_p in [0, 255]
//   (.u8). A group may end in a plane of weight -128 c (SBMwC's top plane):
//   the byte is then two's complement (.s8). So W = sum_g c_g (M_g - 2 S_g)
//   with M_g, S_g exact bytes: at 8 Booth planes (weights 1..128) one group,
//   two digits, two int8 products per (m, n, k) where the CUDA-core loop did
//   P_w = 8 multiply-adds. The digit table (DigitPlan) is built on the host
//   from the plane weights (kernels/bytesplit.py) and passed by value.
// * The activation side arrives already in bytes: the raw int8 x (its low
//   a_bits bits, sign- or zero-extended: booth and sbmwc planes of x sum to
//   the sign-extended value, unsigned planes to the unsigned one, .u8), or,
//   for the packed kernel, A = sum_i wa_i (mag_i - 2 sign_i) split into
//   signed base-256 digits, as many as the range of sum_i wa_i v_i needs for
//   any words (two at 8 Booth planes; the high digit of a valid int8
//   activation is zero and its products are skipped per K chunk).
//
// Every product A_b @ D_d is an exact int32 mma over 128 values of K (one
// warp step), at most 255 * 255 * 128 in magnitude; it is folded into the
// uint32 accumulator right after, times 256^b c_d, modulo 2^32. The mma
// accumulator never wraps.
//
// The pair weights are not an argument: the plan carries their factors.
// The wrappers decide on the host, before the launch, that a call's pw is
// that outer product (kernels/bytesplit.pair_route: by the factors that
// ops._pair_weights records on every pw it builds, else by reading pw back
// on every call); any other pw, and operands packed without plane weights, take the
// all-pairs path (unpack to int8 planes, plane_mm.cu), so no launch here
// ever sees a pw it cannot compute.
//
// Layout. The contraction runs over (word, bit) pairs in the words' own
// order and never un-permutes K: the activation staging writes each word's
// 32 values in the order the weight fragments come out (bit_pos), so
// one layout serves the blocked and the global planar packing.
//
// * mma.sync.m16n8k32 with the weights as the 16-row operand (16 output
//   columns) and the tokens as the 8-column one: at decode (M <= 8) one n8
//   tile holds every token; a block of NT n8 tiles serves 8*NT rows.
// * A warp owns 32 output columns (two m16 tiles); a thread of quad lane q
//   and group g reads, per plane, the 16-byte vector of words of columns
//   4g..4g+3 at word q of a 4-word step. The 8 plane words of a column are
//   bit-transposed in registers (three rounds of masked swaps, 60 integer
//   operations for 32 values), after which register p holds the bytes of
//   bits p, 8+p, 16+p, 24+p — straight A fragments, no shared memory.
// * The activation bytes of one K chunk (16 words, 512 values) are staged
//   per block in shared memory, 8-byte rows swizzled by the word so the
//   quad's B-fragment loads hit distinct banks.
// * gate (packed kernel): the weight's (plane, chunk) occupancy from the
//   pack-time bitmap skips a plane's loads for the chunk, and a digit none
//   of whose planes is occupied skips its transposes and products.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plane_mm {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 32;                   // output columns per warp
constexpr int kBlockCols = kWarps * kWarpCols;  // output columns per block
constexpr int kChunkWords = 16;                 // packed words per K chunk
constexpr int kStepWords = 4;                   // words per warp step (one per quad lane)
constexpr int kMaxPlanes = 32;
constexpr int kMaxWDigits = 2 * kMaxPlanes;
constexpr int kMaxADigits = 4;

// The byte plan of one call (kernels/bytesplit.py builds the same struct).
struct DigitPlan {
  int n_wd;                       // weight digits
  int n_ad;                       // activation digits (signed base-256)
  uint32_t wcoef[kMaxWDigits];    // coefficient c_d of weight digit d (mod 2^32)
  int8_t wplane[kMaxWDigits][8];  // plane whose bit is bit p of digit d's byte, -1: none
  uint8_t wsign[kMaxWDigits];     // 1: digit d reads sign words, 0: magnitude words
  uint8_t ws8[kMaxWDigits];       // 1: digit d's byte is two's complement
  int n_a, n_w;                   // plane counts of the pair weights
  int32_t wa[kMaxPlanes];         // activation plane weights (pw = wa (x) ww)
};

// Position, in a staged 32-byte activation row, of contraction bit t of a
// word: the transposed weight register p holds bits p + 8c (c = 0..3), and
// mma step s takes registers 2s (k slots 4q..4q+3) and 2s+1 (16+4q..).
__host__ __device__ constexpr int bit_pos(int t) { return 4 * (t & 7) + (t >> 3); }

// x[p] is plane slot p's word. After the call, byte c of x[p] is
// sum_q 2^q * bit (8c + p) of the input x[q]: the 8-plane byte of
// contraction bit 8c + p. Masked swaps between words, within each byte.
template <int S, uint32_t Mask>
__device__ __forceinline__ void swap_bits(uint32_t& lo, uint32_t& hi) {
  const uint32_t t = ((lo >> S) ^ hi) & Mask;
  hi ^= t;
  lo ^= t << S;
}

__device__ __forceinline__ void transpose8x32(uint32_t (&x)[8]) {
#pragma unroll
  for (int p = 0; p < 8; p += 2) swap_bits<1, 0x55555555u>(x[p], x[p + 1]);
#pragma unroll
  for (int p = 0; p < 8; p += 4) {
    swap_bits<2, 0x33333333u>(x[p], x[p + 2]);
    swap_bits<2, 0x33333333u>(x[p + 1], x[p + 3]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) swap_bits<4, 0x0F0F0F0Fu>(x[p], x[p + 4]);
}

// d += A (16x32, row) * B (32x8, col); A the weight digit bytes, B the
// activation bytes, .u8 or .s8 each.
template <bool kWs8, bool kAu8>
__device__ __forceinline__ void mma_k32(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
#define PLANE_MM_MMA(AT, BT)                                                                  \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 {%0,%1,%2,%3}, "              \
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                                              \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                                        \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))
  if constexpr (kWs8 && kAu8) {
    PLANE_MM_MMA("s8", "u8");
  } else if constexpr (kWs8) {
    PLANE_MM_MMA("s8", "s8");
  } else if constexpr (kAu8) {
    PLANE_MM_MMA("u8", "u8");
  } else {
    PLANE_MM_MMA("u8", "s8");
  }
#undef PLANE_MM_MMA
}

// One weight digit against one staged activation digit over a 4-word step:
// tmp[T][nt] = digit bytes of the thread's columns (tile T: columns 2T,
// 2T+1 as rows g, g+8) times the tokens of n8 tile nt.
template <int NT, bool kWs8, bool kAu8>
__device__ __forceinline__ void step_products(int32_t (&tmp)[2][NT][4], const uint32_t (&x)[4][8],
                                              const uint8_t* __restrict__ row, int q) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = *reinterpret_cast<const uint2*>(row + nt * 8 * 32 + ((s ^ q) << 3));
      mma_k32<kWs8, kAu8>(tmp[0][nt], x[0][2 * s], x[1][2 * s], x[0][2 * s + 1],
                          x[1][2 * s + 1], b.x, b.y);
      mma_k32<kWs8, kAu8>(tmp[1][nt], x[2][2 * s], x[3][2 * s], x[2][2 * s + 1],
                          x[3][2 * s + 1], b.x, b.y);
    }
  }
}

// Digit d's plane words of the thread's four columns (ncol..ncol+3) at
// word w: x[i][p] is the word of slot p's plane, zero where the slot is
// empty, its plane unoccupied (occ), or w or the column out of range.
// Returns whether any of the digit's planes is occupied (warp-uniform).
template <bool kVec4>
__device__ __forceinline__ bool load_digit(uint32_t (&x)[4][8], const DigitPlan& dp, int d,
                                           uint32_t occ, const uint32_t* __restrict__ wmag,
                                           const uint32_t* __restrict__ wsign, size_t plane_stride,
                                           int w, int KW, int N, int ncol) {
  const uint32_t* __restrict__ base = (dp.wsign[d] ? wsign : wmag) + (size_t)w * N + ncol;
  const bool w_ok = w < KW;
  bool any = false;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int j = dp.wplane[d][p];
    const bool on = j >= 0 && ((occ >> j) & 1u);
    any |= on;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (on && w_ok) {
      const uint32_t* src = base + j * plane_stride;
      if constexpr (kVec4) {
        if (ncol < N) v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        if (ncol < N) v.x = __ldg(src);
        if (ncol + 1 < N) v.y = __ldg(src + 1);
        if (ncol + 2 < N) v.z = __ldg(src + 2);
        if (ncol + 3 < N) v.w = __ldg(src + 3);
      }
    }
    x[0][p] = v.x;
    x[1][p] = v.y;
    x[2][p] = v.z;
    x[3][p] = v.w;
  }
  return any;
}

// Transposes digit d's words (x, from load_digit) into its bytes and adds
// 256^b c_d * (bytes @ activation digit b) to acc for every live b; rows
// point at the staged rows of the thread's word (token g) per digit.
template <int NT>
__device__ __forceinline__ void digit_products(uint32_t (&acc)[2][NT][4], uint32_t (&x)[4][8],
                                               const DigitPlan& dp, int d, uint32_t live,
                                               const uint8_t* __restrict__ row0,
                                               size_t stage_digit, bool au8, int q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) transpose8x32(x[i]);
  const bool ws8 = dp.ws8[d] != 0;
  for (int b = 0; b < dp.n_ad; ++b) {
    if (!((live >> b) & 1u)) continue;
    int32_t tmp[2][NT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[t][nt][e] = 0;
    const uint8_t* row = row0 + b * stage_digit;
    if (ws8) {
      if (au8) step_products<NT, true, true>(tmp, x, row, q);
      else step_products<NT, true, false>(tmp, x, row, q);
    } else {
      if (au8) step_products<NT, false, true>(tmp, x, row, q);
      else step_products<NT, false, false>(tmp, x, row, q);
    }
    const uint32_t coef = dp.wcoef[d] << (8 * b);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][nt][e] += coef * (uint32_t)tmp[t][nt][e];
  }
}

// The block's tile: rows [blockIdx.x * 8*NT, +8*NT), columns
// [blockIdx.y * kBlockCols, +kBlockCols), K chunks [blockIdx.z *
// chunks_per_split, +chunks_per_split). adig holds the activation digits
// (n_ad, M, KWp, 32) bytes, each word's row in bit_pos order, zero beyond
// KW; wmag/wsign the weight words (P_w, KW, N); wocc the (P_w, KWp/16)
// tile occupancy or null (no gate); au8 the activation bytes' type. Calls
// emit(sum mod 2^32, m, n) once per output of the tile inside (M, N).
template <int NT, bool kVec4, typename Emit>
__device__ __forceinline__ void run_tiles(const uint8_t* __restrict__ adig, int M, int KW, int KWp,
                                          const uint32_t* __restrict__ wmag,
                                          const uint32_t* __restrict__ wsign, int N,
                                          const int32_t* __restrict__ wocc, int chunks_per_split,
                                          bool au8, const DigitPlan& dp, Emit emit) {
  constexpr int BM = 8 * NT;
  extern __shared__ __align__(16) uint8_t xs[];  // [n_ad][kChunkWords][BM][32]
  __shared__ int occ_s[kMaxPlanes];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int ncol = blockIdx.y * kBlockCols + (threadIdx.x >> 5) * kWarpCols + 4 * g;
  const int n_chunks = KWp / kChunkWords;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);
  const size_t plane_stride = (size_t)KW * N;
  const size_t digit_stride = (size_t)M * KWp * 32;
  const size_t stage_digit = (size_t)kChunkWords * BM * 32;

  uint32_t acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0u;

  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the previous chunk's readers of xs / occ_s are done
    if (threadIdx.x < dp.n_w) {
      occ_s[threadIdx.x] = wocc == nullptr ? 1 : wocc[(size_t)threadIdx.x * n_chunks + c];
    }
    // stage the chunk's activation digits; live bit b: digit b is non-zero here
    uint32_t live = 0u;
    for (int b = 0; b < dp.n_ad; ++b) {
      uint32_t nz = 0u;
      for (int idx = threadIdx.x; idx < kChunkWords * BM * 4; idx += kThreads) {
        const int part = idx & 3, m = (idx >> 2) % BM, w = (idx >> 2) / BM;
        uint2 v = make_uint2(0u, 0u);
        if (m0 + m < M) {
          v = *reinterpret_cast<const uint2*>(adig + b * digit_stride +
                                              ((size_t)(m0 + m) * KWp + c * kChunkWords + w) * 32 +
                                              part * 8);
        }
        nz |= v.x | v.y;
        *reinterpret_cast<uint2*>(xs + b * stage_digit + (w * BM + m) * 32 + ((part ^ (w & 3)) << 3)) = v;
      }
      live |= (uint32_t)(__syncthreads_or(nz != 0u) != 0) << b;
    }
    if (live == 0u) continue;  // block-uniform: every activation byte of the chunk is zero
    uint32_t occ = 0u;
    for (int j = 0; j < dp.n_w; ++j) occ |= (uint32_t)(occ_s[j] != 0) << j;

    const uint8_t* rows = xs + (size_t)(q * BM + g) * 32;  // the thread's word, token g
    for (int ss = 0; ss < kChunkWords / kStepWords; ++ss) {
      const int w = c * kChunkWords + ss * kStepWords + q;  // the thread's word
      for (int d = 0; d < dp.n_wd; ++d) {
        uint32_t x[4][8];
        if (load_digit<kVec4>(x, dp, d, occ, wmag, wsign, plane_stride, w, KW, N, ncol)) {
          digit_products<NT>(acc, x, dp, d, live, rows + (size_t)ss * kStepWords * BM * 32,
                             stage_digit, au8, q);
        }
      }
    }
  }

  // c0/c1 (rows g, g+8) of tile t are columns 2t, 2t+1; tokens 2q, 2q+1
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = ncol + 2 * t + (e >> 1);
        const int m = m0 + nt * 8 + 2 * q + (e & 1);
        if (m < M && n < N) emit(acc[t][nt][e], m, n);
      }
}

}  // namespace plane_mm
