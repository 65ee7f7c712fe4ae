// Packed plane-pair matrix multiplication for Hopper (sm_90a), on int8
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/plane_mm_packed.py::plane_matmul_packed
// (Pallas body _packed_mm_kernel). Same function, bit for bit:
//
//   out[m, n] = sum_{i,j} pw[i*P_w + j] * sum_{w,t} a_i[m, (w,t)] * w_j[(w,t), n]   (int32)
//
// where both operands arrive as packed plane words: a_i[m, (w,t)] is bit t of
// A's word amag[i, m, w] minus twice bit t of its sign word (Booth planes are
// mag - 2*sign; binary planes have no sign words), and w_j[(w,t), n] likewise
// from wmag[j, w, n]. The contraction runs over (word, bit) pairs and never
// un-permutes K, so it holds for every word layout both operands share: the
// global planar layout (bit t of word w is k = t*KW + w) and the blocked one.
// The sum is taken modulo 2^32 (the reference's int32 arithmetic wraps).
//
// The arithmetic (plane_mm_common.cuh): with pw = wa (x) ww, the staging
// kernel sums A's planes to A = sum_i wa_i (mag_i - 2 sign_i) modulo 2^32
// and splits it into signed base-256 digits, as many as the range of
// sum_i wa_i v_i needs for any words (two at 8 Booth planes, one for 8-bit
// SBMwC); the weight words become the byte digits of their magnitude and
// sign planes. At 8x8 Booth that is four int8 tensor-core products per
// (m, n, k), two where a chunk's high activation digit is all zero, which
// is every chunk of a valid int8 activation. The wrapper launches this only
// for such a pw (kernels/bytesplit.pair_route); any other pw, and operands
// packed without plane weights, go through plane_mm.cu.
//
// What bounds it on the H100: the packed weight words, 2 bytes per weight at
// 8 Booth planes (mag + sign), read once — memory at decode; at prefill the
// products (two per (m, n, k) for a valid int8 activation) and the weight
// words read once per 32-row tile.
//
// Launches, one stream:
// 1. stage: A's words into signed digit bytes, row (digit, m, w) holding word
//    w's 32 values at bit_pos(t), zero beyond KW; zeroes out when K is split;
// 2. the main loop (plane_mm_common.cuh run_tiles) over (row tile, 128
//    columns, K split); at decode K chunks are split across blocks so the
//    card fills, and partial sums meet by integer atomicAdd into the zeroed
//    output, exact in any order.
// gate: the weight's (plane, 16-word chunk) occupancy, from the pack-time
// bitmap, skips a plane's loads for a chunk and a digit none of whose planes
// is occupied; zero planes add zero, so the gated sum is bit-identical to
// the dense one for words the occupancy describes. gate = 0 reads every word.

#include <cstdint>
#include <cuda_runtime.h>

#include "plane_mm_common.cuh"

namespace {

using plane_mm::DigitPlan;
using plane_mm::kBlockCols;
using plane_mm::kChunkWords;
using plane_mm::kThreads;

// One thread per (m, w): the 32 values of A at word w, split into dp.n_ad
// signed bytes each; digit b's row goes to adig[b][m][w] in bit_pos order.
__global__ void plane_mm_packed_stage(const uint32_t* __restrict__ amag, const uint32_t* __restrict__ asign,
                             int n_a, int M, int KW, int KWp, uint32_t* __restrict__ adig,
                             const __grid_constant__ DigitPlan dp,
                             uint32_t* __restrict__ zero, size_t n_zero) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t total = (size_t)M * KWp;
  const size_t digit_words = total * 8;
  for (size_t o = tid; o < total; o += stride) {
    const int w = (int)(o % KWp);
    const int m = (int)(o / KWp);
    uint32_t v[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) v[t] = 0u;
    if (w < KW) {
      for (int i = 0; i < n_a; ++i) {
        const size_t off = ((size_t)i * M + m) * KW + w;
        const uint32_t mag = amag[off];
        const uint32_t sgn = asign != nullptr ? asign[off] : 0u;
        const uint32_t wa = (uint32_t)dp.wa[i];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          v[t] += wa * (((mag >> t) & 1u) - 2u * ((sgn >> t) & 1u));
        }
      }
    }
    // signed base-256 digits: v = d0 + 256 * v', d0 the sign-extended low byte
    for (int b = 0; b < dp.n_ad; ++b) {
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) {
        uint32_t word = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 8 * i + qq;
          const int32_t sv = (int32_t)v[t];
          const int d = (int)(int8_t)(sv & 0xFF);
          word |= (uint32_t)(d & 0xFF) << (8 * i);
          v[t] = (uint32_t)(int32_t)(((int64_t)sv - d) >> 8);
        }
        adig[b * digit_words + o * 8 + qq] = word;
      }
    }
  }
  for (size_t o = tid; o < n_zero; o += stride) zero[o] = 0u;
}

template <int NT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
plane_mm_packed_main(const uint8_t* __restrict__ adig, int M, int KW, int KWp,
            const uint32_t* __restrict__ wmag, const uint32_t* __restrict__ wsign, int N,
            const int32_t* __restrict__ wocc, int chunks_per_split,
            const __grid_constant__ DigitPlan dp, uint32_t* __restrict__ out, int atomic) {
  plane_mm::run_tiles<NT, kVec4>(
      adig, M, KW, KWp, wmag, wsign, N, wocc, chunks_per_split, false, dp,
      [&](uint32_t s, int m, int n) {
        uint32_t* o = out + (size_t)m * N + n;
        if (atomic) {
          atomicAdd(o, s);
        } else {
          *o = s;
        }
      });
}

template <int NT, bool kVec4>
void launch_main(dim3 grid, cudaStream_t s, const uint8_t* adig, int M, int KW, int KWp,
                 const uint32_t* wm, const uint32_t* wsg, int N, const int32_t* wocc, int cps,
                 const DigitPlan& dp, uint32_t* out, int atomic) {
  const size_t smem = (size_t)dp.n_ad * kChunkWords * 8 * NT * 32;
  if (smem > 48 * 1024) {  // above the default limit: four activation digits, 32-row tiles
    cudaFuncSetAttribute(plane_mm_packed_main<NT, kVec4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  plane_mm_packed_main<NT, kVec4><<<grid, kThreads, smem, s>>>(adig, M, KW, KWp, wm, wsg, N, wocc, cps,
                                                      dp, out, atomic);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success; 1 =
// cudaErrorInvalidValue for arguments the kernel does not take). plan is a
// host DigitPlan; adig a device scratch of n_ad * M * KWp * 32 bytes (KWp =
// KW rounded up to 16 words).
extern "C" int plane_matmul_packed_launch(const void* amag, const void* asign, int n_a, int M,
                                          const void* wmag, const void* wsign, int kw, int N,
                                          const void* plan, const void* wocc,
                                          int gate, void* out, void* adig, int ksplit, int bm,
                                          int vec4, void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  const DigitPlan& dp = *static_cast<const DigitPlan*>(plan);
  if (n_a < 1 || n_a > plane_mm::kMaxPlanes || dp.n_a != n_a || dp.n_w < 1 ||
      dp.n_w > plane_mm::kMaxPlanes || dp.n_ad < 1 || dp.n_ad > plane_mm::kMaxADigits ||
      dp.n_wd < 1 || dp.n_wd > plane_mm::kMaxWDigits || M < 1 || N < 1 || kw < 1 ||
      ksplit < 1 || (gate && wocc == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (kw + kChunkWords - 1) / kChunkWords;
  const int KWp = n_chunks * kChunkWords;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  const int splits = (n_chunks + cps - 1) / cps;
  uint32_t* o = static_cast<uint32_t*>(out);
  const int atomic = splits > 1;
  const size_t n_zero = atomic ? (size_t)M * N : 0;
  const size_t stage_items = (size_t)M * KWp;
  const size_t items = stage_items > n_zero ? stage_items : n_zero;
  const int stage_blocks = (int)((items + 255) / 256 < 2048 ? (items + 255) / 256 : 2048);
  uint8_t* ad = static_cast<uint8_t*>(adig);
  plane_mm_packed_stage<<<stage_blocks, 256, 0, s>>>(
      static_cast<const uint32_t*>(amag), static_cast<const uint32_t*>(asign), n_a, M, kw, KWp,
      reinterpret_cast<uint32_t*>(ad), dp, o, n_zero);

  const dim3 grid((M + bm - 1) / bm, (N + kBlockCols - 1) / kBlockCols, splits);
  const uint32_t* wm = static_cast<const uint32_t*>(wmag);
  const uint32_t* wsg = static_cast<const uint32_t*>(wsign);
  const int32_t* oc = gate ? static_cast<const int32_t*>(wocc) : nullptr;
#define PACKED_LAUNCH(NT, V) launch_main<NT, V>(grid, s, ad, M, kw, KWp, wm, wsg, N, oc, cps, dp, o, atomic)
  switch (bm * 2 + (vec4 ? 1 : 0)) {
    case 16: PACKED_LAUNCH(1, false); break;
    case 17: PACKED_LAUNCH(1, true); break;
    case 32: PACKED_LAUNCH(2, false); break;
    case 33: PACKED_LAUNCH(2, true); break;
    case 64: PACKED_LAUNCH(4, false); break;
    case 65: PACKED_LAUNCH(4, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PACKED_LAUNCH
  return (int)cudaGetLastError();
}
