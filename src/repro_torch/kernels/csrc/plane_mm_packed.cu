// Packed plane-pair matrix multiplication for Hopper (sm_90a).
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
// global planar layout (bit t of word w is k = t*KW + w) and the blocked one
// (the same within each pack block). The sum is taken modulo 2^32 in uint32
// (signed overflow is undefined in C++; the reference's int32 arithmetic
// wraps), so wrapped pair weights (Booth, truncated tiers, compacted caches)
// give the reference's result.
//
// What bounds it on the H100: the packed weight words, 2 bytes per weight at
// 8 Booth planes (mag + sign), read once — memory at decode. Folded as below
// the function needs P_w int8 products per (m, n, k), which turns compute
// bound near M = 74 at the int8 tensor-core rate; this kernel runs them on
// the CUDA cores (no tensor cores), so prefill stays far above that bound.
// mma/wgmma, TMA and pipelining are later work.
//
// Design (the fused kernel's fold, with A unpacked from its words): of the
// two reasonable designs — folding the activation planes into one operand
// per weight plane, or a popcount of ANDed words per plane pair — this takes
// the fold. At 8x8 Booth the popcount needs 4 AND+POPC per plane pair, 256
// per (m, n, word) or 8 per k before the pair weighting, and grows with
// P_a * P_w; the fold needs P_w = 8 multiply-adds per (m, n, k) plus an
// unpack shared by the block's 32 columns, does not grow with P_a, and is
// the arithmetic the other two kernels already hold bit-equal on the card.
// * The TPU's sequential K grid dimension is a loop over K chunks of 16 words
//   (512 contraction values) inside one CUDA block; the accumulator is
//   registers.
// * For each weight plane j and chunk, the block unpacks A's words into
//   u_j[m, (w,t)] = sum_i pw[i*P_w + j] * a_i[m, (w,t)] (mod 2^32) in shared
//   memory; the inner loop then does P_w multiply-adds per (m, n, k) instead
//   of P_a * P_w, exact for any pair weights by modular arithmetic.
// * Each weight word is read from device memory once per block, by the thread
//   that owns its output column (32 columns per block, lanes on neighbouring
//   columns: coalesced); the four warps split the words of a chunk and reduce
//   through shared memory at the end. This weight side and the reduction are
//   the fused kernel's own, shared through plane_mm_common.cuh; what is this
//   kernel's is the activation stage, unpacking A's words into u_j.
// * Decode shapes give few blocks, so K chunks are split across blocks
//   (ksplit) when that fills the card; partial sums meet by integer atomicAdd
//   into the zeroed output, exact in any order.
// * gate: the weight plane's tile occupancy (one entry per plane and chunk,
//   from the pack-time bitmap) skips a whole (plane, chunk), and zero words
//   on either side skip their unpack. Zero planes add zero, so the gated sum
//   is bit-identical to the dense one; gate = 0 takes every pair.

#include <cstdint>
#include <cuda_runtime.h>

#include "plane_mm_common.cuh"

namespace {

using plane_mm::kBN;
using plane_mm::kThreads;
constexpr int kChunkWords = 16;              // packed words per K chunk
constexpr int kChunkVals = kChunkWords * 32; // contraction values per chunk
constexpr int kMaxPlanes = 32;               // planes per operand
constexpr int kMaxPairs = kMaxPlanes * kMaxPlanes;

template <int BM>
__global__ void __launch_bounds__(kThreads)
packed_mm_kernel(const uint32_t* __restrict__ amag, const uint32_t* __restrict__ asign,
                 int n_a, int M, const uint32_t* __restrict__ wmag,
                 const uint32_t* __restrict__ wsign, int n_w, int kw, int N,
                 const int32_t* __restrict__ pw, const int32_t* __restrict__ wocc, int gate,
                 int32_t* __restrict__ out, int chunks_per_split, int atomic) {
  // u_j for one chunk: row kk = t * kChunkWords + w holds bit t of word w
  __shared__ __align__(16) uint32_t us[kChunkVals][BM];
  __shared__ uint32_t pws[kMaxPairs];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + (tid & 31);
  const int m0 = blockIdx.y * BM;
  const int n_chunks = (kw + kChunkWords - 1) / kChunkWords;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);

  for (int p = tid; p < n_a * n_w; p += kThreads) pws[p] = (uint32_t)pw[p];

  uint32_t acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0u;

  for (int c = c0; c < c1; ++c) {
    const int w0 = c * kChunkWords;
    const int nwords = min(kChunkWords, kw - w0);
    for (int j = 0; j < n_w; ++j) {
      // block-uniform: every thread skips the same (plane, chunk)
      if (gate && wocc[(size_t)j * n_chunks + c] == 0) continue;
      __syncthreads();  // pws staged / the previous plane's readers of us are done
      for (int idx = tid; idx < BM * kChunkWords; idx += kThreads) {
        const int m = idx % BM, w = idx / BM;
        const int mg = m0 + m;
        uint32_t u[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) u[t] = 0u;
        if (mg < M && w < nwords) {
          for (int i = 0; i < n_a; ++i) {
            const size_t off = ((size_t)i * M + mg) * kw + w0 + w;
            const uint32_t mag = amag[off];
            if (gate && mag == 0u) continue;  // a zero word adds nothing
            const uint32_t sgn = asign != nullptr ? asign[off] : 0u;
            const uint32_t p = pws[i * n_w + j];
#pragma unroll
            for (int t = 0; t < 32; ++t) {
              const int v = (int)((mag >> t) & 1u) - 2 * (int)((sgn >> t) & 1u);
              u[t] += (uint32_t)v * p;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) us[t * kChunkWords + w][m] = u[t];
      }
      __syncthreads();
      if (n < N) {
        const size_t off = ((size_t)j * kw + w0) * N + n;
        plane_mm::accumulate_column<BM>(acc, wmag + off,
                                        wsign != nullptr ? wsign + off : nullptr, N, nwords,
                                        us, kChunkWords, gate != 0);
      }
    }
  }

  plane_mm::reduce_warps<BM>(acc, &us[0][0], [&](uint32_t s, int m, int c) {
    const int mg = m0 + m, ng = blockIdx.x * kBN + c;
    if (mg < M && ng < N) {
      unsigned int* o = reinterpret_cast<unsigned int*>(out) + (size_t)mg * N + ng;
      if (atomic) {
        atomicAdd(o, s);
      } else {
        *o = s;
      }
    }
  });
}

template <int BM>
void launch(dim3 grid, cudaStream_t s, const uint32_t* am, const uint32_t* as, int n_a, int M,
            const uint32_t* wm, const uint32_t* ws, int n_w, int kw, int N, const int32_t* pw,
            const int32_t* wocc, int gate, int32_t* out, int chunks_per_split, int atomic) {
  packed_mm_kernel<BM><<<grid, kThreads, 0, s>>>(am, as, n_a, M, wm, ws, n_w, kw, N, pw, wocc,
                                                 gate, out, chunks_per_split, atomic);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success; 1 =
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int plane_matmul_packed_launch(const void* amag, const void* asign, int n_a, int M,
                                          const void* wmag, const void* wsign, int n_w, int kw,
                                          int N, const void* pw, const void* wocc, int gate,
                                          void* out, int ksplit, int bm, void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  if (n_a < 1 || n_a > kMaxPlanes || n_w < 1 || n_w > kMaxPlanes || M < 1 || N < 1 ||
      kw < 1 || ksplit < 1 || (gate && wocc == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (kw + kChunkWords - 1) / kChunkWords;
  const int chunks_per_split = (n_chunks + ksplit - 1) / ksplit;
  const int splits = (n_chunks + chunks_per_split - 1) / chunks_per_split;
  int32_t* o = static_cast<int32_t*>(out);
  const int atomic = splits > 1;
  if (atomic) cudaMemsetAsync(o, 0, sizeof(int32_t) * (size_t)M * N, s);
  dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, splits);
  const uint32_t* am = static_cast<const uint32_t*>(amag);
  const uint32_t* as = static_cast<const uint32_t*>(asign);
  const uint32_t* wm = static_cast<const uint32_t*>(wmag);
  const uint32_t* ws = static_cast<const uint32_t*>(wsign);
  const int32_t* p = static_cast<const int32_t*>(pw);
  const int32_t* oc = static_cast<const int32_t*>(wocc);
  switch (bm) {
    case 1: launch<1>(grid, s, am, as, n_a, M, wm, ws, n_w, kw, N, p, oc, gate, o, chunks_per_split, atomic); break;
    case 2: launch<2>(grid, s, am, as, n_a, M, wm, ws, n_w, kw, N, p, oc, gate, o, chunks_per_split, atomic); break;
    case 4: launch<4>(grid, s, am, as, n_a, M, wm, ws, n_w, kw, N, p, oc, gate, o, chunks_per_split, atomic); break;
    case 8: launch<8>(grid, s, am, as, n_a, M, wm, ws, n_w, kw, N, p, oc, gate, o, chunks_per_split, atomic); break;
    case 16: launch<16>(grid, s, am, as, n_a, M, wm, ws, n_w, kw, N, p, oc, gate, o, chunks_per_split, atomic); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
