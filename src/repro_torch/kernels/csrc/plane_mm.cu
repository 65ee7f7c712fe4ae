// Plane-pair matrix multiplication for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/plane_mm.py::plane_matmul
// (Pallas body _plane_mm_kernel). Same function, bit for bit:
//
//   out[m, n] = sum_{i,j} pw[i*P_w + j] * sum_k A[i, m, k] * W[j, k, n]   (int32)
//
// over int8 planes: bit planes in {-1, 0, 1} or Booth radix-256 digits in
// [-128, 127], whose pair weights (+-256^(i+j)) are wrapped to int32 by the
// caller. Each plane-pair product is an exact integer dot product; the
// weighted sum is taken modulo 2^32 in uint32, which is the reference's
// int32 wraparound without C++'s undefined signed overflow.
//
// What bounds it on the H100: at digit level P_a = P_w = 2, so the weight
// planes (2 bytes per weight) dominate the bytes; folded to min(P_a, P_w)
// int8 products the work stays memory bound up to M of about 300 at the
// card's int8 tensor-core rate. This kernel does
// the multiply-adds on the CUDA cores, which caps it well below that rate
// at prefill; tensor-core (mma/wgmma) tiles are later work.
//
// What the design does about it:
// * The TPU's sequential K grid dimension ("arbitrary") becomes a loop over
//   K tiles inside the block, the VMEM accumulator becomes registers.
// * The activation side is folded once per (m, k) and weight plane j:
//   u_j[m, k] = sum_i pw[i*P_w + j] * A[i, m, k] (mod 2^32), in shared
//   memory, so the inner loop does P_w multiply-adds per (m, n, k) instead
//   of P_a * P_w; exact for any pair weights by modular arithmetic.
// * Each thread owns 4 neighbouring output columns and reads their weight
//   bytes as one 32-bit word, so a warp reads 128 contiguous bytes of a
//   weight row; the four warps split each K tile and reduce through shared
//   memory.
// * Decode shapes give few blocks, so K is split across blocks (ksplit)
//   when that fills the card; the partial sums meet by integer atomicAdd
//   into the zeroed output, which is exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                 // output columns per thread
constexpr int kBN = 32 * kCols;          // output columns per block
constexpr int kTK = 128;                 // K values per tile
constexpr int kKPerWarp = kTK / kWarps;  // 32
constexpr int kMaxPairs = 256;

template <int BM>
__global__ void __launch_bounds__(kThreads)
plane_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                const int32_t* __restrict__ pw, int n_a, int n_w, int M, int K, int N,
                int32_t* __restrict__ out, int k_per_split, int atomic) {
  __shared__ __align__(16) uint32_t us[kTK][BM];
  __shared__ uint32_t red[kWarps][BM][kBN];
  __shared__ uint32_t pws[kMaxPairs];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN + lane * kCols;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const bool vec = (N % kCols == 0) && (n0 + kCols <= N);

  for (int p = tid; p < n_a * n_w; p += kThreads) pws[p] = (uint32_t)pw[p];

  uint32_t acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0u;

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    for (int j = 0; j < n_w; ++j) {
      __syncthreads();  // pws staged / previous readers of us are done
      for (int idx = tid; idx < BM * kTK; idx += kThreads) {
        const int kk = idx / BM, m = idx - kk * BM;
        const int k = k0 + kk, mg = m0 + m;
        uint32_t u = 0u;
        if (k < kend && mg < M) {
          for (int i = 0; i < n_a; ++i) {
            const int a = (int)A[((size_t)i * M + mg) * K + k];
            u += (uint32_t)a * pws[i * n_w + j];
          }
        }
        us[kk][m] = u;
      }
      __syncthreads();
      if (n0 < N) {
        const int kk0 = warp * kKPerWarp;
        for (int kk = kk0; kk < kk0 + kKPerWarp; ++kk) {
          const int k = k0 + kk;
          if (k >= kend) break;
          const int8_t* wrow = W + ((size_t)j * K + k) * N + n0;
          int wv[kCols];
          if (vec) {
            const char4 w4 = *reinterpret_cast<const char4*>(wrow);
            wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) wv[c] = (n0 + c < N) ? (int)wrow[c] : 0;
          }
          const uint32_t* urow = us[kk];
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const uint32_t u = urow[m];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[m][c] += (uint32_t)wv[c] * u;
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp][m][lane * kCols + c] = acc[m][c];
  __syncthreads();
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int m = idx / kBN, c = idx - m * kBN;
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    const int mg = m0 + m, ng = blockIdx.x * kBN + c;
    if (mg < M && ng < N) {
      unsigned int* o = reinterpret_cast<unsigned int*>(out) + (size_t)mg * N + ng;
      if (atomic) {
        atomicAdd(o, s);
      } else {
        *o = s;
      }
    }
  }
}

template <int BM>
void launch(dim3 grid, cudaStream_t s, const int8_t* A, const int8_t* W, const int32_t* pw,
            int n_a, int n_w, int M, int K, int N, int32_t* out, int k_per_split,
            int atomic) {
  plane_mm_kernel<BM><<<grid, kThreads, 0, s>>>(A, W, pw, n_a, n_w, M, K, N, out,
                                                k_per_split, atomic);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int plane_matmul_launch(const void* A, const void* W, const void* pw, int n_a,
                                   int n_w, int M, int K, int N, void* out, int ksplit,
                                   int bm, void* stream) {
  cudaGetLastError();
  if (n_a < 1 || n_w < 1 || n_a * n_w > kMaxPairs || M < 1 || N < 1 || K < 1 ||
      ksplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (K + kTK - 1) / kTK;
  const int tiles_per_split = (n_tiles + ksplit - 1) / ksplit;
  const int splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int k_per_split = tiles_per_split * kTK;
  int32_t* o = static_cast<int32_t*>(out);
  const int atomic = splits > 1;
  if (atomic) cudaMemsetAsync(o, 0, sizeof(int32_t) * (size_t)M * N, s);
  dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, splits);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(W);
  const int32_t* p = static_cast<const int32_t*>(pw);
  switch (bm) {
    case 1: launch<1>(grid, s, a, w, p, n_a, n_w, M, K, N, o, k_per_split, atomic); break;
    case 2: launch<2>(grid, s, a, w, p, n_a, n_w, M, K, N, o, k_per_split, atomic); break;
    case 4: launch<4>(grid, s, a, w, p, n_a, n_w, M, K, N, o, k_per_split, atomic); break;
    case 8: launch<8>(grid, s, a, w, p, n_a, n_w, M, K, N, o, k_per_split, atomic); break;
    case 16: launch<16>(grid, s, a, w, p, n_a, n_w, M, K, N, o, k_per_split, atomic); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
