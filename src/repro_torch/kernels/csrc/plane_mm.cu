// Plane-pair matrix multiplication for Hopper (sm_90a), on int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/plane_mm.py::plane_matmul
// (Pallas body _plane_mm_kernel). Same function, bit for bit, for any int32
// pair weights:
//
//   out[m, n] = sum_{i,j} pw[i*P_w + j] * sum_k A[i, m, k] * W[j, k, n]   (int32, wrapping)
//
// over int8 planes A (P_a, M, K) and W (P_w, K, N): bit planes in {-1, 0, 1}
// or Booth radix-256 digits in [-128, 127], with any pw (+-2^(i+j), +-256^(i+j)
// wrapped to int32 by the caller, or anything else).
//
// The arithmetic. Every plane pair is one int8 tensor-core product
// (mma.sync.m16n8k32.s8.s8.s32). Over one K chunk of 128 values a pair's
// product is exact in int32: |a * w| <= 2^14, so |sum| <= 2^21. Right after
// each chunk the pair's sum is folded into a uint32 total,
// total += (uint32)pw[p] * (uint32)acc_p, which is the exact result modulo
// 2^32 whatever pw is. So no pair weight needs checking or factoring, and
// K-split partial sums meet through uint32 atomics in any order. Looping over
// the pairs inside each chunk keeps the registers bounded (one pair's
// accumulator at a time), so 8 x 8 bit-plane pairs stay exact as 2 x 2 digits.
//
// What bounds it on the H100: at decode (M <= 8) the weight planes, one byte
// per weight and plane (2 bytes per weight at the digit level), read once —
// memory, 0.031 ms for granite's gate projection at 3.35 TB/s. At prefill the
// P_a * P_w products per (m, n, k): 4 at the digit level where an operations
// bound that folds the planes first would count min(P_a, P_w) = 2.
// With an outer-product pw (every pw the plan executors build) the byte-split
// route of the fused and packed kernels (bytesplit.digit_plan) would regroup
// the planes into A @ W and run one int8 product per signed byte of A times
// one per byte of W: for int8 digit pairs that is fewer products, but it
// needs a staging pass that sums the planes into bytes, and this kernel is
// also the one that must take any pw (the all-pairs path of the other two);
// the factors route is not taken here.
//
// Design:
// * A block owns 128 output columns (four warps of 32) x BM = 8 * NT tokens
//   x a range of K chunks. The weights are the 16-row mma operand (two m16
//   tiles per warp), the tokens the n8 one: at decode one n8 tile holds every
//   token.
// * Per K chunk the A planes' (BM x 128)-byte tiles and one W plane's
//   (128 x 128)-byte tile at a time are staged in shared memory with cp.async,
//   one (chunk, plane) tile ahead of the one being multiplied (two buffers of
//   each). A W tile is staged once and reused across every A plane.
// * The int8 mma wants both operands K-contiguous. A's planes are (M, K) rows
//   already. W's are (K, N) with N contiguous, and ldmatrix .trans moves only
//   16-bit elements, so each thread reads four 4-byte words (four K rows,
//   four columns) of the staged tile and transposes them with __byte_perm
//   (byte_transpose4x4: 8 PRMT) into four columns' K-quads: straight A
//   fragments. A warp transposes its 32 columns x 128 K once per (chunk,
//   W plane) into 32 registers and reuses them for every A plane.
// * Both staged tiles are swizzled by 16-byte chunk (W by K row, A by token)
//   so the fragment reads of a warp hit 32 distinct banks.
// * Decode shapes give few blocks, so K is split across blocks (ksplit, about
//   4 blocks per SM); the partial sums meet by uint32 atomicAdd into the
//   zeroed output. More than kMaxAPlanes A planes run as several launches
//   into the same output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // four warps
constexpr int kBN = 128;           // output columns per block (32 per warp)
constexpr int kBK = 128;           // K values per chunk: a pair's exact int32 span
constexpr int kWTile = kBK * kBN;  // bytes of one W plane's staged tile
constexpr int kMaxAPlanes = 16;    // A planes per launch
constexpr int kMaxWPlanes = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// w[r] holds bytes (k0 + r, n0..n0+3); afterwards w[c] holds bytes
// (k0..k0+3, n0 + c): a 4x4 byte transpose, 8 byte permutes.
__device__ __forceinline__ void byte_transpose4x4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);  // r2c0 r3c0 r2c1 r3c1
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W plane j's tile of K rows [k0, k0 + kBK) x columns [n0, n0 + kBN): row r
// at dst + r * kBN, 16-byte chunk c of it stored at chunk c ^ (((r >> 2) & 3) << 1).
// Zero beyond K and N. kVec: 16-byte cp.async (N % 16 == 0, W 16-byte
// aligned); else byte loads.
template <bool kVec>
__device__ __forceinline__ void stage_w(uint8_t* __restrict__ dst, const int8_t* __restrict__ W,
                                        int K, int N, int k0, int n0) {
  for (int idx = threadIdx.x; idx < kBK * (kBN / 16); idx += kThreads) {
    const int r = idx >> 3, c = idx & 7;
    const int k = k0 + r, n = n0 + 16 * c;
    uint8_t* d = dst + r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
    if constexpr (kVec) {
      const bool ok = k < K && n < N;
      cp_async16(d, ok ? W + (size_t)k * N + n : W, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < K) {
        for (int e = 0; e < 16; ++e) {
          if (n + e < N) v[e >> 2] |= (uint32_t)(uint8_t)W[(size_t)k * N + n + e] << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The n_a A planes' tiles of tokens [m0, m0 + BM) x K [k0, k0 + kBK): token
// t of plane i at dst + (i * BM + t) * kBK, chunk c stored at chunk c ^ (t & 7).
template <int BM, bool kVec>
__device__ __forceinline__ void stage_a(uint8_t* __restrict__ dst, const int8_t* __restrict__ A,
                                        int n_a, int M, int K, int m0, int k0) {
  for (int idx = threadIdx.x; idx < n_a * BM * (kBK / 16); idx += kThreads) {
    const int c = idx & 7, it = idx >> 3;  // it = i * BM + t
    const int t = it % BM, i = it / BM;
    const int m = m0 + t, k = k0 + 16 * c;
    uint8_t* d = dst + it * kBK + ((c ^ (t & 7)) << 4);
    const int8_t* src = A + ((size_t)i * M + m) * K + k;
    if constexpr (kVec) {
      const bool ok = m < M && k < K;
      cp_async16(d, ok ? src : A, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
        for (int e = 0; e < 16; ++e) {
          if (k + e < K) v[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int NT, bool kVec>
__global__ void __launch_bounds__(kThreads, NT >= 4 ? 2 : 4)
plane_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                const int32_t* __restrict__ pw, int n_a, int n_w, int M, int K, int N,
                uint32_t* __restrict__ out, int chunks_per_split, int atomic) {
  constexpr int BM = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wbuf = smem;                                // [2][kBK][kBN]
  uint8_t* abuf = smem + 2 * kWTile;                   // [2][n_a][BM][kBK]
  uint32_t* pw_s = reinterpret_cast<uint32_t*>(abuf + 2 * (size_t)n_a * BM * kBK);
  const size_t a_tile = (size_t)n_a * BM * kBK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);

  for (int p = threadIdx.x; p < n_a * n_w; p += kThreads) pw_s[p] = (uint32_t)pw[p];

  uint32_t total[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[t][nt][e] = 0u;

  // the thread's column word of a staged W row: columns 32 warp + 4 g .. + 3
  const int w_off = ((((2 * warp + (g >> 2)) ^ (q << 1)) & 7) << 4) + ((g & 3) << 2);
  const int n_tiles = (c1 - c0) * n_w;  // (chunk, W plane) pairs, plane fastest
  if (n_tiles > 0) {
    stage_a<BM, kVec>(abuf, A, n_a, M, K, m0, c0 * kBK);
    stage_w<kVec>(wbuf, W, K, N, c0 * kBK, n0);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cc = tile / n_w, j = tile - cc * n_w;
    if (tile + 1 < n_tiles) {
      const int cn = (tile + 1) / n_w, jn = (tile + 1) - cn * n_w;
      if (jn == 0) stage_a<BM, kVec>(abuf + (cn & 1) * a_tile, A, n_a, M, K, m0, (c0 + cn) * kBK);
      stage_w<kVec>(wbuf + ((tile + 1) & 1) * kWTile, W + (size_t)jn * K * N, K, N,
                    (c0 + cn) * kBK, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // this warp's 32 columns x 128 K of W plane j as A fragments: wf[s][T]
    // is m16 tile T (rows g, g+8 = columns 4g + 2T, 4g + 2T + 1) of k32 step s
    const uint8_t* ws = wbuf + (tile & 1) * kWTile + w_off;
    uint32_t wf[4][2][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r] = *reinterpret_cast<const uint32_t*>(ws + (32 * s + 16 * h + 4 * q + r) * kBN);
        }
        byte_transpose4x4(x);  // x[c]: K bytes 32s + 16h + 4q .. +3 of column 4g + c
        wf[s][0][2 * h] = x[0];
        wf[s][0][2 * h + 1] = x[1];
        wf[s][1][2 * h] = x[2];
        wf[s][1][2 * h + 1] = x[3];
      }

    const uint8_t* as = abuf + (cc & 1) * a_tile;
    for (int i = 0; i < n_a; ++i) {
      int32_t acc[2][NT][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0;
      const uint8_t* ai = as + (size_t)i * BM * kBK;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint8_t* row = ai + (nt * 8 + g) * kBK + (q << 2);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + (((2 * s) ^ g) << 4));
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + (((2 * s + 1) ^ g) << 4));
          mma_s8(acc[0][nt], wf[s][0], b0, b1);
          mma_s8(acc[1][nt], wf[s][1], b0, b1);
        }
      const uint32_t p = pw_s[i * n_w + j];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[t][nt][e] += p * (uint32_t)acc[t][nt][e];
    }
    __syncthreads();  // the buffers of this tile are free for the next loads
  }

  // d0/d1 (row g) and d2/d3 (row g + 8) of tile t: columns 4g + 2t, +1; tokens 2q, 2q + 1
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 32 * warp + 4 * g + 2 * t + (e >> 1);
        const int m = m0 + nt * 8 + 2 * q + (e & 1);
        if (m < M && n < N) {
          uint32_t* o = out + (size_t)m * N + n;
          if (atomic) {
            atomicAdd(o, total[t][nt][e]);
          } else {
            *o = total[t][nt][e];
          }
        }
      }
}

template <int NT, bool kVec>
int launch(dim3 grid, size_t smem, cudaStream_t s, const int8_t* A, const int8_t* W,
           const int32_t* pw, int n_a, int n_w, int M, int K, int N, uint32_t* out, int cps,
           int atomic) {
  static bool attr_set = false;  // raise the dynamic shared memory limit once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(plane_mm_kernel<NT, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  plane_mm_kernel<NT, kVec><<<grid, kThreads, smem, s>>>(A, W, pw, n_a, n_w, M, K, N, out, cps,
                                                         atomic);
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success;
// cudaErrorInvalidValue for arguments the kernel does not take). bm: the
// row tile (8, 16 or 32 tokens); ksplit: K-chunk splits across blocks.
extern "C" int plane_matmul_launch(const void* A, const void* W, const void* pw, int n_a,
                                   int n_w, int M, int K, int N, void* out, int ksplit, int bm,
                                   void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  if (n_a < 1 || n_w < 1 || n_w > kMaxWPlanes || M < 1 || N < 1 || K < 1 || ksplit < 1 ||
      (bm != 8 && bm != 16 && bm != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (K + kBK - 1) / kBK;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  const int splits = (n_chunks + cps - 1) / cps;
  const int groups = (n_a + kMaxAPlanes - 1) / kMaxAPlanes;
  const int atomic = splits > 1 || groups > 1;
  uint32_t* o = static_cast<uint32_t*>(out);
  if (atomic) cudaMemsetAsync(o, 0, sizeof(uint32_t) * (size_t)M * N, s);
  const bool vec = K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const dim3 grid((M + bm - 1) / bm, (N + kBN - 1) / kBN, splits);
  for (int i0 = 0; i0 < n_a; i0 += kMaxAPlanes) {
    const int na = n_a - i0 < kMaxAPlanes ? n_a - i0 : kMaxAPlanes;
    const int8_t* a = static_cast<const int8_t*>(A) + (size_t)i0 * M * K;
    const int8_t* w = static_cast<const int8_t*>(W);
    const int32_t* p = static_cast<const int32_t*>(pw) + (size_t)i0 * n_w;
    const size_t smem = 2 * (size_t)kWTile + 2 * (size_t)na * bm * kBK + 4 * (size_t)na * n_w;
    int err = 0;
#define PLANE_MM_LAUNCH(NT, V) \
  err = launch<NT, V>(grid, smem, s, a, w, p, na, n_w, M, K, N, o, cps, atomic)
    switch (bm * 2 + (vec ? 1 : 0)) {
      case 16: PLANE_MM_LAUNCH(1, false); break;
      case 17: PLANE_MM_LAUNCH(1, true); break;
      case 32: PLANE_MM_LAUNCH(2, false); break;
      case 33: PLANE_MM_LAUNCH(2, true); break;
      case 64: PLANE_MM_LAUNCH(4, false); break;
      case 65: PLANE_MM_LAUNCH(4, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef PLANE_MM_LAUNCH
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
