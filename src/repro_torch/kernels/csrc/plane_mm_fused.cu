// Fused bit-serial linear layer for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/plane_mm_fused.py::fused_plane_linear
// (Pallas body _fused_kernel). Same function, computed bit for bit:
//
//   out[m, n] = epilogue( sum_{i,j} pw[i*P_w + j] * sum_k a_i[m, k] * w_j[k, n] )
//
// where a_i are the bit planes sliced on chip from the raw int8 activation
// (shift/mask as slice_activation_planes; Booth planes b[i-1] - b[i]) and
// w_j the weight planes unpacked from blocked packed words (mag - 2*sign;
// in a pack block of bkw words, bit t of word w holds k = t*bkw + w). The
// sum is taken modulo 2^32 in uint32 (signed overflow is undefined in C++,
// the reference's int32 arithmetic wraps). The epilogue is
// ((float(acc) * a_scale[m]) * w_scale[n]) [+ bias[n]] -> silu | gelu(tanh)
// -> bf16, with every float operation rounded separately (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false) so the result is bit-equal
// to the plain PyTorch version; raw mode stores the int32 accumulator.
//
// What bounds it on the H100: at decode (M <= 16) the packed weight words,
// 2 bytes per weight at 8 Booth planes, read once — memory. At prefill the
// P_w folded products (below) are compute: this kernel runs them on the
// CUDA cores (no tensor cores), so it stays far above the int8 tensor-core
// bound; mma/wgmma, TMA and pipelining are later work.
//
// What the design does about it:
// * The TPU's sequential K grid dimension is a loop over the K pack blocks
//   inside one CUDA block; the VMEM accumulator is registers.
// * The activation side is folded first: for each weight plane j and each
//   (m, k), u_j[m, k] = sum_i pw[i*P_w + j] * a_i[m, k] (mod 2^32) is
//   computed once per block into shared memory, so the inner loop does P_w
//   multiply-adds per (m, n, k) instead of a_bits * P_w. The regrouping is
//   exact in modular arithmetic for any pair weights (truncated tiers and
//   compacted caches pass their own).
// * Each weight word is read from device memory once per block, by the
//   thread that owns its output column (32 columns per block, lanes on
//   neighbouring columns: coalesced); the four warps split the words of a
//   pack block and reduce through shared memory at the end. This weight
//   side and the reduction are plane_mm_common.cuh, shared with the packed
//   kernel.
// * Decode shapes give few blocks, so K is split across blocks (ksplit)
//   when that fills the card: partial sums go by integer atomics (exact in
//   any order) into an int32 workspace and a second small kernel applies
//   the epilogue. ksplit == 1 keeps the accumulator out of device memory.
// * gate (occupancy-predicated pairs) computes the same sum; the kernel
//   takes every pair, which is the same result.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "plane_mm_common.cuh"

namespace {

using plane_mm::kBN;
using plane_mm::kThreads;
constexpr int kMaxBlock = 512;   // K values per pack block staged in shared memory
constexpr int kMaxPairs = 64;    // a_bits * P_w <= 8 * 8

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 1) {  // silu: x * sigmoid(x), sigmoid(x) = 1 / (1 + exp(-x))
    float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    return __fmul_rn(v, s);
  }
  if (act == 2) {  // gelu, tanh form: x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))
    float x3 = __fmul_rn(__fmul_rn(v, v), v);
    float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(v, __fmul_rn(0.044715f, x3)));
    float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
    return __fmul_rn(v, cdf);
  }
  return v;
}

__device__ __forceinline__ void store_out(uint32_t acc, int mg, int ng, int N,
                                          const float* __restrict__ a_scale,
                                          const float* __restrict__ w_scale,
                                          const float* __restrict__ bias, int act,
                                          void* __restrict__ out, int raw) {
  const size_t o = (size_t)mg * N + ng;
  if (raw) {
    static_cast<int32_t*>(out)[o] = (int32_t)acc;
    return;
  }
  float v = __fmul_rn(__fmul_rn(__int2float_rn((int32_t)acc), a_scale[mg]), w_scale[ng]);
  if (bias != nullptr) v = __fadd_rn(v, bias[ng]);
  v = activation(v, act);
  static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
fused_plane_linear_kernel(const int8_t* __restrict__ x, int M, int K,
                          const int32_t* __restrict__ wmag,
                          const int32_t* __restrict__ wsign,
                          int n_w, int kw, int N, int bkw,
                          const int32_t* __restrict__ pair_w, int a_bits, int booth,
                          const float* __restrict__ a_scale,
                          const float* __restrict__ w_scale,
                          const float* __restrict__ bias, int act,
                          void* __restrict__ out, int raw,
                          int32_t* __restrict__ ws, int kb_per_split) {
  __shared__ int8_t xs[BM][kMaxBlock];
  __shared__ __align__(16) uint32_t us[kMaxBlock][BM];
  __shared__ uint32_t pws[kMaxPairs];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + (tid & 31);
  const int m0 = blockIdx.y * BM;
  const int bk = bkw * 32;
  const int nk = kw / bkw;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(nk, kb0 + kb_per_split);
  const int amask = (1 << a_bits) - 1;

  if (tid < a_bits * n_w) pws[tid] = (uint32_t)pair_w[tid];

  uint32_t acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0u;

  for (int kb = kb0; kb < kb1; ++kb) {
    __syncthreads();  // the previous block's readers of xs/us are done
    for (int idx = tid; idx < BM * bk; idx += kThreads) {
      const int m = idx / bk, kk = idx - m * bk;
      const int mg = m0 + m, k = kb * bk + kk;
      xs[m][kk] = (mg < M && k < K) ? x[(size_t)mg * K + k] : (int8_t)0;
    }
    for (int j = 0; j < n_w; ++j) {
      __syncthreads();  // xs staged / the previous plane's readers of us are done
      for (int idx = tid; idx < BM * bk; idx += kThreads) {
        const int kk = idx / BM, m = idx - kk * BM;
        const int v = (int)xs[m][kk] & amask;  // two's-complement low a_bits bits
        uint32_t u = 0u;
        int prev = 0;
        for (int i = 0; i < a_bits; ++i) {
          const int cur = (v >> i) & 1;
          const int plane = booth ? (prev - cur) : cur;
          prev = cur;
          u += (uint32_t)plane * pws[i * n_w + j];
        }
        us[kk][m] = u;
      }
      __syncthreads();
      if (n < N) {
        const size_t off = ((size_t)j * kw + (size_t)kb * bkw) * N + n;
        plane_mm::accumulate_column<BM>(
            acc, reinterpret_cast<const uint32_t*>(wmag) + off,
            wsign != nullptr ? reinterpret_cast<const uint32_t*>(wsign) + off : nullptr,
            N, bkw, us, bkw, /*skip_zero=*/true);
      }
    }
  }

  plane_mm::reduce_warps<BM>(acc, &us[0][0], [&](uint32_t s, int m, int c) {
    const int mg = m0 + m, ng = blockIdx.x * kBN + c;
    if (mg < M && ng < N) {
      if (ws != nullptr) {
        atomicAdd(reinterpret_cast<unsigned int*>(ws) + (size_t)mg * N + ng, s);
      } else {
        store_out(s, mg, ng, N, a_scale, w_scale, bias, act, out, raw);
      }
    }
  });
}

__global__ void epilogue_kernel(const int32_t* __restrict__ ws, int M, int N,
                                const float* __restrict__ a_scale,
                                const float* __restrict__ w_scale,
                                const float* __restrict__ bias, int act,
                                void* __restrict__ out, int raw) {
  const size_t total = (size_t)M * N;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int mg = (int)(o / N), ng = (int)(o - (size_t)mg * N);
    store_out((uint32_t)ws[o], mg, ng, N, a_scale, w_scale, bias, act, out, raw);
  }
}

template <int BM>
void launch(dim3 grid, cudaStream_t stream, const int8_t* x, int M, int K,
            const int32_t* wmag, const int32_t* wsign, int n_w, int kw, int N, int bkw,
            const int32_t* pw, int a_bits, int booth, const float* a_scale,
            const float* w_scale, const float* bias, int act, void* out, int raw,
            int32_t* ws, int kb_per_split) {
  fused_plane_linear_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, M, K, wmag, wsign, n_w, kw, N, bkw, pw, a_bits, booth, a_scale, w_scale, bias,
      act, out, raw, ws, kb_per_split);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success; 1 =
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int fused_plane_linear_launch(
    const void* x, int M, int K, const void* wmag, const void* wsign, int n_w, int kw,
    int N, int bkw, const void* pair_w, int a_bits, int booth, const void* a_scale,
    const void* w_scale, const void* bias, int act, void* out, int raw, void* ws,
    int ksplit, int bm, void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  if (bkw < 1 || bkw * 32 > kMaxBlock || kw % bkw != 0 || a_bits < 1 || a_bits > 8 ||
      n_w < 1 || a_bits * n_w > kMaxPairs || ksplit < 1 || M < 1 || N < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = kw / bkw;
  const int kb_per_split = (nk + ksplit - 1) / ksplit;
  const int splits = (nk + kb_per_split - 1) / kb_per_split;
  int32_t* wsp = nullptr;
  if (splits > 1) {
    wsp = static_cast<int32_t*>(ws);
    cudaMemsetAsync(wsp, 0, sizeof(int32_t) * (size_t)M * N, s);
  }
  dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, splits);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int32_t* mp = static_cast<const int32_t*>(wmag);
  const int32_t* sp = static_cast<const int32_t*>(wsign);
  const int32_t* pp = static_cast<const int32_t*>(pair_w);
  const float* as = static_cast<const float*>(a_scale);
  const float* wsc = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  switch (bm) {
    case 1: launch<1>(grid, s, xp, M, K, mp, sp, n_w, kw, N, bkw, pp, a_bits, booth, as, wsc, b, act, out, raw, wsp, kb_per_split); break;
    case 2: launch<2>(grid, s, xp, M, K, mp, sp, n_w, kw, N, bkw, pp, a_bits, booth, as, wsc, b, act, out, raw, wsp, kb_per_split); break;
    case 4: launch<4>(grid, s, xp, M, K, mp, sp, n_w, kw, N, bkw, pp, a_bits, booth, as, wsc, b, act, out, raw, wsp, kb_per_split); break;
    case 8: launch<8>(grid, s, xp, M, K, mp, sp, n_w, kw, N, bkw, pp, a_bits, booth, as, wsc, b, act, out, raw, wsp, kb_per_split); break;
    case 16: launch<16>(grid, s, xp, M, K, mp, sp, n_w, kw, N, bkw, pp, a_bits, booth, as, wsc, b, act, out, raw, wsp, kb_per_split); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    epilogue_kernel<<<blocks, 256, 0, s>>>(wsp, M, N, as, wsc, b, act, out, raw);
  }
  return (int)cudaGetLastError();
}
