// Fused bit-serial linear layer for Hopper (sm_90a), on int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/plane_mm_fused.py::fused_plane_linear
// (Pallas body _fused_kernel). Same function, computed bit for bit:
//
//   out[m, n] = epilogue( sum_{i,j} pw[i*P_w + j] * sum_k a_i[m, k] * w_j[k, n] )
//
// where a_i are the bit planes of the raw int8 activation (shift/mask as
// slice_activation_planes; Booth planes b[i-1] - b[i]) and w_j the weight
// planes in blocked packed words (mag - 2*sign; in a pack block of bkw words,
// bit t of word w holds k = t*bkw + w). The sum is taken modulo 2^32 (the
// reference's int32 arithmetic wraps). The epilogue is
// ((float(acc) * a_scale[m]) * w_scale[n]) [+ bias[n]] -> silu | gelu(tanh)
// -> bf16, every float operation rounded on its own (__fmul_rn / __fadd_rn,
// and the build passes -fmad=false), so the result is bit-equal to the plain
// PyTorch version; raw mode stores the int32 accumulator.
//
// The arithmetic (plane_mm_common.cuh): with pw = wa (x) ww, the planes of x
// sum to one byte per value — x's low a_bits bits, sign-extended for booth
// and sbmwc, unsigned for unsigned (.u8) — and the weight planes to the
// byte digits of their magnitude and sign words, so at 8 Booth weight
// planes the function is two exact int8 tensor-core products per
// (m, n, k), not a_bits * P_w plane pairs. The wrapper launches this only for
// such a pw (kernels/bytesplit.pair_route); any other pw goes through
// plane_mm.cu and then this library's epilogue kernel alone
// (fused_epilogue_launch).
//
// What bounds it on the H100: at decode the packed weight words, 2 bytes per
// weight at 8 Booth planes, read once — memory (0.031 ms for granite's gate
// projection); the bit transposes (60 integer operations per 32 values and
// digit) run beside the loads. At prefill the two products per (m, n, k)
// (operations bound below the byte bound up to M ~ 500 at gate) and the
// weight words read once per 32-row tile.
//
// Launches, one stream:
// 1. stage: x into activation bytes in the words' order — row (m, w) holds
//    the 32 values of word w (k = kb*bk + t*bkw + w % bkw for t = 0..31) at
//    bit_pos(t), zero beyond K — and zeroes the split-K workspace;
// 2. the main loop (plane_mm_common.cuh run_tiles) over (row tile, 128
//    columns, K split); at decode K is split across blocks so the card fills,
//    partial sums meet by uint32 atomics (exact in any order) in an int32
//    workspace, and
// 3. a small epilogue kernel applies the dequant epilogue; ksplit == 1 keeps
//    the accumulator in registers and stores the epilogue directly.
// gate (occupancy-predicated pairs) computes the same sum: the kernel takes
// every tile, so words the occupancy does not describe still count.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "plane_mm_common.cuh"

namespace {

using plane_mm::DigitPlan;
using plane_mm::kBlockCols;
using plane_mm::kChunkWords;
using plane_mm::kThreads;

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

// One thread per 4 staged bytes: word q of row (m, w) holds bits q, q+8,
// q+16, q+24 (bit_pos). Also zeroes ws.
__global__ void plane_mm_fused_stage(const int8_t* __restrict__ x, int M, int K, int KW, int KWp,
                             int bkw, int a_bits, int au8, uint32_t* __restrict__ adig,
                             uint32_t* __restrict__ ws, size_t n_ws) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const int bk = bkw * 32;
  const int sh = 32 - a_bits;
  const size_t total = (size_t)M * KWp * 8;
  for (size_t o = tid; o < total; o += stride) {
    const int q = (int)(o & 7);
    const size_t mw = o >> 3;
    const int w = (int)(mw % KWp);
    const int m = (int)(mw / KWp);
    uint32_t word = 0u;
    if (w < KW) {
      const int kb = w / bkw, wl = w - kb * bkw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kb * bk + (8 * i + q) * bkw + wl;
        if (k < K) {
          const uint32_t u = (uint32_t)(int)x[(size_t)m * K + k] << sh;
          const int v = au8 ? (int)(u >> sh) : ((int)u >> sh);
          word |= (uint32_t)(v & 0xFF) << (8 * i);
        }
      }
    }
    adig[o] = word;
  }
  for (size_t o = tid; o < n_ws; o += stride) ws[o] = 0u;
}

template <int NT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
plane_mm_fused_main(const uint8_t* __restrict__ adig, int M, int KW, int KWp,
            const uint32_t* __restrict__ wmag, const uint32_t* __restrict__ wsign, int N,
            int chunks_per_split, int au8, const __grid_constant__ DigitPlan dp,
            const float* __restrict__ a_scale, const float* __restrict__ w_scale,
            const float* __restrict__ bias, int act, void* __restrict__ out, int raw,
            uint32_t* __restrict__ ws) {
  plane_mm::run_tiles<NT, kVec4>(
      adig, M, KW, KWp, wmag, wsign, N, nullptr, chunks_per_split, au8 != 0, dp,
      [&](uint32_t s, int m, int n) {
        if (ws != nullptr) {
          atomicAdd(ws + (size_t)m * N + n, s);
        } else {
          store_out(s, m, n, N, a_scale, w_scale, bias, act, out, raw);
        }
      });
}

__global__ void plane_mm_fused_epilogue(const uint32_t* __restrict__ ws, int M, int N,
                                const float* __restrict__ a_scale,
                                const float* __restrict__ w_scale,
                                const float* __restrict__ bias, int act,
                                void* __restrict__ out, int raw) {
  const size_t total = (size_t)M * N;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int mg = (int)(o / N), ng = (int)(o - (size_t)mg * N);
    store_out(ws[o], mg, ng, N, a_scale, w_scale, bias, act, out, raw);
  }
}

template <int NT, bool kVec4>
void launch_main(dim3 grid, cudaStream_t s, const uint8_t* adig, int M, int KW, int KWp,
                 const uint32_t* wm, const uint32_t* wsg, int N, int cps, int au8,
                 const DigitPlan& dp, const float* as, const float* wsc, const float* b,
                 int act, void* out, int raw, uint32_t* ws) {
  const size_t smem = (size_t)dp.n_ad * kChunkWords * 8 * NT * 32;
  plane_mm_fused_main<NT, kVec4><<<grid, kThreads, smem, s>>>(adig, M, KW, KWp, wm, wsg, N, cps, au8,
                                                      dp, as, wsc, b, act, out, raw, ws);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success; 1 =
// cudaErrorInvalidValue for arguments the kernel does not take). plan is a
// host DigitPlan (one activation digit); adig a device scratch of
// M * KWp * 32 bytes (KWp = KW rounded up to 16 words); ws an M * N int32
// scratch, used when ksplit > 1.
extern "C" int fused_plane_linear_launch(
    const void* x, int M, int K, const void* wmag, const void* wsign, int kw, int N, int bkw,
    const void* plan, int a_bits, int au8, const void* a_scale,
    const void* w_scale, const void* bias, int act, void* out, int raw, void* ws, void* adig,
    int ksplit, int bm, int vec4, void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  const DigitPlan& dp = *static_cast<const DigitPlan*>(plan);
  if (bkw < 1 || kw % bkw != 0 || a_bits < 1 || a_bits > 8 || ksplit < 1 || M < 1 || N < 1 ||
      dp.n_ad != 1 || dp.n_wd < 1 || dp.n_wd > plane_mm::kMaxWDigits || dp.n_w < 1 ||
      dp.n_w > plane_mm::kMaxPlanes || dp.n_a != a_bits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (kw + kChunkWords - 1) / kChunkWords;
  const int KWp = n_chunks * kChunkWords;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  const int splits = (n_chunks + cps - 1) / cps;
  uint32_t* wsp = splits > 1 ? static_cast<uint32_t*>(ws) : nullptr;
  const size_t n_ws = wsp != nullptr ? (size_t)M * N : 0;
  const size_t stage_items = (size_t)M * KWp * 8;
  const size_t items = stage_items > n_ws ? stage_items : n_ws;
  const int stage_blocks = (int)((items + 255) / 256 < 2048 ? (items + 255) / 256 : 2048);
  uint8_t* ad = static_cast<uint8_t*>(adig);
  plane_mm_fused_stage<<<stage_blocks, 256, 0, s>>>(
      static_cast<const int8_t*>(x), M, K, kw, KWp, bkw, a_bits, au8,
      reinterpret_cast<uint32_t*>(ad), wsp, n_ws);

  const dim3 grid((M + bm - 1) / bm, (N + kBlockCols - 1) / kBlockCols, splits);
  const uint32_t* wm = static_cast<const uint32_t*>(wmag);
  const uint32_t* wsg = static_cast<const uint32_t*>(wsign);
  const float* as = static_cast<const float*>(a_scale);
  const float* wsc = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
#define FUSED_LAUNCH(NT, V) \
  launch_main<NT, V>(grid, s, ad, M, kw, KWp, wm, wsg, N, cps, au8, dp, as, wsc, b, act, out, raw, wsp)
  switch (bm * 2 + (vec4 ? 1 : 0)) {
    case 16: FUSED_LAUNCH(1, false); break;
    case 17: FUSED_LAUNCH(1, true); break;
    case 32: FUSED_LAUNCH(2, false); break;
    case 33: FUSED_LAUNCH(2, true); break;
    case 64: FUSED_LAUNCH(4, false); break;
    case 65: FUSED_LAUNCH(4, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FUSED_LAUNCH
  if (wsp != nullptr) {
    const size_t total = (size_t)M * N;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    plane_mm_fused_epilogue<<<blocks, 256, 0, s>>>(wsp, M, N, as, wsc, b, act, out, raw);
  }
  return (int)cudaGetLastError();
}

// The dequant epilogue alone on an int32 accumulator acc (M, N) — the
// all-pairs path's (plane_mm.cu computed acc) — into bf16 out, bit-equal to
// the main kernel's own epilogue. Returns cudaGetLastError().
extern "C" int fused_epilogue_launch(const void* acc, int M, int N, const void* a_scale,
                                     const void* w_scale, const void* bias, int act, void* out,
                                     void* stream) {
  cudaGetLastError();
  if (M < 1 || N < 1 || a_scale == nullptr || w_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  plane_mm_fused_epilogue<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), M, N, static_cast<const float*>(a_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), act, out, 0);
  return (int)cudaGetLastError();
}
