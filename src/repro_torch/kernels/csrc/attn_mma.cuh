// The tensor-core body of the dense flash-attention kernel (flash_attn.cu,
// which replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention, body _flash_kernel): FA2-style on mma.sync.m16n8k16 bf16
// with float32 accumulation. The function and its operation order are the
// reference kernel's (attn_common.cuh states them); what differs is where
// the products round:
//
//   s = (q . k) * sm_scale;  s *= k_scale;  s = mask ? s : NEG_INF
//   m_new = max(m, rowmax s);  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l = alpha * l + sum p;  p *= v_scale;  o = o * alpha + p . v
//
// * q . k: bf16 q times bf16 k (an int8 k converted to bf16 in shared memory,
//   exact for |k| <= 128) is exact per product; the tensor cores sum in
//   float32.
// * p . v: p is split into a bf16 high part and a bf16 low part,
//   p_hi = bf16(p), p_lo = bf16(p - p_hi), and both go through the tensor
//   cores against bf16 v: two products, p represented to about 2^-17 of
//   itself, where one bf16 p (2^-9) would miss the float32 tolerance the
//   smoke holds the kernel to (1e-4 of max|plain|).
// * exp is __expf (ex2.approx); sums run in other orders than the plain
//   version's. kernels/flash_attention.mma_body_model is the plain model of
//   this rounding, held against the plain version on the CPU.
//
// What bounds it on the H100: prefill attention is operations, 4 B Hq Sq Sk D
// (halved when causal) at 989 TFLOP/s bf16; the p split adds half again
// (three products where the bound counts two), and mma.sync reaches a part
// of the wgmma rate. At decode (block_q < 16) the dense kernel runs the
// split-KV decode body (attn_decode.cuh) or the CUDA-core body.
//
// Design:
// * A CUDA block owns kRows = 64 query rows of one (lane, query head), each
//   of its four warps 16 rows; Q sits in registers as mma A fragments
//   (ldmatrix), s and o in float32 accumulator registers, the online softmax
//   (m, l) in registers, its row reductions across the four threads of a
//   quad (shuffles).
// * K/V tiles of kKeys = 64 positions are staged through shared memory with
//   cp.async, double buffered (the next tile loads while this one is
//   multiplied); rows are 16-byte-chunk swizzled by row so that ldmatrix
//   (K) and ldmatrix .trans (V) hit distinct banks. An int8 K/V tile is
//   converted to bf16 in shared memory (exact) before the fragment loads.
// * Which keys a warp processes follows the reference's blocks: every
//   position of the KV blocks its query block runs (top-left causal: blocks
//   wholly above the diagonal are skipped), masked to NEG_INF where causal or
//   the length mask drops it, so a lane of length 0 gives what the plain
//   version gives; positions past those blocks get -inf (p = 0). Where the
//   lane has a length above 0 every row holds a live key, so whole tiles that
//   are masked for all of a warp's rows are skipped.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // K/V positions per staged tile
constexpr float kNegInf = -1e30f;   // the reference's finite mask value

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a tile of bf16 rows of D values.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (2 * D) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of one block: Q, two raw K and V tiles, and for int8 K/V
// the bf16 copies the fragments are loaded from.
template <int D, typename KVT>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kRows * 2 * D + 4 * (size_t)kKeys * D * sizeof(KVT) +
         (std::is_same<KVT, int8_t>::value ? 2 * (size_t)kKeys * 2 * D : 0);
}

template <int D, typename KVT, typename OT>
__global__ void __launch_bounds__(kThreads)
dense_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k,
                 const KVT* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int32_t* __restrict__ kv_lens,
                 OT* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int block_q, int block_k,
                 int causal, int kv_len, float sm_scale) {
  constexpr bool kI8 = std::is_same<KVT, int8_t>::value;
  constexpr int kRowBf = 2 * D;                    // bytes of a bf16 row
  constexpr int kRowRaw = D * (int)sizeof(KVT);    // bytes of a staged K/V row
  constexpr int kTileRaw = kKeys * kRowRaw;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sq = smem;
  uint8_t* sk = sq + kRows * kRowBf;               // [2][kKeys][kRowRaw]
  uint8_t* sv = sk + 2 * kTileRaw;
  uint8_t* sk16 = sv + 2 * kTileRaw;               // int8 only: [kKeys][kRowBf]
  uint8_t* sv16 = sk16 + kKeys * kRowBf;

  const int b = blockIdx.z, hq = blockIdx.y;
  const int hkv = hq / (Hq / Hkv);
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wr0 = r0 + 16 * warp;  // the warp's rows: one query block (block_q % 16 == 0)
  const bool active = wr0 < Sq;
  const int limit = kv_lens ? kv_lens[b] : kv_len;
  const int kv_steps = Sk / block_k;
  // positions the reference runs for the query block holding `row`
  auto run_end = [&](int row) {
    if (!causal) return kv_steps * block_k;
    const int last = (row / block_q * block_q + block_q - 1) / block_k + 1;
    return (last < kv_steps ? last : kv_steps) * block_k;
  };
  const int block_end = run_end((r0 + kRows < Sq ? r0 + kRows : Sq) - 1);
  const int warp_end = active ? run_end(wr0) : 0;
  const int n_tiles = (block_end + kKeys - 1) / kKeys;

  const size_t q_base = (size_t)(b * Hq + hq) * Sq * D;
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    const bool ok = r0 + r < Sq;
    cp_async16(sq + swz<D>(r, c), ok ? q + q_base + (size_t)(r0 + r) * D + c * 8 : q, ok);
  }
  const size_t kv_base = (size_t)(b * Hkv + hkv) * Sk;
  auto load_kv = [&](int t) {
    constexpr int kChunks = kRowRaw / 16, kPer = 16 / (int)sizeof(KVT);
    uint8_t* dk = sk + (t & 1) * kTileRaw;
    uint8_t* dv = sv + (t & 1) * kTileRaw;
    for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int key = t * kKeys + r;
      const bool ok = key < block_end;
      const size_t off = (kv_base + key) * D + c * kPer;
      const int at = kI8 ? r * kRowRaw + (c << 4) : swz<D>(r, c);
      cp_async16(dk + at, ok ? k + off : k, ok);
      cp_async16(dv + at, ok ? v + off : v, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_kv(0);  // with Q

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int rows[2] = {wr0 + g, wr0 + g + 8};

  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t (and Q) landed; every warp is done with tile t - 1
    if (t == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(qf[kk], sq + swz<D>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
      }
    }
    const uint8_t* tk = sk + (t & 1) * kTileRaw;
    const uint8_t* tv = sv + (t & 1) * kTileRaw;
    if constexpr (kI8) {  // int8 -> bf16, exact; 16 values a thread and pass
      for (int i = threadIdx.x; i < 2 * kKeys * (D / 16); i += kThreads) {
        const int which = i / (kKeys * (D / 16)), j = i - which * (kKeys * (D / 16));
        const int r = j / (D / 16), c = j - r * (D / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>((which ? tv : tk) + r * kRowRaw + c * 16);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)x[2 * e], (float)x[2 * e + 1]);
        uint8_t* dst = which ? sv16 : sk16;
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      tk = sk16;
      tv = sv16;
    }
    if (t + 1 < n_tiles) load_kv(t + 1);  // overlaps this tile's products

    const int key0 = t * kKeys;
    bool run = active && key0 < warp_end;
    if (limit > 0 && (key0 >= limit || (causal && key0 > wr0 + 15))) run = false;
    if (!run) continue;

    // s = q . k over the tile's 64 positions: s[nt] is n8 tile nt (positions 8nt..)
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, tk + swz<D>(16 * np + (lane >> 4) * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // scale and mask; element e of tile nt: row rows[e >> 1], position 8nt + 2qd + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * nt + 2 * qd + (e & 1);
        float x = -INFINITY;  // past the blocks this query block runs: p = 0
        if (key < warp_end) {
          x = s[nt][e] * sm_scale;
          if (k_scale) x = x * __ldg(k_scale + kv_base + key);
          const bool keep = (!causal || rows[e >> 1] >= key) && key < limit;
          x = keep ? x : kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_r[e >> 1]);
        sum[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = alpha[h] * l_r[h] + sum[h];
    }
    if (v_scale) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * nt + 2 * qd + (e & 1);
          if (key < warp_end) s[nt][e] = s[nt][e] * __ldg(v_scale + kv_base + key);
        }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // o += p . v, p as bf16 high + low parts; positions 16kk.. are the k16 step
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a0: (g, 2qd..), a1: (g + 8, ..), a2/a3: positions + 8
        const float* src = s[2 * kk + (f >> 1)] + 2 * (f & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
        ph[f] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[f] = pack_bf16(src[0] - __low2float(hi), src[1] - __high2float(hi));
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int mat = lane >> 3;
        ldsm_x4_trans(vb, tv + swz<D>(16 * kk + (mat & 1) * 8 + (lane & 7), 2 * dp + (mat >> 1)));
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= Sq) continue;
    const float den = fmaxf(l_r[h], 1e-30f);
    OT* dst = out + q_base + (size_t)rows[h] * D + 2 * qd;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      store2(dst + 8 * dt, o[dt][2 * h] / den, o[dt][2 * h + 1] / den);
    }
  }
}

}  // namespace attn_mma
