// The split-KV decode body of the attention kernels (flash_attn.cu) on the
// bf16 tensor cores. It runs the paged kernel, which replaces the TPU kernel
// src/repro/kernels/flash_attention.py::paged_flash_attention (body
// _paged_kernel), and the dense kernel's decode call, the paged kernel's
// twin: the same body through a dense addressing of K/V, so that on gathered
// pools the two give the same bits.
//
// The function is the reference kernels' (attn_common.cuh states it), over
// each lane's positions [0, len):
//
//   s = (q . k) * sm_scale;  s *= k_scale;  s = key < len ? s : NEG_INF
//   m_new = max(m, max s);  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l = alpha * l + sum p;  p *= v_scale;  o = o * alpha + p . v
//   out = o / max(l, 1e-30)
//
// What bounds it on the H100: bytes. One key of one KV head is 2 * D bytes of
// int8 K and V and two float32 scales (264 bytes at D = 128); its Hq / Hkv
// query heads (4 at granite's 32 / 8) need 4 * 4 * D operations, about 7.8
// a byte, so at 3.35 TB/s the work is ~26 TFLOP/s: out of reach of the
// float32 CUDA cores (each product and sum its own instruction under
// -fmad=false), easy for the tensor cores. B = 64 lanes of 512-4096
// positions are ~0.33 GB, ~0.1 ms.
//
// Design:
// * Split-KV ("flash-decoding"). One CUDA block of four warps works on one
//   (split, KV head, lane): kSplitKeys = 128 positions (8 pages of 16), a
//   constant, so a lane's bits never depend on which lanes share the batch.
//   The grid is (splits of the table's span, Hkv, B), known on the host; a
//   block whose split starts at or past the lane's length exits at once,
//   so at A1's shape (B = 4, lengths <= 272) 48 blocks run, not 32 whole
//   lanes, and at A2's (B = 64, 512-4096) 10,000. Each block writes its
//   partial (m, l, o) to a float32 workspace; a second launch from the same
//   C entry point (decode_combine_kernel) merges the live splits of each
//   (lane, KV head) in split order and writes o / max(l, 1e-30). Nothing is
//   read back on the host, so the call can be captured in a CUDA graph.
// * Staging: the split is two stages of kStageKeys = 64 positions (4 pages),
//   both loaded with 16-byte cp.async at once (scales with 4-byte ones), so
//   the second lands while the first is multiplied. The block reads its own
//   table entries: each thread looks up one key's row first (one table read
//   and one division a key, not one a chunk). A key row of one head is D
//   contiguous bytes (Hkv * D apart in a page), read by eight threads side by
//   side; its 16-byte chunks are XOR-swizzled by row so that the fragment
//   reads below hit distinct banks at D = 128. Positions at or past the
//   length are never read (zero-filled).
// * Orientation: S^T = K . Q^T and O^T = V^T . P^T on mma.sync.m16n8k16, so
//   a warp's 16 keys fill the m16 side and the query rows (group heads x Sq,
//   at most kCols = 8) the n8 side: at granite's 4 heads half of each
//   product is used, where Q . K^T with the 4 heads padded to m16 would use
//   a quarter (and twice the mma instructions and accumulator registers).
//   Warp w takes keys [16 w, 16 w + 16) of each stage and keeps its own
//   online softmax; the four warps' states merge in shared memory, in warp
//   order, before the split's partial is written.
// * int8 -> bf16 in registers, exact, two values at a time: byte_perm
//   builds the bf16 pair 0x43 | (x & 0x7F) (128 + the low seven bits) and
//   the pair 0x43 | (x & 0x80) (128, or 256 for a negative x); one bf16x2
//   subtraction gives x (|x| <= 128 has at most 8 significant bits). Each
//   value is converted once, by the thread whose fragment holds it; no bf16
//   copy goes through shared memory.
// * A permuted head dim, so that each fragment is a contiguous read: for q.k
//   thread (g, qd) of a warp holds d in [qd D/4, (qd + 1) D/4) of keys g and
//   g + 8 (k-step kk takes d = qd D/4 + 4 kk + {0,1} as columns 2qd, 2qd+1 and
//   + {2,3} as 2qd+8, 2qd+9, the Q fragment the same d); for p.v thread
//   (g, qd) holds d in [g D/8, (g + 1) D/8) of keys 2qd, 2qd+1, 2qd+8, 2qd+9
//   (m-tile mt has rows d = g D/8 + 2 mt and + 1). The sum over d is the same
//   sum; the output's d is where each accumulator is stored.
// * q . k: bf16 q times bf16 k is exact per product; the tensor cores sum in
//   float32. p . v: p * v_scale is split into a bf16 high and a bf16 low
//   part, each against bf16 v (~2^-18 of p), as the dense tensor-core body
//   does (attn_mma.cuh). P^T's B fragments come from S^T's accumulators by
//   eight shuffles. exp is __expf. kernels/flash_attention.paged_decode_model
//   is the plain model of this rounding (splits, warp tiles, the merges).
// * A lane of length 0 runs no split and writes 0. The dense twin runs such
//   a lane over all its positions, each masked to NEG_INF, as the dense plain
//   version does (finite, equal weights); for every other lane the twin and
//   the paged kernel run the same positions with the same values.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace attn_decode {

using attn_mma::cp_async16;
using attn_mma::mma_bf16;
using attn_mma::smem_addr;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 16;                      // keys of one warp tile: the m16 side
constexpr int kStageKeys = kWarps * kTileKeys;     // 64 keys (4 pages of 16) a stage
constexpr int kStages = 2;
constexpr int kSplitKeys = kStages * kStageKeys;   // 128 keys a split
constexpr int kCols = 8;                           // query rows a block holds: the n8 side
constexpr float kNegInf = -1e30f;                  // the reference's finite mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// Two int8 values of a word w as an exact bf16 pair: bytes 0, 1 (kSel01) or
// 2, 3 (kSel23), low element first. With t = w & 0x7F7F7F7F and sg = w &
// 0x80808080, the bf16 0x43 | low7 is 128 + low7 and 0x43 | sign is 128 +
// 128 sign; their difference is the value (|x| <= 128: exact in bf16).
constexpr unsigned kSel01 = 0x4140u, kSel23 = 0x4342u;
template <unsigned sel>
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t t, uint32_t sg) {
  const uint32_t a = __byte_perm(t, 0x43434343u, sel), b = __byte_perm(sg, 0x43434343u, sel);
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The positions a lane runs, and where a key's row lies.
struct PagedAddr {
  const int32_t* tables;  // (B, P)
  int P, page_size, Hkv;
  // its length, at most the table's span; a lane of length 0 runs none
  __device__ int run_end(int len) const {
    const int span = P * page_size;
    return len <= 0 ? 0 : (len < span ? len : span);
  }
  // (page, row, head) of the (n_pages, page_size, Hkv) pools
  __device__ long long row(int b, int hkv, int key) const {
    const int e = key / page_size;
    const long long page = __ldg(tables + (long long)b * P + e);
    return (page * page_size + (key - e * page_size)) * Hkv + hkv;
  }
};

struct DenseAddr {
  int Hkv, Sk;
  // a lane of length 0 runs every position, masked (the dense plain version)
  __device__ int run_end(int len) const { return len <= 0 ? Sk : (len < Sk ? len : Sk); }
  __device__ long long row(int b, int hkv, int key) const {
    return ((long long)b * Hkv + hkv) * Sk + key;
  }
};

template <int D>
struct Stages {
  int8_t k[kStages][kStageKeys][D];  // 16-byte chunks swizzled by row
  int8_t v[kStages][kStageKeys][D];
  float ks[kStages][kStageKeys];
  float vs[kStages][kStageKeys];
  long long row[kSplitKeys];  // each key's row in the pools (-1: past the length)
};

// after the last tile the same bytes hold the warps' states
template <int D>
struct Merge {
  float o[kWarps][kCols][D];
  float m[kWarps][kCols];
  float l[kWarps][kCols];
};

// Byte offset of 16-byte chunk c of stage row r.
template <int D>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return (c ^ (r & (D / 16 - 1))) << 4;
}

// Floats of one split's partial: o (rows x D), then m and l (kCols each), a
// multiple of 16 bytes so that o is read as float4.
__host__ __device__ inline long long part_floats(int rows, int D) {
  return (long long)rows * D + 2 * kCols;
}

template <int D, typename Addr>
__device__ __forceinline__ void split_body(const __nv_bfloat16* __restrict__ q,
                                           const int8_t* __restrict__ k,
                                           const int8_t* __restrict__ v,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale, const Addr& addr,
                                           const int32_t* __restrict__ kv_lens,
                                           float* __restrict__ ws, int Hq, int Hkv, int Sq,
                                           float sm_scale) {
  static_assert(D == 64 || D == 128, "head dims of the decode body");
  static_assert(sizeof(Merge<D>) <= sizeof(Stages<D>), "the merge reuses the stages");
  constexpr int kChunks = D / 16;   // 16-byte chunks of a key row
  constexpr int kKWords = D / 16;   // words of a key row a thread holds for q.k
  constexpr int kVWords = D / 32;   // words of a key row a thread holds for p.v
  __shared__ __align__(128) uint8_t raw[sizeof(Stages<D>)];
  Stages<D>& st = *reinterpret_cast<Stages<D>*>(raw);

  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int len = __ldg(kv_lens + b);
  const int end = addr.run_end(len);
  const int key0 = split * kSplitKeys;
  if (key0 >= end) return;  // no position of this lane in this split
  const int group = Hq / Hkv, rows = group * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;

  // each key's row once (the table read and the division), then both stages
  // at once: K/V rows in 16-byte chunks, eight threads a row, scales in 4 bytes
  static_assert(kThreads == kSplitKeys, "one thread a key of the split");
  {
    const int key = key0 + tid;
    st.row[tid] = key < end ? addr.row(b, hkv, key) : -1;
  }
  __syncthreads();
  const int n_stages = key0 + kStageKeys < end ? 2 : 1;
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < n_stages) {
      for (int i = tid; i < kStageKeys * kChunks; i += kThreads) {
        const int r = i / kChunks, c = i - r * kChunks;
        const long long row = st.row[t * kStageKeys + r];
        const bool ok = row >= 0;
        const long long at = ok ? row * D + c * 16 : 0;
        cp_async16(&st.k[t][r][chunk_at<D>(r, c)], k + at, ok);
        cp_async16(&st.v[t][r][chunk_at<D>(r, c)], v + at, ok);
      }
      if (tid < kStageKeys) {
        const long long row = st.row[t * kStageKeys + tid];
        const bool ok = row >= 0;
        if (k_scale) cp_async4(&st.ks[t][tid], k_scale + (ok ? row : 0), ok);
        else st.ks[t][tid] = 1.f;
        if (v_scale) cp_async4(&st.vs[t][tid], v_scale + (ok ? row : 0), ok);
        else st.vs[t][tid] = 1.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Q^T's B fragments (column g: query row g = head g / Sq, query g % Sq):
  // words 2 kk and 2 kk + 1 of k-step kk are d = qd D/4 + 4 kk + {0,1}, {2,3}
  uint32_t qb[D / 8];
  if (g < rows) {
    const int gh = g / Sq, qi = g - gh * Sq;
    const uint4* src = reinterpret_cast<const uint4*>(
        q + (((long long)b * Hq + hkv * group + gh) * Sq + qi) * D + qd * (D / 4));
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const uint4 w = __ldg(src + j);
      qb[4 * j] = w.x;
      qb[4 * j + 1] = w.y;
      qb[4 * j + 2] = w.z;
      qb[4 * j + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) qb[j] = 0u;
  }

  // the warp's online softmax: columns 2qd, 2qd + 1 (equal across g)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float o[D / 16][4];  // O^T m-tile mt: rows d = g D/8 + 2 mt (+1), columns 2qd (+1)
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t == 0) asm volatile("cp.async.wait_group 1;\n" ::);
    else asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const int tr = warp * kTileKeys;  // the warp tile's first stage row
    const int tile0 = key0 + t * kStageKeys + tr;
    if (tile0 >= end) continue;

    // S^T = K . Q^T: A fragments of keys g and g + 8, d in [qd D/4, (qd+1) D/4)
    uint32_t kw[2][kKWords];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tr + g + 8 * h;
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            &st.k[t][r][chunk_at<D>(r, qd * (D / 64) + j)]);
        kw[h][4 * j] = w.x;
        kw[h][4 * j + 1] = w.y;
        kw[h][4 * j + 2] = w.z;
        kw[h][4 * j + 3] = w.w;
      }
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t t0 = kw[0][kk] & 0x7F7F7F7Fu, s0 = kw[0][kk] & 0x80808080u;
      const uint32_t t1 = kw[1][kk] & 0x7F7F7F7Fu, s1 = kw[1][kk] & 0x80808080u;
      uint32_t a[4];
      a[0] = i8x2_bf16<kSel01>(t0, s0);  // key g, columns 2qd, 2qd + 1
      a[1] = i8x2_bf16<kSel01>(t1, s1);  // key g + 8
      a[2] = i8x2_bf16<kSel23>(t0, s0);  // key g, columns 2qd + 8, 2qd + 9
      a[3] = i8x2_bf16<kSel23>(t1, s1);
      mma_bf16(s, a, qb[2 * kk], qb[2 * kk + 1]);
    }

    // element e: key g + 8 (e >> 1) of the tile, column 2qd + (e & 1)
    float x[4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = g + 8 * (e >> 1);
      float y = -INFINITY;  // past the positions the lane runs: p = 0
      if (tile0 + j < end) {
        y = s[e] * sm_scale;
        y = y * st.ks[t][tr + j];
        y = tile0 + j < len ? y : kNegInf;
      }
      x[e] = y;
      mx[e & 1] = fmaxf(mx[e & 1], y);
    }
    float alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) mx[c] = fmaxf(mx[c], __shfl_xor_sync(kFull, mx[c], sh));
      const float m_new = fmaxf(m_r[c], mx[c]);  // finite: key tile0 is run
      alpha[c] = __expf(m_r[c] - m_new);
      m_r[c] = m_new;
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __expf(x[e] - m_r[e & 1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float sum = p[c] + p[2 + c];
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) sum = sum + __shfl_xor_sync(kFull, sum, sh);
      l_r[c] = alpha[c] * l_r[c] + sum;
    }
    // p * v_scale as bf16 high | low << 16
    uint32_t hl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = p[e] * st.vs[t][tr + g + 8 * (e >> 1)];
      const __nv_bfloat16 hi = __float2bfloat16_rn(pv);
      const __nv_bfloat16 lo = __float2bfloat16_rn(pv - __bfloat162float(hi));
      hl[e] = (uint32_t)__bfloat16_as_ushort(hi) | ((uint32_t)__bfloat16_as_ushort(lo) << 16);
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] *= alpha[e & 1];

    // P^T's B fragments (keys 2qd, 2qd+1 | 2qd+8, 2qd+9; column g) from the
    // lanes holding keys 2qd and 2qd + 1 of columns 2 (g / 2) + {0, 1}
    const int src0 = 8 * qd + (g >> 1), src1 = src0 + 4;
    uint32_t x0[4], x1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x0[e] = __shfl_sync(kFull, hl[e], src0);
      x1[e] = __shfl_sync(kFull, hl[e], src1);
    }
    const bool odd = g & 1;
    const uint32_t p0 = odd ? x0[1] : x0[0], p1 = odd ? x1[1] : x1[0];  // keys 2qd, 2qd + 1
    const uint32_t p8 = odd ? x0[3] : x0[2], p9 = odd ? x1[3] : x1[2];  // keys 2qd + 8, + 9
    const uint32_t bh0 = __byte_perm(p0, p1, 0x5410u), bh1 = __byte_perm(p8, p9, 0x5410u);
    const uint32_t bl0 = __byte_perm(p0, p1, 0x7632u), bl1 = __byte_perm(p8, p9, 0x7632u);

    // O^T += V^T . P^T: A fragments of keys 2qd, 2qd+1, 2qd+8, 2qd+9, d in [g D/8, (g+1) D/8)
    uint32_t vw[4][kVWords];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = tr + 2 * qd + (h & 1) + 8 * (h >> 1);
      const int byte = g * (D / 8);
      const int8_t* src = &st.v[t][r][chunk_at<D>(r, byte >> 4) + (byte & 15)];
      if constexpr (D == 128) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        vw[h][0] = w.x;
        vw[h][1] = w.y;
        vw[h][2] = w.z;
        vw[h][3] = w.w;
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(src);
        vw[h][0] = w.x;
        vw[h][1] = w.y;
      }
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      // bytes 2 (mt & 1) and 2 (mt & 1) + 1 of word mt / 2 (d = g D/8 + 2 mt, + 1) of
      // keys (2qd, 2qd + 1) and (2qd + 8, 2qd + 9), interleaved key by key
      const int wi = mt >> 1;
      const unsigned sel = (mt & 1) ? 0x7362u : 0x5140u;
      const uint32_t w01 = __byte_perm(vw[0][wi], vw[1][wi], sel);
      const uint32_t w89 = __byte_perm(vw[2][wi], vw[3][wi], sel);
      const uint32_t t01 = w01 & 0x7F7F7F7Fu, s01 = w01 & 0x80808080u;
      const uint32_t t89 = w89 & 0x7F7F7F7Fu, s89 = w89 & 0x80808080u;
      uint32_t a[4];
      a[0] = i8x2_bf16<kSel01>(t01, s01);  // row d, keys 2qd, 2qd + 1
      a[1] = i8x2_bf16<kSel23>(t01, s01);  // row d + 1
      a[2] = i8x2_bf16<kSel01>(t89, s89);  // row d, keys 2qd + 8, 2qd + 9
      a[3] = i8x2_bf16<kSel23>(t89, s89);
      mma_bf16(o[mt], a, bh0, bh1);
      mma_bf16(o[mt], a, bl0, bl1);
    }
  }

  // merge the four warps' states, in warp order, into the split's partial
  __syncthreads();  // every warp is done with the stages
  Merge<D>& mg = *reinterpret_cast<Merge<D>*>(raw);
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 2 * qd + (e & 1);
      if (col < rows) mg.o[warp][col][g * (D / 8) + 2 * mt + (e >> 1)] = o[mt][e];
    }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (2 * qd + c < rows) {
        mg.m[warp][2 * qd + c] = m_r[c];
        mg.l[warp][2 * qd + c] = l_r[c];
      }
    }
  }
  __syncthreads();
  float* part = ws + (((long long)b * Hkv + hkv) * gridDim.x + split) * part_floats(rows, D);
  for (int i = tid; i < rows * D; i += kThreads) {
    const int col = i / D, d = i - col * D;
    float mm = mg.m[0][col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, mg.m[w][col]);  // finite: warp 0 ran
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(mg.m[w][col] - mm);  // 0 for a warp that ran no tile
      acc = acc + f * mg.o[w][col][d];
      lsum = lsum + f * mg.l[w][col];
    }
    part[i] = acc;
    if (d == 0) {
      part[rows * D + col] = mm;
      part[rows * D + kCols + col] = lsum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_paged_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pool,
                          const int8_t* __restrict__ v_pool, const float* __restrict__ ks_pool,
                          const float* __restrict__ vs_pool, PagedAddr addr,
                          const int32_t* __restrict__ kv_lens, float* __restrict__ ws, int Hq,
                          int Hkv, int Sq, float sm_scale) {
  split_body<D>(q, k_pool, v_pool, ks_pool, vs_pool, addr, kv_lens, ws, Hq, Hkv, Sq, sm_scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_dense_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, DenseAddr addr,
                          const int32_t* __restrict__ kv_lens, float* __restrict__ ws, int Hq,
                          int Hkv, int Sq, float sm_scale) {
  split_body<D>(q, k, v, k_scale, v_scale, addr, kv_lens, ws, Hq, Hkv, Sq, sm_scale);
}

// One block per (KV head, lane): the live splits' partials, in split order.
template <typename Addr, typename OT>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, Addr addr,
                      const int32_t* __restrict__ kv_lens, OT* __restrict__ out, int Hq, int Hkv,
                      int Sq, int D, int n_splits) {
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv, rows = group * Sq;
  const int end = addr.run_end(__ldg(kv_lens + b));
  const int live = (end + kSplitKeys - 1) / kSplitKeys;
  const long long stride = part_floats(rows, D);
  const float* base = ws + ((long long)b * Hkv + hkv) * n_splits * stride;
  // four outputs a thread (one float4 of o per split); the loads of the
  // splits are independent, unrolled so that several are in flight
  for (int i = threadIdx.x; i < rows * D / 4; i += kThreads) {
    const int col = 4 * i / D, d = 4 * i - col * D;
    float mm = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < live; ++s) mm = fmaxf(mm, __ldg(base + s * stride + rows * D + col));
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, lsum = 0.f;  // no live split: 0 / 1e-30 = 0
#pragma unroll 8
    for (int s = 0; s < live; ++s) {
      const float* part = base + s * stride;
      const float f = __expf(__ldg(part + rows * D + col) - mm);
      const float4 x = __ldg(reinterpret_cast<const float4*>(part) + i);
      acc[0] = acc[0] + f * x.x;
      acc[1] = acc[1] + f * x.y;
      acc[2] = acc[2] + f * x.z;
      acc[3] = acc[3] + f * x.w;
      lsum = lsum + f * __ldg(part + rows * D + kCols + col);
    }
    const int gh = col / Sq, qi = col - gh * Sq;
    OT* dst = out + (((long long)b * Hq + hkv * group + gh) * Sq + qi) * D + d;
    const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) attn::store(dst + e, acc[e] / den);
  }
}

__host__ inline int splits_of(int n_keys) { return (n_keys + kSplitKeys - 1) / kSplitKeys; }

// Split pass, then combine pass, on one stream. n_keys: the positions a lane
// can hold (P * page_size, or Sk). ws: B * Hkv * splits_of(n_keys) *
// part_floats(rows, D) floats.
template <int D, typename Addr, typename Split, typename OT>
int launch(Split split, const Addr& addr, int n_keys, const __nv_bfloat16* q, const int8_t* k,
           const int8_t* v, const float* ks, const float* vs, const int32_t* lens, OT* out,
           float* ws, int B, int Hq, int Hkv, int Sq, float sm_scale, cudaStream_t s) {
  const int splits = splits_of(n_keys);
  split<<<dim3(splits, Hkv, B), kThreads, 0, s>>>(q, k, v, ks, vs, addr, lens, ws, Hq, Hkv, Sq,
                                                   sm_scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<Addr, OT><<<dim3(Hkv, B), kThreads, 0, s>>>(ws, addr, lens, out, Hq, Hkv,
                                                                    Sq, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace attn_decode
