// Blockwise (flash) attention with online softmax for Hopper (sm_90a): the
// dense kernel and the paged decode kernel.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   * flash_attention (Pallas body _flash_kernel): q (B, Hq, Sq, D) against
//     K/V (B, Hkv, Sk, D) in bf16, float32 or int8 with (B, Hkv, Sk) float32
//     scales, GQA through head hq -> hq / (Hq / Hkv), causal masking aligned
//     to the top left (q_pos >= k_pos, both counted from 0) with whole KV
//     blocks above the diagonal skipped, and padding masked by a static
//     kv_len or per-lane kv_lens;
//   * paged_flash_attention (Pallas body _paged_kernel): decode attention
//     straight off the int8 page pools (n_pages, page_size, Hkv, D) and their
//     float32 scale pools (n_pages, page_size, Hkv) through block tables
//     (B, P); pages at or past a lane's length are skipped.
// Same function as the reference kernels, in their operation order (see
// attn_common.cuh); the output is acc / max(l, 1e-30) in float32 or bf16.
//
// What bounds it on the H100: at decode, bytes — every live page of K and V
// (one byte a value) and its scales, read once: B = 64 lanes of 512-4096
// positions at granite's 8 KV heads and D = 128 are ~0.3 GB, ~0.1 ms at
// 3.35 TB/s. Prefill is bound by operations, 4 B Hq Sq Sk D (halved when
// causal) at 989 TFLOP/s bf16.
//
// Three bodies, chosen by the call's arguments (the wrapper's
// flash_attention.dense_body and paged_body), never as a fallback on failure:
// * the tensor-core prefill body (attn_mma.cuh, mma.sync bf16): dense calls
//   with bf16 q, bf16 or int8 K/V, block_q a multiple of 16, head_dim 64 or
//   128, 16-byte-aligned operands;
// * the split-KV decode body on the tensor cores (attn_decode.cuh): the
//   paged kernel for bf16 q, head_dim 64 or 128, at most 8 query rows a KV
//   head (group x Sq) and 16-byte-aligned operands, and its twin, the dense
//   decode call: bf16 q, int8 K/V, block_q < 16, non-causal with kv_lens, the
//   same head dims, rows and alignment. Both run one body through two
//   addressings, so on gathered pools the two give the same bits;
// * the CUDA-core body (attn_common.cuh, float32 throughout): everything
//   else — float32 q or K/V, where the tensor cores would round, other head
//   dims, causal or static-length calls at block_q < 16, and paged calls
//   with more query rows.
//
// Design of the CUDA-core body (simple and right first):
// * The TPU's sequential KV grid axis with VMEM scratch becomes a loop over
//   KV blocks inside one CUDA block; (m, l, acc) live in shared memory.
// * Paged: one CUDA block per (lane, KV head) holds that head's group of
//   Hq / Hkv query heads, so each page of K and V is read from device memory
//   once per group, with 16-byte loads. The block reads its own table entries
//   and kv_lens[b] (the TPU's scalar prefetch) and stops after
//   ceil(len / page_size) pages, so it never reads the null page's garbage; a
//   lane of length 0 runs no page and writes 0 / 1e-30 = 0, never NaN.
// * Dense: one CUDA block per (lane, query head, query block), the rows of a
//   query block over 32 split across blocks (each row's arithmetic does not
//   depend on the split); KV blocks wholly above the diagonal are skipped, as
//   the reference's should_run does.
// * Offsets into the pools and caches are 64-bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"
#include "attn_decode.cuh"
#include "attn_mma.cuh"

namespace {

using attn::kRowTile;
using attn::kThreads;

template <typename QT>
__device__ inline void load_q_row(float* dst, const QT* __restrict__ src, int D) {
  for (int d = 0; d < D; ++d) dst[d] = attn::to_f32(src[d]);
}

template <typename QT, typename KVT, typename OT>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const QT* __restrict__ q, const KVT* __restrict__ k, const KVT* __restrict__ v,
             const float* __restrict__ k_scale, const float* __restrict__ v_scale,
             const int32_t* __restrict__ kv_lens, OT* __restrict__ out, int Hq, int Hkv,
             int Sq, int Sk, int D, int block_q, int block_k, int causal, int kv_len,
             float sm_scale, int tiles_per_qblock, int rows_per_tile, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int hq = blockIdx.y;
  const int qi = blockIdx.x / tiles_per_qblock;
  const int tile = blockIdx.x - qi * tiles_per_qblock;
  const int row0 = qi * block_q + tile * rows_per_tile;
  const int rows_left = qi * block_q + block_q - row0;
  const int R = rows_left < rows_per_tile ? rows_left : rows_per_tile;
  const int hkv = hq / (Hq / Hkv);
  const attn::Smem sm = attn::carve(smem, rows_per_tile, D, block_k);

  const long long q_base = ((long long)(b * Hq + hq) * Sq + row0) * D;
  for (int i = threadIdx.x; i < R * D; i += kThreads) sm.q[i] = attn::to_f32(q[q_base + i]);
  attn::reset(sm, R, D);

  const int kv_steps = Sk / block_k;
  int n_run = kv_steps;
  if (causal) {  // blocks strictly above the diagonal of this query block
    const int last = (qi * block_q + block_q - 1) / block_k + 1;
    n_run = last < kv_steps ? last : kv_steps;
  }
  const int limit = kv_lens ? kv_lens[b] : kv_len;
  const long long kv_base = (long long)(b * Hkv + hkv) * Sk;
  for (int ki = 0; ki < n_run; ++ki) {
    const long long pos0 = kv_base + (long long)ki * block_k;
    attn::attend_block<KVT>(sm, R, D, block_k, k + pos0 * D, v + pos0 * D, D,
                            k_scale ? k_scale + pos0 : nullptr,
                            v_scale ? v_scale + pos0 : nullptr, 1, ki * block_k, causal != 0,
                            row0, limit, vec != 0, sm_scale);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    attn::store(out + q_base + i, sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename QT, typename OT>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k_pool,
             const int8_t* __restrict__ v_pool, const float* __restrict__ ks_pool,
             const float* __restrict__ vs_pool, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ kv_lens, OT* __restrict__ out, int Hq, int Hkv,
             int Sq, int D, int page_size, int P, float sm_scale, int rows_per_tile, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int hkv = blockIdx.y;
  const int group = Hq / Hkv;
  // rows of this block: (g, i) of query head hkv * group + g, query i
  const int row0 = blockIdx.x * rows_per_tile;
  const int rows_left = group * Sq - row0;
  const int R = rows_left < rows_per_tile ? rows_left : rows_per_tile;
  const attn::Smem sm = attn::carve(smem, rows_per_tile, D, page_size);

  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int g = (row0 + r) / Sq;
    const int i = (row0 + r) - g * Sq;
    load_q_row(sm.q + (size_t)r * D, q + ((long long)(b * Hq + hkv * group + g) * Sq + i) * D, D);
  }
  attn::reset(sm, R, D);

  const int len = kv_lens[b];
  int n_run = len > 0 ? (len + page_size - 1) / page_size : 0;
  n_run = n_run < P ? n_run : P;
  const long long row_stride = (long long)Hkv * D;  // one position of one page
  for (int ki = 0; ki < n_run; ++ki) {
    const long long page = tables[(long long)b * P + ki];
    const long long pos0 = page * page_size * Hkv + hkv;  // (page, row 0, hkv)
    attn::attend_block<int8_t>(sm, R, D, page_size, k_pool + pos0 * D, v_pool + pos0 * D,
                               row_stride, ks_pool + pos0, vs_pool + pos0, Hkv, ki * page_size,
                               false, 0, len, vec != 0, sm_scale);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int g = (row0 + r) / Sq;
    const int qi = (row0 + r) - g * Sq;
    const int d = i - r * D;
    attn::store(out + ((long long)(b * Hq + hkv * group + g) * Sq + qi) * D + d,
                sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

// dtype codes shared with the Python wrapper
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename QT, typename KVT, typename OT>
int launch_dense(dim3 grid, size_t smem, cudaStream_t s, const void* q, const void* k,
                 const void* v, const float* ks, const float* vs, const int32_t* lens, void* out,
                 int Hq, int Hkv, int Sq, int Sk, int D, int bq, int bk, int causal, int kv_len,
                 float sm_scale, int tiles, int rows, int vec) {
  auto kernel = dense_kernel<QT, KVT, OT>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const QT*>(q), static_cast<const KVT*>(k),
                                      static_cast<const KVT*>(v), ks, vs, lens,
                                      static_cast<OT*>(out), Hq, Hkv, Sq, Sk, D, bq, bk, causal,
                                      kv_len, sm_scale, tiles, rows, vec);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int dense_by_out(int out_dtype, dim3 grid, size_t smem, cudaStream_t s, const void* q,
                 const void* k, const void* v, const float* ks, const float* vs,
                 const int32_t* lens, void* out, int Hq, int Hkv, int Sq, int Sk, int D, int bq,
                 int bk, int causal, int kv_len, float sm_scale, int tiles, int rows, int vec) {
  if (out_dtype == kF32)
    return launch_dense<QT, KVT, float>(grid, smem, s, q, k, v, ks, vs, lens, out, Hq, Hkv, Sq,
                                        Sk, D, bq, bk, causal, kv_len, sm_scale, tiles, rows,
                                        vec);
  if (out_dtype == kBF16)
    return launch_dense<QT, KVT, __nv_bfloat16>(grid, smem, s, q, k, v, ks, vs, lens, out, Hq,
                                                Hkv, Sq, Sk, D, bq, bk, causal, kv_len,
                                                sm_scale, tiles, rows, vec);
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int dense_by_kv(int kv_dtype, int out_dtype, dim3 grid, size_t smem, cudaStream_t s,
                const void* q, const void* k, const void* v, const float* ks, const float* vs,
                const int32_t* lens, void* out, int Hq, int Hkv, int Sq, int Sk, int D, int bq,
                int bk, int causal, int kv_len, float sm_scale, int tiles, int rows, int vec) {
  switch (kv_dtype) {
    case kF32:
      return dense_by_out<QT, float>(out_dtype, grid, smem, s, q, k, v, ks, vs, lens, out, Hq,
                                     Hkv, Sq, Sk, D, bq, bk, causal, kv_len, sm_scale, tiles,
                                     rows, vec);
    case kBF16:
      return dense_by_out<QT, __nv_bfloat16>(out_dtype, grid, smem, s, q, k, v, ks, vs, lens,
                                             out, Hq, Hkv, Sq, Sk, D, bq, bk, causal, kv_len,
                                             sm_scale, tiles, rows, vec);
    case kI8:
      return dense_by_out<QT, int8_t>(out_dtype, grid, smem, s, q, k, v, ks, vs, lens, out, Hq,
                                      Hkv, Sq, Sk, D, bq, bk, causal, kv_len, sm_scale, tiles,
                                      rows, vec);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename OT>
int launch_paged(dim3 grid, size_t smem, cudaStream_t s, const void* q, const int8_t* kp,
                 const int8_t* vp, const float* ksp, const float* vsp, const int32_t* tables,
                 const int32_t* lens, void* out, int Hq, int Hkv, int Sq, int D, int ps, int P,
                 float sm_scale, int rows, int vec) {
  auto kernel = paged_kernel<QT, OT>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const QT*>(q), kp, vp, ksp, vsp, tables, lens,
                                      static_cast<OT*>(out), Hq, Hkv, Sq, D, ps, P, sm_scale,
                                      rows, vec);
  return (int)cudaGetLastError();
}

template <int D, typename KVT, typename OT>
int launch_mma(int B, int Hq, int Hkv, int Sq, int Sk, const void* q, const void* k,
               const void* v, const float* ks, const float* vs, const int32_t* lens, void* out,
               int bq, int bk, int causal, int kv_len, float sm_scale, cudaStream_t s) {
  auto kernel = attn_mma::dense_mma_kernel<D, KVT, OT>;
  constexpr size_t smem = attn_mma::smem_bytes<D, KVT>();
  const int err = prepare(kernel, smem);
  if (err) return err;
  const dim3 grid((Sq + attn_mma::kRows - 1) / attn_mma::kRows, Hq, B);
  kernel<<<grid, attn_mma::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), ks, vs, lens, static_cast<OT*>(out), Hq, Hkv, Sq, Sk, bq, bk,
      causal, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, typename KVT>
int mma_by_out(int out_dtype, int B, int Hq, int Hkv, int Sq, int Sk, const void* q,
               const void* k, const void* v, const float* ks, const float* vs,
               const int32_t* lens, void* out, int bq, int bk, int causal, int kv_len,
               float sm_scale, cudaStream_t s) {
  if (out_dtype == kF32)
    return launch_mma<D, KVT, float>(B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens, out, bq, bk,
                                     causal, kv_len, sm_scale, s);
  if (out_dtype == kBF16)
    return launch_mma<D, KVT, __nv_bfloat16>(B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens, out, bq,
                                             bk, causal, kv_len, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int mma_by_kv(int kv_dtype, int out_dtype, int B, int Hq, int Hkv, int Sq, int Sk,
              const void* q, const void* k, const void* v, const float* ks, const float* vs,
              const int32_t* lens, void* out, int bq, int bk, int causal, int kv_len,
              float sm_scale, cudaStream_t s) {
  if (kv_dtype == kBF16)
    return mma_by_out<D, __nv_bfloat16>(out_dtype, B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens,
                                        out, bq, bk, causal, kv_len, sm_scale, s);
  if (kv_dtype == kI8)
    return mma_by_out<D, int8_t>(out_dtype, B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens, out, bq,
                                 bk, causal, kv_len, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The split-KV decode body (attn_decode.cuh): split pass and combine pass.
template <int D, typename Addr, typename Split>
int decode_by_out(int out_dtype, Split split, const Addr& addr, int n_keys, const void* q,
                  const void* k, const void* v, const float* ks, const float* vs,
                  const int32_t* lens, void* out, float* ws, int B, int Hq, int Hkv, int Sq,
                  float sm_scale, cudaStream_t s) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const int8_t*>(k);
  const auto* vb = static_cast<const int8_t*>(v);
  if (out_dtype == kF32)
    return attn_decode::launch<D>(split, addr, n_keys, qb, kb, vb, ks, vs, lens,
                                  static_cast<float*>(out), ws, B, Hq, Hkv, Sq, sm_scale, s);
  if (out_dtype == kBF16)
    return attn_decode::launch<D>(split, addr, n_keys, qb, kb, vb, ks, vs, lens,
                                  static_cast<__nv_bfloat16*>(out), ws, B, Hq, Hkv, Sq, sm_scale,
                                  s);
  return (int)cudaErrorInvalidValue;
}

int decode_dense(int D, int out_dtype, const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int32_t* lens, void* out, float* ws,
                 int B, int Hq, int Hkv, int Sq, int Sk, float sm_scale, cudaStream_t s) {
  const attn_decode::DenseAddr addr{Hkv, Sk};
  if (D == 64)
    return decode_by_out<64>(out_dtype, attn_decode::decode_split_dense_kernel<64>, addr, Sk, q, k,
                             v, ks, vs, lens, out, ws, B, Hq, Hkv, Sq, sm_scale, s);
  if (D == 128)
    return decode_by_out<128>(out_dtype, attn_decode::decode_split_dense_kernel<128>, addr, Sk, q,
                              k, v, ks, vs, lens, out, ws, B, Hq, Hkv, Sq, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

int decode_paged(int D, int out_dtype, const void* q, const void* kp, const void* vp,
                 const float* ksp, const float* vsp, const int32_t* tables, const int32_t* lens,
                 void* out, float* ws, int B, int Hq, int Hkv, int Sq, int ps, int P,
                 float sm_scale, cudaStream_t s) {
  const attn_decode::PagedAddr addr{tables, P, ps, Hkv};
  if (D == 64)
    return decode_by_out<64>(out_dtype, attn_decode::decode_split_paged_kernel<64>, addr, P * ps,
                             q, kp, vp, ksp, vsp, lens, out, ws, B, Hq, Hkv, Sq, sm_scale, s);
  if (D == 128)
    return decode_by_out<128>(out_dtype, attn_decode::decode_split_paged_kernel<128>, addr,
                              P * ps, q, kp, vp, ksp, vsp, lens, out, ws, B, Hq, Hkv, Sq,
                              sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Positions of one split of the decode body; the wrapper sizes its
// workspace with it.
extern "C" int decode_split_keys() { return attn_decode::kSplitKeys; }

// Dense flash attention. q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), k_scale /
// v_scale (B, Hkv, Sk) or null, kv_lens (B,) or null (then kv_len masks),
// out (B, Hq, Sq, D); all contiguous. body: 1 the tensor-core prefill body
// (bf16 q, bf16 or int8 K/V, block_q % 16 == 0, D 64 or 128, 16-byte-aligned
// q, k, v), 2 the split-KV decode body (bf16 q, int8 K/V, block_q < 16,
// non-causal with kv_lens, D 64 or 128, (Hq / Hkv) * Sq <= 8, aligned;
// workspace: B * Hkv * ceil(Sk / 128) * ((Hq / Hkv) * Sq * D + 16) floats), 0
// the CUDA-core body. Returns a cudaError_t code.
extern "C" int flash_attention_launch(const void* q, int q_dtype, const void* k, const void* v,
                                      int kv_dtype, const void* k_scale, const void* v_scale,
                                      const void* kv_lens, void* out, int out_dtype, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D, int block_q,
                                      int block_k, int causal, int kv_len, float sm_scale,
                                      int vec, int body, void* workspace, void* stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || D < 1 || block_q < 1 ||
      block_k < 1 || Sq % block_q || Sk % block_k) {
    return (int)cudaErrorInvalidValue;
  }
  if (body == 2) {
    if (q_dtype != kBF16 || kv_dtype != kI8 || block_q >= 16 || causal || !kv_lens || !vec ||
        (Hq / Hkv) * Sq > attn_decode::kCols || !workspace) {
      return (int)cudaErrorInvalidValue;
    }
    return decode_dense(D, out_dtype, q, k, v, static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale), static_cast<const int32_t*>(kv_lens),
                        out, static_cast<float*>(workspace), B, Hq, Hkv, Sq, Sk, sm_scale,
                        static_cast<cudaStream_t>(stream));
  }
  if (body == 1) {
    if (q_dtype != kBF16 || block_q % 16 || !vec) return (int)cudaErrorInvalidValue;
    const float* ks = static_cast<const float*>(k_scale);
    const float* vs = static_cast<const float*>(v_scale);
    const int32_t* lens = static_cast<const int32_t*>(kv_lens);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 64)
      return mma_by_kv<64>(kv_dtype, out_dtype, B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens, out,
                           block_q, block_k, causal, kv_len, sm_scale, s);
    if (D == 128)
      return mma_by_kv<128>(kv_dtype, out_dtype, B, Hq, Hkv, Sq, Sk, q, k, v, ks, vs, lens, out,
                            block_q, block_k, causal, kv_len, sm_scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const int rows = block_q < kRowTile ? block_q : kRowTile;
  const int tiles = (block_q + rows - 1) / rows;
  const size_t smem = attn::smem_floats(rows, D, block_k) * sizeof(float);
  dim3 grid((Sq / block_q) * tiles, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* lens = static_cast<const int32_t*>(kv_lens);
  if (q_dtype == kF32)
    return dense_by_kv<float>(kv_dtype, out_dtype, grid, smem, s, q, k, v, ks, vs, lens, out, Hq,
                              Hkv, Sq, Sk, D, block_q, block_k, causal, kv_len, sm_scale, tiles,
                              rows, vec);
  if (q_dtype == kBF16)
    return dense_by_kv<__nv_bfloat16>(kv_dtype, out_dtype, grid, smem, s, q, k, v, ks, vs, lens,
                                      out, Hq, Hkv, Sq, Sk, D, block_q, block_k, causal, kv_len,
                                      sm_scale, tiles, rows, vec);
  return (int)cudaErrorInvalidValue;
}

// Paged decode attention. q (B, Hq, Sq, D); pools (n_pages, page_size, Hkv,
// D) int8 and (n_pages, page_size, Hkv) float32; tables (B, P) and kv_lens
// (B,) int32; out (B, Hq, Sq, D); all contiguous. body: 1 the split-KV decode
// body (bf16 q, D 64 or 128, (Hq / Hkv) * Sq <= 8, 16-byte-aligned q and
// pools; workspace: B * Hkv * ceil(P * page_size / 128) * ((Hq / Hkv) * Sq *
// D + 16) floats), 0 the CUDA-core body.
extern "C" int paged_flash_attention_launch(const void* q, int q_dtype, const void* k_pool,
                                            const void* v_pool, const void* ks_pool,
                                            const void* vs_pool, const void* tables,
                                            const void* kv_lens, void* out, int out_dtype, int B,
                                            int Hq, int Hkv, int Sq, int D, int page_size, int P,
                                            float sm_scale, int vec, int body, void* workspace,
                                            void* stream) {
  cudaGetLastError();
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || D < 1 || page_size < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (body == 1) {
    if (q_dtype != kBF16 || !vec || (Hq / Hkv) * Sq > attn_decode::kCols || !workspace) {
      return (int)cudaErrorInvalidValue;
    }
    return decode_paged(D, out_dtype, q, k_pool, v_pool, static_cast<const float*>(ks_pool),
                        static_cast<const float*>(vs_pool), static_cast<const int32_t*>(tables),
                        static_cast<const int32_t*>(kv_lens), out,
                        static_cast<float*>(workspace), B, Hq, Hkv, Sq, page_size, P, sm_scale,
                        static_cast<cudaStream_t>(stream));
  }
  const int total_rows = (Hq / Hkv) * Sq;
  const int rows = total_rows < kRowTile ? total_rows : kRowTile;
  const size_t smem = attn::smem_floats(rows, D, page_size) * sizeof(float);
  dim3 grid((total_rows + rows - 1) / rows, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k_pool);
  const int8_t* vp = static_cast<const int8_t*>(v_pool);
  const float* ksp = static_cast<const float*>(ks_pool);
  const float* vsp = static_cast<const float*>(vs_pool);
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(kv_lens);
  if (q_dtype == kBF16 && out_dtype == kBF16)
    return launch_paged<__nv_bfloat16, __nv_bfloat16>(grid, smem, s, q, kp, vp, ksp, vsp, t, l,
                                                      out, Hq, Hkv, Sq, D, page_size, P,
                                                      sm_scale, rows, vec);
  if (q_dtype == kBF16 && out_dtype == kF32)
    return launch_paged<__nv_bfloat16, float>(grid, smem, s, q, kp, vp, ksp, vsp, t, l, out, Hq,
                                              Hkv, Sq, D, page_size, P, sm_scale, rows, vec);
  if (q_dtype == kF32 && out_dtype == kBF16)
    return launch_paged<float, __nv_bfloat16>(grid, smem, s, q, kp, vp, ksp, vsp, t, l, out, Hq,
                                              Hkv, Sq, D, page_size, P, sm_scale, rows, vec);
  if (q_dtype == kF32 && out_dtype == kF32)
    return launch_paged<float, float>(grid, smem, s, q, kp, vp, ksp, vsp, t, l, out, Hq, Hkv, Sq,
                                      D, page_size, P, sm_scale, rows, vec);
  return (int)cudaErrorInvalidValue;
}
