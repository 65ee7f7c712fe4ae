// Byte folds of device memory: one launch sums the bytes of a table of
// segments into uint32 totals with wraparound.
//
// Replaces the reference's compiled fingerprints: `jax.jit(
// integrity.tree_checksum)` (src/repro/launch/serve.py:181), the at-rest
// fold of the whole quantized weight tree, and `jax.jit(
// cache_slot_checksums)` (:667), the per-slot folds of the KV cache. It has
// no Pallas counterpart: XLA fused those folds itself.
//
// Segment s is `n_slots` spans of `stride_s` bytes at `ptr_s`: span i adds
// into out[i]. The whole tree is every leaf as one span into one total; the
// cache is every leaf (slot axis leading) as n_slots spans into n_slots
// totals. A sum of bytes modulo 2^32 does not depend on the order of its
// terms, so the blocks may meet in any order (atomics) and the result is
// the plain versions' (`integrity.tree_checksum`, `cache_slot_checksums`)
// bit for bit; `fold.chunked_fold` is the plain model of this kernel's
// chunks.
//
// Bound: one read of every byte, no arithmetic to speak of (3.40 GB of
// full-width granite-3-8b at 4 layers, ~1.01 ms at 3.35 TB/s). The design
// keeps the card's memory busy: each block folds one chunk of kChunk bytes
// of one span with 16-byte loads, four in flight a thread before any is
// summed (dp4a sums a word's four bytes in one instruction), then one
// atomicAdd a block. A misaligned head and a ragged tail go byte by byte.
// Blocks find their segment by a binary search of the table's first-block
// column, so a launch covers segments of any size with no idle blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace fold {

constexpr int kThreads = 256;
constexpr long long kChunk = 1LL << 16;  // bytes a block folds (kernels/fold.py: CHUNK_BYTES)
constexpr int kUnroll = 4;               // 16-byte loads in flight a thread

// table: n_seg rows of (pointer, stride in bytes, first block), int64
__global__ void __launch_bounds__(kThreads) fold_kernel(const long long* __restrict__ table,
                                                        int n_seg, unsigned int* __restrict__ out) {
  const long long b = blockIdx.x;
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {  // the last segment whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if (table[3 * mid + 2] <= b) lo = mid; else hi = mid - 1;
  }
  const unsigned char* base = reinterpret_cast<const unsigned char*>(table[3 * lo]);
  const long long stride = table[3 * lo + 1];
  const long long per_span = (stride + kChunk - 1) / kChunk;
  const long long local = b - table[3 * lo + 2];
  const long long slot = local / per_span, c = local % per_span;
  const unsigned char* p = base + slot * stride + c * kChunk;
  const long long len = stride - c * kChunk < kChunk ? stride - c * kChunk : kChunk;

  unsigned int acc = 0;
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > len) head = len;
  for (long long i = threadIdx.x; i < head; i += kThreads) acc += p[i];
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long n_vec = (len - head) / 16;
  for (long long i0 = threadIdx.x; i0 < n_vec; i0 += kUnroll * kThreads) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      w[u] = i < n_vec ? __ldg(v + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = __dp4a(w[u].x, 0x01010101u, acc);
      acc = __dp4a(w[u].y, 0x01010101u, acc);
      acc = __dp4a(w[u].z, 0x01010101u, acc);
      acc = __dp4a(w[u].w, 0x01010101u, acc);
    }
  }
  for (long long i = head + 16 * n_vec + threadIdx.x; i < len; i += kThreads) acc += p[i];

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ unsigned int part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? part[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) atomicAdd(out + slot, acc);
  }
}

}  // namespace fold

// Zero out[0 .. n_slots) and fold the table's segments into it on `stream`
// (n_blocks: the table's total of blocks). Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int fold_launch(const long long* table, int n_seg, long long n_blocks, int n_slots,
                           unsigned int* out, cudaStream_t stream) {
  cudaGetLastError();  // clear any earlier sticky-free error
  cudaMemsetAsync(out, 0, sizeof(unsigned int) * (size_t)n_slots, stream);
  if (n_seg > 0 && n_blocks > 0) {
    fold::fold_kernel<<<(unsigned int)n_blocks, fold::kThreads, 0, stream>>>(table, n_seg, out);
  }
  return (int)cudaGetLastError();
}

extern "C" long long fold_chunk_bytes() { return fold::kChunk; }
