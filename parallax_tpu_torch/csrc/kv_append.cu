// A0 kv_append: copy each token's interleaved [2*Hkv, D] K/V row into its
// paged-cache slot.
//
// Replaces: the in-kernel append DMAs of the TPU kernels
//   parallax_tpu/ops/prefill_fused_pallas.py::gqa_fused_prefill_pallas
//   (append_row, :142-157) — and, as the split path's scatter,
//   parallax_tpu/ops/kv_cache_ops.py::reshape_and_cache.
// Bound on the H100: bytes. It moves 2 * T * 2*Hkv*D elements (read once,
// written once) and does no arithmetic.
// Design: one block per token; a block whose slot is negative (padding) or
// out of range returns at once, as the JAX scatter's mode="drop". Threads
// stride over the row so reads and writes are coalesced. The copy is a bit
// copy (16- or 32-bit words), so the cache equals the plain version's
// bitwise. The TPU prefill kernel relies on its grid running in order so a
// later block sees keys an earlier block appended; GPU blocks run in no
// order, so the prefill path launches this kernel FIRST and the attention
// kernel after it on the same stream.

#include "common.cuh"

namespace {

template <typename W>
__global__ void kv_append_kernel(const W* __restrict__ k,
                                 const W* __restrict__ v, W* cache,
                                 const int* __restrict__ slots, int hkv,
                                 int d, long long total_slots) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= total_slots) return;
  const int row = 2 * hkv * d;
  W* dst = cache + (long long)slot * row;
  const long long src0 = (long long)t * hkv * d;
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    const int h2 = i / d;
    const int dd = i - h2 * d;
    const W* src = (h2 & 1) ? v : k;
    dst[i] = src[src0 + (long long)(h2 >> 1) * d + dd];
  }
}

}  // namespace

extern "C" int pk_kv_append(const void* k, const void* v, void* cache,
                            const void* slots, int t, int hkv, int d,
                            long long total_slots, int dtype, void* stream) {
  if (t <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (dtype == pk::kBF16) {
    kv_append_kernel<uint16_t><<<t, threads, 0, st>>>(
        (const uint16_t*)k, (const uint16_t*)v, (uint16_t*)cache,
        (const int*)slots, hkv, d, total_slots);
  } else {
    kv_append_kernel<uint32_t><<<t, threads, 0, st>>>(
        (const uint32_t*)k, (const uint32_t*)v, (uint32_t*)cache,
        (const int*)slots, hkv, d, total_slots);
  }
  return (int)cudaGetLastError();
}
