// A0 kv_append: copy each token's interleaved [2*Hkv, D] K/V row into its
// paged-cache slot.
//
// Replaces: the in-kernel append DMAs of the TPU kernels
//   parallax_tpu/ops/prefill_fused_pallas.py::gqa_fused_prefill_pallas
//   (append_row, :142-157) — and, as the split path's scatter,
//   parallax_tpu/ops/kv_cache_ops.py::reshape_and_cache.
// Bound on the H100: bytes. It moves 2 * T * 2*Hkv*D elements (read once,
// written once) and does no arithmetic: 3 MB, under 1 us, for a 749-token
// Qwen2.5-7B prefill, so a launch's fixed cost is most of its time.
// Design: one warp per token, kTokensPerBlock tokens a block, one launch.
// A warp whose slot is negative (padding) or out of range returns at once,
// as the JAX scatter's mode="drop". Lanes copy 16-byte vectors (8 bf16 or
// 4 f32): k and v are [T, Hkv, D] and contiguous, so chunk i of a token's
// K (head h = i / chunks_per_head) lands at chunk i + h * chunks_per_head
// of its cache row and the V chunk one head further; each lane carries
// its head forward as it strides, so no chunk pays a division. The copy is
// a bit copy, so the cache equals the plain version's bitwise. D * element
// size must be a multiple of 16 bytes and the pointers 16-byte aligned
// (the wrapper refuses the rest). The TPU prefill kernel relies on its
// grid running in order so a later block sees keys an earlier block
// appended; GPU blocks run in no order, so the prefill path launches this
// kernel FIRST and the attention kernel after it on the same stream.

#include "common.cuh"

namespace {

constexpr int kTokensPerBlock = 8;

__global__ void __launch_bounds__(32 * kTokensPerBlock)
    kv_append_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                     uint4* __restrict__ cache, const int* __restrict__ slots,
                     int t, int hkv, int chunks, long long total_slots) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kTokensPerBlock + (threadIdx.x >> 5);
  if (tok >= t) return;
  const int slot = slots[tok];
  if (slot < 0 || slot >= total_slots) return;
  const int per_tok = hkv * chunks;  // 16-byte chunks of K (or V) a token
  const uint4* ks = k + (long long)tok * per_tok;
  const uint4* vs = v + (long long)tok * per_tok;
  uint4* dst = cache + (long long)slot * 2 * per_tok;
  int h = lane / chunks;
  int c = lane - h * chunks;
  for (int i = lane; i < per_tok; i += 32) {
    const uint4 kk = ks[i];
    const uint4 vv = vs[i];
    uint4* o = dst + i + h * chunks;
    o[0] = kk;
    o[chunks] = vv;
    c += 32;
    while (c >= chunks) {
      c -= chunks;
      ++h;
    }
  }
}

}  // namespace

extern "C" int pk_kv_append(const void* k, const void* v, void* cache,
                            const void* slots, int t, int hkv, int d,
                            long long total_slots, int dtype, void* stream) {
  if (t <= 0) return 0;
  const int esz = dtype == pk::kBF16 ? 2 : 4;
  if ((d * esz) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (t + kTokensPerBlock - 1) / kTokensPerBlock;
  kv_append_kernel<<<blocks, 32 * kTokensPerBlock, 0, st>>>(
      (const uint4*)k, (const uint4*)v, (uint4*)cache, (const int*)slots, t,
      hkv, d * esz / 16, total_slots);
  return (int)cudaGetLastError();
}
