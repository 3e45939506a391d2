// A2 gqa_decode: fused KV append + GQA flash decode, and A9 gqa_attend:
// the same decode without the append. One query token per row.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::gqa_fused_decode_pallas
// (:314), built on paged_decode_stream (:146), with A2; and
// parallax_tpu/ops/attention_pallas.py::gqa_decode_attention_pallas (:130,
// kernel :40), the split path's sink decode, with A9.
// Bound on the H100: bytes. A decode step reads each row's valid pages of
// K and V once per KV head and does only G * D multiply-adds per key; at 7
// rows and contexts of a few hundred tokens the bytes take 2 us, so what
// bounds the kernel in practice is latency: how many blocks stream pages
// at once, and whether each keeps a copy in flight while it computes.
// Design: split-KV (flash-decoding) over the core in attend.cuh. Grid
// (S, Hkv, splits): block (s, h, k) streams split k of row s's valid pages
// of head h (split_range: runs of at least kSplitKeys keys, at most
// kMaxSplits of them, from the window's first page max(kv_len - W, 0) /
// page) through a two-stage cp.async ring, with the G query heads as the
// M of bf16 m16n8k16 tensor-core tiles (padded to 16 or 32 rows) for both
// Q K^T and P V, four warps dividing each 64-key tile. It writes the
// split's partial (m, l, o) to f32 scratch; a second launch on the same
// stream, grid (S, Hq), merges each row's splits per query head in split
// order, the sink folded in once, and writes o / l (zeros for kv_len = 0).
// Blocks past a row's last split exit. A2's append is done by the split that owns the row's
// last page: it writes row s's new K and V of head h into the slot
// (skipped for slot < 0), reaches a barrier, then reads the page; no other
// split reads that slot, and no other block writes it (a row's tail slot
// is private to the row). A9 has no append: the split path scattered the
// step's K/V before the launch. A9 takes no soft cap, as K6. The TPU split
// kernel visits every page slot of the row on a (S, pages_per_seq) grid and
// masks; A9 visits only the valid ones, which gives the same sums.

#include "attend.cuh"

namespace {

struct DecodeArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* cache;
  void* out;
  const int* kv_lens;
  const int* page_indices;
  const int* slots;
  const float* sinks;
  float* scratch;
  int s, num_splits;
  long long total_slots;
  pk::AttnParams ap;
};

template <typename T, int D, int MT, bool kAppend>
__global__ void __launch_bounds__(pk::kDecodeThreads)
    gqa_decode_split_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  pk::decode_split<T, D, MT, kAppend>(
      smem, static_cast<const T*>(a.q), s, static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), kAppend ? a.slots[s] : -1,
      a.total_slots, static_cast<T*>(a.cache),
      a.page_indices + (long long)s * a.ap.pps, a.kv_lens[s], s, blockIdx.y,
      blockIdx.z, a.num_splits, a.scratch, a.ap);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    gqa_decode_combine_kernel(const DecodeArgs a) {
  const int s = blockIdx.x;
  pk::combine_head<T, D>(a.scratch, a.sinks, static_cast<T*>(a.out), s,
                         a.kv_lens[s], s, blockIdx.y, a.num_splits, a.ap);
}

template <bool kAppend>
struct Launch {
  template <typename T, int D, int MT>
  static int run(const DecodeArgs& a, cudaStream_t st) {
    const size_t smem = pk::attn_smem_bytes<T, D>(16 * MT);
    auto split = gqa_decode_split_kernel<T, D, MT, kAppend>;
    cudaError_t err = pk::allow_smem(split, smem);
    if (err != cudaSuccess) return (int)err;
    split<<<dim3(a.s, a.ap.hkv, a.num_splits), pk::kDecodeThreads, smem,
            st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gqa_decode_combine_kernel<T, D><<<dim3(a.s, a.ap.hq), D, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int pk_gqa_decode(const void* q, const void* k_new,
                             const void* v_new, void* cache, void* out,
                             const void* kv_lens, const void* page_indices,
                             const void* slots, const void* sinks,
                             void* scratch, int s, int hq, int hkv, int d,
                             int page, int pps, int num_splits,
                             long long total_slots, int window,
                             float sm_scale, float soft_cap, int dtype,
                             void* stream) {
  if (s <= 0) return 0;
  const DecodeArgs a{q, k_new, v_new, cache, out,
                     (const int*)kv_lens, (const int*)page_indices,
                     (const int*)slots, (const float*)sinks, (float*)scratch,
                     s, num_splits, total_slots,
                     {hq, hkv, hq / hkv, page, pps, window, sm_scale,
                      soft_cap}};
  return pk::dispatch_attn<Launch<true>>(dtype, d, hq / hkv, a,
                                         (cudaStream_t)stream);
}

extern "C" int pk_gqa_attend(const void* q, const void* cache, void* out,
                             const void* kv_lens, const void* page_indices,
                             const void* sinks, void* scratch, int s, int hq,
                             int hkv, int d, int page, int pps,
                             int num_splits, int window, float sm_scale,
                             int dtype, void* stream) {
  if (s <= 0) return 0;
  const DecodeArgs a{q, nullptr, nullptr, const_cast<void*>(cache), out,
                     (const int*)kv_lens, (const int*)page_indices, nullptr,
                     (const float*)sinks, (float*)scratch, s, num_splits, 0,
                     {hq, hkv, hq / hkv, page, pps, window, sm_scale, 0.f}};
  return pk::dispatch_attn<Launch<false>>(dtype, d, hq / hkv, a,
                                          (cudaStream_t)stream);
}
