// A2 gqa_decode: fused KV append + GQA flash decode, and A9 gqa_attend:
// the same decode without the append. One query token per row.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::gqa_fused_decode_pallas
// (:314), built on paged_decode_stream (:146), with A2; and
// parallax_tpu/ops/attention_pallas.py::gqa_decode_attention_pallas (:130,
// kernel :40), the split path's sink decode, with A9.
// Bound on the H100: bytes. A decode step reads each row's valid pages of
// K and V once per KV head and does only G * D multiply-adds per key.
// Design: grid (S, Hkv); block (s, h) streams row s's valid pages of head h
// through the shared core in attend.cuh. A2's block first writes row s's
// new K and V of head h into its slot (skipped for slot < 0), then
// __syncthreads(), so the new token attends to itself. The TPU program
// reads its appended row back through the aliased cache; here the barrier
// gives the same visibility inside the block, and no other block touches
// that head of that slot in the launch (a row's tail slot is private to
// the row). A9 has no append and no barrier before its pages: the split
// path scattered the step's K/V before the launch. The TPU split kernel
// visits every page slot of the row on a (S, pages_per_seq) grid and masks;
// A9 visits only the valid ones, which gives the same sums (a skipped page
// would fold in nothing). The first page is max(kv_len - W, 0) / page under
// a sliding window. Sinks seed the running max and denominator. Rows with
// kv_len = 0 (bucket padding) write zeros. A9 takes no soft cap, as K6.

#include "attend.cuh"

namespace {

template <typename T, int MAXR, bool kAppend>
__global__ void __launch_bounds__(256)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, T* cache, T* out,
                      const int* __restrict__ kv_lens,
                      const int* __restrict__ page_indices,
                      const int* __restrict__ slots,
                      const float* __restrict__ sinks, int pps,
                      long long total_slots, pk::AttendParams ap) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  if constexpr (kAppend) {
    const int slot = slots[s];
    if (slot >= 0 && slot < total_slots) {
      T* dst = cache + (long long)slot * 2 * ap.hkv * ap.d + 2LL * h * ap.d;
      const long long src = ((long long)s * ap.hkv + h) * ap.d;
      for (int i = threadIdx.x; i < ap.d; i += blockDim.x) {
        dst[i] = k_new[src + i];
        dst[ap.d + i] = v_new[src + i];
      }
    }
    __syncthreads();  // the append is visible to this block's page loads
  }
  pk::AttendSmem sm = pk::attend_carve<T>(smem, ap.g, MAXR, ap.d, ap.page);
  float acc[MAXR];
  pk::attend_init<T, MAXR>(sm, q, sinks, s, 1, h, ap, acc);
  pk::attend_fold_seq<T, MAXR>(sm, cache, page_indices + (long long)s * pps,
                               s, 1, s, s + 1, kv_lens[s], h, ap, acc);
  pk::attend_finish<T, MAXR>(sm, out, s, 1, s + 1, h, ap, acc);
}

template <typename T, int MAXR, bool kAppend>
int launch(const void* q, const void* k_new, const void* v_new, void* cache,
           void* out, const void* kv_lens, const void* page_indices,
           const void* slots, const void* sinks, int s, int pps,
           long long total_slots, const pk::AttendParams& ap,
           cudaStream_t st) {
  const int threads = max(64, (ap.d + 31) / 32 * 32);
  const size_t smem = pk::attend_smem_bytes<T>(ap.g, MAXR, ap.d, ap.page);
  auto kern = gqa_decode_kernel<T, MAXR, kAppend>;
  cudaError_t err = pk::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s, ap.hkv);
  kern<<<grid, threads, smem, st>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)cache, (T*)out,
      (const int*)kv_lens, (const int*)page_indices, (const int*)slots,
      (const float*)sinks, pps, total_slots, ap);
  return (int)cudaGetLastError();
}

template <typename T, bool kAppend>
int launch_g(const void* q, const void* k_new, const void* v_new,
             void* cache, void* out, const void* kv_lens,
             const void* page_indices, const void* slots, const void* sinks,
             int s, int pps, long long total_slots,
             const pk::AttendParams& ap, cudaStream_t st) {
  if (ap.g <= 16) {
    return launch<T, 16, kAppend>(q, k_new, v_new, cache, out, kv_lens,
                                  page_indices, slots, sinks, s, pps,
                                  total_slots, ap, st);
  }
  return launch<T, 64, kAppend>(q, k_new, v_new, cache, out, kv_lens,
                                page_indices, slots, sinks, s, pps,
                                total_slots, ap, st);
}

template <bool kAppend>
int launch_t(const void* q, const void* k_new, const void* v_new,
             void* cache, void* out, const void* kv_lens,
             const void* page_indices, const void* slots, const void* sinks,
             int s, int pps, long long total_slots,
             const pk::AttendParams& ap, int dtype, cudaStream_t st) {
  if (dtype == pk::kBF16) {
    return launch_g<__nv_bfloat16, kAppend>(q, k_new, v_new, cache, out,
                                            kv_lens, page_indices, slots,
                                            sinks, s, pps, total_slots, ap,
                                            st);
  }
  return launch_g<float, kAppend>(q, k_new, v_new, cache, out, kv_lens,
                                  page_indices, slots, sinks, s, pps,
                                  total_slots, ap, st);
}

}  // namespace

extern "C" int pk_gqa_decode(const void* q, const void* k_new,
                             const void* v_new, void* cache, void* out,
                             const void* kv_lens, const void* page_indices,
                             const void* slots, const void* sinks, int s,
                             int hq, int hkv, int d, int page, int pps,
                             long long total_slots, int window,
                             float sm_scale, float soft_cap, int dtype,
                             void* stream) {
  if (s <= 0) return 0;
  pk::AttendParams ap{hq, hkv, hq / hkv, d, page, window, sm_scale, soft_cap};
  return launch_t<true>(q, k_new, v_new, cache, out, kv_lens, page_indices,
                        slots, sinks, s, pps, total_slots, ap, dtype,
                        (cudaStream_t)stream);
}

extern "C" int pk_gqa_attend(const void* q, const void* cache, void* out,
                             const void* kv_lens, const void* page_indices,
                             const void* sinks, int s, int hq, int hkv, int d,
                             int page, int pps, int window, float sm_scale,
                             int dtype, void* stream) {
  if (s <= 0) return 0;
  pk::AttendParams ap{hq, hkv, hq / hkv, d, page, window, sm_scale, 0.f};
  return launch_t<false>(q, nullptr, nullptr, const_cast<void*>(cache), out,
                         kv_lens, page_indices, nullptr, sinks, s, pps, 0,
                         ap, dtype, (cudaStream_t)stream);
}
