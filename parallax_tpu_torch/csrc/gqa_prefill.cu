// A1 gqa_prefill: ragged chunked-prefill GQA flash attention over the paged
// cache, attend-only (the chunk's K/V were appended by kv_append.cu, which
// the wrapper launches first on the same stream).
//
// Replaces: parallax_tpu/ops/prefill_fused_pallas.py::gqa_fused_prefill_pallas
// (its attention part; its in-kernel append is kv_append.cu).
// Bound on the H100: bytes at the shapes the engine gives it (Hq = 28,
// Hkv = 4, D = 128, bf16 cache): each (query tile, KV head) block reads its
// sequences' valid pages once and does G * tile * D multiply-adds per key.
// Design: grid (ceil(T / tile), Hkv), tile = 64 / G query tokens so a block
// holds at most 64 (token, head) rows in registers. A block finds the
// sequences its tokens belong to by binary search over cu_q_lens, then
// streams for each one the pages [lo_page, ceil((qmax + 1) / page)) with
// lo_page = max(qmin - W + 1, 0) / page under a sliding window, through the
// shared core in attend.cuh. kv_lens carries each row's FULL context
// (cached prefix + this chunk), so prefix-cache hits and chunked prefill
// need no special case. Tokens at or past cu_q_lens[num_seqs] (bucket
// padding) get exact zeros.

#include "attend.cuh"

namespace {

// The sequence that owns token ``tok`` (< cu[nseq]): the largest s with
// cu[s] <= tok, i.e. searchsorted(cu[1:], tok, side="right").
__device__ inline int seq_of(const int* cu, int nseq, int tok) {
  int lo = 0, hi = nseq - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cu[mid] <= tok) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename T, int MAXR>
__global__ void __launch_bounds__(256)
    gqa_prefill_kernel(const T* __restrict__ q, const T* cache, T* out,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ page_indices,
                       const int* __restrict__ cu,
                       const int* __restrict__ num_seqs,
                       const float* __restrict__ sinks, int t, int pps,
                       int q_tile, pk::AttendParams ap) {
  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.y;
  const int tok0 = blockIdx.x * q_tile;
  const int ntok = min(q_tile, t - tok0);
  pk::AttendSmem sm =
      pk::attend_carve<T>(smem, q_tile * ap.g, MAXR, ap.d, ap.page);
  const int nseq = num_seqs[0];
  const int live_end = nseq > 0 ? cu[nseq] : 0;
  float acc[MAXR];
  pk::attend_init<T, MAXR>(sm, q, sinks, tok0, ntok, h, ap, acc);
  if (tok0 < live_end) {
    const int s_lo = seq_of(cu, nseq, tok0);
    const int s_hi = seq_of(cu, nseq, min(tok0 + ntok, live_end) - 1);
    for (int s = s_lo; s <= s_hi; ++s) {
      pk::attend_fold_seq<T, MAXR>(sm, cache,
                                   page_indices + (long long)s * pps, tok0,
                                   ntok, cu[s], cu[s + 1], kv_lens[s], h, ap,
                                   acc);
    }
  }
  pk::attend_finish<T, MAXR>(sm, out, tok0, ntok, live_end, h, ap, acc);
}

template <typename T>
int launch(const void* q, const void* cache, void* out, const void* kv_lens,
           const void* page_indices, const void* cu, const void* num_seqs,
           const void* sinks, int t, int pps, int q_tile,
           const pk::AttendParams& ap, cudaStream_t st) {
  constexpr int kMaxRows = 64;
  const int threads = max(64, (ap.d + 31) / 32 * 32);
  const size_t smem =
      pk::attend_smem_bytes<T>(q_tile * ap.g, kMaxRows, ap.d, ap.page);
  auto kern = gqa_prefill_kernel<T, kMaxRows>;
  cudaError_t err = pk::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + q_tile - 1) / q_tile, ap.hkv);
  kern<<<grid, threads, smem, st>>>(
      (const T*)q, (const T*)cache, (T*)out, (const int*)kv_lens,
      (const int*)page_indices, (const int*)cu, (const int*)num_seqs,
      (const float*)sinks, t, pps, q_tile, ap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pk_gqa_prefill(const void* q, const void* cache, void* out,
                              const void* kv_lens, const void* page_indices,
                              const void* cu_q_lens, const void* num_seqs,
                              const void* sinks, int t, int hq, int hkv,
                              int d, int page, int pps, int q_tile,
                              int window, float sm_scale, float soft_cap,
                              int dtype, void* stream) {
  if (t <= 0) return 0;
  pk::AttendParams ap{hq, hkv, hq / hkv, d, page, window, sm_scale, soft_cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pk::kBF16) {
    return launch<__nv_bfloat16>(q, cache, out, kv_lens, page_indices,
                                 cu_q_lens, num_seqs, sinks, t, pps, q_tile,
                                 ap, st);
  }
  return launch<float>(q, cache, out, kv_lens, page_indices, cu_q_lens,
                       num_seqs, sinks, t, pps, q_tile, ap, st);
}
