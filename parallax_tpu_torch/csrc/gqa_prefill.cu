// A1 gqa_prefill: ragged chunked-prefill GQA flash attention over the paged
// cache, attend-only (the chunk's K/V were appended by kv_append.cu, which
// the wrapper launches first on the same stream). Also the split path's
// ragged attention for every batch without sinks (K9's route), decode
// steps included.
//
// Replaces: parallax_tpu/ops/prefill_fused_pallas.py::gqa_fused_prefill_pallas
// (its attention part; its in-kernel append is kv_append.cu).
// Bound on the H100: bytes at the shapes the engine gives it (Hq = 28,
// Hkv = 4, D = 128, bf16 cache): a tile reads its sequence's causal
// context once per KV head for all G heads of the group; a 749-token chunk
// over cached prefixes is 3.6 GFLOP against 13 MB. On one-token rows it is
// a decode step, bound by latency as gqa_decode.cu says.
// Design: per-sequence tiles, no tile straddles two sequences. Three
// launches on one stream, no host sync:
// 1. Multi-token tiles, grid (tile bound, Hkv). A tile is up to
//    Shape::kRows (token, head) rows of one sequence (q_tile = kRows / G
//    tokens), eight warps of 16 rows (four for f32 at D = 256), with bf16 m16n8k16 tensor-core products for
//    Q K^T and P V and the online softmax in registers, over pages streamed
//    through a two-stage cp.async ring (attend.cuh). Each block finds its
//    (sequence, tile) from cu_q_lens / num_seqs on the device: warp 0
//    prefix-sums the sequences' tile counts with one shuffle scan. The
//    grid is the static bound (t + (min(S, t / 2) + 1) (q_tile - 1)) /
//    q_tile; surplus blocks exit. The bucket padding [cu[num_seqs], t) is
//    one more entry whose tiles write exact zeros. Pages visited: [lo,
//    ceil((qmax + 1) / page)) with lo = max(qmin - W + 1, 0) / page under a
//    sliding window; a warp skips a page tile that starts past its rows.
// 2. One-token sequences take the decode role: grid (S, Hkv, splits) over
//    the same decode_split device function, split partition and scratch
//    layout as A2 / A9 (gqa_decode.cu), so a decode row through A1 gives
//    A2's bits.
// 3. The same combine as A2 / A9 for the one-token sequences.
// kv_lens carries each row's FULL context (cached prefix + this chunk), so
// prefix-cache hits and chunked prefill need no special case.

#include "attend.cuh"

namespace {

struct PrefillArgs {
  const void* q;
  const void* cache;
  void* out;
  const int* kv_lens;
  const int* page_indices;
  const int* cu;
  const int* num_seqs;
  const float* sinks;
  float* scratch;
  int t, s, q_tile, num_splits;
  pk::AttnParams ap;
};

// Two bf16 blocks fit an SM (104 KB of shared memory each at D = 128) when
// each thread keeps to 128 registers; an f32 block takes 198 KB, a bf16
// block at D = 256 198 KB (one a SM, up to 255 registers a thread: the
// 16-row output accumulator alone is 128 f32 registers at D = 256).
template <typename T, int D>
__global__ void __launch_bounds__(32 * pk::Shape<T, D>::kWarps,
                                  sizeof(T) == 2 && D <= 128 ? 2 : 1)
    gqa_prefill_tile_kernel(const PrefillArgs a) {
  extern __shared__ __align__(16) char smem[];
  pk::prefill_tile<T, D>(smem, static_cast<const T*>(a.q),
                         static_cast<const T*>(a.cache),
                         static_cast<T*>(a.out), a.kv_lens, a.page_indices,
                         a.cu, a.num_seqs[0], a.t, a.q_tile, a.sinks,
                         blockIdx.x, blockIdx.y, a.ap);
}

// Sequence s's one token is cu[s]; sequences of other lengths exit.
__device__ inline bool one_token(const PrefillArgs& a, int s) {
  return s < a.num_seqs[0] && a.cu[s + 1] - a.cu[s] == 1;
}

template <typename T, int D, int MT>
__global__ void __launch_bounds__(pk::kDecodeThreads)
    gqa_prefill_split_kernel(const PrefillArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  if (!one_token(a, s)) return;
  pk::decode_split<T, D, MT, false>(
      smem, static_cast<const T*>(a.q), a.cu[s], nullptr, nullptr, -1, 0,
      const_cast<T*>(static_cast<const T*>(a.cache)),
      a.page_indices + (long long)s * a.ap.pps, a.kv_lens[s], s, blockIdx.y,
      blockIdx.z, a.num_splits, a.scratch, a.ap);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    gqa_prefill_combine_kernel(const PrefillArgs a) {
  const int s = blockIdx.x;
  if (!one_token(a, s)) return;
  pk::combine_head<T, D>(a.scratch, a.sinks, static_cast<T*>(a.out),
                         a.cu[s], a.kv_lens[s], s, blockIdx.y, a.num_splits,
                         a.ap);
}

struct Launch {
  template <typename T, int D, int MT>
  static int run(const PrefillArgs& a, cudaStream_t st) {
    // Every multi-token sequence, and the padding, wastes less than one
    // tile; at most min(S, t / 2) sequences hold two tokens or more.
    using S = pk::Shape<T, D>;
    // A tile's rows must fit the block's query rows (the wrapper's
    // q_tile_for(G, tile_rows(D, elem))).
    if (a.q_tile < 1 || a.q_tile * a.ap.g > S::kRows) {
      return (int)cudaErrorInvalidValue;
    }
    const long long multi = a.s < a.t / 2 ? a.s : a.t / 2;
    const long long tiles =
        ((long long)a.t + (multi + 1) * (a.q_tile - 1)) / a.q_tile;
    const size_t tile_smem = pk::attn_smem_bytes<T, D>(S::kRows);
    auto tile = gqa_prefill_tile_kernel<T, D>;
    cudaError_t err = pk::allow_smem(tile, tile_smem);
    if (err != cudaSuccess) return (int)err;
    tile<<<dim3((unsigned)tiles, a.ap.hkv), 32 * S::kWarps, tile_smem,
           st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.s == 0) return (int)err;
    const size_t split_smem = pk::attn_smem_bytes<T, D>(16 * MT);
    auto split = gqa_prefill_split_kernel<T, D, MT>;
    err = pk::allow_smem(split, split_smem);
    if (err != cudaSuccess) return (int)err;
    split<<<dim3(a.s, a.ap.hkv, a.num_splits), pk::kDecodeThreads,
            split_smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gqa_prefill_combine_kernel<T, D><<<dim3(a.s, a.ap.hq), D, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int pk_gqa_prefill(const void* q, const void* cache, void* out,
                              const void* kv_lens, const void* page_indices,
                              const void* cu_q_lens, const void* num_seqs,
                              const void* sinks, void* scratch, int t, int s,
                              int hq, int hkv, int d, int page, int pps,
                              int q_tile, int num_splits, int window,
                              float sm_scale, float soft_cap, int dtype,
                              void* stream) {
  if (t <= 0) return 0;
  const PrefillArgs a{q, cache, out, (const int*)kv_lens,
                      (const int*)page_indices, (const int*)cu_q_lens,
                      (const int*)num_seqs, (const float*)sinks,
                      (float*)scratch, t, s, q_tile, num_splits,
                      {hq, hkv, hq / hkv, page, pps, window, sm_scale,
                       soft_cap}};
  return pk::dispatch_attn<Launch>(dtype, d, hq / hkv, a,
                                   (cudaStream_t)stream);
}
