// A7 indexer_fused and A8 indexer_scores: the sparse-attention indexer's
// per-token scores for decode batches, one query token per row. A7 first
// appends the row's new index key; A8 only scores. Two head reductions of
// the dots q_h . k: DSA sum_h w_h * relu(.), MSA max_h(.) * sm_scale.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::indexer_scores_fused_pallas
//   (:505, A7) and parallax_tpu/ops/dsa_pallas.py::paged_token_scores_decode
//   (:39, A8), which parallax_tpu/ops/dsa_pallas.py (:117, DSA) and
//   parallax_tpu/ops/msa_pallas.py (:27, MSA) wrap.
// Bound on the H100: bytes. A step reads every index key of each row's
//   context once (128 bf16 per key for DeepSeek-V3.2: under 1 MB at the
//   smoke shapes, 0.3 us) and writes f32[S, pps * page] scores; its 2 * 64
//   * 128 operations per key sit far below the tensor cores' line.
// Design: grid (row, page slot); scores do not interact across keys, so
//   each block owns one page of one row. A page at or past kv_len writes
//   -inf and returns; otherwise the block stages the page's keys with
//   16-byte loads (rows padded by 16 bytes: conflict-free reads) and the
//   row's f32 queries, and each thread computes one key's dots for a
//   strided group of heads (256 / page groups), reducing them as it goes;
//   the groups' partials meet in shared memory. Positions at or past
//   kv_len are exact -inf, and every page slot of the row is written: the
//   TPU kernel fills the whole kv_cap row with -inf first, and the top-k's
//   dense-row detection counts the finite scores.
//   The append race of A7: the block of page slot 0 alone writes the
//   cache, and every block takes the key whose slot equals the append slot
//   from the k_new input rather than the cache. Slot < 0 writes nothing.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int kDSA = 0;

struct IdxArgs {
  const void* q;            // [S, Hi, D]
  const float* weights;     // [S, Hi] (DSA) or null
  const void* k_new;        // [S, D] (A7) or null
  void* cache;              // [P, page, 1, D]
  float* scores;            // [S, pps * page]
  const int* kv_lens;       // [S]
  const int* page_indices;  // [S, pps]
  const int* slots;         // [S] (A7) or null
  int hi, d, page, pps;
  long long total_slots;
  int reduce;               // 0 = DSA, 1 = MSA
  float sm_scale;
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) indexer_kernel(IdxArgs a) {
  constexpr int EPC = 16 / sizeof(T);
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  const int s = blockIdx.x;
  const int jp = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = a.kv_lens[s];
  const int base = jp * a.page;
  const int chunks = a.d / EPC;
  const int stride = chunks + 1;
  T* cache = reinterpret_cast<T*>(a.cache);
  const T* k_new = reinterpret_cast<const T*>(a.k_new);
  const int slot = a.slots != nullptr ? a.slots[s] : -1;
  const bool live = slot >= 0 && slot < a.total_slots;
  if (live && jp == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(k_new + (long long)s * a.d);
    uint4* dst = reinterpret_cast<uint4*>(cache + (long long)slot * a.d);
    for (int c = tid; c < chunks; c += THREADS) dst[c] = src[c];
  }
  float* out = a.scores + (long long)s * a.pps * a.page + base;
  if (base >= n) {
    for (int i = tid; i < a.page; i += THREADS) out[i] = neg_inf;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ks = reinterpret_cast<uint4*>(smem);                      // [page][stride]
  float* qs = reinterpret_cast<float*>(
      smem + pk::align16((size_t)a.page * stride * 16));           // [hi][d]
  float* ws = qs + pk::align16((size_t)a.hi * a.d * 4) / 4;        // [hi]
  float* red = ws + pk::align16((size_t)a.hi * 4) / 4;             // [THREADS]

  const long long page_base = (long long)a.page_indices[(long long)s * a.pps + jp] * a.page;
  for (int i = tid; i < a.page * chunks; i += THREADS) {
    const int p = i / chunks;
    const int ch = i % chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base + p < n) {
      const long long phys = page_base + p;
      const T* src = (live && phys == slot) ? k_new + (long long)s * a.d
                                            : cache + phys * a.d;
      v = reinterpret_cast<const uint4*>(src)[ch];
    }
    ks[p * stride + ch] = v;
  }
  const T* q = reinterpret_cast<const T*>(a.q) + (long long)s * a.hi * a.d;
  for (int i = tid; i < a.hi * a.d; i += THREADS) qs[i] = pk::to_f(q[i]);
  for (int h = tid; h < a.hi; h += THREADS) {
    ws[h] = a.reduce == kDSA ? a.weights[(long long)s * a.hi + h] : 0.0f;
  }
  __syncthreads();

  // Thread = (key p, head group g); heads g, g + groups, ...
  const int groups = THREADS / a.page;
  const int p = tid % a.page;
  const int g = tid / a.page;
  float part = a.reduce == kDSA ? 0.0f : neg_inf;
  const uint4* krow = ks + p * stride;
  for (int h = g; h < a.hi; h += groups) {
    const float* qrow = qs + (long long)h * a.d;
    float dot = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      float kf[EPC];
      unpack<T>(krow[ch], kf);
#pragma unroll
      for (int e = 0; e < EPC; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + ch * EPC + e);
        dot = fmaf(q4.x, kf[e], dot);
        dot = fmaf(q4.y, kf[e + 1], dot);
        dot = fmaf(q4.z, kf[e + 2], dot);
        dot = fmaf(q4.w, kf[e + 3], dot);
      }
    }
    part = a.reduce == kDSA ? fmaf(ws[h], fmaxf(dot, 0.0f), part)
                            : fmaxf(part, dot);
  }
  red[tid] = part;
  __syncthreads();
  if (tid < a.page) {
    float v = red[tid];
    for (int gg = 1; gg < groups; ++gg) {
      const float x = red[gg * a.page + tid];
      v = a.reduce == kDSA ? v + x : fmaxf(v, x);
    }
    if (a.reduce != kDSA) v *= a.sm_scale;
    out[tid] = base + tid < n ? v : neg_inf;
  }
}

size_t smem_bytes(int hi, int d, int page, int elem) {
  return pk::align16((size_t)page * (d * elem + 16)) +
         pk::align16((size_t)hi * d * 4) + pk::align16((size_t)hi * 4) +
         pk::align16(THREADS * 4);
}

template <typename T>
int launch(const IdxArgs& a, int s, cudaStream_t st) {
  const size_t smem = smem_bytes(a.hi, a.d, a.page, sizeof(T));
  auto kern = indexer_kernel<T>;
  const cudaError_t err = pk::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s, a.pps);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int run(const IdxArgs& a, int s, int dtype, void* stream) {
  if (s <= 0 || a.pps <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pk::kBF16) return launch<__nv_bfloat16>(a, s, st);
  return launch<float>(a, s, st);
}

}  // namespace

extern "C" int pk_indexer_fused(const void* q, const void* weights,
                                const void* k_new, void* cache, void* scores,
                                const void* kv_lens, const void* page_indices,
                                const void* slots, int s, int hi, int d,
                                int page, int pps, long long total_slots,
                                int reduce, float sm_scale, int dtype,
                                void* stream) {
  const IdxArgs a{q, (const float*)weights, k_new, cache, (float*)scores,
                  (const int*)kv_lens, (const int*)page_indices,
                  (const int*)slots, hi, d, page, pps, total_slots, reduce,
                  sm_scale};
  return run(a, s, dtype, stream);
}

extern "C" int pk_indexer_scores(const void* q, const void* weights,
                                 void* cache, void* scores,
                                 const void* kv_lens, const void* page_indices,
                                 int s, int hi, int d, int page, int pps,
                                 int reduce, float sm_scale, int dtype,
                                 void* stream) {
  const IdxArgs a{q, (const float*)weights, nullptr, cache, (float*)scores,
                  (const int*)kv_lens, (const int*)page_indices, nullptr, hi,
                  d, page, pps, 0, reduce, sm_scale};
  return run(a, s, dtype, stream);
}
