// A3 sample_topk: sort-free greedy / filtered top-k sampling, one token per
// row.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::fused_sample_topk_pallas
// (:604) and its _sample_kernel (:572).
// Bound on the H100: bytes. The row's logits and noise are read once from
// device memory (8 rows of Qwen2.5-7B's 152,064 logits: 9.7 MB, 2.9 us);
// everything else is a few operations per logit.
// The function, exactly the TPU kernel's arithmetic:
//   temp <= 0: argmax of the logits;
//   else scaled = logits / max(temp, 1e-6) (IEEE division — this file is
//   built without --use_fast_math); when 0 < k < V, v_k is the k-th largest
//   scaled value counted with multiplicity (the value of the k-th element in
//   the order value descending, index ascending, which is what the TPU
//   kernel's k - 1 removals of the first maximum leave), and thresh =
//   k >= 2 ? max(v_k, -1e30) : v_1 (the removed values stand at -1e30);
//   otherwise thresh = -1e30. Then filtered = scaled >= thresh ? scaled :
//   -1e10 and the token is the argmax of filtered + gumbel. Every argmax
//   takes the FIRST index on ties, as jnp.argmax and torch.argmax do, so
//   the kernel picks the plain version's token bit for bit on the same
//   logits and noise. The noise comes from outside the kernel.
// Design: many blocks per row and one read of the row to find v_k. A row is
// cut into C chunks of L logits; C depends on S and V only
// (ops/sampling.py::sample_chunks, its twin): about two waves of the 132
// SMs, at least V / 8192 and at most 128 chunks, no chunk under 1,024
// logits (8 rows of 152,064: C = 33, L = 4,608).
//   1. sample_candidates_kernel, grid (S, C): a block of a top-k row streams
//      its chunk once, stores the order-preserving 32-bit keys of scaled
//      (key(a) > key(b) iff a > b; -0 and +0 are equal in every comparison
//      the threshold enters) in shared memory and writes the chunk's
//      min(k, L) largest keys, with multiplicity, to the workspace: the
//      k-th largest key T by an MSB-first radix select (3 passes of 11, 11
//      and 10 bits: shared-memory histograms, a block scan of the bins to
//      find the digit), then every key above T and as many copies of T as
//      make k.
//      The row's k largest values all lie among their chunks' k largest, so
//      the row's v_k is the k-th largest of the C x k candidates. Block
//      (s, 0) also zeroes row s's ticket.
//   2. sample_pick_kernel, grid (S, C): each block of a top-k row derives
//      v_k from the candidates itself (the same radix select over the C x
//      64 slots, empty ones at key 0, below every number's key; redundantly
//      and deterministically), then takes its chunk's argmax of filtered +
//      gumbel (greedy rows: of the logits); the logits are read a second
//      time, mostly from L2. It writes its (value, index) partial, fences
//      and takes a ticket; the row's last block merges the C partials and
//      writes the token. (value, index) with the first index on ties is a
//      total order, so the merge gives the same token in any order: no
//      floating-point atomics, the same bits every run.
// Two launches, no host sync; the workspace is the wrapper's torch.empty.
// What bounds it now (PERF.md): the two launches' fixed costs and the
// radix passes' shared-memory histograms, not the 2.9 us of bytes.
// -Xptxas -v (sm_90a): 34 registers (candidates) and 32 (pick), 8.3
// and 8.5 KB of static shared memory; no spills.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 64;          // ops/sampling.py FUSED_SAMPLE_TOPK_MAX
constexpr int kMaxChunks = 128;
constexpr unsigned kFull = 0xffffffffu;

struct SampleArgs {
  const float* logits;       // [S, V]
  const float* gumbel;       // [S, V]
  const float* temperature;  // [S]
  const int* top_k;          // [S]
  int* out;                  // [S]
  unsigned* cand;            // [S, C, kMaxK] candidate keys
  float* part_v;             // [S, C] partial argmax values
  int* part_i;               // [S, C] partial argmax indices
  unsigned* tickets;         // [S]
  int vocab, chunks, chunk_len;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Order-preserving key of a float and its inverse.
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Block-wide argmax with first-index tie-break; every thread gets the
// result.
__device__ void block_argmax(float& v, int& i) {
  __shared__ float sv[32];
  __shared__ int si[32];
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? sv[lane] : -INFINITY;
    i = lane < nwarps ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, off);
      const int oi = __shfl_down_sync(kFull, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
}

// The k-th largest of the n keys in shared memory (1 <= k <= n), counted
// with multiplicity; ``above`` gets how many keys are larger. Every thread
// calls it and gets the result. MSB first in 3 passes of 11, 11 and 10
// bits: a shared-memory histogram of the next digit over the keys that
// match the digits found so far, then a block-wide scan of the bins from
// the top (each thread owns a run of bins) finds the digit that holds the
// wanted rank.
__device__ unsigned radix_kth(const unsigned* keys, int n, int k,
                              int* above) {
  __shared__ unsigned hist[1 << 11];
  __shared__ unsigned wsum[kThreads / 32];
  __shared__ unsigned found[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  unsigned prefix = 0u, mask = 0u, want = (unsigned)k;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const int bins = pass == 2 ? 1 << 10 : 1 << 11;
    const int per = bins / kThreads;          // bins a thread scans
    for (int i = tid; i < bins; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const unsigned key = keys[i];
      if ((key & mask) == prefix) {
        atomicAdd(&hist[(key >> shift) & (unsigned)(bins - 1)], 1u);
      }
    }
    __syncthreads();
    unsigned c[4];
    unsigned local = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = j < per ? hist[bins - 1 - (tid * per + j)] : 0u;
      local += c[j];
    }
    unsigned incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[wid] = incl;
    __syncthreads();
    for (int w = 0; w < wid; ++w) incl += wsum[w];
    unsigned run = incl - local;   // keys in the bins above this thread's
    if (run < want && want <= incl) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (want <= run + c[j]) {
          found[0] = (unsigned)(bins - 1 - (tid * per + j));
          found[1] = want - run;
          break;
        }
        run += c[j];
      }
    }
    __syncthreads();
    prefix |= found[0] << shift;
    mask |= (unsigned)(bins - 1) << shift;
    want = found[1];
  }
  *above = k - (int)want;
  __syncthreads();   // hist, wsum and found are free for the next call
  return prefix;
}

__device__ __forceinline__ bool needs_topk(float t, int k, int vocab) {
  return !(t <= 0.f) && k > 0 && k < vocab;
}

__global__ void __launch_bounds__(kThreads)
    sample_candidates_kernel(const SampleArgs a) {
  extern __shared__ unsigned keys[];   // [chunk_len]
  __shared__ unsigned nout;
  const int row = blockIdx.x;
  const int c = blockIdx.y;
  if (c == 0 && threadIdx.x == 0) a.tickets[row] = 0u;
  const float t = a.temperature[row];
  const int k = a.top_k[row];
  if (!needs_topk(t, k, a.vocab) || k > kMaxK) return;
  const int x0 = c * a.chunk_len;
  const int n = min(a.chunk_len, a.vocab - x0);
  const float div = fmaxf(t, 1e-6f);
  const float* lg = a.logits + (long long)row * a.vocab + x0;
  unsigned* dst = a.cand + ((long long)row * a.chunks + c) * kMaxK;
  if (n <= k) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = fkey(lg[i] / div);
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) keys[i] = fkey(lg[i] / div);
  if (threadIdx.x == 0) nout = 0u;
  __syncthreads();
  int above;
  const unsigned kth = radix_kth(keys, n, k, &above);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (keys[i] > kth) dst[atomicAdd(&nout, 1u)] = keys[i];
  }
  for (int i = above + threadIdx.x; i < k; i += blockDim.x) dst[i] = kth;
}

__global__ void __launch_bounds__(kThreads)
    sample_pick_kernel(const SampleArgs a) {
  extern __shared__ unsigned cands[];   // [chunks * kMaxK]
  __shared__ bool last;
  const int row = blockIdx.x;
  const int c = blockIdx.y;
  const float t = a.temperature[row];
  const int k = a.top_k[row];
  const bool greedy = t <= 0.f;
  const float div = fmaxf(t, 1e-6f);
  float thresh = -1e30f;   // no top-k filter: everything >= -1e30 is kept
  if (needs_topk(t, k, a.vocab)) {
    if (k > kMaxK) {   // outside the contract: token -1, no candidates
      if (c == 0 && threadIdx.x == 0) a.out[row] = -1;
      return;
    }
    // Every chunk's kMaxK slots at once; the slots past a chunk's min(k, L)
    // candidates get key 0, below every number's key.
    const int total = a.chunks * kMaxK;
    const unsigned* src = a.cand + (long long)row * total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int cc = i / kMaxK;
      const int m = min(k, min(a.chunk_len, a.vocab - cc * a.chunk_len));
      cands[i] = i - cc * kMaxK < m ? src[i] : 0u;
    }
    __syncthreads();
    int above;
    const float vk = fval(radix_kth(cands, total, k, &above));
    thresh = k >= 2 ? fmaxf(vk, -1e30f) : vk;
  }

  const int x0 = c * a.chunk_len;
  const int x1 = min(x0 + a.chunk_len, a.vocab);
  const float* lg = a.logits + (long long)row * a.vocab;
  const float* gb = a.gumbel + (long long)row * a.vocab;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int x = x0 + threadIdx.x; x < x1; x += blockDim.x) {
    float v;
    if (greedy) {
      v = lg[x];
    } else {
      const float scaled = lg[x] / div;
      v = (scaled >= thresh ? scaled : -1e10f) + gb[x];
    }
    if (better(v, x, bv, bi)) {
      bv = v;
      bi = x;
    }
  }
  block_argmax(bv, bi);
  const long long p = (long long)row * a.chunks + c;
  if (threadIdx.x == 0) {
    a.part_v[p] = bv;
    a.part_i[p] = bi;
    __threadfence();
    last = atomicAdd(&a.tickets[row], 1u) == (unsigned)a.chunks - 1u;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  bv = -INFINITY;
  bi = INT_MAX;
  for (int cc = threadIdx.x; cc < a.chunks; cc += 32) {
    const long long q = (long long)row * a.chunks + cc;
    const float v = __ldcg(a.part_v + q);
    const int i = __ldcg(a.part_i + q);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, bv, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (threadIdx.x == 0) a.out[row] = bi;
}

}  // namespace

// ``workspace``: S * (chunks * (kMaxK + 2) + 1) 32-bit words (candidate
// keys, partial values, partial indices, tickets), no initial value. Rows
// need top_k <= kMaxK (the engine sends larger ones to the split sampler);
// a sampled row with 64 < top_k < V gets token -1.
extern "C" int pk_sample_topk(const void* logits, const void* gumbel,
                              const void* temperature, const void* top_k,
                              void* out, void* workspace, int s, int vocab,
                              int chunks, int chunk_len, void* stream) {
  if (s <= 0) return 0;
  if (vocab <= 0 || chunks < 1 || chunks > kMaxChunks || chunk_len < 1 ||
      (long long)chunks * chunk_len < vocab ||
      (long long)(chunks - 1) * chunk_len >= vocab) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned* ws = static_cast<unsigned*>(workspace);
  const long long sc = (long long)s * chunks;
  const SampleArgs a{(const float*)logits, (const float*)gumbel,
                     (const float*)temperature, (const int*)top_k, (int*)out,
                     ws, reinterpret_cast<float*>(ws + sc * kMaxK),
                     reinterpret_cast<int*>(ws + sc * (kMaxK + 1)),
                     ws + sc * (kMaxK + 2), vocab, chunks, chunk_len};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(s, chunks);
  // The kernels' static shared memory (under 9 KB) counts against the 48 KB
  // that need no opt-in, so the opt-in allows for it.
  constexpr size_t kStatic = 9 * 1024;
  const size_t smem1 = (size_t)chunk_len * sizeof(unsigned);
  cudaError_t err = pk::allow_smem(sample_candidates_kernel, smem1 + kStatic);
  if (err != cudaSuccess) return (int)err;
  sample_candidates_kernel<<<grid, kThreads, smem1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)chunks * kMaxK * sizeof(unsigned);
  err = pk::allow_smem(sample_pick_kernel, smem2 + kStatic);
  if (err != cudaSuccess) return (int)err;
  sample_pick_kernel<<<grid, kThreads, smem2, st>>>(a);
  return (int)cudaGetLastError();
}
