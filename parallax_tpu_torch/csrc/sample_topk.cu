// A3 sample_topk: sort-free greedy / filtered top-k sampling, one token per
// row.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::fused_sample_topk_pallas
// (:604) and its _sample_kernel (:572).
// Bound on the H100: bytes for greedy and small k (the row's logits and
// noise are read once from device memory); for larger k the k - 1 passes
// re-read the row from L2, so the passes bound it.
// Design: one block of 1024 threads per row, exactly the arithmetic of the
// TPU kernel:
//   temp <= 0: argmax of the logits;
//   else scaled = logits / max(temp, 1e-6) (IEEE division — this file is
//   built without --use_fast_math), and when 0 < k < V the k-th value is
//   found as the TPU kernel's k - 1 single-occurrence removals of the
//   current maximum leave it. Removing maxima one occurrence at a time, first
//   index first, walks the row in the total order (value descending, index
//   ascending), so pass j finds the element that follows pass j - 1's in
//   that order: no copy of the row, no removal set. With the removed values
//   standing at -1e30, the TPU kernel's k-th value is max(v_k, -1e30).
//   Then keep = scaled >= kth (ties kept), filtered = keep ? scaled : -1e10
//   and the token is the argmax of filtered + gumbel. Every argmax takes the
//   FIRST index on ties, as jnp.argmax and torch.argmax do, so the kernel
//   picks the plain version's token bit for bit on the same logits and
//   noise. The noise comes from outside the kernel.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax with first-index tie-break; every thread gets the
// result.
__device__ void block_argmax(float& v, int& i) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, v, off);
    const int oi = __shfl_down_sync(full, i, off);
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
      const float ov = __shfl_down_sync(full, v, off);
      const int oi = __shfl_down_sync(full, i, off);
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
  __syncthreads();  // sv/si are reused by the next call
}

__global__ void __launch_bounds__(kThreads)
    sample_topk_kernel(const float* __restrict__ logits,
                       const float* __restrict__ gumbel,
                       const float* __restrict__ temperature,
                       const int* __restrict__ top_k, int* __restrict__ out,
                       int vocab) {
  const int row = blockIdx.x;
  const float* lg = logits + (long long)row * vocab;
  const float* gb = gumbel + (long long)row * vocab;
  const float t = temperature[row];
  const int k = top_k[row];

  float bv = -INFINITY;
  int bi = INT_MAX;
  if (t <= 0.f) {
    for (int x = threadIdx.x; x < vocab; x += blockDim.x) {
      const float v = lg[x];
      if (better(v, x, bv, bi)) {
        bv = v;
        bi = x;
      }
    }
    block_argmax(bv, bi);
    if (threadIdx.x == 0) out[row] = bi;
    return;
  }

  const float div = fmaxf(t, 1e-6f);
  float thresh = -1e30f;  // no top-k filter: everything >= -1e30 is kept
  if (k > 0 && k < vocab) {
    // Pass 1: the first element of the order (value desc, index asc).
    for (int x = threadIdx.x; x < vocab; x += blockDim.x) {
      const float v = lg[x] / div;
      if (better(v, x, bv, bi)) {
        bv = v;
        bi = x;
      }
    }
    block_argmax(bv, bi);
    // Passes 2..k: the element right after the previous one in the order.
    for (int j = 1; j < k; ++j) {
      const float pv = bv;
      const int pi = bi;
      bv = -INFINITY;
      bi = INT_MAX;
      for (int x = threadIdx.x; x < vocab; x += blockDim.x) {
        const float v = lg[x] / div;
        const bool after = v < pv || (v == pv && x > pi);
        if (after && better(v, x, bv, bi)) {
          bv = v;
          bi = x;
        }
      }
      block_argmax(bv, bi);
    }
    thresh = k >= 2 ? fmaxf(bv, -1e30f) : bv;
  }

  bv = -INFINITY;
  bi = INT_MAX;
  for (int x = threadIdx.x; x < vocab; x += blockDim.x) {
    const float scaled = lg[x] / div;
    const float v = (scaled >= thresh ? scaled : -1e10f) + gb[x];
    if (better(v, x, bv, bi)) {
      bv = v;
      bi = x;
    }
  }
  block_argmax(bv, bi);
  if (threadIdx.x == 0) out[row] = bi;
}

}  // namespace

extern "C" int pk_sample_topk(const void* logits, const void* gumbel,
                              const void* temperature, const void* top_k,
                              void* out, int s, int vocab, void* stream) {
  if (s <= 0) return 0;
  sample_topk_kernel<<<s, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)gumbel, (const float*)temperature,
      (const int*)top_k, (int*)out, vocab);
  return (int)cudaGetLastError();
}
