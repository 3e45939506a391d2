// The paged GQA streaming core shared by gqa_prefill.cu and gqa_decode.cu:
// the port of parallax_tpu/ops/decode_fused_pallas.py::paged_decode_stream
// (:146) with online_softmax_update (:111) and online_softmax_finish
// (:133), which both TPU attention kernels build on.
//
// One thread block owns one KV head h and a tile of query tokens; its
// "rows" are (token, query head of h's group) pairs, row r = token r / G,
// head h * G + r % G (G = Hq / Hkv, any value, not only powers of two).
// Per page of the context the block
//   1. stages the page's K and V rows of head h in shared memory
//      (coalesced 16-byte loads, several in flight per thread; K rows
//      padded by one word so the score loop's row-strided reads hit
//      distinct banks),
//   2. computes every (row, key) score in f32 (scale, optional soft cap
//      cap * tanh(s / cap)); masked keys are -inf: the causal mask
//      kv_pos <= qpos, the context bound kv_pos < kv_len, and the sliding
//      window kv_pos > qpos - W,
//   3. folds the page into each row's running max m / denominator l in
//      f32 (one warp per row), turning scores into numerators that are
//      rounded to the value dtype as the plain versions do,
//   4. accumulates o = o * alpha + p @ V with one thread per output column
//      holding all of the tile's rows in registers.
// Sinks seed m = sink[head], l = 1, numerically a virtual key with no
// value. finish writes o / max(l, 1e-30), so rows that saw no key (bucket
// padding, kv_len = 0) come out as exact zeros.
//
// What bounds it on the H100: bytes. Each page's K/V is read from device
// memory once per (tile, head) and reused by all G * tile rows from shared
// memory; only valid pages are visited (first page window-clipped).
#pragma once

#include "common.cuh"

namespace pk {

constexpr float kNeg = -1e30f;
// 16-byte loads each thread keeps in flight while staging a page.
constexpr int kLoadBatch = 4;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

struct AttendParams {
  int hq, hkv, g, d, page;
  int window;       // <= 0: no sliding window
  float sm_scale;
  float soft_cap;   // <= 0: no soft cap
};

struct AttendSmem {
  uint32_t* k;  // [page][kw + 1] K words of one page (row padded)
  uint32_t* v;  // [page][kw]     V words of one page
  float* q;     // [rows][d]      the tile's query rows, f32
  float* p;     // [rows][page+1] scores, then softmax numerators
  float* m;     // [maxr] running max
  float* l;     // [maxr] running denominator
  float* a;     // [maxr] rescale factor of the current page
};

// Bytes of dynamic shared memory for a block with ``rows`` query rows.
template <typename T>
inline size_t attend_smem_bytes(int rows, int maxr, int d, int page) {
  const size_t kw = (size_t)d * sizeof(T) / 4;
  return align16(page * (kw + 1) * 4) + align16(page * kw * 4) +
         align16((size_t)rows * d * 4) + align16((size_t)rows * (page + 1) * 4) +
         3 * align16((size_t)maxr * 4);
}

template <typename T>
__device__ inline AttendSmem attend_carve(char* base, int rows, int maxr,
                                          int d, int page) {
  const size_t kw = (size_t)d * sizeof(T) / 4;
  AttendSmem s;
  size_t off = 0;
  s.k = reinterpret_cast<uint32_t*>(base + off);
  off += align16(page * (kw + 1) * 4);
  s.v = reinterpret_cast<uint32_t*>(base + off);
  off += align16(page * kw * 4);
  s.q = reinterpret_cast<float*>(base + off);
  off += align16((size_t)rows * d * 4);
  s.p = reinterpret_cast<float*>(base + off);
  off += align16((size_t)rows * (page + 1) * 4);
  s.m = reinterpret_cast<float*>(base + off);
  off += align16((size_t)maxr * 4);
  s.l = reinterpret_cast<float*>(base + off);
  off += align16((size_t)maxr * 4);
  s.a = reinterpret_cast<float*>(base + off);
  return s;
}

// Load the tile's query rows and seed the accumulators.
template <typename T, int MAXR>
__device__ inline void attend_init(const AttendSmem& sm, const T* q,
                                   const float* sinks, int tok0, int ntok,
                                   int h, const AttendParams& ap,
                                   float (&acc)[MAXR]) {
  const int rows = ntok * ap.g;
  for (int i = threadIdx.x; i < rows * ap.d; i += blockDim.x) {
    const int r = i / ap.d;
    const int dd = i - r * ap.d;
    const long long tok = tok0 + r / ap.g;
    const int head = h * ap.g + r % ap.g;
    sm.q[i] = to_f(q[(tok * ap.hq + head) * ap.d + dd]);
  }
  if (threadIdx.x < rows) {
    const int head = h * ap.g + threadIdx.x % ap.g;
    sm.m[threadIdx.x] = sinks != nullptr ? sinks[head] : kNeg;
    sm.l[threadIdx.x] = sinks != nullptr ? 1.f : 0.f;
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  __syncthreads();
}

// Fold one sequence's keys into the tile. The sequence owns global query
// tokens [lo, hi) and has context length n, so token ``tok`` sits at
// position n - hi + tok. Tile tokens outside [lo, hi) are masked out of
// this sequence's pages. Every thread of the block calls this with the
// same arguments (the barriers inside are block-uniform).
template <typename T, int MAXR>
__device__ inline void attend_fold_seq(const AttendSmem& sm, const T* cache,
                                       const int* pages_row, int tok0,
                                       int ntok, int lo, int hi, int n,
                                       int h, const AttendParams& ap,
                                       float (&acc)[MAXR]) {
  const int tmin = max(lo, tok0);
  const int tmax = min(hi, tok0 + ntok) - 1;
  if (tmin > tmax || n <= 0) return;
  const int page = ap.page;
  const int qoff = n - hi;
  const int qmin = qoff + tmin;
  const int qmax = qoff + tmax;
  const int hi_page = min((qmax + page) / page, (n + page - 1) / page);
  const int lo_page = ap.window > 0 ? max(qmin - ap.window + 1, 0) / page : 0;
  const int rows = ntok * ap.g;
  const int kw = ap.d * (int)sizeof(T) / 4;
  const int kv4 = kw / 4;  // 16-byte vectors per K (or V) row
  const int pstride = page + 1;
  const long long combined = 2 * ap.hkv;
  const uint4* c4 = reinterpret_cast<const uint4*>(cache);
  uint4* v4 = reinterpret_cast<uint4*>(sm.v);
  const T* vt = reinterpret_cast<const T*>(sm.v);
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int j = lo_page; j < hi_page; ++j) {
    const long long pg = pages_row[j];
    // Stage the page's K and V rows of head h with 16-byte loads, a batch
    // of them issued before any store so that they are in flight together.
    for (int i0 = threadIdx.x; i0 < page * kv4; i0 += kLoadBatch * blockDim.x) {
      uint4 kb[kLoadBatch], vb[kLoadBatch];
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        const int i = i0 + b * blockDim.x;
        if (i < page * kv4) {
          const int key = i / kv4;
          const long long row = ((pg * page + key) * combined + 2 * h) * kv4;
          kb[b] = c4[row + (i - key * kv4)];
          vb[b] = c4[row + kv4 + (i - key * kv4)];
        }
      }
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        const int i = i0 + b * blockDim.x;
        if (i < page * kv4) {
          const int key = i / kv4;
          uint32_t* kd = sm.k + key * (kw + 1) + 4 * (i - key * kv4);
          kd[0] = kb[b].x;
          kd[1] = kb[b].y;
          kd[2] = kb[b].z;
          kd[3] = kb[b].w;
          v4[i] = vb[b];
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < rows * page; i += blockDim.x) {
      const int r = i / page;
      const int key = i - r * page;
      const int tok = tok0 + r / ap.g;
      const int qpos = qoff + tok;
      const int kv_pos = j * page + key;
      bool valid = tok >= lo && tok < hi && kv_pos <= qpos && kv_pos < n;
      if (ap.window > 0) valid = valid && kv_pos > qpos - ap.window;
      float s = -INFINITY;
      if (valid) {
        const float* qr = sm.q + r * ap.d;
        const uint32_t* kr = sm.k + key * (kw + 1);
        float dot = 0.f;
        if constexpr (sizeof(T) == 2) {
          for (int w = 0; w < kw; ++w) {
            const uint32_t u = kr[w];
            dot = fmaf(qr[2 * w], __uint_as_float(u << 16), dot);
            dot = fmaf(qr[2 * w + 1], __uint_as_float(u & 0xffff0000u), dot);
          }
        } else {
          for (int w = 0; w < kw; ++w) {
            dot = fmaf(qr[w], __uint_as_float(kr[w]), dot);
          }
        }
        s = dot * ap.sm_scale;
        if (ap.soft_cap > 0.f) s = ap.soft_cap * tanhf(s / ap.soft_cap);
      }
      sm.p[r * pstride + key] = s;
    }
    __syncthreads();

    // Row statistics: one warp per row, its lanes split the page's keys.
    for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
      float* pr = sm.p + r * pstride;
      float pmax = kNeg;
      for (int key = lane; key < page; key += 32) pmax = fmaxf(pmax, pr[key]);
      pmax = warp_max(pmax);
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, pmax);
      float lsum = 0.f;
      for (int key = lane; key < page; key += 32) {
        const float s = pr[key];
        const float e = s == -INFINITY ? 0.f : expf(s - m_new);
        lsum += e;
        pr[key] = round_to<T>(e);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.l[r] = sm.l[r] * alpha + lsum;
        sm.m[r] = m_new;
        sm.a[r] = alpha;
      }
    }
    __syncthreads();

    if (threadIdx.x < ap.d) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) acc[r] *= sm.a[r];
      }
      for (int key = 0; key < page; ++key) {
        const float vd = to_f(vt[key * ap.d + threadIdx.x]);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < rows) acc[r] = fmaf(sm.p[r * pstride + key], vd, acc[r]);
        }
      }
    }
    __syncthreads();  // the next page overwrites k, v and p
  }
}

// Write the tile's outputs: o / max(l, 1e-30), and exact zeros for tokens
// at or past ``live_end`` (bucket padding).
template <typename T, int MAXR>
__device__ inline void attend_finish(const AttendSmem& sm, T* out, int tok0,
                                     int ntok, int live_end, int h,
                                     const AttendParams& ap,
                                     const float (&acc)[MAXR]) {
  const int rows = ntok * ap.g;
  if (threadIdx.x >= ap.d) return;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const long long tok = tok0 + r / ap.g;
      const int head = h * ap.g + r % ap.g;
      const float o =
          tok < live_end ? acc[r] / fmaxf(sm.l[r], 1e-30f) : 0.f;
      out[(tok * ap.hq + head) * ap.d + threadIdx.x] = from_f<T>(o);
    }
  }
}

}  // namespace pk
