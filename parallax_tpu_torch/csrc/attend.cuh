// The paged GQA attention core shared by gqa_prefill.cu (A1) and
// gqa_decode.cu (A2, A9): the port of
// parallax_tpu/ops/decode_fused_pallas.py::paged_decode_stream (:146) with
// online_softmax_update (:111) and online_softmax_finish (:133), which both
// TPU attention kernels build on.
//
// A block owns one KV head h and a set of query "rows", each a (token,
// query head of h's group) pair: row r is token tok0 + r / G and head
// h * G + r % G (G = Hq / Hkv, any value up to 32; head dim D 64, 128 or
// 256). Rows are cut into m16
// tiles, one per warp along rows (WM warps); the key tiles are cut among
// WK warps along keys. Per key tile of kKT context positions the block
//   1. streams the tile's K and V rows of head h into a ring of kStages
//      shared-memory stages with cp.async (16-byte copies, positions past
//      the range zero-filled), so the next tile's copy overlaps this
//      tile's products;
//   2. computes the scores Q K^T (bf16: mma.sync m16n8k16 with f32
//      accumulation, fragments by ldmatrix; f32: the same fragment layout
//      on the CUDA cores), scale, optional soft cap cap * tanh(s / cap),
//      and masks keys to -inf: kv_pos <= qpos (causal), kv_pos < kend (the
//      range's end) and kv_pos > qpos - W (sliding window);
//   3. folds the tile into each row's running max m and denominator l in
//      registers (rows' statistics reduced over the four lanes that share
//      a row), turning scores into numerators exp2((x - m) log2 e);
//   4. accumulates o = o * alpha + P V with the numerators rounded to the
//      value dtype (the bf16 mma operand, as the plain versions round them).
// A warp whose rows all sit before a tile's first key skips the tile: it
// would fold in nothing.
//
// Two roles use the core:
// - decode_split: one query token (G rows padded to 16 or 32) over one
//   split of its context. A row's splits are fixed runs of pages that depend
//   only on the page size, the window and the row's kv_len (split_range),
//   never on the batch. The WK warps' partials are merged in warp order and
//   the split's (m, l, o) is written to f32 scratch; combine_head merges a
//   row's splits in split order with the sink folded in once (m = sink,
//   l = 1) and writes o / max(l, 1e-30): rows with kv_len 0 get exact
//   zeros. No floating-point atomics: every run gives the same bits.
// - prefill_tile: up to Shape::kRows rows of one sequence's tokens over the
//   causal range of its context, sinks seeded into m and l, written as
//   o * (1 / max(l, 1e-30)).
#pragma once

#include "common.cuh"

namespace pk {

constexpr float kNeg = -1e30f;
constexpr int kKT = 64;              // context positions per key tile
constexpr int kStages = 2;           // stages in the cp.async ring
constexpr int kSplitKeys = 128;      // the fewest keys of a decode split
constexpr int kMaxSplits = 32;       // the most splits of one row
constexpr int kDecodeThreads = 128;  // decode blocks: 4 warps
constexpr int kTileWarps = 8;        // multi-token tiles: 8 warps x 16 rows
constexpr int kTileRows = 16 * kTileWarps;

// The ring depth and the multi-token tile of one (cache type, head dim).
// An f32 block at D = 256 would need 399 KB at the default shape (rows +
// 2 kStages kKT rows of D + 4 floats), past the 227 KB a block can have:
// it keeps the 64-key tile (so its sums run in the same order as every
// other instantiation's) but one ring stage and four warps of rows
// (64 rows: 195 KB; a decode block of 32 rows: 163 KB). Every other
// instantiation takes the defaults (bf16 at D = 256: 198 KB a tile).
template <typename T, int D>
struct Shape {
  static constexpr bool kWide = sizeof(T) == 4 && D > 128;
  static constexpr int kRing = kWide ? 1 : kStages;
  static constexpr int kWarps = kWide ? 4 : kTileWarps;
  static constexpr int kRows = 16 * kWarps;
};

struct AttnParams {
  int hq, hkv, g, page, pps;
  int window;       // <= 0: no sliding window
  float sm_scale;
  float soft_cap;   // <= 0: no soft cap
};

// Shared-memory rows are padded by 16 bytes: 16-byte aligned for cp.async,
// and the 8 rows of an ldmatrix fall on distinct banks.
template <typename T, int D>
struct Tile {
  static constexpr int kLd = D + 16 / (int)sizeof(T);   // row stride
  static constexpr int kVec = 16 / (int)sizeof(T);      // elements per copy
  static constexpr int kChunks = D / kVec;              // copies per row
};

// Bytes of dynamic shared memory of a block with ``rows`` query rows: the
// query tile, then Shape::kRing stages of (K tile, V tile).
template <typename T, int D>
inline size_t attn_smem_bytes(int rows) {
  return (size_t)(rows + 2 * Shape<T, D>::kRing * kKT) * Tile<T, D>::kLd *
         sizeof(T);
}

// A row's decode splits: ``count`` runs of ``per`` pages from ``lo_page``
// (the last one clipped to the row's last page). lo_page is the window's
// first page, max(kv_len - W, 0) / page. Mirrored in Python by
// parallax_tpu_torch/ops/gqa_decode.py::split_ranges.
struct SplitRange {
  int lo_page, per, count;
};

__device__ inline SplitRange split_range(int kv_len, int page,
                                         int window) {
  SplitRange r{0, 1, 0};
  if (kv_len <= 0) return r;
  const int hi_page = (kv_len + page - 1) / page;
  r.lo_page = window > 0 ? max(kv_len - window, 0) / page : 0;
  const int n = hi_page - r.lo_page;
  r.per = max((kSplitKeys + page - 1) / page,
              (n + kMaxSplits - 1) / kMaxSplits);
  r.count = (n + r.per - 1) / r.per;
  return r;
}

// One warp's running state for its 16 rows: this thread holds rows
// grp = lane / 4 and grp + 8, columns 8 n + 2 (lane % 4) and the next one.
// ``l`` is this thread's share of the row's denominator (its columns);
// ``m`` is the row's, equal over the four lanes of a row.
template <int D>
struct WarpAcc {
  float o[D / 8][4];
  float m[2];
  float l[2];
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage the block's query rows [0, rows_pad): row r < rows is token
// tok0 + r / G, head h * G + r % G; rows past ``rows`` are zero.
template <typename T, int D, int NT>
__device__ inline void load_q(T* qs, const T* q, int tok0, int rows,
                              int rows_pad, int h, const AttnParams& ap) {
  using TL = Tile<T, D>;
  for (int i = threadIdx.x; i < rows_pad * TL::kChunks; i += NT) {
    const int r = i / TL::kChunks;
    const int c = i - r * TL::kChunks;
    const T* src = q;
    if (r < rows) {
      const int tk = r / ap.g;
      src = q + ((long long)(tok0 + tk) * ap.hq + h * ap.g + (r - tk * ap.g)) *
                    D + c * TL::kVec;
    }
    cp_async16(qs + r * TL::kLd + c * TL::kVec, src, r < rows ? 16 : 0);
  }
}

// Stage the K and V rows of head h at context positions [pos0, pos0 + kKT);
// positions at or past ``kend`` are zero-filled (a zero V row times a zero
// numerator stays finite). Each position finds its own page, so any page
// size works.
template <typename T, int D, int NT>
__device__ inline void load_kv(T* ks, T* vs, const T* cache,
                               const int* pages_row, int pos0, int kend,
                               int h, const AttnParams& ap) {
  using TL = Tile<T, D>;
  for (int i = threadIdx.x; i < kKT * TL::kChunks; i += NT) {
    const int r = i / TL::kChunks;
    const int c = i - r * TL::kChunks;
    const int pos = pos0 + r;
    const bool ok = pos < kend;
    const T* src = cache;
    if (ok) {
      const long long pg = pages_row[pos / ap.page];
      src = cache +
            ((pg * ap.page + pos % ap.page) * 2 * ap.hkv + 2 * h) * (long long)D +
            c * TL::kVec;
    }
    cp_async16(ks + r * TL::kLd + c * TL::kVec, src, ok ? 16 : 0);
    cp_async16(vs + r * TL::kLd + c * TL::kVec, ok ? src + D : cache,
               ok ? 16 : 0);
  }
}

// s = Q K^T for this warp's 16 rows (from row0) and KW keys (from kb).
template <int D, int KW>
__device__ inline void tile_scores(float (&s)[KW / 8][4],
                                   const __nv_bfloat16* qs, int row0,
                                   const __nv_bfloat16* ks, int kb) {
  constexpr int LD = Tile<__nv_bfloat16, D>::kLd;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldmatrix_x4(a, qs + (row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < KW / 8; j += 2) {
      unsigned b[4];
      ldmatrix_x4(b, ks + (kb + j * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[j], a, b);
      mma_bf16(s[j + 1], a, b + 2);
    }
  }
}

template <int D, int KW>
__device__ inline void tile_scores(float (&s)[KW / 8][4], const float* qs,
                                   int row0, const float* ks, int kb) {
  constexpr int LD = Tile<float, D>::kLd;
  const int lane = threadIdx.x & 31;
  const float* q0 = qs + (row0 + (lane >> 2)) * LD;
  const float* q1 = q0 + 8 * LD;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    const float* k0 = ks + (kb + j * 8 + (lane & 3) * 2) * LD;
    const float* k1 = k0 + LD;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(q0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(q1 + d);
      const float4 y0 = *reinterpret_cast<const float4*>(k0 + d);
      const float4 y1 = *reinterpret_cast<const float4*>(k1 + d);
      s00 = fmaf(x0.x, y0.x, s00); s00 = fmaf(x0.y, y0.y, s00);
      s00 = fmaf(x0.z, y0.z, s00); s00 = fmaf(x0.w, y0.w, s00);
      s01 = fmaf(x0.x, y1.x, s01); s01 = fmaf(x0.y, y1.y, s01);
      s01 = fmaf(x0.z, y1.z, s01); s01 = fmaf(x0.w, y1.w, s01);
      s10 = fmaf(x1.x, y0.x, s10); s10 = fmaf(x1.y, y0.y, s10);
      s10 = fmaf(x1.z, y0.z, s10); s10 = fmaf(x1.w, y0.w, s10);
      s11 = fmaf(x1.x, y1.x, s11); s11 = fmaf(x1.y, y1.y, s11);
      s11 = fmaf(x1.z, y1.z, s11); s11 = fmaf(x1.w, y1.w, s11);
    }
    s[j][0] = s00;
    s[j][1] = s01;
    s[j][2] = s10;
    s[j][3] = s11;
  }
}

// Mask and scale one tile's scores (keys from absolute position pos0) and
// fold them into the rows' running max and denominator; s becomes the
// numerators (f32) and o is rescaled by alpha. Row i's valid keys are
// [klo[i], khi[i]): the causal bound, the range's end and the window,
// folded once per block. Exponentials are exp2 of (x - m) log2 e, one FMA
// from the scaled score (exp2(-inf) = 0 for masked keys).
template <int D, int NK>
__device__ inline void tile_softmax(float (&s)[NK][4], WarpAcc<D>& acc,
                                    const int (&klo)[2], const int (&khi)[2],
                                    int pos0, const AttnParams& ap) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = pos0 + j * 8 + tig * 2 + e;
        float x = s[j][2 * i + e] * ap.sm_scale;
        if (ap.soft_cap > 0.f) x = ap.soft_cap * tanhf(x / ap.soft_cap);
        x = kp >= klo[i] && kp < khi[i] ? x : -INFINITY;
        s[j][2 * i + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = quad_max(mx);
    const float m_new = fmaxf(acc.m[i], mx);
    const float alpha = exp2f((acc.m[i] - m_new) * kLog2e);
    const float mb = m_new * kLog2e;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[j][2 * i + e], kLog2e, -mb));
        ls += p;
        s[j][2 * i + e] = p;
      }
    }
    acc.l[i] = acc.l[i] * alpha + ls;
    acc.m[i] = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc.o[n][2 * i] *= alpha;
      acc.o[n][2 * i + 1] *= alpha;
    }
  }
}

// o += P V: the numerators (rounded to bf16: they are the A operand, laid
// out as the score tiles' accumulators) times the tile's V rows.
template <int D, int KW>
__device__ inline void tile_pv(WarpAcc<D>& acc, const float (&p)[KW / 8][4],
                               const __nv_bfloat16* vs, int kb) {
  constexpr int LD = Tile<__nv_bfloat16, D>::kLd;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    unsigned a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      unsigned b[4];
      ldmatrix_x4_trans(
          b, vs + (kb + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                 (n + (lane >> 4)) * 8);
      mma_bf16(acc.o[n], a, b);
      mma_bf16(acc.o[n + 1], a, b + 2);
    }
  }
}

// The f32 form: each numerator is fetched from the lane that holds it.
template <int D, int KW>
__device__ inline void tile_pv(WarpAcc<D>& acc, const float (&p)[KW / 8][4],
                               const float* vs, int kb) {
  constexpr int LD = Tile<float, D>::kLd;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int src = (lane & ~3) | (c >> 1);
      const float p0 = __shfl_sync(0xffffffffu, p[j][c & 1], src);
      const float p1 = __shfl_sync(0xffffffffu, p[j][2 + (c & 1)], src);
      const float* vr = vs + (kb + j * 8 + c) * LD + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 v = *reinterpret_cast<const float2*>(vr + n * 8);
        acc.o[n][0] = fmaf(p0, v.x, acc.o[n][0]);
        acc.o[n][1] = fmaf(p0, v.y, acc.o[n][1]);
        acc.o[n][2] = fmaf(p1, v.x, acc.o[n][2]);
        acc.o[n][3] = fmaf(p1, v.y, acc.o[n][3]);
      }
    }
  }
}

// Fold context positions [kstart, kend) into every warp's rows. The query
// tile must already be issued (its cp.async group committed). Warp w owns
// rows [16 (w % WM), +16) and keys [(w / WM) KW, +KW) of every tile. Ends
// with the ring drained and a barrier: the shared memory is free again.
template <typename T, int D, int WM, int WK>
__device__ inline void attend_keys(char* smem, const T* cache,
                                   const int* pages_row, int kstart, int kend,
                                   int h, const AttnParams& ap,
                                   const int (&qpos)[2], WarpAcc<D>& acc) {
  // Row i's valid keys: [qpos - W + 1, min(qpos + 1, kend)); none for a
  // padding row (qpos = -1).
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    klo[i] = ap.window > 0 ? qpos[i] - ap.window + 1 : 0;
    khi[i] = min(qpos[i] + 1, kend);
  }
  constexpr int kRing = Shape<T, D>::kRing;
  constexpr int NT = 32 * WM * WK;
  constexpr int KW = kKT / WK;
  constexpr int LD = Tile<T, D>::kLd;
  const T* qs = reinterpret_cast<const T*>(smem);
  T* ring = reinterpret_cast<T*>(smem) + 16 * WM * LD;
  const int warp = threadIdx.x >> 5;
  const int row0 = 16 * (warp % WM);
  const int kb = (warp / WM) * KW;
  // The last query position among this warp's rows (-1: no live row).
  const int wq = __reduce_max_sync(0xffffffffu, max(qpos[0], qpos[1]));
  const int ntiles = kend > kstart ? (kend - kstart + kKT - 1) / kKT : 0;
#pragma unroll
  for (int st = 0; st < kRing; ++st) {
    if (st < ntiles) {
      load_kv<T, D, NT>(ring + 2 * st * kKT * LD, ring + (2 * st + 1) * kKT * LD,
                        cache, pages_row, kstart + st * kKT, kend, h, ap);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const int st = i % kRing;
    const T* ks = ring + 2 * st * kKT * LD;
    const T* vs = ks + kKT * LD;
    const int pos0 = kstart + i * kKT + kb;
    if (pos0 <= wq) {
      float s[KW / 8][4];
      tile_scores<D, KW>(s, qs, row0, ks, kb);
      tile_softmax<D, KW / 8>(s, acc, klo, khi, pos0, ap);
      tile_pv<D, KW>(acc, s, vs, kb);
    }
    __syncthreads();
    if (i + kRing < ntiles) {
      load_kv<T, D, NT>(ring + 2 * st * kKT * LD, ring + (2 * st + 1) * kKT * LD,
                        cache, pages_row, kstart + (i + kRing) * kKT, kend,
                        h, ap);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Decode role: row s's one query token ``tok`` (of kv_len n, so at
// position n - 1) over split ``split`` of its context, for KV head h; G
// rows padded to 16 MT. Writes the split's partial (o [G][D], then (m, l)
// [G]) to scratch[s][h][split]. With kAppend, the split that owns the
// row's last page first writes the row's new K/V into ``slot`` (slot >= 0)
// and reaches a barrier before it reads the page; no other split reads
// that slot. Every thread calls this with block-uniform arguments.
template <typename T, int D, int MT, bool kAppend>
__device__ inline void decode_split(char* smem, const T* q, int tok,
                                    const T* k_new, const T* v_new, int slot,
                                    long long total_slots, T* cache,
                                    const int* pages_row, int n, int s, int h,
                                    int split, int num_splits, float* scratch,
                                    const AttnParams& ap) {
  constexpr int WK = 4 / MT;
  constexpr int ROWS = 16 * MT;
  // The query copy needs no kv_len: it overlaps the kv_len -> page index
  // -> K/V chain of loads.
  load_q<T, D, kDecodeThreads>(reinterpret_cast<T*>(smem), q, tok, ap.g, ROWS,
                               h, ap);
  cp_async_commit();
  const SplitRange sr = split_range(n, ap.page, ap.window);
  if (split >= sr.count) {
    cp_async_wait<0>();
    return;
  }
  const int kstart = (sr.lo_page + split * sr.per) * ap.page;
  const int kend = min(kstart + sr.per * ap.page, n);
  if constexpr (kAppend) {
    if (split == sr.count - 1 && slot >= 0 && slot < total_slots) {
      T* dst = cache + ((long long)slot * 2 * ap.hkv + 2 * h) * D;
      const long long src = ((long long)s * ap.hkv + h) * D;
      for (int i = threadIdx.x; i < D; i += kDecodeThreads) {
        dst[i] = k_new[src + i];
        dst[D + i] = v_new[src + i];
      }
    }
    __syncthreads();  // the append is visible to this block's page copies
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % MT;
  const int wk = warp / MT;
  WarpAcc<D> acc;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = 16 * wm + (lane >> 2) + 8 * i < ap.g ? n - 1 : -1;
    acc.m[i] = kNeg;
    acc.l[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc.o[j][c] = 0.f;
  }
  attend_keys<T, D, MT, WK>(smem, cache, pages_row, kstart, kend, h, ap, qpos,
                            acc);

  // Merge the WK warps' partials of each row, in warp order.
  float* ml = reinterpret_cast<float*>(smem);   // [WK][ROWS][2]
  float* os = ml + WK * ROWS * 2;               // [WK][ROWS][D]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(acc.l[i]);
    if ((lane & 3) == 0) {
      const int r = 16 * wm + (lane >> 2) + 8 * i;
      ml[(wk * ROWS + r) * 2] = acc.m[i];
      ml[(wk * ROWS + r) * 2 + 1] = l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wm + (lane >> 2) + 8 * i;
    float m = ml[r * 2];
#pragma unroll
    for (int w = 1; w < WK; ++w) m = fmaxf(m, ml[(w * ROWS + r) * 2]);
    const float sc = expf(acc.m[i] - m);
    float* dst = os + (wk * ROWS + r) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[j * 8] = acc.o[j][2 * i] * sc;
      dst[j * 8 + 1] = acc.o[j][2 * i + 1] * sc;
    }
  }
  __syncthreads();
  float* part = scratch + (((long long)s * ap.hkv + h) * num_splits + split) *
                              ap.g * (D + 2);
  for (int i = threadIdx.x; i < ap.g * D; i += kDecodeThreads) {
    const int r = i / D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) o += os[(w * ROWS + r) * D + (i - r * D)];
    part[i] = o;
  }
  for (int r = threadIdx.x; r < ap.g; r += kDecodeThreads) {
    float m = ml[r * 2];
#pragma unroll
    for (int w = 1; w < WK; ++w) m = fmaxf(m, ml[(w * ROWS + r) * 2]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      l += ml[(w * ROWS + r) * 2 + 1] * expf(ml[(w * ROWS + r) * 2] - m);
    }
    part[ap.g * D + 2 * r] = m;
    part[ap.g * D + 2 * r + 1] = l;
  }
}

// Merge row s's splits for query head ``head`` and write that head of
// token ``tok``: o / max(l, 1e-30), the sink seeding m and l once. One
// block of D threads: lane k of warp 0 weighs split k (kMaxSplits <= 32),
// e_k = exp(m_k - m) with m the largest of the splits' maxima and the
// sink, l = sum_k l_k e_k + exp(sink - m) (butterfly sums: the same order
// every run); then thread d sums its column over the splits in split
// order.
template <typename T, int D>
__device__ inline void combine_head(const float* scratch, const float* sinks,
                                    T* out, int tok, int n, int s, int head,
                                    int num_splits, const AttnParams& ap) {
  static_assert(kMaxSplits <= 32, "one lane per split");
  __shared__ float e[32];
  __shared__ float l_sum;
  const SplitRange sr = split_range(n, ap.page, ap.window);
  const int h = head / ap.g;
  const int g = head - h * ap.g;
  const int stride = ap.g * (D + 2);
  const float* base =
      scratch + ((long long)s * ap.hkv + h) * num_splits * stride;
  if (threadIdx.x < 32) {
    const int k = threadIdx.x;
    const bool live = k < sr.count;
    const float* ml = base + k * stride + ap.g * D + 2 * g;
    const float mk = live ? ml[0] : -INFINITY;
    const float sink = sinks != nullptr ? sinks[head] : -INFINITY;
    float m = fmaxf(mk, sink);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    const float ek = live ? expf(mk - m) : 0.f;
    float l = live ? ml[1] * ek : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    e[k] = ek;
    if (k == 0) l_sum = sinks != nullptr ? l + expf(sink - m) : l;
  }
  __syncthreads();
  const float* col = base + g * D + threadIdx.x;
  float o = 0.f;
#pragma unroll 8
  for (int k = 0; k < sr.count; ++k) o = fmaf(col[k * stride], e[k], o);
  out[((long long)tok * ap.hq + head) * D + threadIdx.x] =
      from_f<T>(o / fmaxf(l_sum, 1e-30f));
}

// The (sequence, first token, end token, sequence end) of multi-token tile
// ``tile``; false past the last tile. The entries are the live sequences,
// then the bucket padding [cu[nseq], t) as entry nseq. A sequence of one
// token owns no tile (the decode role takes it). Warp 0 gives each lane a
// run of consecutive entries, sums their tile counts and scans the sums
// across the warp; the lane whose range holds ``tile`` walks its entries.
__device__ inline bool find_tile(const int* cu, int nseq, int t, int q_tile,
                                 int tile, int* seq, int* tok0, int* tok_end,
                                 int* seq_end) {
  __shared__ int found[4];
  if (threadIdx.x == 0) found[0] = -1;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int ne = nseq + 1;
    const int per = (ne + 31) / 32;
    const int e0 = min(lane * per, ne);
    const int e1 = min(e0 + per, ne);
    auto tiles_of = [&](int e, int a, int b) {
      const int len = b - a;
      return e < nseq && len < 2 ? 0 : (len + q_tile - 1) / q_tile;
    };
    int local = 0;
    for (int e = e0; e < e1; ++e) {
      local += tiles_of(e, cu[e], e < nseq ? cu[e + 1] : t);
    }
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - local;
    if (tile >= run && tile < incl) {
      for (int e = e0; e < e1; ++e) {
        const int a = cu[e];
        const int b = e < nseq ? cu[e + 1] : t;
        const int nt = tiles_of(e, a, b);
        if (tile < run + nt) {
          found[0] = e;
          found[1] = a + (tile - run) * q_tile;
          found[2] = min(found[1] + q_tile, b);
          found[3] = b;
          break;
        }
        run += nt;
      }
    }
  }
  __syncthreads();
  if (found[0] < 0) return false;
  *seq = found[0];
  *tok0 = found[1];
  *tok_end = found[2];
  *seq_end = found[3];
  return true;
}

// Prefill role: one multi-token tile of one sequence for KV head h over
// the causal range of the sequence's context (kv_lens carries the FULL
// context, so token tok sits at position n - seq_end + tok), or exact
// zeros for a tile of bucket padding.
template <typename T, int D>
__device__ inline void prefill_tile(char* smem, const T* q, const T* cache,
                                    T* out, const int* kv_lens,
                                    const int* page_indices, const int* cu,
                                    int nseq, int t, int q_tile,
                                    const float* sinks, int tile, int h,
                                    const AttnParams& ap) {
  constexpr int NT = 32 * Shape<T, D>::kWarps;
  int seq, tok0, tok_end, seq_end;
  if (!find_tile(cu, nseq, t, q_tile, tile, &seq, &tok0, &tok_end, &seq_end)) {
    return;
  }
  const int rows = (tok_end - tok0) * ap.g;
  if (seq == nseq) {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D;
      const int tk = r / ap.g;
      out[((long long)(tok0 + tk) * ap.hq + h * ap.g + (r - tk * ap.g)) * D +
          (i - r * D)] = from_f<T>(0.f);
    }
    return;
  }
  load_q<T, D, NT>(reinterpret_cast<T*>(smem), q, tok0, rows,
                   Shape<T, D>::kRows, h, ap);
  cp_async_commit();
  const int n = kv_lens[seq];
  const int qoff = n - seq_end;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpAcc<D> acc;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    qpos[i] = r < rows ? qoff + tok0 + r / ap.g : -1;
    acc.m[i] = sinks != nullptr ? sinks[h * ap.g + r % ap.g] : kNeg;
    acc.l[i] = sinks != nullptr && (lane & 3) == 0 ? 1.f : 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc.o[j][c] = 0.f;
  }
  const int qmin = qoff + tok0;
  const int kstart =
      ap.window > 0 ? max(qmin - ap.window + 1, 0) / ap.page * ap.page : 0;
  const int kend = min(qoff + tok_end, n);
  attend_keys<T, D, Shape<T, D>::kWarps, 1>(smem, cache,
                                            page_indices + (long long)seq * ap.pps,
                                            kstart, kend, h, ap, qpos, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(acc.l[i]), 1e-30f);
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    if (r < rows) {
      const int tk = r / ap.g;
      T* dst = out +
               ((long long)(tok0 + tk) * ap.hq + h * ap.g + (r - tk * ap.g)) * D +
               (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store2<T>(dst + j * 8, acc.o[j][2 * i] * inv,
                  acc.o[j][2 * i + 1] * inv);
      }
    }
  }
}

// Runs F::run<T, D, MT>(args...) for the runtime cache type, head dim and
// group size (MT = the group's m16 tiles); cudaErrorInvalidValue for a
// shape no instantiation takes (the wrappers refuse those first).
template <typename F, typename T, int D, typename... A>
inline int dispatch_group(int g, A... args) {
  return g <= 16 ? F::template run<T, D, 1>(args...)
                 : F::template run<T, D, 2>(args...);
}

template <typename F, typename T, typename... A>
inline int dispatch_dim(int d, int g, A... args) {
  switch (d) {
    case 64: return dispatch_group<F, T, 64>(g, args...);
    case 128: return dispatch_group<F, T, 128>(g, args...);
    case 256: return dispatch_group<F, T, 256>(g, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F, typename... A>
inline int dispatch_attn(int dtype, int d, int g, A... args) {
  if (g < 1 || g > 32) return (int)cudaErrorInvalidValue;
  return dtype == kBF16 ? dispatch_dim<F, __nv_bfloat16>(d, g, args...)
                        : dispatch_dim<F, float>(d, g, args...);
}

}  // namespace pk
