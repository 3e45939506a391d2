// A5 mla_decode and A6 mla_attend: MLA flash decode over the latent cache,
// one query token per row. A5 first appends the row's new [latent ‖ k_pe]
// to the cache; A6 only attends (its append ran before, as a scatter).
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::mla_fused_decode_pallas
//   (:421, A5) and parallax_tpu/ops/mla_pallas.py::mla_decode_attention_pallas
//   (:114, kernel _mla_decode_kernel :45, A6).
// Bound on the H100: close to the ridge. 128 query heads share one latent
//   row per key, so a step reads each row's context once (576 bf16 per
//   key) but does 2 * 128 * (576 + 512) operations per key: at DeepSeek-V3's
//   smoke shapes (7 rows, 292-732 keys) 5.9 MB against 0.97 GFLOP, 1.8 us
//   by bytes and 1.0 us at the tensor cores' rate; at 7 rows of 8,192 keys
//   66 MB against 16.0 GFLOP, 19.7 us by bytes and 16.1 us by operations.
//   Products on the CUDA cores (67 TFLOP/s f32) could not come near it:
//   both products run on the tensor cores.
// Design: split-KV flash decoding with the query heads as the M of
//   Hopper's warpgroup products (wgmma, bf16 in, f32 accumulation).
//   - Grid (row, head tile, split). A block owns one row, a tile of 64
//     query heads (bf16; 16 for f32) and one split of the row's keys. Its
//     Q tile [64 x 576] stays in shared memory; each key tile feeds 64
//     heads, so each latent row is read by 2 head tiles per split (the old
//     CUDA-core kernel read it with 16).
//   - Shared memory (bf16): the depth in chunks of 64 columns, each chunk
//     [rows x 128 bytes] with the 128-byte swizzle (16-byte unit u of row j
//     at u ^ (j % 8)), written by 16-byte cp.async copies, a warp a key row
//     (each position finds its own page: any page size). The same chunks
//     are the K-major operand of the score product and the MN-major operand
//     of the value product, so V (the key tile's first 512 columns) is
//     never loaded twice. A 3-stage ring of 32-key tiles.
//   - 2 warpgroups. Per key tile:
//       scores: S[64 x 32] = Q K^T, each warpgroup over one half of the
//       depth (18 wgmma m64n32k16, both operands from shared memory); the
//       halves are added through shared memory, and a + b and b + a are
//       the same float, so both warpgroups hold the same scores and run the
//       same online softmax (running max and denominator in registers, exp2
//       with log2 e folded into one FMA, keys past the split at -inf);
//       values: O[64 x 256] += P[64 x 32] V[32 x 256], each warpgroup one
//       half of the 512 value columns (FlashMLA's split), P the numerators
//       rounded to bf16 as the plain version rounds them, straight from the
//       score accumulators' registers (wgmma's A-in-registers layout is
//       theirs), V MN-major (2 wgmma m64n256k16). O is 128 f32 registers a
//       thread.
//   - Splits: a row's keys are cut into runs of pages that depend on the
//     page size and kv_len alone (mla_split_range: at least kSplitKeys = 64
//     keys, at most kMaxSplits = 16 runs), never on the batch. At the smoke
//     shape that is one 64-key page a split, 58 splits x 2 head tiles = 116
//     blocks; at 7 x 8,192 keys 16 splits of 512 keys, 224 blocks, and 29.6
//     MB of f32 scratch (rows x 16 x 128 heads x 516 floats: 4.2 MB a row
//     at most). Each split stages its unnormalised (o, m, l) in shared
//     memory and writes it to the scratch with 16-byte stores;
//     mla_combine_kernel, grid (row, head), merges a row's splits in split
//     order, parallel over heads x columns, and writes o / max(l, 1e-30):
//     rows with kv_len 0 get exact zeros. No floating-point atomics: every
//     run gives the same bits.
//   - f32 caches keep the fragment layout on the CUDA cores (FMAs), with
//     16-head tiles, 2 warps, 2 ring stages and rows padded by 16 bytes.
//   - The append race. Blocks of one launch run in no order, and several
//     read position kv_len - 1, which A5 itself appends. So exactly one
//     block per row writes the cache (head tile 0 of the split that holds
//     kv_len - 1; split 0 for kv_len 0), and every block takes the row whose
//     slot equals the append slot from the latent_new / k_pe_new inputs
//     (copied element by element into the staged tile) instead of the
//     cache. With slot < 0 (padding or a frozen row) nothing is written and
//     the cache is read as it is. A row's append slot is its private tail;
//     no other row reads it. A6 on A5's cache gives A5's bits.
//   - What bounds it now (PERF.md): not the products. At the smoke
//     shape the f32 partials (15 MB written and read back, against 5.9 MB
//     of cache) and the per-block staging of Q; at the long shape the key
//     tiles' path from L2 (each read by 2 head tiles) at 3 stages in flight.
//     TMA multicast across a 2-block cluster is the next step.
//   -Xptxas -v (sm_90a): split kernel bf16 206 registers, f32 246
//     (a 64-byte stack frame), combine 32; no spills. Dynamic shared
//     memory 201,728 bytes (bf16) and 190,720 (f32) at width 576.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKT = 32;           // context positions per key tile
constexpr int kHalfCols = 256;    // value columns per warpgroup (or warp)
constexpr int kMaxLatent = 2 * kHalfCols;   // R <= 512
constexpr int kNT = kHalfCols / 8;
constexpr int kSplitKeys = 64;    // the fewest keys of a split
constexpr int kMaxSplits = 16;    // the most splits of one row

// bf16: 2 warpgroups of 4 warps, 64 heads; f32: 2 warps, 16 heads.
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kSlabs = 4;    // 16-head slabs: 64 heads a block
  static constexpr int kStages = 3;
};
template <>
struct Cfg<float> {
  static constexpr int kSlabs = 1;
  static constexpr int kStages = 2;
};

template <typename T>
struct Geo {
  static constexpr int kHeads = 16 * Cfg<T>::kSlabs;
  static constexpr int kWarps = 2 * Cfg<T>::kSlabs;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kVec = 16 / (int)sizeof(T);
};

struct MlaArgs {
  const void* q_latent;     // [S, Hq, R]
  const void* q_pe;         // [S, Hq, Dr]
  const void* latent_new;   // [S, R] (A5) or null
  const void* k_pe_new;     // [S, Dr] (A5) or null
  void* cache;              // [P, page, 1, R + Dr]
  void* out;                // [S, Hq, R]
  const int* kv_lens;       // [S]
  const int* page_indices;  // [S, pps]
  const int* slots;         // [S] (A5) or null
  float* scratch;           // [S, num_splits, Hq, part_stride(R)]
  int hq, r, dr, page, pps, num_splits;
  long long total_slots;
  float sm_scale;
};

// A row's splits: ``count`` runs of ``per`` pages from page 0 (the last
// one clipped to the row's last page). Mirrored in Python by
// parallax_tpu_torch/ops/mla_decode.py::mla_split_ranges.
struct SplitRange {
  int per, count;
};

__device__ inline SplitRange mla_split_range(int kv_len, int page) {
  SplitRange sr{1, 0};
  if (kv_len <= 0) return sr;
  const int pages = (kv_len + page - 1) / page;
  sr.per = max((kSplitKeys + page - 1) / page,
               (pages + kMaxSplits - 1) / kMaxSplits);
  sr.count = (pages + sr.per - 1) / sr.per;
  return sr;
}

// A split partial's floats per head: o [R, padded to 16), then m, l and 2
// spare, so every head's row starts 16-byte aligned.
__host__ __device__ inline int part_stride(int r) {
  return (r + 15) / 16 * 16 + 4;
}

// The staged rows' layout. bf16: the depth in chunks of 64 columns, each
// chunk [rows x 128 bytes] with the 128-byte swizzle (16-byte unit u of
// row j at u ^ (j % 8)), which both wgmma operand forms read. f32: rows of
// the depth padded to a multiple of 32 plus 16 bytes, read by the CUDA
// cores. ``units``: the 16-byte units of a staged row (padding included);
// the ones past the cache row's are zeros.
template <typename T>
struct Layout {
  int units, q_bytes, stage_bytes, ld;   // ld: f32 row stride in floats
  __host__ __device__ explicit Layout(int w) {
    if (sizeof(T) == 2) {
      const int chunks = (w + 63) / 64;
      units = chunks * 8;
      q_bytes = chunks * Geo<T>::kHeads * 128;
      stage_bytes = chunks * kKT * 128;
      ld = 0;
    } else {
      const int dp = (w + 31) / 32 * 32;
      units = dp / 4;
      ld = dp + 4;
      q_bytes = Geo<T>::kHeads * ld * 4;
      stage_bytes = kKT * ld * 4;
    }
  }
  // Byte offset of unit u of row j in a block of ``rows`` rows.
  __device__ __forceinline__ int off(int j, int u, int rows) const {
    if (sizeof(T) == 2) {
      return (u >> 3) * rows * 128 + j * 128 + (((u & 7) ^ (j & 7)) << 4);
    }
    return j * ld * 4 + u * 16;
  }
};

template <typename T>
size_t smem_bytes(int w) {
  const Layout<T> lay(w);
  return 1024 + (size_t)lay.q_bytes + (size_t)Cfg<T>::kStages * lay.stage_bytes +
         (size_t)Geo<T>::kWarps * 16 * 32 * sizeof(float);
}

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

// f32 partial scores on the CUDA cores, in the fragment layout of the
// tensor-core tiles: this thread's heads grp = lane / 4 and grp + 8 of the
// warp's 16 (from row0), keys 8 j + 2 (lane % 4) and the next, over the
// depth columns [d0, d1).
__device__ inline void scores_f32(float (&s)[kKT / 8][4], const float* qs,
                                  int row0, const float* ks, int ld, int d0,
                                  int d1) {
  const int lane = threadIdx.x & 31;
  const float* q0 = qs + (row0 + (lane >> 2)) * ld;
  const float* q1 = q0 + 8 * ld;
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j) {
    const float* x0 = ks + (j * 8 + (lane & 3) * 2) * ld;
    const float* x1 = x0 + ld;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int d = d0; d < d1; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
      const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
      const float4 b0 = *reinterpret_cast<const float4*>(x0 + d);
      const float4 b1 = *reinterpret_cast<const float4*>(x1 + d);
      s00 = fmaf(a0.x, b0.x, s00); s00 = fmaf(a0.y, b0.y, s00);
      s00 = fmaf(a0.z, b0.z, s00); s00 = fmaf(a0.w, b0.w, s00);
      s01 = fmaf(a0.x, b1.x, s01); s01 = fmaf(a0.y, b1.y, s01);
      s01 = fmaf(a0.z, b1.z, s01); s01 = fmaf(a0.w, b1.w, s01);
      s10 = fmaf(a1.x, b0.x, s10); s10 = fmaf(a1.y, b0.y, s10);
      s10 = fmaf(a1.z, b0.z, s10); s10 = fmaf(a1.w, b0.w, s10);
      s11 = fmaf(a1.x, b1.x, s11); s11 = fmaf(a1.y, b1.y, s11);
      s11 = fmaf(a1.z, b1.z, s11); s11 = fmaf(a1.w, b1.w, s11);
    }
    s[j][0] = s00;
    s[j][1] = s01;
    s[j][2] = s10;
    s[j][3] = s11;
  }
}

// f32 o[n] += P V for value columns [col0 + 8 n, +8), n < nt: each
// numerator is fetched from the lane that holds it.
__device__ inline void pv_f32(float (&o)[kNT][4],
                              const float (&p)[kKT / 8][4], const float* vs,
                              int ld, int col0, int nt) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      const int src = (lane & ~3) | (c >> 1);
      const float p0 = __shfl_sync(0xffffffffu, p[j][c & 1], src);
      const float p1 = __shfl_sync(0xffffffffu, p[j][2 + (c & 1)], src);
      const float* vr = vs + (j * 8 + c) * ld + col0 + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) {
          const float2 v = *reinterpret_cast<const float2*>(vr + n * 8);
          o[n][0] = fmaf(p0, v.x, o[n][0]);
          o[n][1] = fmaf(p0, v.y, o[n][1]);
          o[n][2] = fmaf(p1, v.x, o[n][2]);
          o[n][3] = fmaf(p1, v.y, o[n][3]);
        }
      }
    }
  }
}

// Stage key tile [pos0, pos0 + kKT) of row s with 16-byte cp.async copies,
// a warp a row (the page lookup once per row); positions at or past kend
// zero-filled. The append slot's row is this step's [latent ‖ k_pe],
// stored element by element (R need not fill whole 16-byte units).
template <typename T>
__device__ inline void load_tile(char* stage, const Layout<T>& lay,
                                 const T* cache, long long slot, int s,
                                 const int* pages_row, int pos0, int kend,
                                 int w, const MlaArgs& a) {
  constexpr int V = Geo<T>::kVec;
  const int units = w / V;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < kKT; j += Geo<T>::kWarps) {
    const int pos = pos0 + j;
    const bool ok = pos < kend;
    long long phys = -1;
    if (ok) {
      phys = (long long)pages_row[pos / a.page] * a.page + pos % a.page;
    }
    if (ok && phys == slot) {
      const T* ln = static_cast<const T*>(a.latent_new) + (long long)s * a.r;
      const T* kn = static_cast<const T*>(a.k_pe_new) + (long long)s * a.dr;
      for (int c = lane; c < w; c += 32) {
        reinterpret_cast<T*>(stage + lay.off(j, c / V, kKT))[c % V] =
            c < a.r ? ln[c] : kn[c - a.r];
      }
      continue;
    }
    const T* src = ok ? cache + phys * w : cache;
    for (int u = lane; u < units; u += 32) {
      pk::cp_async16(stage + lay.off(j, u, kKT), ok ? src + u * V : cache,
                     ok ? 16 : 0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Geo<T>::kThreads, 1)
    mla_split_kernel(const MlaArgs a) {
  using G = Geo<T>;
  constexpr bool kTc = sizeof(T) == 2;     // tensor cores (bf16)
  constexpr int kStages = Cfg<T>::kStages;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + (((pk::smem_u32(smem_raw) + 1023u) & ~1023u) -
                           pk::smem_u32(smem_raw));
  const int s = blockIdx.x;
  const int h0 = blockIdx.y * G::kHeads;
  const int split = blockIdx.z;
  const int w = a.r + a.dr;
  const Layout<T> lay(w);
  char* qs = smem;
  char* ring = qs + lay.q_bytes;
  float* xs = reinterpret_cast<float*>(ring + kStages * lay.stage_bytes);

  const int n = a.kv_lens[s];
  const SplitRange sr = mla_split_range(n, a.page);
  T* cache = static_cast<T*>(a.cache);
  const int slot_in = a.slots != nullptr ? a.slots[s] : -1;
  const long long slot =
      slot_in >= 0 && slot_in < a.total_slots ? slot_in : -1;
  if (slot >= 0 && blockIdx.y == 0 && split == max(sr.count - 1, 0)) {
    const T* ln = static_cast<const T*>(a.latent_new) + (long long)s * a.r;
    const T* kn = static_cast<const T*>(a.k_pe_new) + (long long)s * a.dr;
    T* dst = cache + slot * w;
    for (int c = threadIdx.x; c < w; c += G::kThreads) {
      dst[c] = c < a.r ? ln[c] : kn[c - a.r];
    }
  }
  if (split >= sr.count) return;
  const int kstart = split * sr.per * a.page;
  const int kend = min(kstart + sr.per * a.page, n);

  // The query tile: [q_latent ‖ q_pe ‖ 0] per head, zero rows past hq.
  const T* ql = static_cast<const T*>(a.q_latent);
  const T* qp = static_cast<const T*>(a.q_pe);
  const int uw = w / G::kVec;
  const bool vec =
      (a.r % G::kVec) == 0 &&
      ((reinterpret_cast<uintptr_t>(ql) | reinterpret_cast<uintptr_t>(qp)) &
       15) == 0;
  if (vec) {
    const int ur = a.r / G::kVec;
    for (int i = threadIdx.x; i < G::kHeads * uw; i += G::kThreads) {
      const int hh = i / uw;
      const int u = i - hh * uw;
      const int h = h0 + hh;
      const T* src = ql;
      if (h < a.hq) {
        src = u < ur ? ql + ((long long)s * a.hq + h) * a.r + u * G::kVec
                     : qp + ((long long)s * a.hq + h) * a.dr +
                           (u - ur) * G::kVec;
      }
      pk::cp_async16(qs + lay.off(hh, u, G::kHeads), src, h < a.hq ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < G::kHeads * w; i += G::kThreads) {
      const int hh = i / w;
      const int c = i - hh * w;
      const int h = h0 + hh;
      T v = pk::from_f<T>(0.f);
      if (h < a.hq) {
        v = c < a.r ? ql[((long long)s * a.hq + h) * a.r + c]
                    : qp[((long long)s * a.hq + h) * a.dr + c - a.r];
      }
      reinterpret_cast<T*>(qs + lay.off(hh, c / G::kVec, G::kHeads))
          [c % G::kVec] = v;
    }
  }
  pk::cp_async_commit();
  // The depth padding of every staged row: zeros, never copied over.
  const int padu = lay.units - uw;
  for (int i = threadIdx.x; i < (G::kHeads + kStages * kKT) * padu;
       i += G::kThreads) {
    const int row = i / padu;
    const int u = uw + i - row * padu;
    char* dst = row < G::kHeads
                    ? qs + lay.off(row, u, G::kHeads)
                    : ring + (row - G::kHeads) / kKT * lay.stage_bytes +
                          lay.off((row - G::kHeads) % kKT, u, kKT);
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }

  const int* pages_row = a.page_indices + (long long)s * a.pps;
  const int ntiles = (kend - kstart + kKT - 1) / kKT;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < ntiles) {
      load_tile<T>(ring + st * lay.stage_bytes, lay, cache, slot, s,
                   pages_row, kstart + st * kKT, kend, w, a);
    }
    pk::cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = warp % Cfg<T>::kSlabs;
  const int half = warp / Cfg<T>::kSlabs;  // bf16: the warpgroup
  const int partner = half ? warp - Cfg<T>::kSlabs : warp + Cfg<T>::kSlabs;
  const int row0 = 16 * slab;
  const int col0 = half * kHalfCols;
  const int nt = min(kNT, max(0, (a.r - col0 + 15) / 16 * 2));
  const int tig = lane & 3;
  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float* xs_own = xs + warp * 16 * 32 + lane;
  const float* xs_partner = xs + partner * 16 * 32 + lane;
  // The score product's k16 steps (bf16) or depth columns (f32) of this
  // half: the two halves of the padded depth.
  const int ksteps = lay.units / 4;          // bf16: k16 steps per half
  const uint32_t qs_u32 = pk::smem_u32(qs);

  for (int i = 0; i < ntiles; ++i) {
    pk::cp_async_wait<kStages - 1>();
    if constexpr (kTc) pk::fence_proxy_async();
    __syncthreads();
    char* stage = ring + (i % kStages) * lay.stage_bytes;
    float sc[kKT / 8][4];
    if constexpr (kTc) {
      // S[64 x 32] over this warpgroup's depth half: Q and the key tile
      // both K-major, one 64-column chunk = 4 k16 steps of 32 bytes.
      float d[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) d[e] = 0.f;
      const uint32_t st_u32 = pk::smem_u32(stage);
      pk::wgmma_fence();
      for (int kk = half * ksteps; kk < (half + 1) * ksteps; ++kk) {
        const uint32_t c = (uint32_t)(kk >> 2);
        const uint64_t da =
            pk::desc_sw128(qs_u32 + c * G::kHeads * 128) + 2 * (kk & 3);
        const uint64_t db =
            pk::desc_sw128(st_u32 + c * kKT * 128) + 2 * (kk & 3);
        pk::wgmma_m64n32k16(d, da, db);
      }
      pk::wgmma_commit();
      pk::wgmma_wait<0>();
      pk::fence_regs(d);
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = d[4 * j + c];
      }
    } else {
      const int dh = lay.units * 2;            // f32 columns per half
      scores_f32(sc, reinterpret_cast<const float*>(qs), row0,
                 reinterpret_cast<const float*>(stage), lay.ld, half * dh,
                 (half + 1) * dh);
    }
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) xs_own[(j * 4 + c) * 32] = sc[j][c];
    }
    __syncthreads();
    const int pos0 = kstart + i * kKT;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] += xs_partner[(j * 4 + c) * 32];
    }
    // Online softmax over the tile for this thread's two heads.
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = pos0 + j * 8 + tig * 2 + e;
          const float x = kp < kend ? sc[j][2 * r2 + e] * a.sm_scale
                                    : -INFINITY;
          sc[j][2 * r2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[r2], mx);
      const float alpha = exp2f((m[r2] - m_new) * kLog2e);
      const float mb = m_new * kLog2e;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sc[j][2 * r2 + e], kLog2e, -mb));
          ls += p;
          sc[j][2 * r2 + e] = p;
        }
      }
      l[r2] = l[r2] * alpha + ls;
      m[r2] = m_new;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        o[j][2 * r2] *= alpha;
        o[j][2 * r2 + 1] *= alpha;
      }
    }
    if constexpr (kTc) {
      // O[64 x 256] += P[64 x 32] V[32 x 256]: P (rounded to bf16) from
      // registers, V the tile's value columns read MN-major from the same
      // swizzled chunks (4 chunks of 64 columns 4 KB apart, 8-key groups
      // 1 KB apart).
      if (col0 < a.r) {
        unsigned pa[kKT / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
          pa[kk][0] = pk::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[kk][1] = pk::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[kk][2] = pk::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[kk][3] = pk::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }
        float(&acc)[128] = reinterpret_cast<float(&)[128]>(o);
        const uint32_t vb =
            pk::smem_u32(stage) + (uint32_t)(col0 / 64) * kKT * 128;
        pk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
          pk::wgmma_m64n256k16_rs(
              acc, pa[kk], pk::desc_sw128_mn(vb + kk * 16 * 128, kKT * 128,
                                             8 * 128));
        }
        pk::wgmma_commit();
        pk::wgmma_wait<0>();
        pk::fence_regs(acc);
      }
    } else {
      pv_f32(o, sc, reinterpret_cast<const float*>(stage), lay.ld, col0, nt);
    }
    __syncthreads();
    if (i + kStages < ntiles) {
      load_tile<T>(ring + (i % kStages) * lay.stage_bytes, lay, cache, slot,
                   s, pages_row, kstart + (i + kStages) * kKT, kend, w, a);
    }
    pk::cp_async_commit();
  }
  pk::cp_async_wait<0>();

  // The split's partial [heads][RS] (o unnormalised, then m and l) is
  // staged in the now free shared memory and written with 16-byte stores:
  // the head tile's rows are contiguous in the scratch.
  const int rs = part_stride(a.r);
  float* os = reinterpret_cast<float*>(smem);
  const int grp = lane >> 2;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const float lsum = quad_sum(l[r2]);
    float* row = os + (row0 + grp + 8 * r2) * rs;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < nt) {
        *reinterpret_cast<float2*>(row + col0 + j * 8 + tig * 2) =
            make_float2(o[j][2 * r2], o[j][2 * r2 + 1]);
      }
    }
    if (half == 0 && tig == 0) {
      row[rs - 4] = m[r2];
      row[rs - 3] = lsum;
    }
  }
  __syncthreads();
  const int heads = min(G::kHeads, a.hq - h0);
  float4* dst = reinterpret_cast<float4*>(
      a.scratch + (((long long)s * a.num_splits + split) * a.hq + h0) * rs);
  const float4* src = reinterpret_cast<const float4*>(os);
  for (int i = threadIdx.x; i < heads * rs / 4; i += G::kThreads) {
    dst[i] = src[i];
  }
}

// Merge row s's splits for head h and write it: lane k of warp 0 weighs
// split k (kMaxSplits <= 32), e_k = exp(m_k - m) with m the splits'
// largest maximum, l = sum_k l_k e_k (butterfly sums: the same order every
// run); then each thread sums its columns over the splits in split order
// and writes o / max(l, 1e-30).
template <typename T>
__global__ void __launch_bounds__(128) mla_combine_kernel(const MlaArgs a) {
  static_assert(kMaxSplits <= 32, "one lane per split");
  __shared__ float e[32];
  __shared__ float l_sum;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const SplitRange sr = mla_split_range(a.kv_lens[s], a.page);
  const int rs = part_stride(a.r);
  const long long stride = (long long)a.hq * rs;
  const float* base =
      a.scratch + ((long long)s * a.num_splits * a.hq + h) * rs;
  if (threadIdx.x < 32) {
    const int k = threadIdx.x;
    const bool live = k < sr.count;
    const float mk = live ? base[k * stride + rs - 4] : -INFINITY;
    float mx = mk;
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float ek = live ? expf(mk - mx) : 0.f;
    float lk = live ? base[k * stride + rs - 3] * ek : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      lk += __shfl_xor_sync(0xffffffffu, lk, off);
    }
    e[k] = ek;
    if (k == 0) l_sum = lk;
  }
  __syncthreads();
  // Column c = threadIdx.x + 128 j of each split: kCols independent loads
  // a split, so the loads of several splits are in flight at once.
  constexpr int kCols = kMaxLatent / 128;
  float o[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < sr.count; ++k) {
    const float ek = e[k];
    const float* src = base + k * stride + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (threadIdx.x + 128 * j < a.r) o[j] = fmaf(src[128 * j], ek, o[j]);
    }
  }
  const float denom = fmaxf(l_sum, 1e-30f);
  T* out = static_cast<T*>(a.out) + ((long long)s * a.hq + h) * a.r;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = threadIdx.x + 128 * j;
    if (c < a.r) out[c] = pk::from_f<T>(o[j] / denom);
  }
}

template <typename T>
int launch(const MlaArgs& a, int s, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(a.r + a.dr);
  auto split = mla_split_kernel<T>;
  cudaError_t err = pk::allow_smem(split, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s, (a.hq + Geo<T>::kHeads - 1) / Geo<T>::kHeads,
                  a.num_splits);
  split<<<grid, Geo<T>::kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_combine_kernel<T><<<dim3(s, a.hq), 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int run(const MlaArgs& a, int s, int dtype, void* stream) {
  if (s <= 0 || a.hq <= 0) return 0;
  if (a.num_splits < 1 || a.num_splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pk::kBF16) return launch<__nv_bfloat16>(a, s, st);
  return launch<float>(a, s, st);
}

}  // namespace

extern "C" int pk_mla_decode(const void* q_latent, const void* q_pe,
                             const void* latent_new, const void* k_pe_new,
                             void* cache, void* out, const void* kv_lens,
                             const void* page_indices, const void* slots,
                             void* scratch, int s, int hq, int r, int dr,
                             int page, int pps, int num_splits,
                             long long total_slots, float sm_scale, int dtype,
                             void* stream) {
  const MlaArgs a{q_latent, q_pe, latent_new, k_pe_new, cache, out,
                  (const int*)kv_lens, (const int*)page_indices,
                  (const int*)slots, (float*)scratch, hq, r, dr, page, pps,
                  num_splits, total_slots, sm_scale};
  return run(a, s, dtype, stream);
}

extern "C" int pk_mla_attend(const void* q_latent, const void* q_pe,
                             void* cache, void* out, const void* kv_lens,
                             const void* page_indices, void* scratch, int s,
                             int hq, int r, int dr, int page, int pps,
                             int num_splits, float sm_scale, int dtype,
                             void* stream) {
  const MlaArgs a{q_latent, q_pe, nullptr, nullptr, cache, out,
                  (const int*)kv_lens, (const int*)page_indices, nullptr,
                  (float*)scratch, hq, r, dr, page, pps, num_splits, 0,
                  sm_scale};
  return run(a, s, dtype, stream);
}
