// A7 indexer_fused and A8 indexer_scores: the sparse-attention indexer's
// per-token scores for decode batches, one query token per row. A7 first
// appends the row's new index key; A8 only scores. Two head reductions of
// the dots q_h . k: DSA sum_h w_h * relu(.), MSA max_h(.) * sm_scale.
//
// Replaces: parallax_tpu/ops/decode_fused_pallas.py::indexer_scores_fused_pallas
//   (:505, A7) and parallax_tpu/ops/dsa_pallas.py::paged_token_scores_decode
//   (:39, A8), which parallax_tpu/ops/dsa_pallas.py (:117, DSA) and
//   parallax_tpu/ops/msa_pallas.py (:27, MSA) wrap.
// Bound on the H100: bytes, once the products run on the tensor cores. A
//   step reads every index key of each row's context once (128 bf16 per key
//   for DeepSeek-V3.2) and writes f32[S, pps * page] scores. Its 2 * 64 *
//   128 operations per key (64 per byte) sit below the tensor cores' ridge
//   (295 per byte) but far above the CUDA cores' (20): at 7 rows of 32,768
//   keys 58.7 MB of keys take 17.8 us at 3.35 TB/s, the 3.76 GFLOP 3.8 us
//   on the tensor cores and 56 us as f32 FMAs. At the smoke shape (7 rows,
//   292-732 keys) the bytes are under 1 MB and latency decides.
// Design (bf16, Hi <= 64, D a multiple of 64 up to 256, pages of a
//   multiple of 8 positions: every registered indexer, DeepSeek-V3.2's
//   Hi 64 / D 128 and MiniMax-M3's Hi 16 / D 64, at the engine's pages):
//   - Blocks by work, not by page slot. Grid (row, B); the host picks B
//     from S alone (about three blocks an SM, at most half the page slots)
//     and never reads kv_len. Each block cuts its own run from kv_len
//     (indexer_run): an equal share of the row's live pages and of its
//     dead tail, which it fills with 16-byte -inf stores. Every position is
//     written by exactly one block, and a key's score does not depend on
//     the cut (its heads meet in one fixed order), so there is no combine
//     pass and no float atomics.
//   - The row's queries are staged once per block, bf16, as the K-major B
//     operand of wgmma (64-element rows with the 128-byte swizzle, 1024-byte
//     aligned; rows past Hi are zeros), by 16-byte cp.async copies while
//     the first key tiles come.
//   - An asynchronous page ring: kStages stages of 64 positions, filled by
//     TMA (one thread; an mbarrier per stage counts the bytes), in boxes of
//     gcd(page, 64) positions x 64 columns with the 128-byte swizzle, each
//     box through its own page_indices entry. The cache's tensor map is
//     encoded once per (cache, shape) on the host and reused (cache_map).
//   - Products on the tensor cores, keys as M: S^T[64 keys x 64 heads] +=
//     K[64 x 16] Q[64 x 16]^T over D in k16 steps (wgmma m64n64k16, f32
//     accumulators; bf16 x bf16 products are exact in f32).
//   - The head reduction in registers: a thread holds 16 heads of two
//     keys; DSA relu and the weight (16 weights in registers, 0 past Hi),
//     MSA the max (heads past Hi left out), then the 4 lanes of the quad
//     by __shfl_xor. No shared-memory pass across warps: each warp owns
//     16 keys. Each warp stores its 16 scores with 16-byte writes;
//     sm_scale applies after the max.
//   f32 caches, and bf16 shapes outside that body, take a CUDA-core body
//   with the same grid, runs and epilogue stores, a 2-stage cp.async ring
//   (rows padded by 16 bytes) and the row's queries staged once per block
//   as f32: thread = (key, head group of 2), dots as FMA chains.
//   Positions at or past kv_len are exact -inf, and every position of the
//   row is written: the TPU kernel fills the whole row with -inf first, and
//   the top-k's dense-row detection counts the finite scores.
//   The append race of A7: block 0 of the row alone writes the cache, and
//   every block takes the key whose slot equals the append slot from the
//   k_new input rather than the cache (the TMA body overwrites that row of
//   the staged tile). Slot < 0 writes nothing. A row's append slot is its
//   private tail; no other row reads it.
//   -Xptxas -v (sm_90a): the tensor-core body 80 registers (a 32-byte
//   stack frame for thread 0's box rows), the CUDA-core bodies 64 (f32)
//   and 55 (bf16); no spills. Dynamic shared memory 66,852 bytes at D 128:
//   three blocks an SM.

#include "common.cuh"
#include "hopper.cuh"

#include <mutex>
#include <numeric>

namespace {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kKeyTile = 64;       // positions per key tile (wgmma M)
constexpr int kHeadTile = 64;      // head rows of the query tile (wgmma N)
constexpr int kStages = 3;         // key tiles in flight (tensor-core body)
constexpr int kFmaStages = 2;      // key tiles in flight (CUDA-core body)
constexpr int kMaxTcDepth = 256;   // the deepest D of the tensor-core body
constexpr int kGroups = kThreads / kKeyTile;   // CUDA-core head groups
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
  int hi, d, page, pps, blocks;
  long long total_slots;
  int reduce;               // 0 = DSA, 1 = MSA
  float sm_scale;
};

// Block b's share of a row: live pages [lo, hi) and dead pages
// [dead_lo, dead_hi). Mirrored in Python by
// parallax_tpu_torch/ops/dsa_decode.py::indexer_runs.
struct Run {
  int lo, hi, dead_lo, dead_hi;
};

__device__ __forceinline__ Run indexer_run(int kv_len, int page, int pps,
                                           int blocks, int b) {
  const int live = kv_len <= 0 ? 0 : min((kv_len + page - 1) / page, pps);
  const int dead = pps - live;
  Run r;
  r.lo = (int)((long long)b * live / blocks);
  r.hi = (int)((long long)(b + 1) * live / blocks);
  r.dead_lo = live + (int)((long long)b * dead / blocks);
  r.dead_hi = live + (int)((long long)(b + 1) * dead / blocks);
  return r;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// -inf into row[lo, hi): 16-byte stores between scalar head and tail.
__device__ void fill_neg_inf(float* row, long long lo, long long hi) {
  float* p = row + lo;
  long long cnt = hi - lo;
  if (cnt <= 0) return;
  const long long head =
      min(cnt, (long long)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                   4);
  const float ni = neg_inf();
  for (long long i = threadIdx.x; i < head; i += kThreads) p[i] = ni;
  p += head;
  cnt -= head;
  const float4 v4 = make_float4(ni, ni, ni, ni);
  float4* p4 = reinterpret_cast<float4*>(p);
  for (long long i = threadIdx.x; i < cnt / 4; i += kThreads) p4[i] = v4;
  for (long long i = cnt / 4 * 4 + threadIdx.x; i < cnt; i += kThreads) {
    p[i] = ni;
  }
}

// The prologue both bodies share: A7's append by block 0, the block's run,
// and its dead pages filled with -inf.
template <typename T>
__device__ Run prologue(const IdxArgs& a, int s, int n, long long slot) {
  if (slot >= 0 && blockIdx.y == 0) {
    const int units = a.d * (int)sizeof(T) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.k_new) + (long long)s * a.d);
    uint4* dst =
        reinterpret_cast<uint4*>(static_cast<T*>(a.cache) + slot * a.d);
    for (int u = threadIdx.x; u < units; u += kThreads) dst[u] = src[u];
  }
  const Run r = indexer_run(n, a.page, a.pps, a.blocks, blockIdx.y);
  float* row = a.scores + (long long)s * a.pps * a.page;
  fill_neg_inf(row, (long long)r.dead_lo * a.page,
               (long long)r.dead_hi * a.page);
  return r;
}

// CUDA-core body: stage key tile [pos0, pos0 + kKeyTile) of row s with
// 16-byte cp.async copies into rows of ``row_bytes``; positions at or past
// ``live`` zero-filled; the append slot's key from k_new.
template <typename T>
__device__ __forceinline__ void load_keys(char* stage, const IdxArgs& a,
                                          const int* pages_row, int s,
                                          long long slot, int pos0, int live,
                                          int row_bytes) {
  constexpr int V = 16 / (int)sizeof(T);
  const int units = a.d / V;
  const T* cache = static_cast<const T*>(a.cache);
  const T* k_new = static_cast<const T*>(a.k_new) + (long long)s * a.d;
  for (int i = threadIdx.x; i < kKeyTile * units; i += kThreads) {
    const int j = i / units;
    const int u = i - j * units;
    const int pos = pos0 + j;
    const bool ok = pos < live;
    const T* src = cache;
    if (ok) {
      const long long phys =
          (long long)pages_row[pos / a.page] * a.page + pos % a.page;
      src = (phys == slot ? k_new : cache + phys * a.d) + u * V;
    }
    pk::cp_async16(stage + j * row_bytes + u * 16, src, ok ? 16 : 0);
  }
}

// Scores of positions p .. p + 3 of a row: times ``scale``, -inf at or
// past kv_len (n), stored below ``end`` with one 16-byte write where the
// four are whole and aligned.
__device__ __forceinline__ void store4(float* row, int p, int n, int end,
                                       float scale, float (&o)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = p + e < n ? o[e] * scale : neg_inf();
  if (p >= end) return;
  float* dst = row + p;
  if (p + 4 <= end && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p + e < end) dst[e] = o[e];
    }
  }
}

// -- The tensor-core body (bf16) ---------------------------------------------

// Byte offset of 16-byte unit u of row j in a K-major tile of ``rows`` rows:
// 64-column chunks of [rows x 128 bytes], unit u % 8 of row j at
// (u % 8) ^ (j % 8) (the 128-byte swizzle that desc_sw128 describes).
__device__ __forceinline__ int sw_off(int j, int u, int rows) {
  return (u >> 3) * rows * 128 + j * 128 + (((u & 7) ^ (j & 7)) << 4);
}

size_t mma_smem_bytes(int d) {
  return 1024 + (size_t)kHeadTile * d * 2 + (size_t)kStages * kKeyTile * d * 2 +
         (size_t)(kThreads / 32) * 16 * 4 + 12 * kStages;
}

// Thread 0: the TMA copies of key tile [pos0, pos0 + 64) below ``end`` into
// the stage at ``dst``: per box of ``box`` positions (one page or part of
// one), a [box x 64] copy of each 64-column chunk, counted on ``bar``.
// ``*patch`` gets the tile row of the append slot (A7), or -1; the
// barrier's completion publishes it to the waiting threads.
__device__ __forceinline__ void tma_tile(const CUtensorMap* tm, uint32_t dst,
                                         uint32_t bar, int* patch,
                                         const int* pages_row, long long slot,
                                         int pos0, int end, int page, int box,
                                         int chunks) {
  const int boxes = min(kKeyTile, end - pos0 + box - 1) / box;
  int rows[kKeyTile / 8];
  int j = -1;
  for (int g = 0; g < boxes; ++g) {
    const int p = pos0 + g * box;
    rows[g] = pages_row[p / page] * page + p % page;
    if (slot >= rows[g] && slot < rows[g] + box) {
      j = g * box + (int)(slot - rows[g]);
    }
  }
  *patch = j;
  pk::mbar_expect_tx(bar, (uint32_t)(boxes * chunks * box * 128));
  for (int g = 0; g < boxes; ++g) {
    for (int c = 0; c < chunks; ++c) {
      pk::tma_load_2d(dst + c * kKeyTile * 128 + g * box * 128, tm, bar,
                      c * 64, rows[g]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) indexer_mma_kernel(
    const __grid_constant__ CUtensorMap tm, IdxArgs a, int box) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + (((pk::smem_u32(smem_raw) + 1023u) & ~1023u) -
                           pk::smem_u32(smem_raw));
  const int s = blockIdx.x;
  if (threadIdx.x == 0) pk::tma_prefetch(&tm);
  const int n = a.kv_lens[s];
  const int slot_in = a.slots != nullptr ? a.slots[s] : -1;
  const long long slot =
      slot_in >= 0 && slot_in < a.total_slots ? slot_in : -1;
  const Run r = prologue<T>(a, s, n, slot);
  if (r.hi <= r.lo) return;

  const int q_bytes = kHeadTile * a.d * 2;
  const int stage_bytes = kKeyTile * a.d * 2;
  const int chunks = a.d / 64;
  char* qs = smem;
  char* ring = qs + q_bytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This warp's 16 key scores, staged for 16-byte stores; then one
  // mbarrier and one append row (tma_tile's patch) per stage.
  float* wsc = reinterpret_cast<float*>(ring + kStages * stage_bytes) +
               warp * 16;
  const uint32_t full = pk::smem_u32(ring + kStages * stage_bytes) +
                        (kThreads / 32) * 16 * 4;
  int* patch = reinterpret_cast<int*>(ring + kStages * stage_bytes +
                                      (kThreads / 32) * 16 * 4 + 8 * kStages);
  const uint32_t ring_u32 = pk::smem_u32(ring);
  const int* pages_row = a.page_indices + (long long)s * a.pps;
  const int kstart = r.lo * a.page;
  const int kend = r.hi * a.page;           // the run's last position + 1
  const int ntiles = (kend - kstart + kKeyTile - 1) / kKeyTile;
  // Thread 0 starts the first copies as soon as the barriers exist; the
  // others wait on a barrier only after the __syncthreads below.
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) pk::mbar_init(full + 8 * st, 1);
    pk::mbar_fence_init();
    for (int st = 0; st < kStages - 1 && st < ntiles; ++st) {
      tma_tile(&tm, ring_u32 + st * stage_bytes, full + 8 * st, patch + st,
               pages_row, slot, kstart + st * kKeyTile, kend, a.page, box,
               chunks);
    }
  }
  // The query tile [64 x D], zero rows past Hi, while the keys come.
  {
    constexpr int V = 8;
    const int units = a.d / V;
    const T* q = static_cast<const T*>(a.q) + (long long)s * a.hi * a.d;
    for (int i = threadIdx.x; i < kHeadTile * units; i += kThreads) {
      const int h = i / units;
      const int u = i - h * units;
      const bool ok = h < a.hi;
      pk::cp_async16(qs + sw_off(h, u, kHeadTile),
                     ok ? q + (long long)h * a.d + u * V : q, ok ? 16 : 0);
    }
    pk::cp_async_commit();
  }
  __syncthreads();

  // The product is S^T[64 keys x 64 heads]: this thread holds keys
  // 16 warp + lane / 4 (+ 8) and heads 8 j + 2 (lane % 4) + c, so a key's
  // heads meet in its own registers and the 4 lanes of its quad.
  const bool dsa = a.reduce == kDSA;
  float wr[16];                               // DSA weights (0 past Hi)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int h = 8 * j + 2 * (lane & 3) + c;
      wr[2 * j + c] =
          dsa && h < a.hi ? a.weights[(long long)s * a.hi + h] : 0.f;
    }
  }
  const int ksteps = a.d / 16;
  const uint32_t qs_u32 = pk::smem_u32(qs);
  float* row = a.scores + (long long)s * a.pps * a.page;
  const uint4* k_new = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.k_new) + (long long)s * a.d);

  for (int i = 0; i < ntiles; ++i) {
    const int stage = i % kStages;
    const int pos0 = kstart + i * kKeyTile;
    pk::mbar_wait(full + 8 * stage, (i / kStages) & 1);
    if (i == 0) pk::cp_async_wait<0>();
    // A7: the append slot's key, if this tile holds it, from k_new (the
    // copy may have read the cache before block 0 wrote it).
    const int j = patch[stage];
    if (j >= 0) {
      for (int u = threadIdx.x; u < a.d / 8; u += kThreads) {
        *reinterpret_cast<uint4*>(ring + stage * stage_bytes +
                                  sw_off(j, u, kKeyTile)) = k_new[u];
      }
    }
    pk::fence_proxy_async();
    __syncthreads();
    // Tile i is in; every thread is done with tile i - 1, whose stage the
    // next copy refills.
    const int nxt = i + kStages - 1;
    if (threadIdx.x == 0 && nxt < ntiles) {
      tma_tile(&tm, ring_u32 + (nxt % kStages) * stage_bytes,
               full + 8 * (nxt % kStages), patch + nxt % kStages, pages_row,
               slot, kstart + nxt * kKeyTile, kend, a.page, box, chunks);
    }

    const uint32_t st_u32 = ring_u32 + stage * stage_bytes;
    // The first k step overwrites the accumulators; fence_regs keeps every
    // other write of them outside the products (else they serialize).
    float d[32];
    pk::fence_regs(d);
    pk::wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t c = (uint32_t)(kk >> 2);
      const uint64_t da =
          pk::desc_sw128(st_u32 + c * kKeyTile * 128) + 2 * (kk & 3);
      const uint64_t db =
          pk::desc_sw128(qs_u32 + c * kHeadTile * 128) + 2 * (kk & 3);
      pk::wgmma_m64n64k16(d, da, db, kk > 0);
    }
    pk::wgmma_commit();
    pk::wgmma_wait<0>();
    pk::fence_regs(d);

    // d[4 j + 2 h + c]: key 16 warp + lane / 4 + 8 h, head 8 j + 2 (lane %
    // 4) + c. Each key's heads in a fixed order: the thread's 16, then its
    // quad's 4 lanes. Positions past kv_len hold whatever the page held
    // and come out -inf.
    float v[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = dsa ? 0.f : neg_inf();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float y = d[4 * j + 2 * hh + c];
          if (dsa) {
            x = fmaf(wr[2 * j + c], fmaxf(y, 0.f), x);
          } else if (8 * j + 2 * (lane & 3) + c < a.hi) {
            x = fmaxf(x, y);
          }
        }
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, m);
        x = dsa ? x + y : fmaxf(x, y);
      }
      v[hh] = x;
    }
    if ((lane & 3) == 0) {
      wsc[lane >> 2] = v[0];
      wsc[8 + (lane >> 2)] = v[1];
    }
    __syncwarp();
    if (lane < 4) {
      const float4 x = reinterpret_cast<const float4*>(wsc)[lane];
      float o[4] = {x.x, x.y, x.z, x.w};
      store4(row, pos0 + 16 * warp + 4 * lane, n, kend,
             dsa ? 1.f : a.sm_scale, o);
    }
  }
}

// The tensor maps of the caches A7 / A8 have read: the cache viewed as
// [P * page rows, D] bf16 in boxes of [box rows x 64 columns] with the
// 128-byte swizzle. A map depends only on its key, so a later cache at
// the same address and shape reuses it; encoding one costs host time that
// every call would pay otherwise.
struct MapEntry {
  const void* ptr;
  long long rows;
  int d, box;
  CUtensorMap map;
};
constexpr int kMaps = 64;
MapEntry g_maps[kMaps];
int g_maps_used = 0, g_maps_next = 0;
std::mutex g_maps_mu;

int cache_map(const void* ptr, long long rows, int d, int box,
              CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_maps_used; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == ptr && e.rows == rows && e.d == d && e.box == box) {
      *out = e.map;
      return 0;
    }
  }
  const pk::EncodeTiled fn = pk::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  MapEntry e{ptr, rows, d, box, {}};
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t boxd[2] = {64, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          const_cast<void*>(ptr), dims, strides, boxd, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  g_maps[g_maps_next] = e;
  g_maps_next = (g_maps_next + 1) % kMaps;
  g_maps_used = g_maps_used < kMaps ? g_maps_used + 1 : kMaps;
  *out = e.map;
  return 0;
}

// -- The CUDA-core body (f32, and bf16 outside the tensor-core body) --------

// The staged key row: D elements and 16 bytes of padding (conflict-free
// 16-byte reads down a column of keys).
__host__ __device__ inline int fma_row_bytes(int d, int elem) {
  return d * elem + 16;
}

size_t fma_smem_bytes(int hi, int d, int elem) {
  return pk::align16((size_t)hi * d * 4) + pk::align16((size_t)hi * 4) +
         (size_t)kFmaStages * kKeyTile * fma_row_bytes(d, elem) +
         (size_t)kGroups * kKeyTile * 4;
}

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
__global__ void __launch_bounds__(kThreads) indexer_fma_kernel(IdxArgs a) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  const int n = a.kv_lens[s];
  const int slot_in = a.slots != nullptr ? a.slots[s] : -1;
  const long long slot =
      slot_in >= 0 && slot_in < a.total_slots ? slot_in : -1;
  const Run r = prologue<T>(a, s, n, slot);
  if (r.hi <= r.lo) return;

  const int row_bytes = fma_row_bytes(a.d, sizeof(T));
  float* qs = reinterpret_cast<float*>(smem);                    // [hi][d]
  float* ws = qs + pk::align16((size_t)a.hi * a.d * 4) / 4;      // [hi]
  char* ring = reinterpret_cast<char*>(ws + pk::align16((size_t)a.hi * 4) / 4);
  float* red = reinterpret_cast<float*>(ring + kFmaStages * kKeyTile * row_bytes);
  const int* pages_row = a.page_indices + (long long)s * a.pps;
  const int kstart = r.lo * a.page;
  const int kend = r.hi * a.page;
  const int live = min(kend, n);
  const int ntiles = (kend - kstart + kKeyTile - 1) / kKeyTile;
  load_keys<T>(ring, a, pages_row, s, slot, kstart, live, row_bytes);
  pk::cp_async_commit();

  // The row's queries as f32, once, while the first tile is in flight.
  const int units = a.d / V;
  const uint4* q = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.q) + (long long)s * a.hi * a.d);
  for (int i = threadIdx.x; i < a.hi * units; i += kThreads) {
    float f[V];
    unpack<T>(q[i], f);
#pragma unroll
    for (int e = 0; e < V; ++e) qs[i * V + e] = f[e];
  }
  const bool dsa = a.reduce == kDSA;
  for (int h = threadIdx.x; h < a.hi; h += kThreads) {
    ws[h] = dsa ? a.weights[(long long)s * a.hi + h] : 0.f;
  }

  // Thread = (key p, head group g): heads g, g + kGroups, ...; the groups'
  // partials meet in red [kGroups][kKeyTile], added in group order.
  const int p = threadIdx.x % kKeyTile;
  const int g = threadIdx.x / kKeyTile;
  float* row = a.scores + (long long)s * a.pps * a.page;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_keys<T>(ring + ((i + 1) % kFmaStages) * kKeyTile * row_bytes, a,
                   pages_row, s, slot, kstart + (i + 1) * kKeyTile, live,
                   row_bytes);
    }
    pk::cp_async_commit();
    pk::cp_async_wait<1>();
    __syncthreads();
    const uint4* krow = reinterpret_cast<const uint4*>(
        ring + (i % kFmaStages) * kKeyTile * row_bytes + p * row_bytes);
    float part = dsa ? 0.f : neg_inf();
    for (int h = g; h < a.hi; h += kGroups) {
      const float* qrow = qs + (long long)h * a.d;
      float dot = 0.f;
      for (int u = 0; u < units; ++u) {
        float kf[V];
        unpack<T>(krow[u], kf);
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qrow[u * V + e], kf[e], dot);
      }
      part = dsa ? fmaf(ws[h], fmaxf(dot, 0.f), part) : fmaxf(part, dot);
    }
    red[g * kKeyTile + p] = part;
    __syncthreads();
    if (threadIdx.x < kKeyTile / 4) {
      const float4* r4 = reinterpret_cast<const float4*>(red);
      float4 x = r4[threadIdx.x];
#pragma unroll
      for (int k = 1; k < kGroups; ++k) {
        const float4 y = r4[k * kKeyTile / 4 + threadIdx.x];
        if (dsa) {
          x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
        } else {
          x.x = fmaxf(x.x, y.x); x.y = fmaxf(x.y, y.y);
          x.z = fmaxf(x.z, y.z); x.w = fmaxf(x.w, y.w);
        }
      }
      float o[4] = {x.x, x.y, x.z, x.w};
      store4(row, kstart + i * kKeyTile + 4 * threadIdx.x, n, kend,
             dsa ? 1.f : a.sm_scale, o);
    }
    // The next iteration's copy refills this tile's stage and red.
    __syncthreads();
  }
  pk::cp_async_wait<0>();
}

// The tensor-core body: bf16, Hi <= 64, D a multiple of 64 up to 256, and
// pages of a multiple of 8 positions (a TMA box of gcd(page, 64) rows
// lands 1024-byte aligned, where the swizzle starts over).
bool use_mma(int dtype, int hi, int d, int page) {
  return dtype == pk::kBF16 && hi <= kHeadTile && d % 64 == 0 &&
         d <= kMaxTcDepth && page % 8 == 0;
}

template <typename K>
int launch(K kern, const IdxArgs& a, int s, size_t smem, cudaStream_t st) {
  const cudaError_t err = pk::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(s, a.blocks), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int run(const IdxArgs& a, int s, int dtype, void* stream) {
  if (s <= 0 || a.pps <= 0) return 0;
  if (a.blocks < 1 || a.blocks > a.pps) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_mma(dtype, a.hi, a.d, a.page)) {
    const int box = std::gcd(a.page, kKeyTile);
    CUtensorMap tm;
    const int err = cache_map(a.cache, a.total_slots, a.d, box, &tm);
    if (err != 0) return err;
    const size_t smem = mma_smem_bytes(a.d);
    const cudaError_t e2 = pk::allow_smem(indexer_mma_kernel, smem);
    if (e2 != cudaSuccess) return (int)e2;
    indexer_mma_kernel<<<dim3(s, a.blocks), kThreads, smem, st>>>(tm, a, box);
    return (int)cudaGetLastError();
  }
  if (dtype == pk::kBF16) {
    return launch(indexer_fma_kernel<__nv_bfloat16>, a, s,
                  fma_smem_bytes(a.hi, a.d, 2), st);
  }
  return launch(indexer_fma_kernel<float>, a, s, fma_smem_bytes(a.hi, a.d, 4),
                st);
}

}  // namespace

extern "C" int pk_indexer_fused(const void* q, const void* weights,
                                const void* k_new, void* cache, void* scores,
                                const void* kv_lens, const void* page_indices,
                                const void* slots, int s, int hi, int d,
                                int page, int pps, int blocks,
                                long long total_slots, int reduce,
                                float sm_scale, int dtype, void* stream) {
  const IdxArgs a{q, (const float*)weights, k_new, cache, (float*)scores,
                  (const int*)kv_lens, (const int*)page_indices,
                  (const int*)slots, hi, d, page, pps, blocks, total_slots,
                  reduce, sm_scale};
  return run(a, s, dtype, stream);
}

extern "C" int pk_indexer_scores(const void* q, const void* weights,
                                 void* cache, void* scores,
                                 const void* kv_lens, const void* page_indices,
                                 int s, int hi, int d, int page, int pps,
                                 int blocks, long long total_slots, int reduce,
                                 float sm_scale, int dtype, void* stream) {
  const IdxArgs a{q, (const float*)weights, nullptr, cache, (float*)scores,
                  (const int*)kv_lens, (const int*)page_indices, nullptr, hi,
                  d, page, pps, blocks, total_slots, reduce, sm_scale};
  return run(a, s, dtype, stream);
}
