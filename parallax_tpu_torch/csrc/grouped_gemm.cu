// A4 grouped_gemm: the MoE experts' grouped matrix product. Rows of lhs
// are sorted by expert; rows [off[g], off[g+1]) are multiplied by expert
// g's weight: out[rows of g] = lhs[rows of g] @ rhs[g]^T, in f32.
//
// Replaces: the library kernel jax.experimental.pallas.ops.tpu.megablox.gmm
//   as parallax_tpu/models/moe.py::_moe_megablox (:121-151) calls it, once
//   per projection (gate, up, down) with the stacked expert weights.
// Bound on the H100: bytes in both regimes. A 2,048-token Qwen3-30B-A3B
//   prefill step (M = 16,384 rows over 128 experts) reads every expert's
//   768 x 2048 bf16 slice (403 MB) against 51.5 GFLOP (about 120 us of
//   weight bytes against 52 us of tensor-core time); DeepSeek-V3's (256
//   experts of 2048 x 7168) reads 7.4 GB, 2.3 ms. A decode step (M of about
//   56) reads only the touched experts' slices: 133 MB for Qwen3 (40 us),
//   1.5 GB for DeepSeek-V3 (0.45 ms), and does almost no arithmetic.
// Design: two variants of one kernel, chosen on the host from M alone (no
//   host sync); each is right for any group sizes. Both are fed by TMA
//   (tiles of 64 K-elements, one 128-byte swizzled row each) through a ring
//   of full / empty mbarriers, and multiply with wgmma from shared memory
//   with f32 accumulators in registers. The weights are read through a 3-D
//   tensor map over [E, N, K] (K contiguous, as the JAX package stacks
//   them), so an N or K tail loads zeros and never the next expert; lhs
//   through a 2-D map over [M, K], whose rows past the group's end are
//   loaded and never stored.
//   - prefill (M > kDecodeMaxRows): 128-row tiles x 256 columns. One
//     producer warp issues the loads of a 4-stage ring; two consumer
//     warpgroups (setmaxnreg moves registers to them) each run wgmma
//     m64n256k16 on 64 of the rows. A group of 65-128 rows (DeepSeek's
//     prefill groups average 65) is one tile, so its weight slice is read
//     once; a tile whose second 64 rows all lie past its group loads and
//     multiplies only the first 64.
//   - decode (M <= kDecodeMaxRows): groups hold a few rows, so A and B are
//     swapped: 64 weight rows go on wgmma's M side and the group's rows,
//     16 to a tile, on its narrow side (m64n16k16). Each block streams one
//     64 x K weight slab through a 6-stage ring (48 KB of weights in
//     flight, three blocks an SM); Qwen3's gate/up step is about 42 groups
//     x 12 slabs = 504 blocks, so every SM streams.
//   Group sizes change every step, so the grid is the static upper bound of
//   row tiles, (M + min(E, M) * (BM - 1)) / BM, times the column tiles, and
//   each block finds its (group, first row) on the device: warp 0
//   prefix-sums ceil(rows_g / BM) over the groups with one shuffle scan;
//   surplus blocks exit. Empty groups own no tile. The column tiles of one
//   row tile are consecutive blocks, so the blocks that share lhs rows run
//   together, and a group's row tiles follow one another so its weight
//   slice is read from L2 after the first. No atomics and no split-K: the
//   result is the same bits on every run. K must be a multiple of 8 (TMA's
//   16-byte row stride) and the operands 16-byte aligned.

#include "common.cuh"
#include "group_tiles.cuh"
#include "hopper.cuh"

namespace {

// Measured on an H100 (chip_smoke.py's kernels phase, both variants forced,
// device-only, at top-8 decode steps of 7-256 rows): the two run within 8%
// of each other at every M from 56 to 2,048. The decode variant is ahead
// at Qwen3-30B-A3B's shapes up to M 1,024 (1-8%) and even with the prefill
// variant at DeepSeek-V3's up to M 512; the prefill variant leads at
// DeepSeek-V3's M 1,024 and at Qwen3's gate/up at M 2,048. So the decode
// variant takes M <= 512: a step of up to 64 rows (the engine's default
// max_batch_size) at top-8.
constexpr int kDecodeMaxRows = 512;

constexpr int kBK = 64;  // K elements per stage: one 128-byte swizzled row

// Prefill variant.
constexpr int kPBM = 128;
constexpr int kPBN = 256;
constexpr int kPStages = 4;
constexpr int kPThreads = 384;  // producer warpgroup + two consumer ones
constexpr uint32_t kPHalfBytes = 64 * kBK * 2;
constexpr uint32_t kPABytes = kPBM * kBK * 2;
constexpr uint32_t kPBBytes = kPBN * kBK * 2;
constexpr uint32_t kPStageBytes = kPABytes + kPBBytes;

// Decode variant.
constexpr int kDBM = 16;        // group rows per tile (wgmma's N)
constexpr int kDBN = 64;        // weight rows per block (wgmma's M)
constexpr int kDStages = 6;
constexpr int kDThreads = 160;  // one consumer warpgroup + a producer warp
constexpr uint32_t kDWBytes = kDBN * kBK * 2;
constexpr uint32_t kDXBytes = kDBM * kBK * 2;
constexpr uint32_t kDStageBytes = kDWBytes + kDXBytes;

// Dynamic shared memory: the ring, its 2 x stages barriers, and the slack
// that aligns the ring to the 1024 bytes the swizzle needs.
constexpr size_t smem_bytes(uint32_t stage_bytes, int stages) {
  return (size_t)stages * stage_bytes + 16 * stages + 1024;
}

// The ring's base in shared memory, aligned to 1024 bytes.
__device__ __forceinline__ uint32_t ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return (pk::smem_u32(smem_raw) + 1023u) & ~1023u;
}

// Stores an f32 pair of row r at columns c, c + 1 (rows past the group's
// end and columns past N are dropped).
__device__ __forceinline__ void store_pair(float* __restrict__ out, int r,
                                           int row_end, int c, int n,
                                           float v0, float v1) {
  if (r >= row_end) return;
  float* o = out + (long long)r * n + c;
  if (c + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    if (c < n) o[0] = v0;
    if (c + 1 < n) o[1] = v1;
  }
}

__global__ void __launch_bounds__(kPThreads, 1)
    grouped_gemm_prefill_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                                const __grid_constant__ CUtensorMap tm_rhs,
                                const int* __restrict__ offsets,
                                float* __restrict__ out, int n, int k, int e,
                                int n_tiles) {
  int g, row0, row_end;
  if (!pk::find_group_tile<kPBM>(offsets, e, blockIdx.x / n_tiles, &g, &row0,
                       &row_end)) {
    return;
  }
  const int n0 = (blockIdx.x % n_tiles) * kPBN;
  // Halves of the row tile that hold rows of the group.
  const int halves = row_end - row0 > 64 ? 2 : 1;
  const uint32_t base = ring_base();
  const uint32_t full = base + kPStages * kPStageBytes;
  const uint32_t empty = full + 8 * kPStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      pk::mbar_init(full + 8 * s, 1);
      pk::mbar_init(empty + 8 * s, 128 * halves);
    }
    pk::mbar_fence_init();
  }
  __syncthreads();
  const int ktiles = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    pk::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      pk::tma_prefetch(&tm_lhs);
      pk::tma_prefetch(&tm_rhs);
      const uint32_t bytes = halves * kPHalfBytes + kPBBytes;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kPStages;
        if (kt >= kPStages) {
          pk::mbar_wait(empty + 8 * s, ((kt / kPStages) - 1) & 1);
        }
        const uint32_t a = base + s * kPStageBytes;
        const uint32_t bar = full + 8 * s;
        pk::mbar_expect_tx(bar, bytes);
        pk::tma_load_2d(a, &tm_lhs, bar, kt * kBK, row0);
        if (halves == 2) {
          pk::tma_load_2d(a + kPHalfBytes, &tm_lhs, bar, kt * kBK, row0 + 64);
        }
        pk::tma_load_3d(a + kPABytes, &tm_rhs, bar, kt * kBK, n0, g);
      }
    }
  } else {
    pk::reg_alloc<232>();
    const int half = wg - 1;
    if (half < halves) {
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kPStages;
        pk::mbar_wait(full + 8 * s, (kt / kPStages) & 1);
        const uint32_t a = base + s * kPStageBytes + half * kPHalfBytes;
        const uint64_t da = pk::desc_sw128(a);
        const uint64_t db = pk::desc_sw128(base + s * kPStageBytes + kPABytes);
        pk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pk::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        }
        pk::wgmma_commit();
        // Keep one batch in flight; the one before it has read its stage.
        pk::wgmma_wait<1>();
        if (kt > 0) pk::mbar_arrive(empty + 8 * ((kt - 1) % kPStages));
      }
      pk::wgmma_wait<0>();
      pk::fence_regs(acc);
      const int t = threadIdx.x % 128;
      const int r = row0 + half * 64 + (t / 32) * 16 + (t % 32) / 4;
      const int c0 = n0 + 2 * (t % 4);
#pragma unroll
      for (int j = 0; j < kPBN / 8; ++j) {
        store_pair(out, r, row_end, c0 + 8 * j, n, acc[4 * j], acc[4 * j + 1]);
        store_pair(out, r + 8, row_end, c0 + 8 * j, n, acc[4 * j + 2],
                   acc[4 * j + 3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kDThreads)
    grouped_gemm_decode_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                               const __grid_constant__ CUtensorMap tm_rhs,
                               const int* __restrict__ offsets,
                               float* __restrict__ out, int n, int k, int e,
                               int n_tiles) {
  int g, row0, row_end;
  if (!pk::find_group_tile<kDBM>(offsets, e, blockIdx.x / n_tiles, &g, &row0,
                       &row_end)) {
    return;
  }
  const int n0 = (blockIdx.x % n_tiles) * kDBN;
  const uint32_t base = ring_base();
  const uint32_t full = base + kDStages * kDStageBytes;
  const uint32_t empty = full + 8 * kDStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      pk::mbar_init(full + 8 * s, 1);
      pk::mbar_init(empty + 8 * s, 128);
    }
    pk::mbar_fence_init();
  }
  __syncthreads();
  const int ktiles = (k + kBK - 1) / kBK;
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      pk::tma_prefetch(&tm_lhs);
      pk::tma_prefetch(&tm_rhs);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kDStages;
        if (kt >= kDStages) {
          pk::mbar_wait(empty + 8 * s, ((kt / kDStages) - 1) & 1);
        }
        const uint32_t w = base + s * kDStageBytes;
        const uint32_t bar = full + 8 * s;
        pk::mbar_expect_tx(bar, kDStageBytes);
        pk::tma_load_3d(w, &tm_rhs, bar, kt * kBK, n0, g);
        pk::tma_load_2d(w + kDWBytes, &tm_lhs, bar, kt * kBK, row0);
      }
    }
  } else {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kDStages;
      pk::mbar_wait(full + 8 * s, (kt / kDStages) & 1);
      const uint32_t w = base + s * kDStageBytes;
      const uint64_t dw = pk::desc_sw128(w);
      const uint64_t dx = pk::desc_sw128(w + kDWBytes);
      pk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pk::wgmma_m64n16k16(acc, dw + 2 * kk, dx + 2 * kk);
      }
      pk::wgmma_commit();
      pk::wgmma_wait<1>();
      if (kt > 0) pk::mbar_arrive(empty + 8 * ((kt - 1) % kDStages));
    }
    pk::wgmma_wait<0>();
    pk::fence_regs(acc);
    // acc holds out^T: weight row (its output column) by group row.
    const int t = threadIdx.x;
    const int c = n0 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < kDBM / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c + 8 * (q >> 1);
        const int r = row0 + 8 * j + 2 * (t % 4) + (q & 1);
        if (r < row_end && col < n) out[(long long)r * n + col] = acc[4 * j + q];
      }
    }
  }
}

// A bf16 tensor map over ``rank`` dims (innermost first) with boxes of
// ``box`` elements, 128-byte swizzled; out-of-range elements load as 0.
int encode(CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, const cuuint32_t* box) {
  const pk::EncodeTiled fn = pk::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  cuuint64_t strides[2];
  strides[0] = dims[0] * 2;
  strides[1] = strides[0] * dims[1];
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 picks by M (kDecodeMaxRows), 1 forces prefill, 2 decode.
extern "C" int pk_grouped_gemm(const void* lhs, const void* rhs,
                               const void* group_offsets, void* out, int m,
                               int n, int k, int e, int variant,
                               void* stream) {
  if (m <= 0 || n <= 0 || e <= 0) return 0;
  if (variant < 0 || variant > 2 || k <= 0 || k % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const bool decode = variant == 2 || (variant == 0 && m <= kDecodeMaxRows);
  const int bm = decode ? kDBM : kPBM;
  const int bn = decode ? kDBN : kPBN;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap tm_lhs, tm_rhs;
  const cuuint64_t dl[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint32_t bl[2] = {(cuuint32_t)kBK, (cuuint32_t)(decode ? kDBM : 64)};
  const cuuint64_t dr[3] = {(cuuint64_t)k, (cuuint64_t)n, (cuuint64_t)e};
  const cuuint32_t br[3] = {(cuuint32_t)kBK, (cuuint32_t)bn, 1};
  int err = encode(&tm_lhs, lhs, 2, dl, bl);
  if (err == 0) err = encode(&tm_rhs, rhs, 3, dr, br);
  if (err != 0) return err;
  // Every non-empty group wastes less than one tile of rows, and at most
  // min(E, M) groups are non-empty.
  const long long busy = m < e ? m : e;
  const long long tiles = ((long long)m + busy * (bm - 1)) / bm;
  const int n_tiles = (n + bn - 1) / bn;
  const long long blocks = tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int* offs = (const int*)group_offsets;
  float* o = (float*)out;
  if (decode) {
    const size_t smem = smem_bytes(kDStageBytes, kDStages);
    cudaError_t e2 = pk::allow_smem(grouped_gemm_decode_kernel, smem);
    if (e2 != cudaSuccess) return (int)e2;
    grouped_gemm_decode_kernel<<<(unsigned)blocks, kDThreads, smem, st>>>(
        tm_lhs, tm_rhs, offs, o, n, k, e, n_tiles);
  } else {
    const size_t smem = smem_bytes(kPStageBytes, kPStages);
    cudaError_t e2 = pk::allow_smem(grouped_gemm_prefill_kernel, smem);
    if (e2 != cudaSuccess) return (int)e2;
    grouped_gemm_prefill_kernel<<<(unsigned)blocks, kPThreads, smem, st>>>(
        tm_lhs, tm_rhs, offs, o, n, k, e, n_tiles);
  }
  return (int)cudaGetLastError();
}
