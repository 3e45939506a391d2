// A4 grouped_gemm: the MoE experts' grouped matrix product. Rows of lhs
// are sorted by expert; rows [off[g], off[g+1]) are multiplied by expert
// g's weight: out[rows of g] = lhs[rows of g] @ rhs[g]^T, in f32.
//
// Replaces: the library kernel jax.experimental.pallas.ops.tpu.megablox.gmm
//   as parallax_tpu/models/moe.py::_moe_megablox (:121-151) calls it, once
//   per projection (gate, up, down) with the stacked expert weights.
// Bound on the H100: bytes at both shapes of the Qwen3-30B-A3B path. A
//   2,048-token prefill step (M = 16,384 rows over 128 experts) reads every
//   expert's 768 x 2048 bf16 slice (403 MB) against 51.5 GFLOP of products
//   (about 155 us of bytes against 52 us of tensor-core time); a decode step
//   (M of about 56) reads only the touched experts' slices.
// Design: bf16 tensor-core tiles (mma.sync m16n8k16, f32 accumulate) of
//   BM x BN = 64 x 128 output, staged through shared memory in a 3-deep
//   cp.async ring of BK = 32 slices. The weights are stored [E, N, K]
//   (K contiguous, as the JAX package stacks them), so lhs (row-major) and
//   rhs (read as column-major K x N) are exactly mma's row.col operands and
//   no transpose is made. Smem rows are padded to 40 halves, which makes
//   the fragment loads free of bank conflicts.
//   Group sizes change every step and must not cost a host sync, so the
//   grid is the static upper bound of row tiles, (M + min(E, M) * (BM - 1))
//   / BM, and each block finds its (group, first row) on the device: warp 0
//   prefix-sums ceil(rows_g / BM) over the groups with one shuffle scan.
//   Surplus blocks exit. Rows past the group's end (groups of 1 row, tiles
//   that end mid-group) are zero-filled on load and not stored; empty
//   groups own no tile. N and K tails are masked the same way (K must be a
//   multiple of 8: 16-byte rows). Weight offsets are computed in 64 bits.
//   blockIdx.x walks the N tiles of one row tile, so the blocks that share
//   a row tile (and a group's neighbouring row tiles) run together and read
//   lhs and the expert's weights from L2 rather than device memory. No
//   atomics and no split-K: the result is the same bits on every run.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;     // padded smem row, in bf16 elements
constexpr int STAGES = 3;
constexpr int THREADS = 128;    // 4 warps: 2 along rows x 2 along columns
constexpr int WM = 32;          // rows per warp
constexpr int WN = 64;          // columns per warp
constexpr int MT = WM / 16;     // m16 tiles per warp
constexpr int NT = WN / 8;      // n8 tiles per warp
constexpr int CHUNKS = BK / 8;  // 16-byte chunks per smem row

// The (group, first row, group end) of row tile ``tile``; false when the
// tile is past the last one. Warp 0 gives each lane a run of consecutive
// groups, sums their tile counts, and scans the sums across the warp; the
// one lane whose range holds ``tile`` walks its groups to find it.
__device__ bool find_tile(const int* __restrict__ offsets, int e, int tile,
                          int* group, int* row0, int* row_end) {
  __shared__ int found[3];
  if (threadIdx.x == 0) found[0] = -1;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (e + 31) / 32;
    const int g0 = min(lane * per, e);
    const int g1 = min(g0 + per, e);
    int local = 0;
    for (int g = g0; g < g1; ++g) {
      local += (offsets[g + 1] - offsets[g] + BM - 1) / BM;
    }
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - local;
    if (tile >= run && tile < incl) {
      for (int g = g0; g < g1; ++g) {
        const int a = offsets[g];
        const int b = offsets[g + 1];
        const int tiles = (b - a + BM - 1) / BM;
        if (tile < run + tiles) {
          found[0] = g;
          found[1] = a + (tile - run) * BM;
          found[2] = b;
          break;
        }
        run += tiles;
      }
    }
  }
  __syncthreads();
  if (found[0] < 0) return false;
  *group = found[0];
  *row0 = found[1];
  *row_end = found[2];
  return true;
}

__global__ void __launch_bounds__(THREADS)
    grouped_gemm_kernel(const __nv_bfloat16* __restrict__ lhs,
                        const __nv_bfloat16* __restrict__ rhs,
                        const int* __restrict__ offsets,
                        float* __restrict__ out, int n, int k, int e) {
  int g, row0, row_end;
  if (!find_tile(offsets, e, blockIdx.y, &g, &row0, &row_end)) return;
  const int n0 = blockIdx.x * BN;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * BM * LDS;
  const __nv_bfloat16* W = rhs + (long long)g * n * k;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = threadIdx.x; c < BM * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS;
      const int kc = (c % CHUNKS) * 8;
      const bool ok = row0 + r < row_end && k0 + kc < k;
      const __nv_bfloat16* src =
          ok ? lhs + (long long)(row0 + r) * k + k0 + kc : lhs;
      pk::cp_async16(As + (stage * BM + r) * LDS + kc, src, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < BN * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS;
      const int kc = (c % CHUNKS) * 8;
      const bool ok = n0 + r < n && k0 + kc < k;
      const __nv_bfloat16* src =
          ok ? W + (long long)(n0 + r) * k + k0 + kc : W;
      pk::cp_async16(Bs + (stage * BN + r) * LDS + kc, src, ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int ktiles = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    pk::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * WM;
  const int wn = (warp & 1) * WN;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  // A warp whose rows all lie past the group's end (a 1-row decode group)
  // still loads and meets every barrier, but issues no products.
  const bool active = row0 + wm < row_end && n0 + wn < n;

  for (int kt = 0; kt < ktiles; ++kt) {
    pk::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load(nk % STAGES, nk);
    pk::cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* A = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* B = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MT][4];
      unsigned b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = A + (wm + i * 16 + grp) * LDS + kk + tig * 2;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 8);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = B + (wn + j * 8 + grp) * LDS + kk + tig * 2;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) pk::mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  pk::cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + wn + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + i * 16 + grp + h * 8;
        if (r >= row_end) continue;
        float* o = out + (long long)r * n + c;
        if (c < n) o[0] = acc[i][j][2 * h];
        if (c + 1 < n) o[1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

}  // namespace

extern "C" int pk_grouped_gemm(const void* lhs, const void* rhs,
                               const void* group_offsets, void* out, int m,
                               int n, int k, int e, void* stream) {
  if (m <= 0 || n <= 0 || e <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // Every non-empty group wastes less than one tile of rows, and at most
  // min(E, M) groups are non-empty.
  const long long busy = m < e ? m : e;
  const long long tiles = ((long long)m + busy * (BM - 1)) / BM;
  const dim3 grid((n + BN - 1) / BN, (unsigned)tiles);
  const size_t smem = (size_t)STAGES * (BM + BN) * LDS * sizeof(__nv_bfloat16);
  const cudaError_t err = pk::allow_smem(grouped_gemm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  grouped_gemm_kernel<<<grid, THREADS, smem, st>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs,
      (const int*)group_offsets, (float*)out, n, k, e);
  return (int)cudaGetLastError();
}
