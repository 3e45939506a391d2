// The tile map of the grouped products (A4 grouped_gemm, A11
// grouped_gemm_q): rows sorted by group, group g owning rows
// [offsets[g], offsets[g + 1]), each group cut into BM-row tiles and the
// tiles numbered in group order. Empty groups own no tile.
#pragma once

namespace pk {

// The (group, first row, group end) of row tile ``tile``; false when the
// tile is past the last one. Warp 0 gives each lane a run of consecutive
// groups, sums their tile counts, and scans the sums across the warp; the
// one lane whose range holds ``tile`` walks its groups to find it.
template <int BM>
__device__ bool find_group_tile(const int* __restrict__ offsets, int e, int tile,
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

}  // namespace pk
