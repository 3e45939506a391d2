// A10 quant_linear and A11 grouped_gemm_q: matrix products with weight-only
// quantized weights (u8 values, one per byte for int8 and int4 alike, with
// per-group bf16 scales and optional biases along K), dequantized inside the
// kernel so that device memory holds only the quantized bytes.
//   A10: out[M, N] = x[M, K] @ deq(q[N, K])^T, out bf16 or f32;
//   A11: A4's contract (grouped_gemm.cu) over a quantized stack q[E, N, K]:
//        out[rows of g] = lhs[rows of g] @ deq(q[g])^T in f32.
//   deq(q) = bf16(f32(q) * f32(s[n, k / g]) + f32(b[n, k / g])), the
//   rounding of ops/quant.py::dequantize_weight (multiply and add are kept
//   apart, no fused multiply-add, so the weight's bits are the plain
//   version's); the products accumulate in f32.
//
// Replaces: no Pallas kernel. The JAX package multiplies a quantized param
//   by dequantizing it in the consuming dot_general
//   (parallax_tpu/models/layers.py:75 get_weight in linear :127 and
//   lm_head_logits :160; parallax_tpu/models/moe.py:92
//   _stacked_expert_weights before megablox gmm), and XLA fuses the
//   dequantization into the product. A port that dequantized to a bf16
//   weight first would write it to device memory and read it back on every
//   call (1.09 GB for Qwen2.5-7B's lm_head).
// Bound on the H100: bytes at decode (M of a few rows reads N * K bytes of
//   weights and N * K / g * 4 of scales and biases, and does 2 * M * N * K
//   operations: 7 rows of Qwen2.5-7B's gate/up weight, 68 MB, take 20 us of
//   memory time against 1 us of tensor-core time); operations at a prefill
//   batch of several hundred rows.
// Design: two variants, chosen on the host from M (no host sync).
//   - decode (A10: M <= kDecodeMaxRows; A11: M <= kQDecodeMaxRows, in
//     tiles of kQDecodeRows rows of one group): each warp owns one weight
//     row; its lanes read the row 16 bytes at a time (a chunk's loads
//     issued together, before the chunk's x is staged), dequantize the 16
//     values in registers and multiply them with up to 8 (or 16) rows of
//     x, staged in shared memory 2,048 (1,024) columns at a time; a warp
//     shuffle sums the lanes' partials. The weight bytes are read once a
//     16-row slab of x, by one warp.
//   - prefill: 64 x 64 output tiles of four warps. Each K step of 32 loads
//     the x tile and dequantizes the 64 x 32 weight tile into shared memory
//     (16 values a thread, one group each), then mma.sync m16n8k16 (bf16,
//     f32 accumulators) multiplies them; a warp owns a 32 x 32 quadrant.
//   A11 finds each block's (group, first row) on the device with A4's tile
//   map (group_tiles.cuh) over the static grid bound (M + min(E, M) * (BM -
//   1)) / BM of row tiles; surplus blocks exit. No atomics and no split-K:
//   two calls give the same bits. K must be a multiple of 16 (16-byte rows
//   of q), g one of 32, 64, 128, and the operands 16-byte aligned.
// Simple and right first: no TMA, no wgmma, no pipelining of the loads
//   (ROADMAP queue 2 lists what a faster version needs).

#include "common.cuh"
#include "group_tiles.cuh"

namespace {

// The variants' crossovers in M, set from chip_smoke.py's sweep (both
// variants forced, device time, summed over a layer's products: Qwen2.5-7B's
// q, o, gate, up and down for A10, Qwen3-30B-A3B's gate, up and down for
// A11). Past them the prefill variant's tiles fill the card.
constexpr int kDecodeMaxRows = 48;
constexpr int kQDecodeMaxRows = 128;
constexpr int kDThreads = 256;      // 8 warps, one weight row each
constexpr int kDSmemElems = 16384;  // the x stage: 32 KB of bf16
constexpr int kQDecodeRows = 8;     // A11's decode tiles (rows of a group)

constexpr int kPBM = 64;
constexpr int kPBN = 64;
constexpr int kPBK = 32;
constexpr int kPThreads = 128;
constexpr int kPLD = kPBK + 8;  // padded smem row (bf16): no bank conflicts

// The dequantized weight value, rounded to bf16 as the plain version is.
__device__ __forceinline__ __nv_bfloat16 deq(uint32_t q, float s, float b) {
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn((float)q, s), b));
}

__device__ __forceinline__ void scale_bias(const __nv_bfloat16* __restrict__ s,
                                           const __nv_bfloat16* __restrict__ b,
                                           long long at, float* sf, float* bf) {
  *sf = __bfloat162float(s[at]);
  *bf = b != nullptr ? __bfloat162float(b[at]) : 0.0f;
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Decode tile: rows [0, rows) of x (rows <= RM, row stride k) times
// weight rows n0 + warp of q (row stride k) into out (row stride n_total).
// x is staged kDSmemElems / RM columns at a time (2,048 for RM 8, 1,024 for
// RM 16); each lane issues its kSegs 16-byte weight loads of a chunk before
// the chunk's staging barrier, so they are in flight while x is staged.
// Every thread of the block calls it (it synchronises).
template <int RM, typename OutT>
__device__ void decode_tile(const __nv_bfloat16* __restrict__ x, int rows,
                            const uint8_t* __restrict__ q,
                            const __nv_bfloat16* __restrict__ s,
                            const __nv_bfloat16* __restrict__ b,
                            OutT* __restrict__ out, int n0, int n_total,
                            int k, int g) {
  constexpr int kChunk = kDSmemElems / RM;
  constexpr int kSegs = kChunk / (16 * 32);  // 16-byte loads a lane a chunk
  __shared__ __align__(16) __nv_bfloat16 xs[kDSmemElems];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = n0 + warp;
  const bool valid = n < n_total;
  const int groups = k / g;
  const uint8_t* qrow = q + (long long)n * k;
  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.0f;
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int len = min(kChunk, k - c0);
    uint4 qv[kSegs];
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      const int kk = (lane + 32 * i) * 16;
      qv[i] = valid && kk < len
                  ? __ldg(reinterpret_cast<const uint4*>(qrow + c0 + kk))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    const int vecs = len / 8;  // 16-byte vectors of x a row
    __syncthreads();           // the last chunk's readers are done
    for (int i = threadIdx.x; i < rows * vecs; i += kDThreads) {
      const int r = i / vecs;
      const int c = i % vecs;
      *reinterpret_cast<uint4*>(xs + r * kChunk + c * 8) =
          *reinterpret_cast<const uint4*>(x + (long long)r * k + c0 + c * 8);
    }
    __syncthreads();
    if (!valid) continue;
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      const int seg = lane + 32 * i;
      if (seg * 16 >= len) continue;
      const int kk = c0 + seg * 16;
      float sf, bf;
      scale_bias(s, b, (long long)n * groups + kk / g, &sf, &bf);
      const uint32_t words[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
      float w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        w[j] = __bfloat162float(deq((words[j / 4] >> (8 * (j % 4))) & 0xffu,
                                    sf, bf));
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < rows) {
          const uint4* xp =
              reinterpret_cast<const uint4*>(xs + r * kChunk + seg * 16);
          const uint4 v[2] = {xp[0], xp[1]};
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(v);
          float sum = acc[r];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float2 f = __bfloat1622float2(h[t]);
            sum = fmaf(w[2 * t], f.x, sum);
            sum = fmaf(w[2 * t + 1], f.y, sum);
          }
          acc[r] = sum;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
  }
  if (valid && lane == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < rows) out[(long long)r * n_total + n] = to_out<OutT>(acc[r]);
    }
  }
}

// Prefill tile: rows [0, rows) of x (rows <= kPBM) times weight rows
// [n0, n0 + kPBN) into out; four warps, each a 32 x 32 quadrant.
template <typename OutT>
__device__ void mma_tile(const __nv_bfloat16* __restrict__ x, int rows,
                         const uint8_t* __restrict__ q,
                         const __nv_bfloat16* __restrict__ s,
                         const __nv_bfloat16* __restrict__ b,
                         OutT* __restrict__ out, int n0, int n_total, int k,
                         int g) {
  __shared__ __align__(16) __nv_bfloat16 as[kPBM * kPLD];
  __shared__ __align__(16) __nv_bfloat16 bs[kPBN * kPLD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int gid = lane >> 2;
  const int tg = lane & 3;
  const int groups = k / g;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kPBK) {
    // x tile: 64 rows x 4 vectors of 8 bf16; rows past ``rows`` and columns
    // past K load zeros.
    for (int i = tid; i < kPBM * (kPBK / 8); i += kPThreads) {
      const int r = i / (kPBK / 8);
      const int c = i % (kPBK / 8);
      const int kk = k0 + c * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && kk < k) {
        v = *reinterpret_cast<const uint4*>(x + (long long)r * k + kk);
      }
      *reinterpret_cast<uint4*>(as + r * kPLD + c * 8) = v;
    }
    // Weight tile: 64 rows x 2 vectors of 16 u8, one a thread, dequantized.
    {
      const int r = tid / 2;
      const int c = tid % 2;
      const int n = n0 + r;
      const int kk = k0 + c * 16;
      unsigned packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) packed[j] = 0u;
      if (n < n_total && kk < k) {
        const uint4 qv =
            __ldg(reinterpret_cast<const uint4*>(q + (long long)n * k + kk));
        float sf, bf;
        scale_bias(s, b, (long long)n * groups + kk / g, &sf, &bf);
        const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t w = words[j / 2] >> (16 * (j % 2));
          const __nv_bfloat16 lo = deq(w & 0xffu, sf, bf);
          const __nv_bfloat16 hi = deq((w >> 8) & 0xffu, sf, bf);
          packed[j] = (unsigned)__bfloat16_as_ushort(lo) |
                      ((unsigned)__bfloat16_as_ushort(hi) << 16);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(bs + r * kPLD + c * 16);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPBK; kk += 16) {
      unsigned a[2][4];
      unsigned bw[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = as + (wm * 32 + mi * 16 + gid) * kPLD + kk +
                                 tg * 2;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * kPLD);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 8);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * kPLD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = bs + (wn * 32 + ni * 8 + gid) * kPLD + kk +
                                 tg * 2;
        bw[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bw[ni][1] = *reinterpret_cast<const unsigned*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) pk::mma_bf16(acc[mi][ni], a[mi], bw[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 32 + mi * 16 + gid;
      const int c = n0 + wn * 32 + ni * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= rows) continue;
        OutT* o = out + (long long)rr * n_total;
        if (c < n_total) o[c] = to_out<OutT>(acc[mi][ni][2 * h]);
        if (c + 1 < n_total) o[c + 1] = to_out<OutT>(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// Row tiles of RM rows (8 when M <= 8, else 16).
template <int RM, typename OutT>
__global__ void __launch_bounds__(kDThreads)
    quant_linear_decode_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ q,
                               const __nv_bfloat16* __restrict__ s,
                               const __nv_bfloat16* __restrict__ b,
                               OutT* __restrict__ out, int m, int n, int k,
                               int g) {
  const int r0 = blockIdx.y * RM;
  decode_tile<RM, OutT>(x + (long long)r0 * k, min(RM, m - r0), q, s, b,
                        out + (long long)r0 * n,
                        blockIdx.x * (kDThreads / 32), n, k, g);
}

template <typename OutT>
__global__ void __launch_bounds__(kPThreads)
    quant_linear_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                                const uint8_t* __restrict__ q,
                                const __nv_bfloat16* __restrict__ s,
                                const __nv_bfloat16* __restrict__ b,
                                OutT* __restrict__ out, int m, int n, int k,
                                int g) {
  const int r0 = blockIdx.y * kPBM;
  mma_tile<OutT>(x + (long long)r0 * k, min(kPBM, m - r0), q, s, b,
                 out + (long long)r0 * n, blockIdx.x * kPBN, n, k, g);
}

// A11: block -> (row tile, column tile) as in A4; the row tile's group g
// picks the weight slab q[g] and its scales.
template <int BM, int BN, int THREADS>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_q_kernel(const __nv_bfloat16* __restrict__ lhs,
                          const uint8_t* __restrict__ q,
                          const __nv_bfloat16* __restrict__ s,
                          const __nv_bfloat16* __restrict__ b,
                          const int* __restrict__ offsets,
                          float* __restrict__ out, int n, int k, int e, int g,
                          int n_tiles) {
  int grp, row0, row_end;
  if (!pk::find_group_tile<BM>(offsets, e, blockIdx.x / n_tiles, &grp, &row0,
                               &row_end)) {
    return;
  }
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int rows = min(BM, row_end - row0);
  const long long slab = (long long)grp * n;
  const long long groups = k / g;
  const __nv_bfloat16* bg = b != nullptr ? b + slab * groups : nullptr;
  if constexpr (BM == kQDecodeRows) {
    decode_tile<kQDecodeRows, float>(lhs + (long long)row0 * k, rows,
                                     q + slab * k, s + slab * groups, bg,
                                     out + (long long)row0 * n, n0, n, k, g);
  } else {
    mma_tile<float>(lhs + (long long)row0 * k, rows, q + slab * k,
                    s + slab * groups, bg, out + (long long)row0 * n, n0, n, k,
                    g);
  }
}

bool bad_shape(int k, int g) {
  return k <= 0 || k % 16 != 0 || (g != 32 && g != 64 && g != 128) ||
         k % g != 0;
}

template <typename OutT>
int launch_quant_linear(const void* x, const void* q, const void* s,
                        const void* b, void* out, int m, int n, int k, int g,
                        bool decode, cudaStream_t st) {
  const auto* xp = (const __nv_bfloat16*)x;
  const auto* qp = (const uint8_t*)q;
  const auto* sp = (const __nv_bfloat16*)s;
  const auto* bp = (const __nv_bfloat16*)b;
  OutT* op = (OutT*)out;
  if (decode) {
    const int rm = m <= 8 ? 8 : 16;
    const dim3 grid((n + kDThreads / 32 - 1) / (kDThreads / 32),
                    (m + rm - 1) / rm);
    if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
    if (rm == 8) {
      quant_linear_decode_kernel<8, OutT>
          <<<grid, kDThreads, 0, st>>>(xp, qp, sp, bp, op, m, n, k, g);
    } else {
      quant_linear_decode_kernel<16, OutT>
          <<<grid, kDThreads, 0, st>>>(xp, qp, sp, bp, op, m, n, k, g);
    }
  } else {
    const dim3 grid((n + kPBN - 1) / kPBN, (m + kPBM - 1) / kPBM);
    if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
    quant_linear_prefill_kernel<OutT>
        <<<grid, kPThreads, 0, st>>>(xp, qp, sp, bp, op, m, n, k, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. variant: 0 picks by M
// (kDecodeMaxRows), 1 forces prefill, 2 decode. biases may be null.
extern "C" int pk_quant_linear(const void* x, const void* qweight,
                               const void* scales, const void* biases,
                               void* out, int m, int n, int k, int g,
                               int out_dtype, int variant, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bad_shape(k, g) || variant < 0 || variant > 2 || out_dtype < 0 ||
      out_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool decode = variant == 2 || (variant == 0 && m <= kDecodeMaxRows);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0) {
    return launch_quant_linear<float>(x, qweight, scales, biases, out, m, n,
                                      k, g, decode, st);
  }
  return launch_quant_linear<__nv_bfloat16>(x, qweight, scales, biases, out,
                                            m, n, k, g, decode, st);
}

// variant: 0 picks by M (kQDecodeMaxRows), 1 forces prefill, 2 decode.
// biases may be null.
extern "C" int pk_grouped_gemm_q(const void* lhs, const void* qweight,
                                 const void* scales, const void* biases,
                                 const void* group_offsets, void* out, int m,
                                 int n, int k, int e, int g, int variant,
                                 void* stream) {
  if (m <= 0 || n <= 0 || e <= 0) return 0;
  if (bad_shape(k, g) || variant < 0 || variant > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const bool decode = variant == 2 || (variant == 0 && m <= kQDecodeMaxRows);
  const int bm = decode ? kQDecodeRows : kPBM;
  const int bn = decode ? kDThreads / 32 : kPBN;
  const long long busy = m < e ? m : e;
  const long long tiles = ((long long)m + busy * (bm - 1)) / bm;
  const int n_tiles = (n + bn - 1) / bn;
  const long long blocks = tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* lp = (const __nv_bfloat16*)lhs;
  const auto* qp = (const uint8_t*)qweight;
  const auto* sp = (const __nv_bfloat16*)scales;
  const auto* bp = (const __nv_bfloat16*)biases;
  const int* offs = (const int*)group_offsets;
  float* o = (float*)out;
  if (decode) {
    grouped_gemm_q_kernel<kQDecodeRows, kDThreads / 32, kDThreads>
        <<<(unsigned)blocks, kDThreads, 0, st>>>(lp, qp, sp, bp, offs, o, n,
                                                 k, e, g, n_tiles);
  } else {
    grouped_gemm_q_kernel<kPBM, kPBN, kPThreads>
        <<<(unsigned)blocks, kPThreads, 0, st>>>(lp, qp, sp, bp, offs, o, n,
                                                 k, e, g, n_tiles);
  }
  return (int)cudaGetLastError();
}
