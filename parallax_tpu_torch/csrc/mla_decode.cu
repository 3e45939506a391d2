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
//   by bytes and 1.0 us at the tensor cores' rate.
// Design: this first version runs on the CUDA cores (f32 FMA), not the
//   tensor cores, and is several times its bound: it is simple and exact,
//   and a later PR moves the two products onto mma / wgmma tiles.
//   - Heads are split across blocks: a row's f32 accumulator over 128 heads
//     x 512 latent columns (256 KB) does not fit one block, so the grid is
//     (row, block of HB = 8 heads). Every head-block of a row streams the
//     row's keys, so the row's latent (under 1 MB) is read from device
//     memory once and from L2 by the other head-blocks.
//   - Keys are staged KT = 32 at a time (each key's page looked up on its
//     own, so any page size works) with 16-byte loads into rows padded by
//     16 bytes, which makes the score stage's row-strided reads free of
//     bank conflicts. Scores: one warp per head, one lane per key, the q
//     row broadcast from shared memory; the online softmax (running max m,
//     denominator l, f32, masked keys at -1e30 as the TPU kernel's) runs
//     in that warp. Numerators are rounded to the cache dtype before the
//     value product, as the plain version does. Values: each thread owns
//     up to 2 latent columns of all 8 heads in registers.
//   - The append race. Every head-block of a row reads position kv_len-1,
//     which A5 itself appends, and blocks of one launch run in no order.
//     So exactly one block per row (head-block 0) writes the cache, and
//     every block takes the row whose slot equals the append slot from the
//     new_rows input instead of the cache. With slot < 0 (padding or a
//     frozen row) nothing is written and the cache is read as it is. A
//     row's append slot is its private tail; no other row reads it.
//   - Rows with kv_len 0 see no key and write exact zeros (o / max(l,
//     1e-30) with o = l = 0).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HB = 8;       // query heads per block: one warp each
constexpr int KT = 32;      // keys per staged tile: one lane each
constexpr int MAXC = 2;     // latent columns per thread: R <= 2 * THREADS
constexpr float kNeg = -1e30f;

struct MlaArgs {
  const void* q_latent;     // [S, Hq, R]
  const void* q_pe;         // [S, Hq, Dr]
  const void* new_rows;     // [S, R + Dr] (A5) or null
  void* cache;              // [P, page, 1, R + Dr]
  void* out;                // [S, Hq, R]
  const int* kv_lens;       // [S]
  const int* page_indices;  // [S, pps]
  const int* slots;         // [S] (A5) or null
  int hq, r, dr, page, pps;
  long long total_slots;
  float sm_scale;
};

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

// The f32 values of one 16-byte chunk (8 bf16 or 4 f32 elements).
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
__global__ void __launch_bounds__(THREADS) mla_decode_kernel(MlaArgs a) {
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte chunk
  const int s = blockIdx.x;
  const int h0 = blockIdx.y * HB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int w = a.r + a.dr;
  const int chunks = w / EPC;
  const int stride = chunks + 1;          // padded row, in 16-byte chunks

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ks = reinterpret_cast<uint4*>(smem);                  // [KT][stride]
  float* qs = reinterpret_cast<float*>(
      smem + pk::align16((size_t)KT * stride * 16));           // [HB][w]
  float* ps = qs + pk::align16((size_t)HB * w * 4) / 4;        // [KT][HB]
  float* alpha_s = ps + pk::align16((size_t)KT * HB * 4) / 4;  // [HB]
  float* l_s = alpha_s + pk::align16(HB * 4) / 4;              // [HB]

  T* cache = reinterpret_cast<T*>(a.cache);
  const T* new_rows = reinterpret_cast<const T*>(a.new_rows);
  const int slot = a.slots != nullptr ? a.slots[s] : -1;
  const bool live = slot >= 0 && slot < a.total_slots;
  if (live && blockIdx.y == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(new_rows + (long long)s * w);
    uint4* dst = reinterpret_cast<uint4*>(cache + (long long)slot * w);
    for (int c = tid; c < chunks; c += THREADS) dst[c] = src[c];
  }

  const T* ql = reinterpret_cast<const T*>(a.q_latent);
  const T* qp = reinterpret_cast<const T*>(a.q_pe);
  for (int i = tid; i < HB * w; i += THREADS) {
    const int hh = i / w;
    const int c = i % w;
    const int h = h0 + hh;
    float v = 0.0f;
    if (h < a.hq) {
      v = c < a.r ? pk::to_f(ql[((long long)s * a.hq + h) * a.r + c])
                  : pk::to_f(qp[((long long)s * a.hq + h) * a.dr + c - a.r]);
    }
    qs[i] = v;
  }

  float acc[HB][MAXC];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int i = 0; i < MAXC; ++i) acc[hh][i] = 0.0f;
  float m = kNeg;   // warp ``warp``'s head: running max and denominator
  float l = 0.0f;

  const int n = a.kv_lens[s];
  const int* pages = a.page_indices + (long long)s * a.pps;
  for (int base = 0; base < n; base += KT) {
    __syncthreads();   // the previous tile's values are consumed
    for (int i = tid; i < KT * chunks; i += THREADS) {
      const int j = i / chunks;
      const int ch = i % chunks;
      const int pos = base + j;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pos < n) {
        const long long phys =
            (long long)pages[pos / a.page] * a.page + pos % a.page;
        const T* src = (live && phys == slot) ? new_rows + (long long)s * w
                                              : cache + phys * w;
        v = reinterpret_cast<const uint4*>(src)[ch];
      }
      ks[j * stride + ch] = v;
    }
    __syncthreads();

    // Scores: warp = head, lane = key.
    const float* qrow = qs + warp * w;
    const uint4* krow = ks + lane * stride;
    float dot = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      float kf[EPC];
      unpack<T>(krow[ch], kf);
#pragma unroll
      for (int e = 0; e < EPC; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + ch * EPC + e);
        dot = fmaf(q4.x, kf[e], dot);
        dot = fmaf(q4.y, kf[e + 1], dot);
        dot = fmaf(q4.z, kf[e + 2], dot);
        dot = fmaf(q4.w, kf[e + 3], dot);
      }
    }
    const bool valid = base + lane < n;
    const float sc = valid ? dot * a.sm_scale : kNeg;
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(sc - m_new) : 0.0f;
    l = l * alpha + warp_sum(p);
    m = m_new;
    ps[lane * HB + warp] = pk::round_to<T>(p);
    if (lane == 0) alpha_s[warp] = alpha;
    __syncthreads();

    // Values: thread = latent column(s), all HB heads in registers.
    float al[HB];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) al[hh] = alpha_s[hh];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) acc[hh][i] *= al[hh];
    }
    const int kn = min(KT, n - base);
    for (int j = 0; j < kn; ++j) {
      const T* vrow = reinterpret_cast<const T*>(ks + j * stride);
      const float4 p0 = *reinterpret_cast<const float4*>(ps + j * HB);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + j * HB + 4);
      const float pj[HB] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = tid + i * THREADS;
        if (c < a.r) {
          const float v = pk::to_f(vrow[c]);
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) acc[hh][i] = fmaf(pj[hh], v, acc[hh][i]);
        }
      }
    }
  }

  if (lane == 0) l_s[warp] = l;
  __syncthreads();
  T* out = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    if (h >= a.hq) continue;
    const float inv = 1.0f / fmaxf(l_s[hh], 1e-30f);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = tid + i * THREADS;
      if (c < a.r) {
        out[((long long)s * a.hq + h) * a.r + c] = pk::from_f<T>(acc[hh][i] * inv);
      }
    }
  }
}

size_t smem_bytes(int w, int elem) {
  return pk::align16((size_t)KT * (w * elem + 16)) +
         pk::align16((size_t)HB * w * 4) + pk::align16((size_t)KT * HB * 4) +
         3 * pk::align16(HB * 4);
}

template <typename T>
int launch(const MlaArgs& a, int s, cudaStream_t st) {
  const size_t smem = smem_bytes(a.r + a.dr, sizeof(T));
  auto kern = mla_decode_kernel<T>;
  const cudaError_t err = pk::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s, (a.hq + HB - 1) / HB);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int run(const MlaArgs& a, int s, int dtype, void* stream) {
  if (s <= 0 || a.hq <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pk::kBF16) return launch<__nv_bfloat16>(a, s, st);
  return launch<float>(a, s, st);
}

}  // namespace

extern "C" int pk_mla_decode(const void* q_latent, const void* q_pe,
                             const void* new_rows, void* cache, void* out,
                             const void* kv_lens, const void* page_indices,
                             const void* slots, int s, int hq, int r, int dr,
                             int page, int pps, long long total_slots,
                             float sm_scale, int dtype, void* stream) {
  const MlaArgs a{q_latent, q_pe, new_rows, cache, out,
                  (const int*)kv_lens, (const int*)page_indices,
                  (const int*)slots, hq, r, dr, page, pps, total_slots,
                  sm_scale};
  return run(a, s, dtype, stream);
}

extern "C" int pk_mla_attend(const void* q_latent, const void* q_pe,
                             void* cache, void* out, const void* kv_lens,
                             const void* page_indices, int s, int hq, int r,
                             int dr, int page, int pps, float sm_scale,
                             int dtype, void* stream) {
  const MlaArgs a{q_latent, q_pe, nullptr, cache, out,
                  (const int*)kv_lens, (const int*)page_indices, nullptr,
                  hq, r, dr, page, pps, 0, sm_scale};
  return run(a, s, dtype, stream);
}
