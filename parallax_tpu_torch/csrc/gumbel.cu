// gumbel_rows: per-row gumbel noise indexed by token id, f32[S, V], made on
// the device from tensors. A port-only kernel: the TPU side has no Pallas
// kernel here.
//
// Replaces: parallax_tpu/ops/sampling.py::row_gumbel, which draws the
//   noise with XLA's threefry inside the jitted decode scan. The port needs
//   the same noise inside a replayed CUDA graph, where each row's output
//   step advances on the device, so the noise is a function of tensors:
//   - row r's 64-bit key is mix_seed(seeds[r], steps[r]) for a seeded row
//     (seeds[r] >= 0) and mix_seed(mix_seed(base_seed, steps[r]), r) for an
//     unseeded one (ops/sampling.py::mix_seed, the splitmix64 finalizer,
//     computed here);
//   - token t's 32 random bits are word t % 4 of Philox4x32-10 at counter
//     (t / 4, 0, 0, 0) under the key's low and high words;
//   - u = (bits >> 8) * 2^-24 floored at f32's tiny, noise = -log(-log(u)).
// The plain twin (ops/sampling.py::gumbel_rows_plain) does the same
// arithmetic in int64 torch ops and gives the same bits.
// Bound on the H100: bytes. It writes S * V * 4 bytes and reads 16 bytes a
// row: 4.9 MB, 1.45 us, at S 8 and Qwen2.5's V 152,064. Philox's 10 rounds
// are 20 32-bit multiplies a group of 4 tokens, far under the store time.
// Design: one thread a group of 4 tokens, one 16-byte store of 4 floats
// when V is a multiple of 4 (the row then starts 16-byte aligned), scalar
// stores otherwise. ``bits``, when not null, also receives the 32-bit words
// (the card's check against the twin).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long mix_seed(unsigned long long a,
                                                       unsigned long long b) {
  unsigned long long z = a * 0x9E3779B97F4A7C15ull + b + 0x632BE59BD9B4E019ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFFull;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float gumbel_of(unsigned bits) {
  const float tiny = 1.17549435e-38f;
  const float u = fmaxf((float)(bits >> 8) * 5.9604644775390625e-08f, tiny);
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(kThreads)
    gumbel_rows_kernel(const long long* __restrict__ seeds,
                       const long long* __restrict__ steps,
                       float* __restrict__ out, unsigned* __restrict__ bits,
                       unsigned long long base_seed, int v) {
  const int row = blockIdx.y;
  const int group = blockIdx.x * kThreads + threadIdx.x;
  const int t0 = group * 4;
  if (t0 >= v) return;
  const long long seed = seeds[row];
  const unsigned long long step = (unsigned long long)steps[row];
  const unsigned long long key =
      seed >= 0 ? mix_seed((unsigned long long)seed, step)
                : mix_seed(mix_seed(base_seed, step), (unsigned long long)row);
  const uint4 w = philox4x32_10(make_uint4((unsigned)group, 0u, 0u, 0u),
                                make_uint2((unsigned)key,
                                           (unsigned)(key >> 32)));
  const long long base = (long long)row * v + t0;
  if ((v & 3) == 0) {
    reinterpret_cast<float4*>(out + base)[0] =
        make_float4(gumbel_of(w.x), gumbel_of(w.y), gumbel_of(w.z),
                    gumbel_of(w.w));
    if (bits) reinterpret_cast<uint4*>(bits + base)[0] = w;
    return;
  }
  const unsigned word[4] = {w.x, w.y, w.z, w.w};
  const int n = min(4, v - t0);
  for (int i = 0; i < n; ++i) {
    out[base + i] = gumbel_of(word[i]);
    if (bits) bits[base + i] = word[i];
  }
}

}  // namespace

extern "C" int pk_gumbel_rows(const void* seeds, const void* steps, void* out,
                              void* bits, long long base_seed, int s, int v,
                              void* stream) {
  if (s <= 0 || v <= 0) return 0;
  const int groups = (v + 3) / 4;
  const dim3 grid((groups + kThreads - 1) / kThreads, s);
  gumbel_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)seeds, (const long long*)steps, (float*)out,
      (unsigned*)bits, (unsigned long long)base_seed, v);
  return (int)cudaGetLastError();
}
