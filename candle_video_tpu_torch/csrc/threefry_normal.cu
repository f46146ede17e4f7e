// R1: jax.random.normal drawn on the card, one row per key:
//   out[r, i] = normal(bits(key_r, i)),  bits = xor of the two words of
//   threefry2x32(key_r, (i >> 32, i & 0xffffffff)).
//
// Replaces: no TPU kernel.  The JAX package draws its seeded noise with
//   jax.random.normal inside its XLA programs (the decode noise,
//   candle_video_tpu/models/ltx_video/pipeline.py:108; the stochastic step
//   noise, :255; the jax.random latents, :879 and :892; the posterior
//   sample, vae.py:1199; the SVD noise, svd/pipeline.py:70; the server's
//   rows, serving.py:41, one vmap over the seeds).  This kernel is the
//   port's counterpart of all of them; utils/rng.py's NumPy `normal` is the
//   host reference both it and its plain version are held to.
//
// The stream is JAX's with jax_threefry_partitionable on: the counter of
//   value i is the pair (i >> 32, i & 0xffffffff) of its flat index, so a
//   row of any shape is the flat draw reshaped, and the rows of a batch are
//   independent.  float32: a uniform in [nextafter(-1, 0), 1) from the top
//   23 bits, then sqrt(2) * erfinv(u) with XLA's float32 erfinv (M. Giles'
//   polynomials for w = -log1p(-u*u) below and above 5).  bfloat16 is
//   another stream: 7 mantissa bits from the low byte, every step rounded to
//   bfloat16, the erfinv in float32 on the bfloat16 uniform.  Every product
//   and sum of the uniform and the polynomials goes through __fmul_rn /
//   __fadd_rn, so nvcc cannot contract them into FMAs: the host reference
//   and the plain PyTorch version round each one.  log1pf is CUDA's, which
//   may differ from the host's log1p by an ulp; the plain version calls the
//   same function on the card.
//
// What bounds it on this card: integer operations.  A value costs about 80
//   int32 operations (20 rounds of add, rotate and xor, 5 key injections of
//   two adds, the counter split and the final xor and bit extraction) and
//   writes 4 or 2 bytes: 638,976 float32 values (one 2B decode-noise draw)
//   are 51 M operations, 3.1 us at the INT32 rate (64 lanes on each of 132
//   SMs at 1.98 GHz, 16.7 T/s), against 0.76 us to write their 2.6 MB.
//
// What the design does about it: nothing yet beyond one pass.  A grid of
//   (x blocks, rows) threads, grid-stride in x over the row's n values, each
//   thread one value: keys arrive by value in the kernel's parameters (up
//   to MAX_ROWS rows a launch), so a draw needs no copy to the card and no
//   synchronisation with the host; the key schedule is computed per thread
//   and the rotations are constants of the unrolled rounds.  Not yet: two
//   values a thread (threefry's two words are xor-ed, so each value costs a
//   whole block cipher call), vector stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 128;  // keys a launch carries; MAX_ROWS in threefry_normal.py
constexpr int THREADS = 256;

struct Keys {
  uint32_t k[2 * MAX_ROWS];  // (hi, lo) of each row
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds (Salmon et al. 2011), as jax.random's: the two
// output words xor-ed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

// XLA's float32 erfinv, each step rounded (no contraction).
__device__ __forceinline__ float erfinv_f32(float x) {
  const float small[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                          -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                          -0.00417768164f, 0.246640727f, 1.50140941f};
  const float large[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                          -0.00367342844f, 0.00573950773f, -0.0076224613f,
                          0.00943887047f, 1.00167406f, 2.83297682f};
  const float w = -log1pf(__fmul_rn(-x, x));
  const float ws = __fsub_rn(w, 2.5f);
  const float wl = __fsub_rn(__fsqrt_rn(fmaxf(w, 5.0f)), 3.0f);
  float ps = small[0], pl = large[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    ps = __fadd_rn(small[k], __fmul_rn(ps, ws));
    pl = __fadd_rn(large[k], __fmul_rn(pl, wl));
  }
  return __fmul_rn(w < 5.0f ? ps : pl, x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float normal_f32(uint32_t bits) {
  const float lo = __uint_as_float(0xBF7FFFFFu);  // nextafter(-1, 0)
  const float u01 = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(u01, __fsub_rn(1.0f, lo)), lo));
  return __fmul_rn(1.41421354f, erfinv_f32(u));  // float32 sqrt(2)
}

__device__ __forceinline__ float normal_bf16(uint32_t bits) {
  const float lo = -0.99609375f;  // nextafter(-1, 0) in bfloat16
  const uint32_t mant = ((bits & 0xFFu) >> 1) | 0x3F80u;
  const float u01 = __fsub_rn(__uint_as_float(mant << 16), 1.0f);
  const float u = fmaxf(lo, round_bf16(__fadd_rn(round_bf16(__fmul_rn(u01, 2.0f)), lo)));
  return __fmul_rn(1.4140625f, round_bf16(erfinv_f32(u)));  // bfloat16 sqrt(2)
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) threefry_normal_kernel(Keys keys, void* out,
                                                                  long long n) {
  const int r = blockIdx.y;
  const uint32_t k0 = keys.k[2 * r], k1 = keys.k[2 * r + 1];
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const uint32_t bits = threefry_bits(k0, k1, (uint32_t)((unsigned long long)i >> 32),
                                        (uint32_t)i);
    if (BF16) {
      static_cast<__nv_bfloat16*>(out)[r * n + i] = __float2bfloat16_rn(normal_bf16(bits));
    } else {
      static_cast<float*>(out)[r * n + i] = normal_f32(bits);
    }
  }
}

}  // namespace

// keys: host (hi, lo) pairs of `rows` rows (1..MAX_ROWS), copied into the
// launch's parameters; out: [rows, n] float32 (bf16 = 0) or bfloat16
// (bf16 = 1) on the card.
extern "C" int cvt_threefry_normal(const unsigned int* keys, int rows, long long n, int bf16,
                                   void* out, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || n < 1 || out == nullptr || keys == nullptr)
    return (int)cudaErrorInvalidValue;
  Keys k = {};
  for (int i = 0; i < 2 * rows; ++i) k.k[i] = keys[i];
  const long long want = (n + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(want < 65535 ? want : 65535), (unsigned)rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    threefry_normal_kernel<true><<<grid, THREADS, 0, st>>>(k, out, n);
  else
    threefry_normal_kernel<false><<<grid, THREADS, 0, st>>>(k, out, n);
  return (int)cudaGetLastError();
}
