// Weight-only int4 matmul (W4A16) for Hopper: y = x . bf16(s * q + m) [+ bias].
//
// Replaces: candle_video_tpu/ops/pallas/int4_weight_matmul.py, w4_matmul
//   (kernel `_kernel`), the TPU kernel that carries the true-4-bit T5-XXL
//   (GGUF Q4_K form) and the W4 DiT's small-M linears.  Same math: the
//   weight is packed nibbles in the K-half planar layout (byte j of column n
//   holds logical row j in its low nibble and row K/2 + j in its high one),
//   with an affine scale s and min m per (group of qblock logical rows,
//   column), f32 or bf16.  W[k, n] = bf16(f32(q) * f32(s) + f32(m)), rounded
//   once; the product is accumulated in f32, rounded to bf16, then an
//   optional bias is added in bf16.  The multiply and the add are kept apart
//   (__fmul_rn, __fadd_rn, no fused multiply-add), so the dequantized weight
//   is bit for bit that of the plain PyTorch version.
//
// What bounds it on this card: weight bandwidth.  At M = 128 tokens the
//   kernel does 2 * 128 flops per weight, 0.5 byte of nibbles plus 8/32 byte
//   of f32 (s, m) (4/32 in bf16): ~340 flops per byte, at the ~295 flop/byte
//   ridge of bf16 on H100 and far from it once the x tile's L2 reads count.
//   One T5-XXL encode streams 4.63e9 weights * 0.75 B ~ 3.5 GB, a floor of
//   ~1.0 ms at 3.35 TB/s; the 13B DiT's cross-attention k/v ~1.0 GB a step.
//
// What the design does about it: K3's structure (csrc/int8_weight_matmul.cu)
//   over packed rows.  One CTA covers all 128 rows of an M-tile and 64
//   output columns, so at M = 128 every weight byte leaves device memory
//   once and only as a nibble pair.  Each k-step takes 32 packed rows: one
//   [32, 64] byte tile feeds two dequantized bf16 tiles in shared memory
//   (low nibbles against x[:, k0:k0+32], high nibbles against
//   x[:, K/2+k0 : K/2+k0+32]), one 64-deep product on the tensor cores
//   (nvcuda::wmma bf16 16x16x16, f32 accumulation, 8 warps of 32x32).  The
//   raw bytes, scales and mins of step i+1 are loaded into registers before
//   step i's products; the dequant happens at the store to shared memory.
//   K is split across CTAs so that a 128-row matmul still puts several CTAs
//   on every SM; a second small kernel sums the f32 partial tiles in a fixed
//   order, rounds to bf16 and adds the bias.  Not yet: cp.async/TMA rings,
//   wgmma, one scale load per group instead of per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 64;
constexpr int BKP = 32;              // packed rows per k-step
constexpr int BK = 2 * BKP;          // logical rows per k-step: BKP low + BKP high
constexpr int THREADS = 256;         // 8 warps: 4 (rows) x 2 (columns)
constexpr int XLD = BK + 8;          // bf16 pitch of the x tile
constexpr int WLD = BN + 8;          // bf16 pitch of the dequantized tile
constexpr int CLD = BN + 4;          // f32 pitch of the epilogue tile
constexpr int X_BYTES = BM * XLD * 2;
constexpr int W_BYTES = BK * WLD * 2;
constexpr int C_BYTES = BM * CLD * 4;
constexpr int SMEM = (X_BYTES + W_BYTES) > C_BYTES ? (X_BYTES + W_BYTES) : C_BYTES;
constexpr int X_VECS = BM * BK / 8 / THREADS;  // 16-byte x vectors per thread per step

// 8 consecutive scale (or min) values of one row, as raw bits: two 16-byte
// vectors for f32, one for bf16.
template <typename ST>
struct Raw8 {
  static constexpr int V = sizeof(ST) / 2;
  uint4 v[V];
};

template <typename ST>
__device__ __forceinline__ float value(const Raw8<ST>& r, int t);

template <>
__device__ __forceinline__ float value<float>(const Raw8<float>& r, int t) {
  return __uint_as_float(reinterpret_cast<const uint32_t*>(r.v)[t]);
}

template <>
__device__ __forceinline__ float value<__nv_bfloat16>(const Raw8<__nv_bfloat16>& r, int t) {
  const uint32_t word = reinterpret_cast<const uint32_t*>(r.v)[t / 2];
  return __uint_as_float((t & 1) ? (word & 0xFFFF0000u) : (word << 16));
}

template <typename ST>
__device__ __forceinline__ void load_raw8(Raw8<ST>& r, const ST* __restrict__ p, bool valid) {
#pragma unroll
  for (int i = 0; i < Raw8<ST>::V; ++i)
    r.v[i] = valid ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0);
}

// One k-step's global data for this thread, held in registers so the loads
// of step i+1 are in flight while step i runs on the tensor cores.
template <typename ST>
struct Stage {
  uint4 x[X_VECS];  // 8 bf16 each of the [BM, BK] x tile
  uint2 w;          // 8 packed bytes: one packed row, 8 columns
  Raw8<ST> s[2];    // scales of that row's low and high group
  Raw8<ST> m[2];    // mins of the same groups
};

// x tile column c < BKP reads x[:, k0 + c] (low rows), c >= BKP reads
// x[:, K/2 + k0 + c - BKP] (high rows).
template <typename ST>
__device__ __forceinline__ void load_stage(Stage<ST>& st, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ wp,
                                           const ST* __restrict__ sc, const ST* __restrict__ mn,
                                           int m0, int n0, int k0, int kend, int M, int K,
                                           int N, int qblock) {
  const int kh = K / 2;
#pragma unroll
  for (int j = 0; j < X_VECS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int kp = k0 + (c % BKP);  // packed row of the vector's first column
    const int col = (c < BKP ? 0 : kh) + kp;
    st.x[j] = make_uint4(0, 0, 0, 0);
    if (m0 + r < M && kp < kend)  // kend % 8 == 0: a vector is all in or out
      st.x[j] = *reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * K + col);
  }
  const int r = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 8;
  const int kp = k0 + r, n = n0 + c;
  const bool valid = kp < kend && n < N;  // N % 8 == 0: all 8 columns in or out
  st.w = valid ? *reinterpret_cast<const uint2*>(wp + (int64_t)kp * N + n) : make_uint2(0, 0);
  const int g_lo = kp / qblock, g_hi = (kh + kp) / qblock;
  load_raw8<ST>(st.s[0], sc + (int64_t)g_lo * N + n, valid);
  load_raw8<ST>(st.m[0], mn + (int64_t)g_lo * N + n, valid);
  load_raw8<ST>(st.s[1], sc + (int64_t)g_hi * N + n, valid);
  load_raw8<ST>(st.m[1], mn + (int64_t)g_hi * N + n, valid);
}

// Writes the x tile, and the dequantized low rows to Ws[0 : BKP) and high
// rows to Ws[BKP : BK).  Invalid rows and columns carry zero bytes, scales
// and mins, so they dequantize to 0.
template <typename ST>
__device__ __forceinline__ void store_stage(const Stage<ST>& st, __nv_bfloat16* Xs,
                                            __nv_bfloat16* Ws) {
#pragma unroll
  for (int j = 0; j < X_VECS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    *reinterpret_cast<uint4*>(Xs + (i / (BK / 8)) * XLD + (i % (BK / 8)) * 8) = st.x[j];
  }
  const int r = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Ws + (half * BKP + r) * WLD + c);
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      float w[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t word = (t + u) < 4 ? st.w.x : st.w.y;
        const uint32_t byte = (word >> (8 * ((t + u) % 4))) & 0xFFu;
        const float q = (float)(half ? (byte >> 4) : (byte & 0xFu));
        w[u] = __fadd_rn(__fmul_rn(q, value<ST>(st.s[half], t + u)),
                         value<ST>(st.m[half], t + u));
      }
      dst[t / 2] = __floats2bfloat162_rn(w[0], w[1]);
    }
  }
}

// Partial product of one (M-tile, N-tile, K-split) into ws[split, M, N] (f32).
template <typename ST>
__global__ void __launch_bounds__(THREADS)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                 const ST* __restrict__ sc, const ST* __restrict__ mn, float* __restrict__ ws,
                 int M, int K, int N, int qblock, int kp_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k-loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kp_per_split;
  const int kend = min(K / 2, kbeg + kp_per_split);
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage<ST> st;
  load_stage<ST>(st, x, wp, sc, mn, m0, n0, kbeg, kend, M, K, N, qblock);
  for (int k0 = kbeg; k0 < kend; k0 += BKP) {
    store_stage<ST>(st, Xs, Ws);
    __syncthreads();
    if (k0 + BKP < kend)
      load_stage<ST>(st, x, wp, sc, mn, m0, n0, k0 + BKP, kend, M, K, N, qblock);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Xs + (wr * 32 + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + kk * WLD + wc * 32 + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * CLD + wc * 32 + j * 16, acc[i][j],
                              CLD, wmma::mem_row_major);
  __syncthreads();

  float* dst = ws + (int64_t)blockIdx.z * M * N;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) dst[(int64_t)m * N + n] = Cs[r * CLD + c];
  }
}

// y = bf16(sum of the splits, in split order) [+ bias, in bf16].
__global__ void w4_finalize_kernel(const float* __restrict__ ws,
                                   const __nv_bfloat16* __restrict__ bias,
                                   __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const int64_t total = (int64_t)M * N;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += ws[s * total + i];
    __nv_bfloat16 out = __float2bfloat16(acc);
    if (bias) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(bias[i % N]));
    y[i] = out;
  }
}

}  // namespace

// x bf16 [M, K]; wp uint8 [K/2, N]; s, m [K/qblock, N] in f32 (scale_bf16 = 0)
// or bf16 (1); ws: f32 workspace of splits * M * N; kp_per_split (packed
// rows) a multiple of 32 with splits * kp_per_split >= K/2.
extern "C" int cvt_w4_matmul(const void* x, const void* wp, const void* s, const void* m,
                             const void* bias, void* ws, void* y, int M, int K, int N,
                             int qblock, int scale_bf16, int splits, int kp_per_split,
                             void* stream) {
  if (K % 16 != 0 || N % 8 != 0 || qblock <= 0 || K % (2 * qblock) != 0 ||
      kp_per_split % BKP != 0 || splits < 1 || (int64_t)splits * kp_per_split < K / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(wp);
  float* wsf = static_cast<float*>(ws);
  if (scale_bf16)
    w4_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        xb, wb, static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(m),
        wsf, M, K, N, qblock, kp_per_split);
  else
    w4_matmul_kernel<float><<<grid, THREADS, 0, st>>>(
        xb, wb, static_cast<const float*>(s), static_cast<const float*>(m), wsf, M, K, N,
        qblock, kp_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w4_finalize_kernel<<<blocks, 256, 0, st>>>(wsf, static_cast<const __nv_bfloat16*>(bias),
                                             static_cast<__nv_bfloat16*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
