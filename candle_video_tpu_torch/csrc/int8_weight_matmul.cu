// Weight-only int8 matmul (W8A16) for Hopper: y = x . bf16(q * s) [+ bias].
//
// Replaces: candle_video_tpu/ops/pallas/int8_weight_matmul.py, w8_matmul
//   (kernel `_kernel`), the TPU kernel that carries every T5-XXL linear with
//   its weights resident as int8.  Same math: W[k, n] = bf16(f32(q[k, n]) *
//   s[k / qblock, n]) with qblock in {16, 32, 128}, the product accumulated
//   in f32, rounded to bf16, then an optional bias added in bf16.
//
// What bounds it on this card: weight bandwidth.  The T5 encode runs at
//   M = 128 tokens against (K, N) up to (4096, 10240), about 2 * 128 = 256
//   flops per weight byte, below the ~295 flop/byte ridge of bf16 on H100;
//   one T5-XXL encode streams about 4.6 GB of int8 (24 * (4 * 4096^2 +
//   3 * 4096 * 10240) bytes), a floor of about 1.4 ms at 3.35 TB/s.
//
// What the design does about it: one CTA covers all 128 rows of an M-tile
//   and 64 output columns, so at M = 128 every weight byte leaves device
//   memory once and only as int8.  A k-loop of 32-deep steps dequantizes
//   the int8 tile (and its scale row) into bf16 shared memory and runs the
//   product on the tensor cores (nvcuda::wmma bf16 16x16x16, f32
//   accumulation); 8 warps each own a 32x32 block of the 128x64 tile.  The
//   next step's loads are issued into registers before the current step's
//   products, and K is split across CTAs (split-K) so that a 128-row matmul
//   still puts several CTAs on every SM; the f32 partial tiles are summed in
//   a fixed order by a second small kernel, which also rounds to bf16 and
//   adds the bias.  Not yet: cp.async/TMA rings, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int THREADS = 256;         // 8 warps: 4 (rows) x 2 (columns)
constexpr int XLD = BK + 8;          // bf16 pitch of the x tile
constexpr int WLD = BN + 8;          // bf16 pitch of the dequantized tile
constexpr int CLD = BN + 4;          // f32 pitch of the epilogue tile
constexpr int X_BYTES = BM * XLD * 2;
constexpr int W_BYTES = BK * WLD * 2;
constexpr int C_BYTES = BM * CLD * 4;
constexpr int SMEM = (X_BYTES + W_BYTES) > C_BYTES ? (X_BYTES + W_BYTES) : C_BYTES;

// One k-step's global data for this thread, held in registers so the loads
// of step i+1 are in flight while step i runs on the tensor cores.
struct Stage {
  uint4 x[2];  // 2 x 8 bf16 of the [BM, BK] x tile
  float w[8];  // 8 dequantized weights of one row of the [BK, BN] tile
};

__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ wq,
                                           const float* __restrict__ sc, int m0, int n0,
                                           int k0, int kend, int M, int K, int N,
                                           int qblock, bool nvec) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    st.x[j] = make_uint4(0, 0, 0, 0);
    if (m0 + r < M && k0 + c < kend)  // K % 8 == 0: a vector is all in or out
      st.x[j] = *reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * K + k0 + c);
  }
  const int r = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 8;
  const int kk = k0 + r, n = n0 + c;
#pragma unroll
  for (int t = 0; t < 8; ++t) st.w[t] = 0.f;
  if (kk < kend && n < N) {
    const int8_t* src = wq + (int64_t)kk * N + n;
    const float* srow = sc + (int64_t)(kk / qblock) * N + n;
    if (nvec) {  // N % 8 == 0: 8 int8 and 8 scales as vectors
      const int2 raw = *reinterpret_cast<const int2*>(src);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
      const float4 s0 = reinterpret_cast<const float4*>(srow)[0];
      const float4 s1 = reinterpret_cast<const float4*>(srow)[1];
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) st.w[t] = (float)b8[t] * sv[t];
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (n + t < N) st.w[t] = (float)src[t] * srow[t];
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* Xs,
                                            __nv_bfloat16* Ws) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * THREADS;
    *reinterpret_cast<uint4*>(Xs + (i / (BK / 8)) * XLD + (i % (BK / 8)) * 8) = st.x[j];
  }
  const int r = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 8;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Ws + r * WLD + c);
#pragma unroll
  for (int t = 0; t < 4; ++t) dst[t] = __floats2bfloat162_rn(st.w[2 * t], st.w[2 * t + 1]);
}

// Partial product of one (M-tile, N-tile, K-split) into ws[split, M, N] (f32).
__global__ void __launch_bounds__(THREADS)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sc, float* __restrict__ ws, int M, int K, int N,
                 int qblock, int k_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k-loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const bool nvec = (N % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  load_stage(st, x, wq, sc, m0, n0, kbeg, kend, M, K, N, qblock, nvec);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    store_stage(st, Xs, Ws);
    __syncthreads();
    if (k0 + BK < kend)
      load_stage(st, x, wq, sc, m0, n0, k0 + BK, kend, M, K, N, qblock, nvec);
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
__global__ void w8_finalize_kernel(const float* __restrict__ ws,
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

// ws: f32 workspace of splits * M * N; k_per_split a multiple of 32 with
// splits * k_per_split >= K.
extern "C" int cvt_w8_matmul(const void* x, const void* wq, const void* sc, const void* bias,
                             void* ws, void* y, int M, int K, int N, int qblock, int splits,
                             int k_per_split, void* stream) {
  if (K % 8 != 0 || qblock <= 0 || K % qblock != 0 || k_per_split % BK != 0 ||
      splits < 1 || (int64_t)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  w8_matmul_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sc), static_cast<float*>(ws), M, K, N, qblock, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w8_finalize_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                             static_cast<const __nv_bfloat16*>(bias),
                                             static_cast<__nv_bfloat16*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
