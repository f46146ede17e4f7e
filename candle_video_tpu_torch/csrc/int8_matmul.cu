// Fused W8A8 matmul on int8 wgmma, fed by a TMA ring:
//   y = cast(f32(x_q . w_q) * s_x[m] * s_w[n] [+ bias]).
//
// Replaces: candle_video_tpu/ops/pallas/int8_matmul.py:48, w8a8_matmul
//   (kernel `_kernel`, pallas_call at :75), the TPU kernel that keeps the
//   int32 accumulator on chip and writes only the dequantized output.  Same
//   math: the int8 x int8 product is summed exactly in int32, converted to
//   f32, multiplied by the row scale and then by the column scale (in that
//   order, without contraction), an optional f32 bias added in f32, and the
//   result rounded once to bf16.
//
// What bounds it on this card: operations.  The W8A8 DiT tier runs its block
//   linears at M = 4992 tokens against (K, N) = (2048, 2048), (2048, 8192)
//   and (8192, 2048): 2 * 4992 * 2048 * 2048 = 41.9 GOP for a square linear,
//   0.021 ms at the 1979 TOP/s int8 peak, against 0.017 ms to move its 19.3
//   MB at 3.35 TB/s.  Its cross-attention k/v linears (M = 128 caption
//   tokens, 2048^2) are 1.07 GOP on 4.7 MB: bytes, 0.0015 ms.  The earlier
//   design (warp-level m16n8k32 instructions fed by two cp.async stages)
//   read 14% of the bound at the square shape, and at M = 128 its 16 CTAs
//   left 116 of the 132 SMs idle.
//
// What the design does about it: one CTA owns a BM = 128 by BN output tile
//   (BN = 128 or 256, from the host plan plan_w8a8 in
//   ops/kernels/int8_matmul.py) and walks K in steps of 128 bytes (128 int8,
//   one 128-byte swizzled row).  A producer warp (one thread, 40 registers)
//   fills a ring of STAGES slots by TMA, guarded by full and empty
//   mbarriers: per step one box {128, 128} of x_q [M, K] and one box
//   {128, BN} of w_q [N, K], both K-major, which is the only layout 8-bit
//   wgmma reads; TMA zero-fills the rows past M and N and the K tail, and
//   zeros add nothing to the sum.  Two consumer warpgroups (232 registers)
//   own 64 rows each and run wgmma m64nBNk32 s8.s8 -> s32 from shared
//   memory, four per step (a k32 advances the descriptor by 32 bytes, as a
//   bf16 k16 does), one step's batch kept in flight while the next slot is
//   awaited.  The producer warpgroup's other three warps copy the tile's
//   s_w, bias and s_x into shared memory meanwhile.  The epilogue
//   dequantizes the int32 accumulators in registers from there, stages the
//   bf16 tile in the idle ring and writes it out in whole rows, 16 bytes a
//   thread, predicated at the ragged M and N edges.  Where the
//   output tiles cannot fill the SMs (the M = 128 linears: 16 tiles) the
//   plan splits the K-steps over `split` CTAs per tile: each writes its
//   int32 partial to a workspace and a second small pass sums them and runs
//   the same epilogue.  int32 sums are exact and order-free (|x|, |w| <= 127
//   and K <= 8192 keep |acc| < 2^31), so a split output equals the unsplit
//   one bit for bit.  Not yet: a persistent tile loop (the epilogue does
//   not overlap the next tile's loads), the activation quantizer fused into
//   the A load, a TMA store.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;       // output rows per CTA: two consumers of 64
constexpr int BK = 128;       // K bytes (int8 elements) per step: one swizzled row
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// A CTA tile of BM x BN and a ring of STAGES slots, each one x_q box and one
// w_q box: 32 KB a step at BN = 128 (six slots), 48 KB at BN = 256 (four);
// then the tile's s_w, bias and s_x in f32, and the full, empty and
// epilogue barriers.
template <int BN, int STAGES_>
struct Cfg {
  static constexpr int STAGES = STAGES_;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int VEC_BYTES = (2 * BN + BM) * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + VEC_BYTES + (2 * STAGES + 1) * 8;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

template <int BN>
__device__ __forceinline__ void wgmma_step(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_s8_n128(acc, da, db, 1);
  else
    wgmma_s8_n256(acc, da, db, 1);
}

// the epilogue's arithmetic, the TPU kernel's order: f32(acc) * s_x, then
// * s_w, then + bias, each rounded (no contraction)
__device__ __forceinline__ float dequant(int acc, float rs, float cs, bool has_bias, float b) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
  if (has_bias) v = __fadd_rn(v, b);
  return v;
}

struct Args {
  const float* sx;    // f32 [M]
  const float* sw;    // f32 [N]
  const float* bias;  // f32 [N] or null
  bf16* y;            // [M, N]
  int* ws;            // int32 [split, Mp, Np] partials, or null
  int M, N, steps, split;
  int Mp, Np;  // the workspace's padded rows and columns (whole tiles)
};

template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const Args args) {
  using C = Cfg<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* sws = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE_BYTES);  // s_w[n0..]
  float* bss = sws + BN;                                                     // bias[n0..]
  float* sxs = bss + BN;                                                     // s_x[m0..]
  uint64_t* full = reinterpret_cast<uint64_t*>(sxs + BM);
  uint64_t* empty = full + C::STAGES;
  uint64_t* epi = empty + C::STAGES;  // the three vectors are in place

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  // this CTA's K-steps
  const int s_begin = (int)((int64_t)z * args.steps / args.split);
  const int s_end = (int)((int64_t)(z + 1) * args.steps / args.split);
  const int nsteps = s_end - s_begin;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(epi, 96);  // the producer warpgroup's warps 1-3
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues both boxes of every step; warps 1-3
    // bring the epilogue's scales and bias into shared memory meanwhile, so
    // that no consumer thread waits on L2 for its 128 of them after the
    // mainloop ----
    regs_dealloc<40>();
    if (tid >= 32) {
      for (int i = tid - 32; i < BN; i += 96) {
        const int n = n0 + i;
        sws[i] = n < args.N ? args.sw[n] : 0.f;
        bss[i] = args.bias != nullptr && n < args.N ? args.bias[n] : 0.f;
      }
      for (int i = tid - 32; i < BM; i += 96) sxs[i] = m0 + i < args.M ? args.sx[m0 + i] : 0.f;
      mbar_arrive(epi);
    } else if (tid == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % C::STAGES;
        const int k0 = (s_begin + i) * BK;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        unsigned char* as = smem + s * C::STAGE_BYTES;
        tma_load_2d(as, &xmap, &full[s], k0, m0);
        tma_load_2d(as + C::A_BYTES, &wmap, &full[s], k0, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns tile rows 64c .. 64c + 63 ----
  regs_alloc<232>();
  const int c = wg - 1;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int i = 0; i < nsteps; ++i) {
    const int s = i % C::STAGES;
    mbar_wait(&full[s], (i / C::STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + s * C::STAGE_BYTES) + c * 64 * 128;
    const uint32_t b_addr = smem_u32(smem + s * C::STAGE_BYTES + C::A_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_step<BN>(acc, desc_sw128(a_addr + kk * 32, 16, 1024),
                     desc_sw128(b_addr + kk * 32, 16, 1024));
    wgmma_commit();
    // keep this step's batch in flight; the previous one is done, so its
    // slot goes back to the producer
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: this thread holds rows m0 + 64c + 16*warp + lane/4 + 8i and
  // columns n0 + 8j + 2*(lane%4) + e in acc[4j + 2i + e]
  const int warp = tid / 32, lane = tid % 32;
  if (args.split > 1) {
    // the int32 partial, whole tiles into the padded workspace (no edge)
    int* ws = args.ws + (int64_t)z * args.Mp * args.Np;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 64 * c + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<int2*>(ws + (int64_t)m * args.Np + n0 + 8 * j + 2 * (lane % 4)) =
            make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    return;
  }
  // every accumulator dequantized in place (its f32 bits kept in the same
  // register) from the tile's scales in shared memory, then staged as bf16
  const bool has_bias = args.bias != nullptr;
  mbar_wait(epi, 0);
  float rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rs[i] = sxs[64 * c + 16 * warp + lane / 4 + 8 * i];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 cs = *reinterpret_cast<const float2*>(sws + 8 * j + 2 * (lane % 4));
    const float2 bs = *reinterpret_cast<const float2*>(bss + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] = __float_as_int(dequant(acc[4 * j + 2 * i], rs[i], cs.x, has_bias, bs.x));
      acc[4 * j + 2 * i + 1] =
          __float_as_int(dequant(acc[4 * j + 2 * i + 1], rs[i], cs.y, has_bias, bs.y));
    }
  }
  // The bf16 tile goes out through shared memory (the ring, idle once both
  // consumers are past their last step), so that the stores to y are whole
  // rows, 16 bytes a thread, instead of 16 bytes in each of 8 rows per warp
  // store; a row pitch of BN * 2 + 16 bytes keeps the fragment writes free
  // of bank conflicts
  constexpr int PITCH = BN * 2 + 16;
  named_barrier(1, 256);  // both consumers are done with the ring
  unsigned char* stage = smem + c * 64 * PITCH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * i;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + r * PITCH + (8 * j + 2 * (lane % 4)) * 2) =
          __floats2bfloat162_rn(__int_as_float(acc[4 * j + 2 * i]),
                                __int_as_float(acc[4 * j + 2 * i + 1]));
  }
  named_barrier(2 + c, 128);  // this warpgroup's 64 rows are staged
  const bool whole = args.N % 8 == 0;  // every 16-byte chunk in range and aligned
  for (int idx = tid; idx < 64 * (BN / 8); idx += 128) {
    const int r = idx / (BN / 8), q = idx % (BN / 8);
    const int m = m0 + 64 * c + r, n = n0 + 8 * q;
    if (m >= args.M || n >= args.N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * PITCH + 16 * q);
    bf16* dst = args.y + (int64_t)m * args.N + n;
    if (whole) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int t = 0; t < 8 && n + t < args.N; ++t) dst[t] = e[t];
    }
  }
}

// the split-K pass: the split partials summed in int32 (exact, any order),
// then the epilogue above; four columns a thread
__global__ void w8a8_matmul_splitk_reduce(const Args args) {
  const int n4s = (args.N + 3) / 4;
  const int64_t plane = (int64_t)args.Mp * args.Np;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < (int64_t)args.M * n4s;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / n4s), n = (int)(i % n4s) * 4;
    const int64_t at = (int64_t)m * args.Np + n;  // 16-byte aligned: Np % 128 == 0
    int4 acc = *reinterpret_cast<const int4*>(args.ws + at);
    for (int z = 1; z < args.split; ++z) {
      const int4 p = *reinterpret_cast<const int4*>(args.ws + z * plane + at);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    const float rs = args.sx[m];
    const int a[4] = {acc.x, acc.y, acc.z, acc.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = n + e < args.N ? dequant(a[e], rs, args.sw[n + e], args.bias != nullptr,
                                      args.bias ? args.bias[n + e] : 0.f)
                            : 0.f;
    bf16* yr = args.y + (int64_t)m * args.N;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < args.N) yr[n + e] = __float2bfloat16_rn(v[e]);
  }
}

template <int BN, int STAGES>
cudaError_t launch(const void* xq, const void* wq, const Args& args, int K, int smem_bytes,
                   cudaStream_t st) {
  using C = Cfg<BN, STAGES>;
  if (smem_bytes < C::SMEM) return cudaErrorInvalidValue;
  // x_q as [M, K] and w_q as [N, K], innermost first, 128-byte boxes of K
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)args.M};
  const uint64_t wdims[2] = {(uint64_t)K, (uint64_t)args.N};
  const uint64_t strides[1] = {(uint64_t)K};
  const uint32_t xbox[2] = {BK, BM};
  const uint32_t wbox[2] = {BK, BN};
  CUtensorMap xmap, wmap;
  int err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 2, xdims, strides, xbox);
  if (err == 0) err = make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 2, wdims, strides, wbox);
  if (err != 0) return (cudaError_t)err;
  auto kern = w8a8_matmul_kernel<BN, STAGES>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(args.Np / BN, args.Mp / BM, args.split);
  kern<<<grid, THREADS, smem_bytes, st>>>(xmap, wmap, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || args.split == 1) return e;
  const int64_t work = (int64_t)args.M * ((args.N + 3) / 4);
  const int blocks = (int)((work + 255) / 256 < 132 * 8 ? (work + 255) / 256 : 132 * 8);
  w8a8_matmul_splitk_reduce<<<blocks, 256, 0, st>>>(args);
  return cudaGetLastError();
}

}  // namespace

// x_q int8 [M, K], s_x f32 [M], w_q int8 [N, K] (K contiguous), s_w f32 [N],
// bias f32 [N] or null, y bf16 [M, N].  K is a multiple of 16 (TMA's stride
// rule; the wrapper pads x_q and w_q with zeros).  The plan (plan_w8a8): BN =
// 128 with 6 stages or 256 with 4, smem_bytes, and the K-steps split over
// `split` CTAs per tile (ws: int32 [split, ceil(M/128)*128, ceil(N/BN)*BN]
// when split > 1, else null).  Any other configuration is refused.
extern "C" int cvt_w8a8_matmul(const void* xq, const void* sx, const void* wq, const void* sw,
                               const void* bias, void* ws, void* y, int M, int K, int N, int bn,
                               int stages, int split, int smem_bytes, void* stream) {
  const int steps = (K + BK - 1) / BK;
  if (M < 1 || K < 1 || N < 1 || K % 16 != 0 || split < 1 || split > steps ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args args;
  args.sx = static_cast<const float*>(sx);
  args.sw = static_cast<const float*>(sw);
  args.bias = static_cast<const float*>(bias);
  args.y = static_cast<bf16*>(y);
  args.ws = static_cast<int*>(ws);
  args.M = M, args.N = N, args.steps = steps, args.split = split;
  args.Mp = (M + BM - 1) / BM * BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 128 && stages == 6) {
    args.Np = (N + 127) / 128 * 128;
    return (int)launch<128, 6>(xq, wq, args, K, smem_bytes, st);
  }
  if (bn == 256 && stages == 4) {
    args.Np = (N + 255) / 256 * 256;
    return (int)launch<256, 4>(xq, wq, args, K, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}
