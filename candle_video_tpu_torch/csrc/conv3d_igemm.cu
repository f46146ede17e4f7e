// Implicit-GEMM 3x3x3 stride-1 conv on wgmma, fed by a TMA ring, channels last:
//   y[b, t, h, w, o] = cast(bias[o] + sum over (dt, dh, dw, c) of
//                      x[b, T(t, dt), h + dh - 1, w + dw - 1, c] * w[dt, dh, dw, o, c])
// with replicate padding in time (T clamps the frame index) and zero
// padding in space.
//
// Replaces: candle_video_tpu/ops/pallas/conv3d_igemm.py:98, conv3d_igemm_cl
//   (kernel `_kernel`, pallas_call at :150), the TPU kernel written for the
//   VAE decoder's 3x3x3 convs: 27 tap products accumulated in f32 over a
//   halo tile of the channels-last input, the f32 bias fused, the output in
//   the input dtype.
//
// What bounds it on this card: operations.  The decoder's tail conv
//   (C = O = 128 at 97 x 128 x 192) is 2 * 2.38M * 128 * 3456 = 2.11 TFLOP,
//   2.13 ms at the 989 TFLOP/s bf16 peak, against 0.14 ms to move its 1.2
//   GB once at 3.35 TB/s; the 44 eligible convs of a dense 97-frame decode
//   are 47.6 TFLOP, 48.1 ms.  The earlier mma.sync design read 12-22% of
//   that: mma.sync with 32-bit fragment loads, 32-channel steps in two
//   cp.async stages, and 1.2 waves of CTAs at the mid block.
//
// What the design does about it: the GEMM is M = output positions by N = O
//   by K = 27 * C, walked in 64-channel steps (tap-major).  One CTA owns an
//   M tile that is a bh x bw rectangle of one output frame (b, t): 256
//   positions by BN = 128 output channels, or 128 by BN = 256, so that each
//   step brings 48 KB for 2M multiply-adds.  The rectangle, BN and a split of
//   the K-steps over CTAs come from the host plan (plan_conv3d in
//   ops/kernels/conv3d_igemm.py), per shape.  A producer warp (one thread,
//   40 registers) fills a ring of STAGES slots by TMA, guarded by full and
//   empty mbarriers: per step one box {64, bw, bh, 1} of x viewed as
//   [B*T, H, W, C] at channel c0, column w0 + dw - 1, row h0 + dh - 1 and
//   frame b*T + T(t, dt) (the clamp is the producer's scalar), and one box
//   {64, BN} of the packed weight viewed as [27*O, C].  TMA zero-fills the
//   out-of-frame rows and columns, negative coordinates included: that is
//   the zero padding in space, so there is no padded copy of the input, and
//   "valid" (the streamed decode) is the clamp left out.  Both boxes land
//   128-byte-swizzled, the layout wgmma reads.  Two consumer warpgroups (232
//   registers, 128 f32 accumulators each) own half the tile's rows and run
//   wgmma m64nBNk16 from shared memory (two m64 blocks each at BN = 128),
//   one step's batch kept in flight while the next step's slot is awaited.
//   Epilogue as before: + f32 bias (__fadd_rn), one rounding to bf16, stored
//   channels last; or, when the plan splits the K-steps, the f32 partials go
//   to a workspace and a second small pass adds them in split order, adds
//   the bias and rounds once.  Not yet: a persistent tile scheduler, reuse
//   of the input box across the three dw taps, a TMA store.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BKC = 64;       // channels per K-step (one 128-byte row)
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// time modes: how an output frame's tap dt maps to an input frame
enum { CAUSAL = 0, SAME = 1, VALID = 2 };

// A CTA tile of BM positions x BN channels: BM = 256 at BN = 128 and BM =
// 128 at BN = 256, so that every step brings 48 KB for 2M multiply-adds and
// each consumer keeps 128 f32 accumulators (MW m64 blocks of BN / 2).
template <int BN>
struct Cfg {
  static constexpr int BM = BN == 128 ? 256 : 128;
  static constexpr int MW = BM / 128;  // m64 blocks per consumer warpgroup
  static constexpr int A_BYTES = BM * BKC * 2;
  static constexpr int B_BYTES = BN * BKC * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// The input frame that output frame t reads for tap dt (0..2).
__device__ __forceinline__ int tap_frame(int t, int dt, int T, int mode) {
  if (mode == VALID) return t + dt;
  const int p = t + dt - (mode == CAUSAL ? 2 : 1);
  return p < 0 ? 0 : (p >= T ? T - 1 : p);
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_ss_n128(acc, da, db, 1);
  else
    wgmma_ss_n256(acc, da, db, 1);
}

struct Args {
  const float* bias;  // f32 [O] or null
  bf16* y;            // [B, T_out, H, W, O]
  float* ws;          // [split, B*T_out*H*W, O] f32 partials, or null
  int T, H, W, C, O, T_out, mode;
  int bh, bw, tiles_h, tiles_w;
  int steps, split;  // K-steps in all (27 * C / 64), CTAs along K
  int64_t positions;  // B * T_out * H * W
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_igemm_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const Args args) {
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::STAGES * Cf::STAGE_BYTES);
  uint64_t* empty = full + Cf::STAGES;

  // this CTA's output tile: frame (b, t), rectangle (th, tw), channels n0..
  int mt = blockIdx.x;
  const int tw = mt % args.tiles_w;
  mt /= args.tiles_w;
  const int th = mt % args.tiles_h;
  mt /= args.tiles_h;
  const int t = mt % args.T_out, b = mt / args.T_out;
  const int h0 = th * args.bh, w0 = tw * args.bw, n0 = blockIdx.y * BN;
  // this CTA's K-steps
  const int z = blockIdx.z;
  const int s_begin = (int)((int64_t)z * args.steps / args.split);
  const int s_end = (int)((int64_t)(z + 1) * args.steps / args.split);
  const int nsteps = s_end - s_begin;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues both boxes of every step ----
    regs_dealloc<40>();
    if (tid == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      const int cblocks = args.C / BKC;
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % Cf::STAGES;
        const int step = s_begin + i;
        const int tap = step / cblocks, c0 = (step % cblocks) * BKC;
        const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
        const int frame = b * args.T + tap_frame(t, dt, args.T, args.mode);
        mbar_wait(&empty[s], ((i / Cf::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], Cf::STAGE_BYTES);
        unsigned char* as = smem + s * Cf::STAGE_BYTES;
        // the box's column coordinate carries the dw shift, its row the dh one
        tma_load_4d(as, &xmap, &full[s], c0, w0 + dw - 1, h0 + dh - 1, frame);
        tma_load_2d(as + Cf::A_BYTES, &wmap, &full[s], c0, tap * args.O + n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns tile rows MW*64*c .. + MW*64 - 1 ----
  regs_alloc<232>();
  const int c = wg - 1;
  float acc[Cf::MW][BN / 2];
#pragma unroll
  for (int mw = 0; mw < Cf::MW; ++mw)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    const int s = i % Cf::STAGES;
    mbar_wait(&full[s], (i / Cf::STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + s * Cf::STAGE_BYTES) + c * Cf::MW * 64 * 128;
    const uint32_t b_addr = smem_u32(smem + s * Cf::STAGE_BYTES + Cf::A_BYTES);
#pragma unroll
    for (int mw = 0; mw < Cf::MW; ++mw) fence_regs(acc[mw]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
#pragma unroll
      for (int mw = 0; mw < Cf::MW; ++mw)
        wgmma_step<BN>(acc[mw], desc_sw128(a_addr + mw * 64 * 128 + kk * 32, 16, 1024),
                       desc_sw128(b_addr + kk * 32, 16, 1024));
    wgmma_commit();
    // keep this step's batch in flight; the previous one is done, so its
    // slot goes back to the producer
    wgmma_wait<1>();
#pragma unroll
    for (int mw = 0; mw < Cf::MW; ++mw) fence_regs(acc[mw]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % Cf::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mw = 0; mw < Cf::MW; ++mw) fence_regs(acc[mw]);

  // epilogue: this thread holds tile rows MW*64*c + 64*mw + 16*warp +
  // lane/4 + 8i and channels n0 + 8j + 2*(lane%4) + e in acc[mw][4j + 2i +
  // e]; rows of the rectangle past the frame's edge are not stored
  const int warp = tid / 32, lane = tid % 32;
  float* ws = args.split > 1 ? args.ws + (int64_t)z * args.positions * args.O : nullptr;
#pragma unroll
  for (int r = 0; r < 2 * Cf::MW; ++r) {
    const int mw = r / 2, i = r % 2;
    const int m = Cf::MW * 64 * c + 64 * mw + 16 * warp + lane / 4 + 8 * i;
    const int h = h0 + m / args.bw, w = w0 + m % args.bw;
    if (h >= args.H || w >= args.W) continue;
    const int64_t pos = (((int64_t)b * args.T_out + t) * args.H + h) * args.W + w;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      float v0 = acc[mw][4 * j + 2 * i], v1 = acc[mw][4 * j + 2 * i + 1];
      if (ws) {
        *reinterpret_cast<float2*>(ws + pos * args.O + n) = make_float2(v0, v1);
        continue;
      }
      if (args.bias) {
        v0 = __fadd_rn(v0, args.bias[n]);
        v1 = __fadd_rn(v1, args.bias[n + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(args.y + pos * args.O + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// the split-K pass: y = bf16(sum over splits in order + bias), 4 channels a
// thread
__global__ void conv3d_splitk_reduce(const float* __restrict__ ws,
                                     const float* __restrict__ bias, bf16* __restrict__ y,
                                     int64_t n4, int O, int split) {
  const int64_t plane = n4 * 4;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(ws)[i];
    for (int z = 1; z < split; ++z) {
      const float4 p = reinterpret_cast<const float4*>(ws + z * plane)[i];
      acc.x = __fadd_rn(acc.x, p.x);
      acc.y = __fadd_rn(acc.y, p.y);
      acc.z = __fadd_rn(acc.z, p.z);
      acc.w = __fadd_rn(acc.w, p.w);
    }
    if (bias) {
      const int n = (int)((i * 4) % O);
      acc.x = __fadd_rn(acc.x, bias[n]);
      acc.y = __fadd_rn(acc.y, bias[n + 1]);
      acc.z = __fadd_rn(acc.z, bias[n + 2]);
      acc.w = __fadd_rn(acc.w, bias[n + 3]);
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + i * 4);
    out[0] = __floats2bfloat162_rn(acc.x, acc.y);
    out[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const Args& args, int B, cudaStream_t st) {
  // x as [B*T, H, W, C] and the packed weight as [27*O, C], innermost first
  const uint64_t xdims[4] = {(uint64_t)args.C, (uint64_t)args.W, (uint64_t)args.H,
                             (uint64_t)B * args.T};
  const uint64_t xstrides[3] = {(uint64_t)args.C * 2, (uint64_t)args.W * args.C * 2,
                                (uint64_t)args.H * args.W * args.C * 2};
  const uint32_t xbox[4] = {BKC, (uint32_t)args.bw, (uint32_t)args.bh, 1};
  const uint64_t wdims[2] = {(uint64_t)args.C, (uint64_t)27 * args.O};
  const uint64_t wstrides[1] = {(uint64_t)args.C * 2};
  const uint32_t wbox[2] = {BKC, BN};
  CUtensorMap xmap, wmap;
  int err = make_map_bf16(&xmap, x, 4, xdims, xstrides, xbox);
  if (err == 0) err = make_map_bf16(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != 0) return (cudaError_t)err;
  auto kern = conv3d_igemm_kernel<BN>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t m_tiles = (int64_t)B * args.T_out * args.tiles_h * args.tiles_w;
  dim3 grid((unsigned)m_tiles, args.O / BN, args.split);
  kern<<<grid, THREADS, Cfg<BN>::SMEM, st>>>(xmap, wmap, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || args.split == 1) return e;
  const int64_t n4 = args.positions * args.O / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  conv3d_splitk_reduce<<<blocks, 256, 0, st>>>(args.ws, args.bias, args.y, n4, args.O,
                                               args.split);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [B, T, H, W, C] (channels last), w bf16 [27, O, C] (taps dt-major,
// C contiguous), bias f32 [O] or null, y bf16 [B, T_out, H, W, O]; mode 0
// causal (T_out = T), 1 same (T_out = T), 2 valid (T_out = T - 2).  The
// plan: BN = 128 or 256 output channels per CTA and a bh x bw rectangle of
// Cfg<BN>::BM (256 or 128) positions,
// the K-steps split over `split` CTAs (ws: f32 [split, B*T_out*H*W, O] when
// split > 1, else null).
extern "C" int cvt_conv3d_igemm(const void* x, const void* w, const void* bias, void* y,
                                void* ws, int B, int T, int H, int W, int C, int O, int mode,
                                int bh, int bw, int bn, int split, void* stream) {
  const int T_out = mode == VALID ? T - 2 : T;
  const int steps = 27 * (C / BKC);
  if (B < 1 || T_out < 1 || H < 1 || W < 1 || C % BKC != 0 || C < BKC || mode < CAUSAL ||
      mode > VALID || bh < 1 || bw < 1 || bh > 256 || bw > 256 ||
      (bn != 128 && bn != 256) || bh * bw != (bn == 128 ? Cfg<128>::BM : Cfg<256>::BM) ||
      O % bn != 0 || split < 1 || split > steps ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args args;
  args.bias = static_cast<const float*>(bias);
  args.y = static_cast<bf16*>(y);
  args.ws = static_cast<float*>(ws);
  args.T = T, args.H = H, args.W = W, args.C = C, args.O = O, args.T_out = T_out;
  args.mode = mode, args.bh = bh, args.bw = bw;
  args.tiles_h = (H + bh - 1) / bh, args.tiles_w = (W + bw - 1) / bw;
  args.steps = steps, args.split = split;
  args.positions = (int64_t)B * T_out * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bn == 128 ? launch<128>(x, w, args, B, st) : launch<256>(x, w, args, B, st));
}
