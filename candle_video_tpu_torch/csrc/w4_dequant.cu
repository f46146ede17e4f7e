// W4 transient dequant: packed nibbles [K/2, N] (K-half planar) with an
// affine scale s and min m per (group of qblock logical rows, column) ->
// the bf16 weight [K, N], in one pass:
//   bf16 order: W = bf16(bf16(q * bf16(s)) + bf16(m)),
//   f32 order:  W = bf16(f32(f32(q) * f32(s)) + f32(m)).
//
// Replaces: no TPU kernel.  The JAX package's w4_matmul_xla
//   (candle_video_tpu/ops/pallas/int4_weight_matmul.py) leaves this dequant
//   to XLA, which fuses it into the matmul's operand.  The port's plain
//   version, int4_weight_matmul.dequantize, runs it as six full-size torch
//   kernels (& 0xF, >> 4, cat, the cast, a broadcast * and a broadcast +),
//   about 15.5 bytes of traffic a weight.  It exists for the transient route
//   (w4_matmul_xla_equivalent): every 13B W4 DiT block linear at M >= 1024
//   rows (attn1 q/k/v/out, attn2 q/out, the two FF linears: 384 a step),
//   and the qblocks K4 is not built for.  cuBLAS then runs on its output.
//   Both orders are bit for bit the plain version's: each product and sum
//   goes through __fmul_rn / __fadd_rn, so nvcc cannot contract q * s + m
//   into one FMA (which would drop the f32 order's rounding of the
//   product), and the bf16 order rounds the product to bf16 before the add,
//   as torch's bf16 * and + each round their float result.
//
// What bounds it on this card: bytes.  A weight needs half a byte of codes
//   in and two bytes out, plus s and m once per qblock rows: 2.625 B a
//   weight with bf16 s and m at qblock 32.  A 13B step dequantizes 48 x (6 x
//   4096^2 + 2 x 4096 x 16384) = 11.3 G weights, 29.6 GB: 8.8 ms at 3.35
//   TB/s, against 111 ms for the six torch kernels (H100 80GB HBM3, 700 W).
//
// What the design does about it: one read of each code and one write of
//   each weight.  A thread's item is 8 consecutive columns of 4 consecutive
//   packed rows: one 8-byte load of codes a row, all four issued before the
//   first is used, and two 16-byte bf16 stores a row, logical rows j (low
//   nibbles) and K/2 + j (high nibbles).  The scale and min of groups
//   j / qblock and (K/2 + j) / qblock are 16- or 32-byte loads made once for
//   the item's rows (again only where a row starts a group), so the
//   qblock rows that share them read them from L2 a quarter as often as a
//   row a thread would.  Neighbouring threads take neighbouring columns, so
//   every load and store of a warp is contiguous.  A ragged N (a multiple of
//   8, not of 16) needs no tail and no padding: an item never crosses a
//   row's end; a ragged K/2 masks the last item's rows.  Stores are plain,
//   so the weight stays in L2 for the cuBLAS product that reads it next.  A
//   grid-stride launch sized to the blocks the card holds at once.  On an
//   H100 80GB HBM3 at 700 W it runs at 74-82% of the bound at the 13B's
//   three shapes (64-72 registers, 4 blocks an SM): a step's 384 dequants in
//   11.4 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int COLS = 8;   // columns of a thread's item: one 8-byte load of codes a row
constexpr int ROWS = 4;   // packed rows of a thread's item, which share s and m

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 consecutive scale values (16- or 32-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// one weight from its code; s and m already in the order's precision
template <bool BF16_ORDER>
__device__ __forceinline__ float weight(uint32_t q, float s, float m) {
  const float p = __fmul_rn((float)q, s);
  return __fadd_rn(BF16_ORDER ? round_bf16(p) : p, m);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 columns of one packed row: codes `b` (byte t = column t), the nibble
// half's s and m -> 8 bf16 weights as one 16-byte store
template <bool BF16_ORDER>
__device__ __forceinline__ void store8(uint2 b, int shift, const float (&s)[8],
                                       const float (&m)[8], bf16* out) {
  const uint32_t bytes[2] = {b.x, b.y};
  uint32_t w[4];
#pragma unroll
  for (int t = 0; t < 8; t += 2) {
    const uint32_t word = bytes[t / 4], at = 8 * (t % 4) + shift;
    w[t / 2] = pack2(weight<BF16_ORDER>((word >> at) & 0xF, s[t], m[t]),
                     weight<BF16_ORDER>((word >> (at + 8)) & 0xF, s[t + 1], m[t + 1]));
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread's item: COLS columns from c of ROWS packed rows from j0.
template <bool BF16_ORDER, typename S>
__global__ void __launch_bounds__(THREADS)
    w4_dequant_kernel(const uint8_t* __restrict__ wp, const S* __restrict__ s,
                      const S* __restrict__ m, bf16* __restrict__ out, int kh, int n,
                      int chunks, int qblock, unsigned items) {
  const unsigned stride = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < items; i += stride) {
    const int j0 = (int)(i / (unsigned)chunks) * ROWS;
    const int c = (int)(i % (unsigned)chunks) * COLS;
    const int rows = min(ROWS, kh - j0);
    uint2 codes[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)  // every load in flight before the first use
      codes[r] = r < rows ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)(j0 + r) * n + c))
                          : make_uint2(0, 0);
    float sl[COLS], ml[COLS], sh[COLS], mh[COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = j0 + r;
      if (r >= rows) break;
      if (r == 0 || j % qblock == 0) {  // a new group: the low and the high half's
        // (K/2 is a multiple of qblock, so both halves change group at one row)
        const size_t lo = (size_t)(j / qblock) * n + c, hi = (size_t)((kh + j) / qblock) * n + c;
        load8(s + lo, sl);
        load8(m + lo, ml);
        load8(s + hi, sh);
        load8(m + hi, mh);
        if (BF16_ORDER) {  // torch rounds f32 s and m to bf16 first (exact for bf16 ones)
#pragma unroll
          for (int t = 0; t < COLS; ++t) {
            sl[t] = round_bf16(sl[t]); ml[t] = round_bf16(ml[t]);
            sh[t] = round_bf16(sh[t]); mh[t] = round_bf16(mh[t]);
          }
        }
      }
      store8<BF16_ORDER>(codes[r], 0, sl, ml, out + (size_t)j * n + c);
      store8<BF16_ORDER>(codes[r], 4, sh, mh, out + (size_t)(kh + j) * n + c);
    }
  }
}

template <bool BF16_ORDER, typename S>
int launch(const void* wp, const void* s, const void* m, void* out, int kh, int n, int qblock,
           cudaStream_t stream) {
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, w4_dequant_kernel<BF16_ORDER, S>,
                                                  THREADS, 0);
    return blocks;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int chunks = n / COLS;
  const long long items = (long long)((kh + ROWS - 1) / ROWS) * chunks;
  if (items > UINT_MAX - (long long)sms * per_sm * THREADS) return (int)cudaErrorInvalidValue;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (long long)sms * per_sm ? want : (long long)sms * per_sm);
  w4_dequant_kernel<BF16_ORDER, S><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(wp), static_cast<const S*>(s), static_cast<const S*>(m),
      static_cast<bf16*>(out), kh, n, chunks, qblock, (unsigned)items);
  return (int)cudaGetLastError();
}

}  // namespace

// wp uint8 [K/2, N], s and m [K/qblock, N] (f32: scale_bf16 = 0; bf16: 1),
// out bf16 [K, N]; order_bf16 = 1 rounds q * s to bf16 before + m.  Every
// pointer 16-byte aligned, N a multiple of 8, K a multiple of 2 * qblock.
extern "C" int cvt_w4_dequant(const void* wp, const void* s, const void* m, void* out, int K,
                              int N, int qblock, int scale_bf16, int order_bf16, void* stream) {
  if (K < 2 || N < 8 || N % 8 != 0 || qblock < 1 || K % (2 * qblock) != 0 || wp == nullptr ||
      s == nullptr || m == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {wp, s, m, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kh = K / 2;
  if (order_bf16)
    return scale_bf16 ? launch<true, bf16>(wp, s, m, out, kh, N, qblock, st)
                      : launch<true, float>(wp, s, m, out, kh, N, qblock, st);
  return scale_bf16 ? launch<false, bf16>(wp, s, m, out, kh, N, qblock, st)
                    : launch<false, float>(wp, s, m, out, kh, N, qblock, st);
}
