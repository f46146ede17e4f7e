// K3 and K4: weight-only quantized matmuls (W8A16, W4A16) on wgmma, fed by
// a TMA ring, split-K summed inside a thread-block cluster:
//   y = bf16(x . W) [+ bias, in bf16],  x bf16 [M, K],  W dequantized per tile.
//
// Replaces:
//   K3: candle_video_tpu/ops/pallas/int8_weight_matmul.py:82, w8_matmul
//     (kernel `_kernel` :52), the TPU kernel that carries every int8 T5-XXL
//     linear and the 13B W8 DiT's cross-attention k/v.  W = bf16(f32(q) *
//     s[k / qblock, n]), q int8 [K, N], s f32.
//   K4: candle_video_tpu/ops/pallas/int4_weight_matmul.py:205, w4_matmul
//     (kernel `_kernel` :170), the Q4_K-form T5 and the 13B W4 DiT's
//     cross-attention k/v.  The payload is packed nibbles [K/2, N] in the
//     K-half planar layout (byte j of column n holds logical row j in its
//     low nibble and row K/2 + j in its high one), with an affine scale s
//     and min m per (group of qblock logical rows, column), f32 or bf16:
//     W = bf16(f32(q) * f32(s) + f32(m)), the product rounded to f32
//     before the add, the sum rounded once to bf16.
//   Both: the product accumulated in f32, rounded to bf16, then the
//   optional bias added in bf16.  The dequantized weight is bit for bit the
//   plain PyTorch version's `dequantize`.  One template, one instance per
//   weight format (W8, W4<float>, W4<bf16>), so a profile tells K3 from K4
//   by name.  The payloads stay in the K-major [K, N] / [K/2, N] layout
//   that Int8Linear, Int4Linear, the GGUF loader and convert.py produce.
//
// What bounds it on this card: bytes, at the ridge.  The path runs M = 128
//   tokens (256 under CFG) against (K, N) = 4096^2, 4096 x 10240 and
//   10240 x 4096.  At 4096^2 K3 moves 21 MB (int8 weights, f32 scales, x,
//   y): 0.0063 ms at 3.35 TB/s, against 4.3 GFLOP, 0.0043 ms at the bf16
//   peak; K4 moves 14.7 MB (0.0044 ms) for the same 4.3 GFLOP, so its
//   tensor cores must run near their peak too.  The earlier design
//   (nvcuda::wmma through shared memory, loads staged in registers, split-K
//   through a global f32 workspace read back by a second kernel) ran under
//   10% of the bound, for five reasons; what this design does about each:
//   1. Split-K through device memory: at 4096^2 K3's nine [128, 4096] f32
//      partials (18.9 MB) were written and read back, more traffic than
//      the product itself.  Here the splits of one output tile form one
//      cluster along K (at most 8, launched with cudaLaunchKernelEx and a
//      cluster-dimension attribute); each CTA leaves its f32 tile in its own
//      shared memory, and after a cluster barrier CTA z sums rows z * 128 /
//      split .. of every peer's tile through distributed shared memory
//      (mapa, ld.shared::cluster), in split order 0, 1, 2, ..., so the
//      result is deterministic.  It rounds to bf16, adds the bias and
//      stores whole rows.  No workspace, one launch.
//   2. Too few bytes in flight: one 32-deep step held in registers, x
//      re-read by 64 N-tiles.  Here a producer warp keeps a ring of 3 to 8
//      stages in flight by TMA, each holding the x tile (bf16, 128 tokens x
//      64 k, 128-byte swizzle; K4 two boxes: columns k0 and K/2 + k0, the
//      low-nibble and high-nibble rows of one packed tile, from a [M, 2,
//      K/2] view so that each half zero-fills at its own end), the raw
//      weight tile (64 payload rows x BN bytes as UINT8, 128-byte swizzle),
//      and the tile's scale rows (K4: and min rows, low and high groups),
//      unswizzled.  BN = 128 or 256 (the host plan plan_w8 / plan_w4), so
//      x is read once per 128 or 256 columns.
//   3. Scales loaded per row: each scale and min now leaves device memory
//      once, by TMA, and a thread reads the pair of its two columns from
//      shared memory once per 16-deep chunk.
//   4. Integer to float on the conversion pipe: a code becomes a float by
//      OR-ing it into the mantissa of 2^23 (one byte permute; int8 first
//      XOR 0x80 to make it unsigned) and one FP32 subtract, exact for
//      integers below 2^23, so bit-identical to the conversion; K4 folds
//      the subtract into its multiply by the scale, one exact FMA.  The
//      f32 -> bf16 pair rounding is one cvt.rn.bf16x2, faster on the card
//      than an integer round-to-nearest-even with a byte permute, which
//      gives the same bits on finite values
//      (utils/probe_weight_only.py times both).
//   5. Host work per call: the wrapper now allocates only y and makes one
//      launch; the launch is a pure function of the shape (plan cached),
//      the tensor maps of a resident weight are encoded once (a map is a
//      pure function of its arguments, kept on all of them), and the
//      shared-memory limit is raised once per device.
//
// Which operand the dequantized weight is.  Dequantizing into a bf16 B tile
//   in shared memory for an SS wgmma costs, per weight at M = 128, 1 byte of
//   raw read, 2 bytes of bf16 written and 4 read back by the two m64 halves,
//   plus x: ~8 bytes of shared-memory traffic, about 136 B/clk per SM at
//   the rate the bound asks (~17 weights/clk/SM), above the SM's 128.  So
//   the design swaps A and B: Y^T = W^T x^T.  The weight is wgmma's
//   register A operand (64 output columns of a warpgroup per m64) and x is
//   B from shared memory, K-major as TMA writes it (m64n128k16, the 128
//   tokens of an M-tile as wgmma's N).  A thread's A fragment comes from
//   the raw tile by one ldmatrix.trans over bytes: the 8x8 16-bit matrices
//   of 8 payload rows x 16 columns hand thread t the bytes of columns
//   nb + 2g, nb + 2g + 1 (g = lane / 4) in rows 2q, 2q + 1 (q = lane % 4),
//   exactly the k pairs of its A fragment when wgmma row g is column nb +
//   2g and row g + 8 column nb + 2g + 1.  The epilogue undoes that
//   permutation.  Traffic: 1 byte of raw read per weight plus x read once
//   per m64 of columns (M / 32 bytes a weight), ~5 bytes.  Two consumer
//   warpgroups each own BN / 2 columns (one or two m64 blocks); four of one
//   m64 block each (one producer warp, 544 threads) ran slower on the
//   card: ptxas gives them 96 registers, and K4's instance spilled.  A
//   warpgroup's products go out in commit groups of two 16-deep chunks per
//   m64 block (K4: the low chunks of a 32-row pair, then the high ones),
//   and the next group is dequantized into the other register buffer
//   while one runs (wait_group 1).  ptxas keeps such a pipeline only if no
//   other instruction writes an operand register while a group is in
//   flight: the descriptors are computed before the fence, and the step
//   loop runs at least once (see below); otherwise it serializes every
//   wgmma (its C7515 note), which cost the kernel a third of its rate.
//
// Measured on an H100 (chip_smoke.py's K3 and K4 phases and
//   utils/probe_weight_only.py's ablation; PERF.md section 6): 18-44% of
//   the bound at the path's shapes.  A 64-row step of a 256-column tile
//   takes ~1.15 us, of which the products alone take ~0.8 and the dequant
//   alone ~0.8 (two consumer warps a scheduler leave it latency-bound); a
//   CTA also pays 5-7 us for the cluster's sum through distributed shared
//   memory at six splits.  An H100 holds 17 clusters of six and 15 of
//   eight, so the plan puts 80-96 of its 132 SMs to work at M = 128.
//
// Not yet: a persistent tile loop, TMA multicast of x across a cluster
//   along N, a TMA store of y, a narrower wgmma N for M below 128.

#include <cuda_bf16.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;            // tokens per CTA: the wgmma's N
constexpr int BKP = 64;            // payload rows per step (K4: 128 logical rows)
constexpr int X_BYTES = BM * 128;  // one x box: 128 tokens x 64 bf16
constexpr int W_BOX = 128 * BKP;   // one raw weight box: 64 rows x 128 columns
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int MAX_SPLIT = 8;       // the portable cluster size
constexpr int SMEM_LIMIT = 232448;

// K3: int8 codes, one f32 scale per (qblock, column)
struct W8 {
  typedef float Scale;
  static constexpr int X_BOXES = 1;
  static constexpr int SCALE_TILES = 1;  // s
};

// K4: packed nibbles, affine s and m per (qblock, column) in T
template <typename T>
struct W4 {
  typedef T Scale;
  static constexpr int X_BOXES = 2;      // the low and high halves of K
  static constexpr int SCALE_TILES = 4;  // s low, s high, m low, m high
};

// the shared-memory plan, recomputed here from what the host plan passes
__host__ __device__ inline int stage_bytes_of(int x_boxes, int scale_tiles, int scale_size,
                                              int bn, int srows) {
  const int b = x_boxes * X_BYTES + bn * BKP + scale_tiles * srows * bn * scale_size;
  return (b + 1023) / 1024 * 1024;
}
__host__ __device__ inline int tile_bytes_of(int bn) { return BM * (bn + 4) * 4; }
__host__ inline int smem_of(int stage_bytes, int stages, int bn) {
  const int ring = stages * stage_bytes, tile = tile_bytes_of(bn);
  return 1024 + (ring > tile ? ring : tile) + 2 * stages * 8;
}

struct Args {
  const bf16* bias;  // [N] or null
  bf16* y;           // [M, N]
  int M, N;          // y's rows and columns (the payload may be padded past N)
  int steps, split, qblock, qshift;  // qshift: log2(min(qblock, 64))
  int stages, stage_bytes, tile_elems;  // tile_elems: one scale tile, srows * BN
};

// ---- dequantization -----------------------------------------------------

// byte i of u (< 256) as a float, plus `offset`: 2^23 + u with u in the
// mantissa, one byte permute and one subtract, exact
__device__ __forceinline__ float code(uint32_t u, int i, float offset) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)), offset);
}

// the bf16 pair, round to nearest even (an integer rounding with a byte
// permute gives the same bits and ran slower on the card:
// utils/probe_weight_only.py)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;  // the first source goes to the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

// One 16-deep chunk of one m64 block: ra holds payload rows 2q, 2q + 1 and
// rb rows 2q + 8, 2q + 9 (bytes: row 2q col n, row 2q col n + 1, row 2q + 1
// col n, row 2q + 1 col n + 1) -> the A fragment {rows g, g + 8} x {k}
// with wgmma row g = column n and row g + 8 = column n + 1.
__device__ __forceinline__ void dequant8(uint32_t (&a)[4], uint32_t ra, uint32_t rb, float2 s) {
  ra ^= 0x80808080u;  // int8 -> int8 + 128 in [0, 255]
  rb ^= 0x80808080u;
  const float off = 8388736.f;  // 2^23 + 128
  a[0] = pack2(__fmul_rn(code(ra, 0, off), s.x), __fmul_rn(code(ra, 2, off), s.x));
  a[1] = pack2(__fmul_rn(code(ra, 1, off), s.y), __fmul_rn(code(ra, 3, off), s.y));
  a[2] = pack2(__fmul_rn(code(rb, 0, off), s.x), __fmul_rn(code(rb, 2, off), s.x));
  a[3] = pack2(__fmul_rn(code(rb, 1, off), s.y), __fmul_rn(code(rb, 3, off), s.y));
}

// K4's chunk: ra and rb hold one nibble per byte (already masked).  With
// the code's float c = 2^23 + q (no subtract), q * s is one FMA: c * s +
// (-2^23 * s) is q * s exactly, rounded once, as the multiply alone rounds
// it; -2^23 * s is exact (a power of two), made once per scale pair.  Then
// + m, rounded apart.
__device__ __forceinline__ float affine(uint32_t u, int i, float s, float ns, float m) {
  return __fadd_rn(__fmaf_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)), s, ns), m);
}

__device__ __forceinline__ void dequant4(uint32_t (&a)[4], uint32_t ra, uint32_t rb, float2 s,
                                         float2 m) {
  const float2 ns = make_float2(-8388608.f * s.x, -8388608.f * s.y);  // -2^23 s
  a[0] = pack2(affine(ra, 0, s.x, ns.x, m.x), affine(ra, 2, s.x, ns.x, m.x));
  a[1] = pack2(affine(ra, 1, s.y, ns.y, m.y), affine(ra, 3, s.y, ns.y, m.y));
  a[2] = pack2(affine(rb, 0, s.x, ns.x, m.x), affine(rb, 2, s.x, ns.x, m.x));
  a[3] = pack2(affine(rb, 1, s.y, ns.y, m.y), affine(rb, 3, s.y, ns.y, m.y));
}

// One group of products: CH 16-deep chunks, A from `af`, x (B, K-major) of
// chunk ch at shared address xa[ch].  The next group's dequant runs while
// this group runs, so the wait leaves it in flight; the previous group,
// which read `other`, is done after it, and the fences keep `other` live
// until then.
template <int CH, int NB>
__device__ __forceinline__ void issue_group(float (&acc)[NB][64], uint32_t (&af)[CH][NB][4],
                                            uint32_t (&other)[CH][NB][4],
                                            const uint32_t (&xa)[CH]) {
  // every operand is in its register before the fence: an instruction
  // that defines one between the group's wgmma makes ptxas serialize them
  uint64_t db[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) db[ch] = desc_sw128(xa[ch], 16, 1024);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) fence_regs(af[ch]);
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) fence_regs(acc[bb]);
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) wgmma_rs_n128(acc[bb], af[ch][bb], db[ch], 1);
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) fence_regs(acc[bb]);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) fence_regs(other[ch]);
}

// ---- the kernel -----------------------------------------------------------

template <typename F, int NB>
__global__ void __launch_bounds__(THREADS, 1)
weight_only_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap smap,
                          const __grid_constant__ CUtensorMap mmap, const Args args) {
  constexpr int BN = 128 * NB;  // output columns per CTA; each consumer owns NB m64 blocks
  constexpr int P = BN + 4;     // f32 pitch of the staged tile (conflict-free float2 stores)
  typedef typename F::Scale S;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset into the shared array, so that the compiler keeps
  // loads through it in the shared space
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ring = args.stages * args.stage_bytes;
  const int tile_bytes = tile_bytes_of(BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > tile_bytes ? ring : tile_bytes));
  uint64_t* empty = full + args.stages;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int z = (int)cluster_rank();  // the split: the cluster spans gridDim.z
  const int s_begin = (int)((int64_t)z * args.steps / args.split);
  const int nsteps = (int)((int64_t)(z + 1) * args.steps / args.split) - s_begin;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < args.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every box of every step ----
    regs_dealloc<40>();
    if (tid == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      tma_prefetch_map(&smap);
      if (F::SCALE_TILES > 1) tma_prefetch_map(&mmap);
      const int srows_bytes = args.tile_elems * (int)sizeof(S);
      const unsigned tx = F::X_BOXES * X_BYTES + BN * BKP + F::SCALE_TILES * srows_bytes;
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % args.stages;
        const int k0 = (s_begin + i) * BKP;  // payload row (K4: packed row)
        const int g0 = k0 / args.qblock;     // its group's scale row (K4: within a half)
        mbar_wait(&empty[s], ((i / args.stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], tx);
        unsigned char* st = smem + s * args.stage_bytes;
        unsigned char* wt = st + F::X_BOXES * X_BYTES;
        unsigned char* sc = wt + BN * BKP;
        if constexpr (F::X_BOXES == 1) {
          tma_load_2d(st, &xmap, &full[s], k0, m0);
          tma_load_2d(sc, &smap, &full[s], n0, g0);
        } else {
          tma_load_3d(st, &xmap, &full[s], k0, 0, m0);
          tma_load_3d(st + X_BYTES, &xmap, &full[s], k0, 1, m0);
          tma_load_3d(sc, &smap, &full[s], n0, g0, 0);
          tma_load_3d(sc + srows_bytes, &smap, &full[s], n0, g0, 1);
          tma_load_3d(sc + 2 * srows_bytes, &mmap, &full[s], n0, g0, 0);
          tma_load_3d(sc + 3 * srows_bytes, &mmap, &full[s], n0, g0, 1);
        }
#pragma unroll
#pragma unroll
        for (int h = 0; h < NB; ++h) tma_load_2d(wt + h * W_BOX, &wmap, &full[s], n0 + 128 * h, k0);
      }
    }
    __syncwarp();
    cluster_sync();  // the partial tiles are staged
    cluster_sync();  // the peers have read them
    return;
  }

  // ---- consumers: warpgroup c owns tile columns 64 NB c .. 64 NB (c + 1) - 1 ----
  // (the registers the producer gives up: without them K4's f32 instance
  // spills)
  regs_alloc<232>();
  const int c = wg - 1;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  float acc[NB][64];
#pragma unroll
  for (int bb = 0; bb < NB; ++bb)
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[bb][r] = 0.f;
  // A of one group: the 2 chunks of one x box in one 32-row pair, for each
  // m64 block; two buffers, alternating from group to group (K3: pairs 0
  // and 1 of a step; K4: the low and the high chunks of a pair)
  uint32_t a[2][2][NB][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[b][ch][bb][r] = 0u;

  // every CTA has a step (the plan's split is at most the steps); a loop
  // that may run no time makes the compiler zero the accumulators again on
  // the path around it, which ptxas counts as a write while the last group
  // is in flight and answers by serializing every wgmma
  int i = 0;
  do {
    const int s = i % args.stages;
    mbar_wait(&full[s], (i / args.stages) & 1);
    unsigned char* st = smem + s * args.stage_bytes;
    const uint32_t x_addr = smem_u32(st);
    const uint32_t w_addr = x_addr + F::X_BOXES * X_BYTES;
    const S* sc = reinterpret_cast<const S*>(st + F::X_BOXES * X_BYTES + BN * BKP);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      // payload rows 32p .. 32p + 31 of the step: four 8-row matrices
      uint32_t raw[NB][4];
      const int row = 32 * p + lane;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const int nb = 64 * (c * NB + bb) + 16 * warp;  // this warp's 16 columns
        ldmatrix_x4_trans(raw[bb], w_addr + (nb / 128) * W_BOX + row * 128 +
                                       ((((nb % 128) / 16) ^ (row % 8)) * 16));
      }
#pragma unroll
      for (int half = 0; half < F::X_BOXES; ++half) {
        const int buf = (F::X_BOXES * p + half) & 1;
        uint32_t xa[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kc = 2 * p + h;                 // k16 chunk of the x box
          const int gr = (16 * kc) >> args.qshift;  // its scale row in the stage
          xa[h] = x_addr + half * X_BYTES + 32 * kc;
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            const int n = 64 * (c * NB + bb) + 16 * warp + 2 * g;
            uint32_t(&af)[4] = a[buf][h][bb];
            if constexpr (F::X_BOXES == 1) {
              dequant8(af, raw[bb][2 * h], raw[bb][2 * h + 1], pair(sc + gr * BN + n));
            } else {
              const uint32_t ra = half ? (raw[bb][2 * h] >> 4) & 0x0F0F0F0Fu
                                       : raw[bb][2 * h] & 0x0F0F0F0Fu;
              const uint32_t rb = half ? (raw[bb][2 * h + 1] >> 4) & 0x0F0F0F0Fu
                                       : raw[bb][2 * h + 1] & 0x0F0F0F0Fu;
              dequant4(af, ra, rb, pair(sc + half * args.tile_elems + gr * BN + n),
                       pair(sc + (2 + half) * args.tile_elems + gr * BN + n));
            }
          }
        }
        issue_group(acc, a[buf], a[buf ^ 1], xa);
        // the previous step's last group is done, and this warp's loads of
        // it were done before: its slot goes back, one arrival per warp
        if (p == 0 && half == 0 && i > 0 && lane == 0)
          mbar_arrive(&empty[(i - 1) % args.stages]);
      }
    }
  } while (++i < nsteps);
  wgmma_wait<0>();
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) fence_regs(acc[bb]);

  // ---- the partial tile, [token][column] in f32, into the idle ring ----
  // acc[bb][4j + 2i + e] is wgmma row 16 warp + g + 8i, column 8j + 2q + e:
  // tile column 64 (c NB + bb) + 16 warp + 2g + i, token 8j + 2q + e
  named_barrier(1, 256);  // both consumers are done with the ring
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    const int n = 64 * (c * NB + bb) + 16 * warp + 2 * g;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(tile + (8 * j + 2 * q + e) * P + n) =
            make_float2(acc[bb][4 * j + e], acc[bb][4 * j + 2 + e]);
  }
  cluster_sync();

  // ---- split-K: this CTA's rows of the tile, summed over the cluster's
  // partials in split order, rounded, biased and stored in whole rows ----
  const int rows = (BM + args.split - 1) / args.split;
  const int r0 = z * rows;
  const int r1 = min(min(BM, r0 + rows), args.M - m0);
  const bool vec = args.N % 4 == 0;
  const uint32_t tile_addr = smem_u32(tile);
  const int items = (r1 - r0) * (BN / 4);  // 4 columns an item
  // UNROLL items a thread at once, every split's partial of each in flight
  // (a peer's shared memory is far: the loads' latency, not their bytes,
  // set this loop's pace), the own partial read locally
  constexpr int UNROLL = 2;
  for (int base = threadIdx.x - 128; base < items; base += UNROLL * 256) {
    float4 part[UNROLL][MAX_SPLIT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * 256;
      if (idx >= items) break;
      const int r = r0 + idx / (BN / 4), col = 4 * (idx % (BN / 4));
      const uint32_t at = tile_addr + (uint32_t)(r * P + col) * 4;
#pragma unroll
      for (int zz = 0; zz < MAX_SPLIT; ++zz)
        if (zz < args.split)
          part[u][zz] = zz == z ? *reinterpret_cast<const float4*>(tile + r * P + col)
                                : ld_cluster_f4(peer_addr(at, zz));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * 256;
      if (idx >= items) break;
      const int r = r0 + idx / (BN / 4), n = n0 + 4 * (idx % (BN / 4));
      if (n >= args.N) continue;
      // summed in split order
      float4 v = part[u][0];
#pragma unroll
      for (int zz = 1; zz < MAX_SPLIT; ++zz) {
        if (zz >= args.split) break;
        v.x = __fadd_rn(v.x, part[u][zz].x);
        v.y = __fadd_rn(v.y, part[u][zz].y);
        v.z = __fadd_rn(v.z, part[u][zz].z);
        v.w = __fadd_rn(v.w, part[u][zz].w);
      }
      const float vs[4] = {v.x, v.y, v.z, v.w};
      union {
        bf16 h[4];
        uint2 u2;
      } out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out.h[e] = __float2bfloat16_rn(vs[e]);
        if (args.bias != nullptr && n + e < args.N)
          out.h[e] = __float2bfloat16_rn(__bfloat162float(out.h[e]) +
                                         __bfloat162float(args.bias[n + e]));
      }
      bf16* dst = args.y + (int64_t)(m0 + r) * args.N + n;
      if (vec) {
        *reinterpret_cast<uint2*>(dst) = out.u2;
      } else {
        for (int e = 0; e < 4 && n + e < args.N; ++e) dst[e] = out.h[e];
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer still reads its tile
}

// ---- host ---------------------------------------------------------------------

inline bool qblock_ok(int qb) { return qb >= 16 && qb % 16 == 0 && (64 % qb == 0 || qb % 64 == 0); }

// A tensor map is a pure function of its arguments (address, type, dims,
// strides, box, swizzle), so encoded maps are kept, keyed on all of them:
// the resident weights' and scales' maps are encoded once, not per call.
// A T5 encode alone names ~340 maps; the table is emptied at 4096.
struct MapKey {
  const void* base;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
  int rank, type, swizzle;
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(MapKey)) == 0; }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {  // FNV-1a over the key's bytes
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&k);
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ b[i]) * 1099511628211ull;
    return (size_t)h;
  }
};

int cached_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
               const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  static std::mutex lock;
  MapKey key;
  memset(&key, 0, sizeof(key));  // the padding takes part in the hash and compare
  key.base = base, key.rank = rank, key.type = (int)type, key.swizzle = (int)swizzle;
  for (int d = 0; d < rank; ++d) key.dims[d] = dims[d], key.box[d] = box[d];
  for (int d = 0; d + 1 < rank; ++d) key.strides[d] = strides[d];
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = maps.find(key);
  if (hit != maps.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = make_map(map, type, base, rank, dims, strides, box, swizzle);
  if (err != 0) return err;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return 0;
}

inline int log2i(int v) {
  int r = 0;
  while ((1 << (r + 1)) <= v) ++r;
  return r;
}

template <typename F, int NB>
cudaError_t launch_nb(const CUtensorMap* maps, const Args& args, int n_tiles, int m_tiles,
                      int smem_bytes, cudaStream_t st) {
  auto kern = weight_only_matmul_kernel<F, NB>;
  // the shared-memory limit is raised once per device, to the most any plan asks
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, m_tiles, args.split);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = args.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, maps[0], maps[1], maps[2], maps[3], args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Checks the plan against what this source builds and fills in the rest of
// Args; returns 0 or a CUDA error code.
template <typename F>
int plan_args(Args& args, int M, int N, int n_pad, int payload_rows, int qblock, int bn,
              int stages, int split, int smem_bytes) {
  const int steps = (payload_rows + BKP - 1) / BKP;
  if (M < 1 || N < 1 || N > n_pad || n_pad % 16 != 0 || !qblock_ok(qblock) ||
      (bn != 128 && bn != 256) || stages < 2 || split < 1 || split > MAX_SPLIT ||
      split > steps || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int srows = qblock < BKP ? BKP / qblock : 1;
  args.stage_bytes = stage_bytes_of(F::X_BOXES, F::SCALE_TILES, (int)sizeof(typename F::Scale),
                                    bn, srows);
  if (smem_bytes < smem_of(args.stage_bytes, stages, bn)) return (int)cudaErrorInvalidValue;
  args.M = M, args.N = N, args.steps = steps, args.split = split, args.qblock = qblock;
  args.qshift = log2i(qblock < BKP ? qblock : BKP);
  args.stages = stages, args.tile_elems = srows * bn;
  return 0;
}

template <typename F>
int launch(const CUtensorMap* maps, const Args& args, int bn, int smem_bytes, void* stream) {
  const int n_tiles = (args.N + bn - 1) / bn, m_tiles = (args.M + BM - 1) / BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bn == 128 ? launch_nb<F, 1>(maps, args, n_tiles, m_tiles, smem_bytes, st)
                         : launch_nb<F, 2>(maps, args, n_tiles, m_tiles, smem_bytes, st));
}

}  // namespace

// K3.  x bf16 [M, K] (K % 8 == 0), w_q int8 [K, n_pad], s f32 [K / qblock,
// n_pad] (n_pad: N rounded up to 16, the payload's pitch; the wrapper pads
// a ragged N with zeros), bias bf16 [N] or null, y bf16 [M, N].  qblock a
// multiple of 16 that divides 64 or is a multiple of 64, K % qblock == 0.
// The plan (plan_w8): bn 128 or 256, the ring's stages, the cluster's
// split (at most 8 and the 64-row steps), smem_bytes.  Anything else is
// refused.
extern "C" int cvt_w8_matmul(const void* x, const void* wq, const void* s, const void* bias,
                             void* y, int M, int K, int N, int n_pad, int qblock, int bn,
                             int stages, int split, int smem_bytes, void* stream) {
  Args args;
  int err = plan_args<W8>(args, M, N, n_pad, K, qblock, bn, stages, split, smem_bytes);
  if (err != 0 || K % 8 != 0 || K % qblock != 0) return err ? err : (int)cudaErrorInvalidValue;
  args.bias = static_cast<const bf16*>(bias);
  args.y = static_cast<bf16*>(y);
  const int srows = args.tile_elems / bn;
  CUtensorMap maps[4];
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, xstr[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {64, BM};
  const uint64_t wdims[2] = {(uint64_t)n_pad, (uint64_t)K}, wstr[1] = {(uint64_t)n_pad};
  const uint32_t wbox[2] = {128, BKP};
  const uint64_t sdims[2] = {(uint64_t)n_pad, (uint64_t)(K / qblock)};
  const uint64_t sstr[1] = {(uint64_t)n_pad * 4};
  const uint32_t sbox[2] = {(uint32_t)bn, (uint32_t)srows};
  err = cached_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xdims, xstr, xbox);
  if (err == 0)
    err = cached_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 2, wdims, wstr, wbox);
  if (err == 0)
    err = cached_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, 2, sdims, sstr, sbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  maps[3] = maps[2];  // K3 has no mins
  return launch<W8>(maps, args, bn, smem_bytes, stream);
}

// K4.  x bf16 [M, K] (K % 16 == 0, K % (2 qblock) == 0), w_p uint8 [K / 2,
// n_pad] (K-half planar nibbles), s and m [K / qblock, n_pad] in f32
// (scale_bf16 = 0) or bf16 (1), bias bf16 [N] or null, y bf16 [M, N]; the
// rest as K3, the steps counted in 64 packed rows.
extern "C" int cvt_w4_matmul(const void* x, const void* wp, const void* s, const void* m,
                             const void* bias, void* y, int M, int K, int N, int n_pad,
                             int qblock, int scale_bf16, int bn, int stages, int split,
                             int smem_bytes, void* stream) {
  Args args;
  int err = scale_bf16
                ? plan_args<W4<bf16>>(args, M, N, n_pad, K / 2, qblock, bn, stages, split,
                                      smem_bytes)
                : plan_args<W4<float>>(args, M, N, n_pad, K / 2, qblock, bn, stages, split,
                                       smem_bytes);
  if (err != 0 || K % 16 != 0 || K % (2 * qblock) != 0)
    return err ? err : (int)cudaErrorInvalidValue;
  args.bias = static_cast<const bf16*>(bias);
  args.y = static_cast<bf16*>(y);
  const int srows = args.tile_elems / bn, es = scale_bf16 ? 2 : 4;
  const uint64_t half_groups = (uint64_t)(K / qblock / 2);
  CUtensorMap maps[4];
  // x as [M, 2, K/2]: each half of K zero-fills at its own end
  const uint64_t xdims[3] = {(uint64_t)K / 2, 2, (uint64_t)M};
  const uint64_t xstr[2] = {(uint64_t)K, (uint64_t)K * 2};
  const uint32_t xbox[3] = {64, 1, BM};
  const uint64_t wdims[2] = {(uint64_t)n_pad, (uint64_t)K / 2}, wstr[1] = {(uint64_t)n_pad};
  const uint32_t wbox[2] = {128, BKP};
  // s and m as [2, G/2, n_pad]: the low and the high half's groups
  const uint64_t sdims[3] = {(uint64_t)n_pad, half_groups, 2};
  const uint64_t sstr[2] = {(uint64_t)n_pad * es, half_groups * n_pad * es};
  const uint32_t sbox[3] = {(uint32_t)bn, (uint32_t)srows, 1};
  const CUtensorMapDataType st =
      scale_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  err = cached_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 3, xdims, xstr, xbox);
  if (err == 0)
    err = cached_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, 2, wdims, wstr, wbox);
  if (err == 0)
    err = cached_map(&maps[2], st, s, 3, sdims, sstr, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = cached_map(&maps[3], st, m, 3, sdims, sstr, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  return scale_bf16 ? launch<W4<bf16>>(maps, args, bn, smem_bytes, stream)
                    : launch<W4<float>>(maps, args, bn, smem_bytes, stream);
}

// How many clusters of `split` CTAs of the kernel at smem_bytes (one CTA an
// SM, whatever the format and tile width) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int cvt_weight_only_max_clusters(int split, int smem_bytes, int* out) {
  if (split < 1 || split > MAX_SPLIT || smem_bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* kern = (const void*)weight_only_matmul_kernel<W8, 2>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  return (int)e;
}
