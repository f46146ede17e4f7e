// K1: lane-packed flash attention on wgmma, fed by a TMA ring (bf16 in, f32
// softmax, bf16 out).
//
// Replaces: candle_video_tpu/ops/pallas/flash_attention_packed.py:543,
//   flash_attention_packed (one-pass kernel `_kernel`, pallas_call at :698),
//   the TPU kernel that carries every LTX DiT self-attention and the SVD
//   UNet's level-1 and level-2 self-attention.  Same contract: q/k/v in
//   their natural projection layout [B, S, H*D] (a head is a D-wide column
//   slice, addressed by stride, never transposed), optional additive f32 key
//   bias [B, 1, 1, K], optional interleaved RoPE applied to q inside the
//   kernel from full-width f32 tables [1|B, S, H*D] (k arrives rotated),
//   ragged S and K masked; D = 64 or 128.
//
// What bounds it on this card: arithmetic.  At the 2B shape (S = K = 4992,
//   H = 32, D = 64) one call is 4*S*K*D*H = 204 GFLOP, 0.206 ms at the
//   989 TFLOP/s bf16 peak, against 80 MB of q/k/v/out (0.024 ms at
//   3.35 TB/s); at the 13B shape (D = 128) 408 GFLOP, 0.413 ms.  The earlier
//   mma.sync design reached a fifth of that: mma.sync cannot reach the
//   wgmma rate, and every thread spent issue slots on cp.async copies and
//   fragment loads.
//
// What the design does about it: one CTA owns 64 * CONS q rows of one
//   (batch, head) and runs CONS + 1 warpgroups.  The producer (warpgroup 0,
//   one thread, 24 or 40 registers) walks the key tiles: 128-key K and V
//   tiles [128, D] come by TMA from 3D tensor maps over [B, K, H*D] (box
//   {64, 128, 1} at column h*D, two boxes per tile at D = 128), so the
//   ragged key tail zero-fills inside its own batch, into a ring of STAGES
//   slots guarded by full and empty mbarriers.  The consumers (three with
//   160 registers at D = 64, where a tile's softmax costs the ALU and SFU as
//   much time as its products cost the tensor cores, so a third warpgroup
//   keeps them busy; two with 232 at D = 128) own 64 q rows each: they load
//   their rows once, rotate them in f32 from the tables, round once to bf16
//   and write them into the same 128-byte-swizzled layout TMA writes.  Per
//   key tile each consumer runs S = Q K^T as wgmma m64n128k16 with both
//   operands in shared memory, then on the accumulator fragments: scale and
//   the f32 key bias (in log2 units, one FMA), keys >= K at -1e30 in the
//   last tile (the zero-filled tail must not score 0), row max by two
//   shuffles, the running (m, l) in f32, p by exp2; p rounded to bf16 is the
//   register A operand of O += P V, wgmma m64nDk16 with V read from shared
//   memory through the transpose bit (V is [keys, D], D contiguous).  Those
//   are the rounding points of the TPU kernel and of the mma.sync design, so
//   their limits hold.  The output is divided by l once and stored as bf16.
//   Not yet: softmax overlapped with the next Q K^T, ping-pong between the
//   consumers, a TMA store of the output.
//   The earlier mma.sync design of K1, K2, K5 and K6 (one template, 64-key
//   tiles double-buffered by cp.async, fragments by ldmatrix) peaked at about
//   a quarter of its bound and is gone.
//
// K2, the long-sequence kernel, is the same kernel in the FIXED mode.
// Replaces: candle_video_tpu/ops/pallas/flash_attention_packed.py:392,
//   _packed_long -> _kernel_long (:234, pallas_call at :517), which the TPU
//   takes once the padded key length exceeds 8192 (every DiT self-attention
//   of a 512x768 clip of 169 frames or more).  K1's contract plus an f32
//   shift [B, G] (G = H*D/128 lane groups), computed by the wrapper in torch
//   as the JAX package computes it in XLA: the Cauchy-Schwarz bound
//   scale * max|q_g| * max|k_g|, clipped at 40, plus the key bias's global
//   max.  The shift is the same for every key tile of a row, so numerator
//   and denominator are plain sums over key tiles: no running max, no
//   alpha, no rescale of O, one divide by l at the end.  A row whose every
//   score lies ~103 nats under the shift underflows to l = 0, as in the
//   plain version (the TPU, which flushes subnormals, at ~87).
// What bounds it: arithmetic, as K1.  At the 257-frame path shape (S = K =
//   12672, H = 32, D = 64) one call is 4*S*K*D*H = 1.316 TFLOP, 1.33 ms at
//   the bf16 peak (2.66 ms at D = 128); q/k/v/out are 4 * 52 MB.  The
//   mma.sync template it ran on reached a quarter of that.
// What the design does about it: K1's producer, ring, q load and Q K^T
//   unchanged; the softmax reads shift[b, h / (128 / D)] once, in log2
//   units, and per score is one FMA (scale, bias and shift), the padded-key
//   mask and one exp2.  That exp2 keeps subnormal results (ex2.approx.f32,
//   not .ftz, three more ALU instructions): scores sit up to ~80 nats under
//   the shift (the bound is clipped at 40, a realised row maximum can be
//   -40 or lower), where a flushed p would drop mass that the plain
//   version keeps.
//
// K5, one ring-attention step, is the same kernel in the RING mode.
// Replaces: candle_video_tpu/ops/pallas/ring_chunk.py:91, ring_chunk_update
//   -> _kernel (:32, pallas_call at :134), which carries every DiT
//   self-attention of the sequence-parallel denoise (--mesh sp=N): the
//   local q chunk [B, Sq, H*D] (rotated outside, no bias) against one K/V
//   chunk [B, Sc, H*D] that rotates around the ring, folded into the
//   carried online-softmax state.  The state is plain, not lane-packed:
//   running max m and sum l f32 [B, H, Sq] in natural units, unnormalised
//   output acc f32 [B, Sq, H*D], updated in place.
// What bounds it: arithmetic, as K1, plus the state read and written once
//   in f32.  At sp = 1 on the 2B path (Sq = Sc = 4992, H = 32, D = 64) the
//   products are 204 GFLOP (0.206 ms at the bf16 peak) and the bytes 225 MB
//   (0.067 ms at 3.35 TB/s).
// What the design does about it: K1's loop, seeded and written back in
//   place of (-1e30, 0, 0) and the bf16 store.  Each consumer loads its rows'
//   m (times log2e, K1's units), l (on one lane of each quad, so the quad's
//   partial sums add once at the end) and acc straight into the m64nD
//   fragments of O; after the last tile it reduces l over the quad and
//   writes m in natural units, l and acc unnormalised.  Rows at or past Sq
//   neither read nor write the state.  The TPU kernel takes the chunk's row
//   max first and merges once; this carries the running max across tiles,
//   so p is rounded to bf16 against another shift (K1's limits hold).
//
// K6, classic flash attention over [B, S, H, D], is the same kernel in the
// UNROTATED mode.
// Replaces: candle_video_tpu/ops/pallas/flash_attention.py:175,
//   flash_attention -> _fa_kernel (:41) and _fa_kernel_onepass (:108),
//   pallas_call at :257: the TPU's route for heads that do not fill 128-lane
//   groups, which carries the SVD UNet's level-0 self-attention (5 heads of
//   64).  Same function: non-causal softmax(q k^T * scale + bias) v with the
//   true running row max, an optional f32 key bias [B, 1, 1, K], p rounded
//   to bf16 before P*V, f32 accumulation, bf16 out.  [B, S, H, D] lies in
//   memory as [B, S, H*D] with any H, which is K1's layout: the TMA boxes
//   sit at column h*D, the consumers load q by stride, and H enters only
//   through H*D and gridDim.y (at H = 5, D = 64 a row is 640 bytes, which
//   TMA's 16-byte stride rule takes).
// What bounds it: arithmetic.  At the SVD path shape (B = 28 frames of a
//   CFG pair, S = K = 9216, H = 5, D = 64) one call is 3.04 TFLOP, 3.08 ms
//   at the bf16 peak; q/k/v/out are 0.66 GB, 0.2 ms at 3.35 TB/s.
// What the design does about it: K1's online mode as it is, with the q
//   rotation compiled out.  Its own mode value makes it a template instance
//   of its own (flash_attention_hopper_kernel<64, 3, 3, 3> on the SVD path),
//   so a profile tells K6 from K1 by the kernel's name.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BKV = 128;  // keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

// What the softmax does with the scores, the kernel's fourth template
// parameter: K1's running max (ONLINE), K2's fixed shift (FIXED), K5's
// running max seeded from and written back to the carried state (RING), and
// K6's, which is ONLINE that never rotates q (UNROTATED).
enum Mode : int { ONLINE = 0, FIXED = 1, RING = 2, UNROTATED = 3 };

// One CTA at head width D: CONS consumer warpgroups of 64 q rows each and
// a ring of STAGES key tiles, both chosen by the host
// (flash_attention_packed.py's k1_launch_params: three consumers at D = 64,
// two at D = 128, three stages); the registers each role keeps after
// setmaxnreg, and the shared memory: [q: BQ x D][STAGES x (K tile, V tile)]
// [full, empty barriers].  Each operand is ATOMS column blocks of 64
// (128-byte rows), rows stacked.
template <int D, int CONS_, int STAGES_>
struct Cfg {
  static constexpr int CONS = CONS_;
  static constexpr int BQ = 64 * CONS;
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int PRODUCER_REGS = CONS == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = CONS == 3 ? 160 : 232;
  static_assert(128 * (PRODUCER_REGS + CONS * CONSUMER_REGS) <= 65536, "register file");
  static constexpr int ATOMS = D / 64;
  static constexpr int STAGES = STAGES_;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int TILE_BYTES = BKV * D * 2;  // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
  // + 1024: the dynamic base is rounded up to the swizzle's 1024-byte period
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// 2^x on the SFU (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x with subnormal results kept (the SFU plus a range fix-up)
__device__ __forceinline__ float ex2_sub(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ONLINE, FIXED and UNROTATED write out [B, S, H*D] bf16; FIXED reads shift
// [B, G]; RING reads and writes the state m_st, l_st [B, H, S] and acc_st
// [B, S, H*D] (f32) and takes neither bias nor tables.
template <int D, int CONS, int STAGES, int MODE>
__global__ void __launch_bounds__(Cfg<D, CONS, STAGES>::THREADS, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const bf16* __restrict__ q, const float* __restrict__ bias,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              const float* __restrict__ shift, bf16* __restrict__ out,
                              float* __restrict__ m_st, float* __restrict__ l_st,
                              float* __restrict__ acc_st, int S, int K, int H,
                              int64_t rope_bstride, float scale) {
  using C = Cfg<D, CONS, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  unsigned char* KVs = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int ntiles = (K + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx
      mbar_init(&empty[s], 128 * C::CONS);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    regs_dealloc<C::PRODUCER_REGS>();
    if (tid == 0) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        unsigned char* kt = KVs + s * C::STAGE_BYTES;
        unsigned char* vt = kt + C::TILE_BYTES;
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_3d(kt + a * BKV * 128, &kmap, &full[s], h * D + 64 * a, it * BKV, b);
          tma_load_3d(vt + a * BKV * 128, &vmap, &full[s], h * D + 64 * a, it * BKV, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns q rows q0 + 64c .. + 63 ----
  regs_alloc<C::CONSUMER_REGS>();
  const int c = wg - 1;
  const int64_t HD = (int64_t)H * D;
  unsigned char* Qc = Qs + c * (64 * D * 2);

  // q rows -> shared, rotated in f32 and rounded once to bf16 (the TPU
  // kernel's _rotate: lane 2i gets x[2i]c - x[2i+1]s, lane 2i+1 gets
  // x[2i+1]c + x[2i]s), in the 128-byte-swizzled layout
  {
    const bf16* qb = q + (int64_t)b * S * HD + (int64_t)h * D;
    constexpr int VEC = D / 8;  // 16-byte chunks per row
    for (int i = tid; i < 64 * VEC; i += 128) {
      const int r = i / VEC, j = i % VEC, row = q0 + 64 * c + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < S) {
        val = *reinterpret_cast<const uint4*>(qb + (int64_t)row * HD + 8 * j);
        if (MODE != RING && MODE != UNROTATED && cos_t) {
          const int64_t off =
              (int64_t)b * rope_bstride + (int64_t)row * HD + (int64_t)h * D + 8 * j;
          float cs[8], sn[8], x[8];
          *reinterpret_cast<float4*>(cs) = reinterpret_cast<const float4*>(cos_t + off)[0];
          *reinterpret_cast<float4*>(cs + 4) = reinterpret_cast<const float4*>(cos_t + off)[1];
          *reinterpret_cast<float4*>(sn) = reinterpret_cast<const float4*>(sin_t + off)[0];
          *reinterpret_cast<float4*>(sn + 4) = reinterpret_cast<const float4*>(sin_t + off)[1];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 t = __bfloat1622float2(h2[e]);
            x[2 * e] = t.x;
            x[2 * e + 1] = t.y;
          }
          uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ev = x[2 * e] * cs[2 * e] - x[2 * e + 1] * sn[2 * e];
            const float od = x[2 * e + 1] * cs[2 * e + 1] + x[2 * e] * sn[2 * e + 1];
            w[e] = pack_bf16(ev, od);
          }
        }
      }
      const int a = j / 8, jj = j % 8;
      *reinterpret_cast<uint4*>(Qc + a * 64 * 128 + r * 128 + ((jj ^ (r & 7)) * 16)) = val;
    }
    fence_async_shared();
    named_barrier(1 + c, 128);  // this warpgroup's q is in place
  }

  const int warp = tid / 32, lane = tid % 32;
  const float* biasb = MODE != RING && bias ? bias + (int64_t)b * K : nullptr;
  const uint32_t q_addr = smem_u32(Qc);
  const float scale_log2 = scale * LOG2E;

  float o[D / 2];  // O accumulator, m64nD layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[64];  // S accumulator, m64n128 layout
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  // this thread's rows: row0 (i = 0) and row0 + 8 (i = 1)
  const int row0 = q0 + 64 * c + warp * 16 + lane / 4;
  float mfix = 0.f;  // FIXED: the row's shift in log2 units
  if constexpr (MODE == FIXED) {
    constexpr int HP = 128 / D;  // heads per 128-lane group
    mfix = shift[(int64_t)b * (H / HP) + h / HP] * LOG2E;
  }
  const int64_t st0 = ((int64_t)b * H + h) * S + row0;  // RING: m_st / l_st index of row0
  float* accb = MODE == RING ? acc_st + (int64_t)b * S * HD + (int64_t)h * D + 2 * (lane % 4)
                             : nullptr;
  if constexpr (MODE == RING) {
    // seed (m, l, O) with the carried state; the row's l rides on one lane
    // of its quad, since the quad's partial sums add once at the end
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < S) {
        m[i] = m_st[st0 + 8 * i] * LOG2E;
        l[i] = lane % 4 == 0 ? l_st[st0 + 8 * i] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < S) {
          const float2 a =
              *reinterpret_cast<const float2*>(accb + (int64_t)(row0 + 8 * i) * HD + 8 * j);
          o[4 * j + 2 * i] = a.x;
          o[4 * j + 2 * i + 1] = a.y;
        }
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    const uint32_t k_addr = smem_u32(KVs + s * C::STAGE_BYTES);
    const uint32_t v_addr = k_addr + C::TILE_BYTES;

    // S[64 x 128] = Q K^T, 16 columns of D per instruction
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;     // in q's atoms
      const uint32_t koff = (kk / 4) * BKV * 128 + (kk % 4) * 32;  // in k's atoms
      wgmma_ss_n128(sc, desc_sw128(q_addr + off, 16, 1024), desc_sw128(k_addr + koff, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // softmax on the fragments: this thread holds rows warp*16 + lane/4
    // (i = 0) and + 8 (i = 1), keys k0 + 8j + 2*(lane%4) + e in sc[4j + 2i + e]
    // The scores are kept in log2 units, (s * scale + bias) * log2e, so p is
    // one subtraction and one exp2 away; the running max m is in the same
    // units.  FIXED folds its shift in here, the same for every key tile.
    // Keys past K exist only in the last tile.
    const int k0 = it * BKV;
    const float tile_shift = mfix;
    if (biasb) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + e;
          const float bk = key < K ? fmaf(biasb[key], LOG2E, -tile_shift) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sc[4 * j + 2 * i + e] = fmaf(sc[4 * j + 2 * i + e], scale_log2, bk);
        }
    } else if constexpr (MODE == FIXED) {
#pragma unroll
      for (int r = 0; r < 64; ++r) sc[r] = fmaf(sc[r], scale_log2, -tile_shift);
    } else {
#pragma unroll
      for (int r = 0; r < 64; ++r) sc[r] *= scale_log2;
    }
    if (k0 + BKV > K) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * (lane % 4) + e >= K) {
            sc[4 * j + e] = NEG;
            sc[4 * j + 2 + e] = NEG;
          }
    }
    if constexpr (MODE == FIXED) {
      // p = 2^(score - shift), summed as it is: no max, no rescale
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const float p = ex2_sub(sc[r]);
        sc[r] = p;
        l[(r >> 1) & 1] += p;
      }
    } else {
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int r = 0; r < 64; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
      float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const float p = ex2(sc[r] - m[(r >> 1) & 1]);
        sc[r] = p;
        rowsum[(r >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rowsum[i];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r >> 1) & 1];
    }

    // O[64 x D] += P V: p in bf16 is the A fragment of 16 keys (two n8
    // column blocks of S), packed before the fence; V's 16 key rows are
    // 2048 bytes apart
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[t][r] = pack_bf16(sc[8 * t + 2 * r], sc[8 * t + 2 * r + 1]);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      const uint64_t dv = desc_sw128(v_addr + t * 16 * 128, BKV * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64_t(o, pa[t], dv, 1);
      else
        wgmma_rs_n128_t(o, pa[t], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if constexpr (MODE == RING) {
    // the state goes back unnormalised, m in natural units
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < S && lane % 4 == 0) {
        m_st[st0 + 8 * i] = m[i] * (1.f / LOG2E);
        l_st[st0 + 8 * i] = l[i];
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < S)
          *reinterpret_cast<float2*>(accb + (int64_t)(row0 + 8 * i) * HD + 8 * j) =
              make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    return;
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  bf16* ob = out + (int64_t)b * S * HD + (int64_t)h * D + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row0 * HD + 8 * j) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)(row0 + 8) * HD + 8 * j) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// the pointers a mode reads or writes beyond q, k and v
struct Args {
  const void* bias;
  const void* cos_t;
  const void* sin_t;
  const void* shift;
  void* out;
  void* m;
  void* l;
  void* acc;
};

template <int D, int CONS, int STAGES, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const Args& a, int B, int S,
                   int K, int H, long long rope_bstride, float scale, int smem_bytes,
                   cudaStream_t st) {
  using C = Cfg<D, CONS, STAGES>;
  if (smem_bytes < C::SMEM) return cudaErrorInvalidValue;
  // K and V as [B, K, H*D] (innermost first), one 64-column box of 128 keys
  const uint64_t dims[3] = {(uint64_t)H * D, (uint64_t)K, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * D * 2, (uint64_t)K * H * D * 2};
  const uint32_t box[3] = {64, BKV, 1};
  CUtensorMap kmap, vmap;
  int err = make_map_bf16(&kmap, k, 3, dims, strides, box);
  if (err == 0) err = make_map_bf16(&vmap, v, 3, dims, strides, box);
  if (err != 0) return (cudaError_t)err;
  auto kern = flash_attention_hopper_kernel<D, CONS, STAGES, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, C::THREADS, smem_bytes, st>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.cos_t), static_cast<const float*>(a.sin_t),
      static_cast<const float*>(a.shift), static_cast<bf16*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), static_cast<float*>(a.acc), S, K, H,
      (int64_t)rope_bstride, scale);
  return cudaGetLastError();
}

// The (D, consumers, stages) built for every mode: (64, 3, 3) and
// (128, 2, 3); any other configuration is refused.
template <int MODE>
int dispatch(const void* q, const void* k, const void* v, const Args& a, int B, int S, int K,
             int H, int D, long long rope_bstride, float scale, int consumers, int stages,
             int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || K < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (D == 64 && consumers == 3 && stages == 3)
    return (int)launch<64, 3, 3, MODE>(q, k, v, a, B, S, K, H, rope_bstride, scale, smem_bytes,
                                       st);
  if (D == 128 && consumers == 2 && stages == 3)
    return (int)launch<128, 2, 3, MODE>(q, k, v, a, B, S, K, H, rope_bstride, scale,
                                        smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// consumers, stages and smem_bytes are the host's launch parameters
// (flash_attention_packed.py's launch_params), the same for all four modes.

// K1: q [B, S, H*D], k, v [B, K, H*D] bf16; bias f32 [B, K] or null; cos,
// sin f32 [1|B, S, H*D] or null (rope_bstride 0 or S*H*D); out [B, S, H*D]
// bf16.
extern "C" int cvt_flash_attention_packed(const void* q, const void* k, const void* v,
                                          const void* bias, const void* cos_t,
                                          const void* sin_t, void* out, int B, int S, int K,
                                          int H, int D, long long rope_bstride, float scale,
                                          int consumers, int stages, int smem_bytes,
                                          void* stream) {
  const Args a{bias, cos_t, sin_t, nullptr, out, nullptr, nullptr, nullptr};
  return dispatch<ONLINE>(q, k, v, a, B, S, K, H, D, rope_bstride, scale, consumers, stages,
                          smem_bytes, stream);
}

// K2: K1's arguments plus the shift f32 [B, H*D/128].
extern "C" int cvt_flash_attention_packed_long(const void* q, const void* k, const void* v,
                                               const void* bias, const void* cos_t,
                                               const void* sin_t, const void* shift, void* out,
                                               int B, int S, int K, int H, int D,
                                               long long rope_bstride, float scale,
                                               int consumers, int stages, int smem_bytes,
                                               void* stream) {
  if (shift == nullptr || D < 1 || 128 % D || H % (128 / D)) return (int)cudaErrorInvalidValue;
  const Args a{bias, cos_t, sin_t, shift, out, nullptr, nullptr, nullptr};
  return dispatch<FIXED>(q, k, v, a, B, S, K, H, D, rope_bstride, scale, consumers, stages,
                         smem_bytes, stream);
}

// K5: q [B, Sq, H*D] (rotated), k, v [B, Sc, H*D] bf16; the state m, l
// [B, H, Sq] and acc [B, Sq, H*D] f32, updated in place.
extern "C" int cvt_ring_chunk_update(const void* q, const void* k, const void* v, void* m,
                                     void* l, void* acc, int B, int Sq, int Sc, int H, int D,
                                     float scale, int consumers, int stages, int smem_bytes,
                                     void* stream) {
  if (m == nullptr || l == nullptr || acc == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, m, l, acc};
  return dispatch<RING>(q, k, v, a, B, Sq, Sc, H, D, 0, scale, consumers, stages, smem_bytes,
                        stream);
}

// K6: q [B, S, H, D] (any H), k, v [B, K, H, D] bf16; bias f32 [B, K] or
// null; out [B, S, H, D] bf16.
extern "C" int cvt_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int S, int K, int H,
                                   int D, float scale, int consumers, int stages,
                                   int smem_bytes, void* stream) {
  const Args a{bias, nullptr, nullptr, nullptr, out, nullptr, nullptr, nullptr};
  return dispatch<UNROTATED>(q, k, v, a, B, S, K, H, D, 0, scale, consumers, stages,
                             smem_bytes, stream);
}
