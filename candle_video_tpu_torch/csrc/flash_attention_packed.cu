// K6: classic flash attention on mma.sync (bf16 in, f32 softmax, bf16 out),
// the last kernel on this template.  K1, K2 and K5, first written on it,
// run on the wgmma/TMA kernel of flash_attention_hopper.cu; K6 moves there
// next.
//
// Replaces: candle_video_tpu/ops/pallas/flash_attention.py:175,
//   flash_attention -> _fa_kernel (:41) and _fa_kernel_onepass (:108),
//   pallas_call at :257: the TPU's fallback for the shapes the lane-packed
//   layout does not take (heads that do not fill 128-lane groups), which
//   carries the SVD UNet's level-0 self-attention (5 heads of 64).  Same
//   function as both Pallas bodies: non-causal softmax(q k^T * scale + bias)
//   v with the true running row max (no bound, no shift: SVD logits are not
//   clipped), an optional f32 key bias [B, 1, 1, K], padded keys at -1e30, p
//   rounded to bf16 before P*V, f32 accumulation, bf16 out.  It reads
//   [B, S, H, D] as it lies, which is [B, S, H*D] with any H (a head is a
//   D-wide column slice, addressed by stride): the TPU's [B*H, S, D]
//   transposes were a tiling choice and are gone.
// What bounds it: arithmetic.  At the SVD path shape (B = 28 frames of a
//   CFG pair, S = K = 72*128 = 9216, H = 5, D = 64) one call is 3.04 TFLOP,
//   3.08 ms at the bf16 peak; q/k/v/out are 0.66 GB, 0.2 ms at 3.35 TB/s.
// What the design does about it: both products run on the tensor cores
//   (mma.sync m16n8k16 bf16 -> f32) with every intermediate in registers.
//   One CTA of 8 warps owns a 128-row q tile of one (batch, head); each warp
//   owns 16 rows, keeps its q as A fragments, its 16 x 64 score tile and its
//   16 x D output accumulator in registers, and runs the online softmax
//   there: no [rows, K] score tile is ever stored.  p is rounded to bf16 and
//   re-used directly as the A operand of P*V, as on the TPU.  K/V stream
//   through shared memory in 64-key tiles, double-buffered with cp.async so
//   the next tile's loads overlap this tile's math; fragments come from
//   shared memory by ldmatrix (V transposed on load), with padded rows so
//   those loads are free of bank conflicts.  mma.sync cannot reach the
//   wgmma rate (K1 on this template reached a fifth of its bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;      // q rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 8;     // 16 q rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded row pitch (bf16): conflict-free ldmatrix
  static constexpr size_t BYTES = sizeof(bf16) * (BQ + 4 * BK) * LD;  // q + 2x(k, v)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulation
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q, k, v [B, S|K, H*D] bf16, bias f32 [B, K] or null, out [B, S, H*D]
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       bf16* __restrict__ out, int S, int K, int H, float scale) {
  constexpr int LD = Smem<D>::LD;
  constexpr int VEC = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t HD = (int64_t)H * D;
  const bf16* qb = q + (int64_t)b * S * HD + (int64_t)h * D;
  const bf16* kb = k + (int64_t)b * K * HD + (int64_t)h * D;
  const bf16* vb = v + (int64_t)b * K * HD + (int64_t)h * D;
  const float* biasb = bias ? bias + (int64_t)b * K : nullptr;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * VEC; i += THREADS) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const bool valid = k0 + r < K;
      const int64_t off = (int64_t)(valid ? k0 + r : 0) * HD + c;
      cp_async16(smem_u32(Ks + (buf * BK + r) * LD + c), kb + off, valid);
      cp_async16(smem_u32(Vs + (buf * BK + r) * LD + c), vb + off, valid);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q tile -> shared
  for (int i = tid; i < BQ * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8, row = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < S) val = *reinterpret_cast<const uint4*>(qb + (int64_t)row * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  // ldmatrix addressing: lane l feeds row (l % 8) of 8x8 matrix (l / 8)
  const int mi = lane / 8, mr = lane % 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], smem_u32(Qs + (warp * 16 + (mi % 2) * 8 + mr) * LD + kk * 16 + (mi / 2) * 8));

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  const int ntiles = (K + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * BK * LD;
    const bf16* Vt = Vs + (it & 1) * BK * LD;

    // scores s[16 x BK] = q . k^T, in n8 tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, smem_u32(Kt + (8 * (j + mi / 2) + mr) * LD + kk * 16 + (mi % 2) * 8));
        mma16816(s[j], qf[kk], bfr[0], bfr[1]);
        mma16816(s[j + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // online softmax: this thread holds rows lane/4 (e = 0, 1) and lane/4 + 8
    // (e = 2, 3), keys 8j + 2*(lane%4) + (e & 1)
    const int k0 = it * BK;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        float val = s[j][e] * scale;
        if (biasb && key < K) val += biasb[key];
        val = key < K ? val : NEG;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        s[j][e] = p;
        rowsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // o[16 x D] += p . v: the score accumulators of two n8 tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                             pack_bf16(s[2 * t][2], s[2 * t][3]),
                             pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                             pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, smem_u32(Vt + (16 * t + (mi % 2) * 8 + mr) * LD + 8 * (n + mi / 2)));
        mma16816(o[n], a, bfr[0], bfr[1]);
        mma16816(o[n + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int row0 = q0 + warp * 16 + lane / 4;
  bf16* ob = out + (int64_t)b * S * HD + (int64_t)h * D + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row0 * HD + 8 * n) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)(row0 + 8) * HD + 8 * n) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int S, int K, int H, float scale, cudaStream_t st) {
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, Smem<D>::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), S, K, H, scale);
  return cudaGetLastError();
}

}  // namespace

// K6: q, k, v [B, S|K, H, D] bf16, optional bias f32 [B, 1, 1, K], out
// [B, S, H, D] bf16
extern "C" int cvt_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int S, int K, int H,
                                   int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(q, k, v, bias, out, B, S, K, H, scale, st);
  if (D == 128) return (int)launch<128>(q, k, v, bias, out, B, S, K, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
