// The tensor-core tile of the quantized-matmul kernels (quant_matmul.cu's
// qmm_mma_kernel, fused_expert.cu's fused_mma_kernel): one block's 64 x
// 128 tile of x @ dequant(W) over all of K, for a bit-plane-packed W.
//
//  * Exact codes, factored dequant: dequant(W)[k,n] = (q - z[g,n]) * s[g,n]
//    with integer codes q in 0..255, which bf16 holds exactly.  Per 64-row
//    pack block the block computes t = x @ q with mma.sync m16n8k16 bf16
//    (f32 accumulate) and folds acc += s * (t - z * xsum) in f32, the same
//    factoring as the CUDA-core walk (quant_tile.cuh).
//  * Hi/lo activations: x = x_hi + x_lo with x_hi = bf16(x) and x_lo =
//    bf16(x - x_hi), both multiplied by the same exact codes, so x keeps
//    about 16 bits of mantissa (relative error ~2^-18 per element, against
//    ~2^-9 for one bf16 pass) and W loses nothing; xsum is summed from the
//    same x_hi + x_lo.  8-bit codes, whose dequantized weights can be up
//    to 128x wider, take a third part bf16(x - x_hi - x_lo) (~24 bits): with
//    two, the x error summed over K 8192 reached 1.5e-3 on outputs near 0,
//    above the f32 kernel's tolerance (1e-3 + 1e-4 |y|).
//  * 8 warps of 32 x 32 (2 x 4 m16n8 fragments), 128 registers, so two
//    blocks share an SM.  A cp.async ring brings each pack block's raw x
//    (f32), plane words and scale/zero into shared memory two pack blocks
//    ahead; the block then splits x into hi/lo bf16 and unpacks the codes
//    once into a bf16 (k, n) tile, both padded so that ldmatrix(.trans)
//    reads them without bank conflicts.  Ragged M and N are masked (zero
//    fill on load), not padded.
//  * MASKED tiles (fused_expert.cu's experts) take a null plane pointer for
//    a plane above the expert's true width: its words load as zeros and
//    are not read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace quant_tile {

constexpr int MM_BM = 64;             // tokens per block
constexpr int MM_WM = MM_BM / 2;      // tokens per warp (2 x 4 warps)
constexpr int MM_MT = MM_WM / 16;     // m16 fragments per warp
constexpr int A_LD = PACK + 8;        // bf16 row stride of the x part tiles
constexpr int B_LD = BN + 8;          // bf16 row stride of the code tile
// shared memory of one block when two share an SM (228 KB, 1 KB of it
// reserved per block)
constexpr int SMEM_HALF_SM = (228 - 2) * 1024 / 2;

// Dynamic shared memory of mma_tile<BITS>: RING stages of raw inputs (x
// f32, scale/zero f32, plane bytes) filled by cp.async, then the operand
// buffer (the NX bf16 parts of x and the code tile, per-token sums of x,
// scale/zero) that the mma reads.
template <int BITS> struct MmaSmem {
  // bf16 parts of x: hi + lo (~16 bits of mantissa); 8-bit codes, whose
  // dequantized weights are up to 128x wider, also take a third part
  // (~24 bits), or the x error summed over K reaches the f32 tolerance
  static constexpr int NX = BITS == 8 ? 3 : 2;
  static constexpr int L0 = PACK * Fmt<BITS>::P0 / 8;  // plane rows per
  static constexpr int L1 = PACK * Fmt<BITS>::P1 / 8;  // pack block
  static constexpr int XS = MM_BM * PACK * 4;
  static constexpr int SZ = 2 * BN * 4;
  static constexpr int PL = (L0 + L1) * BN;
  static constexpr int STAGE = XS + SZ + PL;
  static constexpr int AT = MM_BM * A_LD * 2;
  static constexpr int BT = PACK * B_LD * 2;
  static constexpr int OP = NX * AT + BT + MM_BM * 4 + SZ;
  static constexpr int RING = 3 * STAGE + OP <= SMEM_HALF_SM ? 3 : 2;
  static constexpr int TOTAL = RING * STAGE + OP;
  static_assert(TOTAL <= SMEM_HALF_SM, "two blocks no longer fit an SM");
};

// The operand buffer (layout of MmaSmem::OP): x part p at ax + p * MM_BM
// * A_LD.
template <int NX>
struct MmaOperands {
  __nv_bfloat16 *ax, *bt;
  float *xsum, *sz;
  __device__ __forceinline__ explicit MmaOperands(char* base)
      : ax(reinterpret_cast<__nv_bfloat16*>(base)),
        bt(ax + NX * MM_BM * A_LD),
        xsum(reinterpret_cast<float*>(bt + PACK * B_LD)),
        sz(xsum + MM_BM) {}
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of BYTES (4 or 16); zero fill when !ok (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Queue the raw inputs of pack block pb for tokens m0.. and columns n0..
// into one ring stage: x rows (16-byte copies, rows at or past a.C zero),
// the pack block's scale and zero row, the plane words (4-byte copies,
// columns at or past N zero; with MASKED, a null plane's words zero too).
template <int BITS, bool MASKED>
__device__ __forceinline__ void mma_load_stage(const Args& a, char* stage,
                                               int pb, int m0, int n0) {
  using S = MmaSmem<BITS>;
  const int tid = threadIdx.x;
  const int M = a.C, N = a.N;
  float* xs = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int i = 0; i < MM_BM * PACK / 4 / (WARPS * 32); ++i) {
    const int c = tid + i * WARPS * 32;
    const int row = c / (PACK / 4), k = (c % (PACK / 4)) * 4;
    const bool ok = m0 + row < M;
    cp_async<16>(xs + row * PACK + k,
                 ok ? a.x + (size_t)(m0 + row) * a.K + pb * PACK + k : a.x,
                 ok);
  }
  if (tid < 2 * BN / 4) {
    const float* src = tid < BN / 4 ? a.scale : a.zero;
    const int col = n0 + (tid % (BN / 4)) * 4;
    const int g = pb * PACK / a.group_size;
    const bool ok = col < N;
    cp_async<16>(reinterpret_cast<float*>(stage + S::XS) + tid * 4,
                 ok ? src + (size_t)g * N + col : src, ok);
  }
  uint8_t* pl = reinterpret_cast<uint8_t*>(stage + S::XS + S::SZ);
  for (int w = tid; w < (S::L0 + S::L1) * (BN / 4); w += WARPS * 32) {
    const int row = w / (BN / 4), col = n0 + (w % (BN / 4)) * 4;
    const uint8_t* src =
        row < S::L0 ? a.plane0 + ((size_t)pb * S::L0 + row) * N
                    : a.plane1 + ((size_t)pb * S::L1 + row - S::L0) * N;
    if constexpr (MASKED) {
      const bool ok = col < N && (row < S::L0 ? a.plane0 : a.plane1);
      cp_async<4>(pl + w * 4, ok ? src + col : (const void*)a.scale, ok);
    } else {
      const bool ok = col < N;
      cp_async<4>(pl + w * 4, ok ? src + col : a.plane0, ok);
    }
  }
}

// One ring stage into an operand buffer: x -> its NX bf16 parts (x_hi =
// bf16(x), x_lo = bf16(x - x_hi), ...; row-major (token, k)) and
// xsum[token] = sum_k of their sum; the plane words -> codes as bf16
// (k, n); scale/zero copied.  Thread t converts x
// chunks t + 256 i (16 threads per token row, reduced by shuffles) and the
// codes of columns 4 (t % 32) .. +3 at rows k = t / 32 + 8 i.
template <int BITS>
__device__ __forceinline__ void mma_convert(
    const char* stage, const MmaOperands<MmaSmem<BITS>::NX>& op) {
  using S = MmaSmem<BITS>;
  constexpr int P0 = Fmt<BITS>::P0, P1 = Fmt<BITS>::P1;
  constexpr uint32_t M0 = ((1u << P0) - 1u) * 0x01010101u;
  const int tid = threadIdx.x;
  const float* xs = reinterpret_cast<const float*>(stage);
  static_assert(2 * BN == WARPS * 32, "one scale/zero value per thread");
  op.sz[tid] = reinterpret_cast<const float*>(stage + S::XS)[tid];
#pragma unroll
  for (int i = 0; i < MM_BM * PACK / 4 / (WARPS * 32); ++i) {
    const int c = tid + i * WARPS * 32;
    const int row = c / (PACK / 4), k = (c % (PACK / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(xs + row * PACK + k);
    float r[4] = {v.x, v.y, v.z, v.w};   // what the parts so far leave
    float xt[4] = {0.f, 0.f, 0.f, 0.f};  // the sum of the parts
#pragma unroll
    for (int p = 0; p < S::NX; ++p) {
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(r[0], r[1]);
      const __nv_bfloat162 h1 = __floats2bfloat162_rn(r[2], r[3]);
      const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
      const float f[4] = {f0.x, f0.y, f1.x, f1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xt[e] += f[e];
        r[e] -= f[e];
      }
      *reinterpret_cast<uint2*>(op.ax + (p * MM_BM + row) * A_LD + k) =
          make_uint2(bf2_bits(h0), bf2_bits(h1));
    }
    float s = (xt[0] + xt[1]) + (xt[2] + xt[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    if (k == 0) op.xsum[row] = s;
  }
  const uint8_t* pl = reinterpret_cast<const uint8_t*>(stage + S::XS + S::SZ);
  const int w4 = (tid % 32) * 4;
#pragma unroll
  for (int i = 0; i < PACK / WARPS; ++i) {
    const int k = tid / 32 + WARPS * i;
    // plane-0 chunk j sits at bit offset j*P0 of rows [j*L0, (j+1)*L0)
    uint32_t codes =
        (*reinterpret_cast<const uint32_t*>(pl + (k % S::L0) * BN + w4) >>
         ((k / S::L0) * P0)) & M0;
    if constexpr (P1 != 0) {
      constexpr uint32_t M1 = ((1u << P1) - 1u) * 0x01010101u;
      codes |= ((*reinterpret_cast<const uint32_t*>(
                     pl + (S::L0 + k % S::L1) * BN + w4) >>
                 ((k / S::L1) * P1)) & M1) << P0;
    }
    const __nv_bfloat162 c01 = __floats2bfloat162_rn(byte_to_float(codes, 0),
                                                     byte_to_float(codes, 1));
    const __nv_bfloat162 c23 = __floats2bfloat162_rn(byte_to_float(codes, 2),
                                                     byte_to_float(codes, 3));
    *reinterpret_cast<uint2*>(op.bt + k * B_LD + w4) =
        make_uint2(bf2_bits(c01), bf2_bits(c23));
  }
}

// acc = x[m0 .. m0+63] @ dequant(W)[:, n0 .. n0+127] over all K / 64 pack
// blocks of a (rows at or past a.C read as zero).  Warp (wm, wn) = (warp /
// 4, warp % 4) owns rows wm*32 .. and columns wn*32 .. as 2 x 4 m16n8
// fragments: acc[i][j] holds rows +i*16+g (elements 0, 1) and +8 (2, 3),
// columns +j*8+2*(lane%4) and +1, with g = lane / 4.  smem: the block's
// MmaSmem<BITS>::TOTAL bytes of dynamic shared memory.  MASKED: see
// mma_load_stage.  Returns with every copy landed but no barrier after the
// last mma.
template <int BITS, bool MASKED = false>
__device__ __forceinline__ void mma_tile(const Args& a, char* smem, int m0,
                                         int n0, float (&acc)[MM_MT][4][4]) {
  using S = MmaSmem<BITS>;
  char* ring = smem;
  const MmaOperands<S::NX> op(smem + S::RING * S::STAGE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tq = lane % 4;       // fragment row / column pair
  const int n_pb = a.K / PACK;

  // ldmatrix lane addresses: lane l names row l % 8 of 8x8 matrix l / 8.
  // A (x4): matrices (rows +0/+8) x (k +0/+8) -> a0a1, a2a3, a4a5, a6a7.
  // B (x4.trans): (k +0/+8) x (n +0/+8) -> b0b1, b2b3 of two n8 tiles.
  const int lr = lane % 8, lm = lane / 8;
  const uint32_t a_off =
      ((wm * MM_WM + (lm % 2) * 8 + lr) * A_LD + (lm / 2) * 8) * 2;
  const uint32_t ax_s = smem_addr(op.ax) + a_off;
  const uint32_t bt_s = smem_addr(op.bt) +
      (((lm % 2) * 8 + lr) * B_LD + wn * 32 + (lm / 2) * 8) * 2;

#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Ring: stage s % RING holds pack block s from its cp.async until its
  // conversion.  Iteration pb waits for pack block pb, refills the stage
  // that pb - 1 left, converts pb into the operand buffer and runs its mma.
#pragma unroll
  for (int s = 0; s < S::RING - 1; ++s) {
    if (s < n_pb)
      mma_load_stage<BITS, MASKED>(a, ring + s * S::STAGE, s, m0, n0);
    cp_async_commit();
  }
  for (int pb = 0; pb < n_pb; ++pb) {
    cp_async_wait<S::RING - 2>();       // this thread's copies of pb landed
    __syncthreads();                    // everyone's; last block's mma done
    const int nx = pb + S::RING - 1;
    if (nx < n_pb)
      mma_load_stage<BITS, MASKED>(a, ring + (nx % S::RING) * S::STAGE, nx,
                                   m0, n0);
    cp_async_commit();
    mma_convert<BITS>(ring + (pb % S::RING) * S::STAGE, op);
    __syncthreads();

    float t[MM_MT][4][4];
#pragma unroll
    for (int i = 0; i < MM_MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PACK / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt_s + (kk * 16 * B_LD + p * 16) * 2);
        b[2 * p][0] = r[0]; b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2]; b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int h = 0; h < S::NX; ++h) {  // x_hi, x_lo, ...
        uint32_t af[MM_MT][4];
#pragma unroll
        for (int i = 0; i < MM_MT; ++i)
          ldsm_x4(af[i], ax_s + ((h * MM_BM + i * 16) * A_LD + kk * 16) * 2);
#pragma unroll
        for (int i = 0; i < MM_MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(t[i][j], af[i], b[j][0], b[j][1]);
      }
    }
    // fold the pack block: acc += s * (t - z * xsum)
    float xr[MM_MT][2];
#pragma unroll
    for (int i = 0; i < MM_MT; ++i) {
      xr[i][0] = op.xsum[wm * MM_WM + i * 16 + g];
      xr[i][1] = op.xsum[wm * MM_WM + i * 16 + g + 8];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cn = wn * 32 + j * 8 + 2 * tq;
      const float2 sv = *reinterpret_cast<const float2*>(op.sz + cn);
      const float2 zv = *reinterpret_cast<const float2*>(op.sz + BN + cn);
#pragma unroll
      for (int i = 0; i < MM_MT; ++i) {
        acc[i][j][0] += sv.x * (t[i][j][0] - zv.x * xr[i][0]);
        acc[i][j][1] += sv.y * (t[i][j][1] - zv.y * xr[i][0]);
        acc[i][j][2] += sv.x * (t[i][j][2] - zv.x * xr[i][1]);
        acc[i][j][3] += sv.y * (t[i][j][3] - zv.y * xr[i][1]);
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace quant_tile
