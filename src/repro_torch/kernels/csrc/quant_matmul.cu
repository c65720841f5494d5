// Quantized matmul with the optional low-rank compensation epilogue, for
// Hopper: y = x @ dequant(Wq) [+ mask_r((x*mask) @ (U*us)) * vs @ V].
//
// Replaces the TPU kernels repro/kernels/quant_matmul.py::quant_matmul_pallas
// and lowrank_comp_matmul_pallas (both _pallas_qmm, body _qmm_kernel).  The
// TPU kernel takes the rank-space activation xu precomputed by its ops
// wrapper; here the kernel computes it, from the int8 U and its scales.
//
// Shapes on the dense path (Llama-3.2-3B, one layer): w1/w3 K 3072 x N 8192,
// w2 K 8192 x N 3072, 2 bits, g64, rank 32; M = 4 at decode, 1024 prefill.
//
// Two paths, chosen by the token count M (kMmaMinM = 128):
//
// Decode, M < kMmaMinM: qmm_splitk_kernel, on CUDA cores.  It is bound by
// the bytes of the packed planes + f32 scale/zero + int8 U/V (about 9.8 MB
// per projection, 2.9 us at 3.35 TB/s).
//  * At E = 1 a grid of (tokens/ct, N/128) has 64 blocks for w1/w3 and 24
//    for w2 at decode, on 132 SMs, so the kernel also splits K over blocks
//    (grid z), chosen by the wrapper so that the decode grid holds at least
//    two blocks per SM with at least one pack block per warp.  Each block
//    runs the fused kernel's K walk (quant_tile.cuh) over its K split and
//    writes an f32 partial.
//  * One extra column of blocks computes the rank-space partial x @ U of
//    each (token tile, K split) while the other blocks walk the weights
//    (rows whose mask is 0 skipped), so xu costs no launch of its own; its
//    threads split the rows 32 ways and take 4 ranks each.
//
// Prefill, M >= kMmaMinM: qmm_mma_kernel, on the tensor cores.  The
// arithmetic bounds it: 2*M*K*N is 0.78 ms for a 3072 x 8192 projection at
// M 1024 on the CUDA cores (67 TFLOP/s f32), 0.104 ms as the two bf16
// products below on the tensor cores (989 TFLOP/s dense).
//  * Exact codes, factored dequant: dequant(W)[k,n] = (q - z[g,n]) * s[g,n]
//    with integer codes q in 0..255, which bf16 holds exactly.  Per 64-row
//    pack block the block computes t = x @ q with mma.sync m16n8k16 bf16
//    (f32 accumulate) and folds acc += s * (t - z * xsum) in f32, the same
//    factoring as the CUDA-core walk.
//  * Hi/lo activations: x = x_hi + x_lo with x_hi = bf16(x) and x_lo =
//    bf16(x - x_hi), both multiplied by the same exact codes, so x keeps
//    about 16 bits of mantissa (relative error ~2^-18 per element, against
//    ~2^-9 for one bf16 pass) and W loses nothing; xsum is summed from the
//    same x_hi + x_lo.  8-bit codes, whose dequantized weights can be up
//    to 128x wider, take a third part bf16(x - x_hi - x_lo) (~24 bits): with
//    two, the x error summed over K 8192 reached 1.5e-3 on outputs near 0,
//    above the f32 kernel's tolerance (1e-3 + 1e-4 |y|).
//  * Tile: one block per (64 tokens, 128 columns), 8 warps of 32 x 32 (2 x 4
//    m16n8 fragments), 128 registers, so two blocks share an SM.  A 3-stage
//    cp.async ring brings each pack block's raw x (f32), plane words and
//    scale/zero into shared memory two pack blocks ahead; the block then
//    splits x into hi/lo bf16 and unpacks the codes once into a bf16
//    (k, n) tile, both padded so that ldmatrix(.trans) reads them without
//    bank conflicts.  Ragged M and N are masked (zero fill on load,
//    guarded stores), not padded.
//  * What holds it back (tools/qmm_mma_ablation.py disables parts of the
//    loop on the H100): the mma.sync phase, the conversion and the loads
//    with their barriers each take about a third of the time and barely
//    overlap, even with two blocks per SM.  Neither interleaving the next
//    pack block's conversion into the mma nor producer/consumer warps nor
//    a deeper ring made it faster.  wgmma with TMA-fed shared-memory
//    operands is the next step.
//  * The rank-space partials come from 8 extra columns of blocks, one
//    8-token chunk each (the decode path's xu_split), scheduled first.  K
//    splits = 1; the second launch adds the epilogue.
//  * Why kMmaMinM = 128: below it the mma grid (ceil(M/64) x N/128 blocks)
//    leaves SMs idle while the split-K grid still fills the card.  Per
//    Llama-3.2-3B layer (w1 + w3 + w2, 2 bits) split-K is faster up to
//    M 96 and the mma path from M 128 (w1 alone crosses over near M 64,
//    w2 between M 128 and 256; chip_smoke.py prints the crossover,
//    PERF.md records it).
//
// Both paths: qmm_reduce_kernel sums the K splits in a fixed order (no
// atomics, so the result is the same from run to run), reduces xu and
// scales it by mask, rank cap, us and vs, and adds xu @ V.  Two launches
// per compensated projection.
//
// Plain C interface (route b of the build): each entry point returns
// cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace quant_tile;

constexpr int MAXR = 1024;        // largest rank (RANK_BUCKETS' top)
constexpr int RED_THREADS = 64;   // second pass: 4 columns per thread

__device__ __forceinline__ int rank_limit(const int* rank_cap, int R) {
  int r = R;
  if (rank_cap != nullptr) r = min(r, rank_cap[0]);
  return max(r, 0);
}

// Rank-space partial of one (token tile, K split): xu_part[ks, m, r] =
// sum over rows [k_begin, k_end) of x[m, k] * u[k, r], for r < r_end.
// Thread t takes ranks r0 + 4*(t%8) .. +3 and every 32nd row from t/8;
// the 32 row slices meet in shared memory (smem: CT*1024 floats).
template <int CT>
__device__ __forceinline__ void xu_split(const float* __restrict__ x,
                                         const int8_t* __restrict__ u,
                                         float* __restrict__ xu_part,
                                         float* smem, int M, int K, int R,
                                         int r_end, int c0, int ks,
                                         int k_begin, int k_end) {
  const int q = threadIdx.x % 8, slice = threadIdx.x / 8;
  const bool vec = R % 4 == 0;
  for (int r0 = 0; r0 < r_end; r0 += 32) {
    const int r = r0 + 4 * q;
    float acc[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
    if (r < r_end) {
#pragma unroll 4
      for (int k = k_begin + slice; k < k_end; k += 32) {
        const int8_t* ur = u + (size_t)k * R + r;
        float uv[4];
        if (vec) {
          const char4 w = *reinterpret_cast<const char4*>(ur);
          uv[0] = w.x; uv[1] = w.y; uv[2] = w.z; uv[3] = w.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) uv[i] = r + i < R ? (float)ur[i] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float xv = c0 + c < M ? x[(size_t)(c0 + c) * K + k] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] += xv * uv[i];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        smem[(c * 32 + slice) * 32 + 4 * q + i] = acc[c][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * 32; idx += WARPS * 32) {
      const int c = idx / 32, rr = idx % 32;
      if (c0 + c >= M || r0 + rr >= r_end) continue;
      float sum = 0.f;
#pragma unroll 8
      for (int sl = 0; sl < 32; ++sl) sum += smem[(c * 32 + sl) * 32 + rr];
      xu_part[((size_t)ks * M + c0 + c) * R + r0 + rr] = sum;
    }
  }
}

// Block (token tile, 128-column tile, K split).  partial (KS, M, N) f32.
// When u is given, the blocks of the extra column tile y = ceil(N/128)
// write xu_part (KS, M, R) f32 instead, for rank < min(R, rank_cap), if a
// row of their token tile has a non-zero mask.
template <int BITS, int CT>
__global__ void __launch_bounds__(WARPS * 32)
qmm_splitk_kernel(Args a, const int8_t* __restrict__ u,
                  const float* __restrict__ mask,
                  const int* __restrict__ rank_cap,
                  float* __restrict__ partial, float* __restrict__ xu_part,
                  int R, int kch) {
  const int M = a.C, K = a.K, N = a.N;
  const int c0 = blockIdx.x * CT;
  const int n0 = blockIdx.y * BN;
  const int ks = blockIdx.z;
  const int pb_begin = ks * kch;
  const int pb_end = min(K / PACK, pb_begin + kch);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * 4;
  const bool col_ok = col < N;

  __shared__ __align__(16) float smem[WARPS * CT * BN];
  if (n0 >= N) {                     // the rank-space column
    const int r_end = rank_limit(rank_cap, R);
    bool any = false;
    for (int c = 0; c < CT; ++c)
      any |= c0 + c < M && (mask == nullptr || mask[c0 + c] != 0.f);
    if (any && r_end > 0)
      xu_split<CT>(a.x, u, xu_part, smem, M, K, R, r_end, c0, ks,
                   pb_begin * PACK, pb_end * PACK);
    return;
  }
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  warp_k_walk<BITS, CT>(a, M, 0, c0, pb_begin, pb_end, warp, lane, col,
                        col_ok, 0xFFFFFFFFu, 0xFFFFFFFFu,
                        smem + warp * CT * PACK, acc);

  // cross-warp reduction through shared memory
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      smem[(warp * CT + c) * BN + lane * 4 + i] = acc[c][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < CT * BN; idx += WARPS * 32) {
    const int c = idx / BN, nn = idx % BN;
    const int n = n0 + nn;
    if (c0 + c >= M || n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += smem[(w * CT + c) * BN + nn];
    partial[((size_t)ks * M + c0 + c) * N + n] = y;
  }
}

// Block (row m, 256 columns); 4 columns per thread.
// out[m, n] = sum_ks partial[ks, m, n] + sum_r xu[m, r] * v[r, n] with
// xu[m, r] = mask[m] * us[r] * vs[r] * sum_ks xu_part[ks, m, r] for
// r < min(R, rank_cap) (no compensation when xu_part is null or the
// row's mask is 0).  The K splits are summed in a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
qmm_reduce_kernel(const float* __restrict__ partial,
                  const float* __restrict__ xu_part,
                  const int8_t* __restrict__ v,
                  const float* __restrict__ u_scale,
                  const float* __restrict__ v_scale,
                  const float* __restrict__ mask,
                  const int* __restrict__ rank_cap,
                  float* __restrict__ out, int M, int N, int R, int KS) {
  const int m = blockIdx.x;
  const int col = (blockIdx.y * RED_THREADS + threadIdx.x) * 4;
  __shared__ float xus[MAXR];
  const float mk = mask != nullptr ? mask[m] : 1.f;
  const int r_end = (xu_part != nullptr && mk != 0.f)
                        ? rank_limit(rank_cap, R) : 0;
  for (int r = threadIdx.x; r < r_end; r += RED_THREADS) {
    float s = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) s += xu_part[((size_t)ks * M + m) * R + r];
    xus[r] = s * mk * u_scale[r] * v_scale[r];
  }
  __syncthreads();
  if (col >= N) return;
  float4 y = *reinterpret_cast<const float4*>(partial + (size_t)m * N + col);
#pragma unroll 4
  for (int ks = 1; ks < KS; ++ks) {
    const float4 p = *reinterpret_cast<const float4*>(
        partial + ((size_t)ks * M + m) * N + col);
    y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
  }
#pragma unroll 8
  for (int r = 0; r < r_end; ++r) {
    const char4 vv = *reinterpret_cast<const char4*>(v + (size_t)r * N + col);
    const float xr = xus[r];
    y.x += xr * (float)vv.x; y.y += xr * (float)vv.y;
    y.z += xr * (float)vv.z; y.w += xr * (float)vv.w;
  }
  *reinterpret_cast<float4*>(out + (size_t)m * N + col) = y;
}

template <int BITS>
void launch_splitk(int ct, dim3 grid, cudaStream_t stream, const Args& a,
                   const int8_t* u, const float* mask, const int* rank_cap,
                   float* partial, float* xu_part, int R, int kch) {
  const dim3 block(WARPS * 32);
#define QMM_LAUNCH(CTV)                                                  \
  qmm_splitk_kernel<BITS, CTV><<<grid, block, 0, stream>>>(              \
      a, u, mask, rank_cap, partial, xu_part, R, kch)
  switch (ct) {
    case 1: QMM_LAUNCH(1); break;
    case 2: QMM_LAUNCH(2); break;
    case 4: QMM_LAUNCH(4); break;
    default: QMM_LAUNCH(8); break;
  }
#undef QMM_LAUNCH
}

// ---------------------------------------------------------------------------
// prefill: the tensor-core path
// ---------------------------------------------------------------------------

constexpr int kMmaMinM = 128;         // tokens from which the mma path runs
constexpr int MM_BM = 64;             // tokens per block
constexpr int MM_WM = MM_BM / 2;      // tokens per warp (2 x 4 warps)
constexpr int MM_MT = MM_WM / 16;     // m16 fragments per warp
constexpr int A_LD = PACK + 8;        // bf16 row stride of the x part tiles
constexpr int B_LD = BN + 8;          // bf16 row stride of the code tile
constexpr int XU_CHUNKS = MM_BM / 8;  // rank-space blocks per token tile
// shared memory of one block when two share an SM (228 KB, 1 KB of it
// reserved per block)
constexpr int SMEM_HALF_SM = (228 - 2) * 1024 / 2;

// Dynamic shared memory of qmm_mma_kernel<BITS>: RING stages of raw
// inputs (x f32, scale/zero f32, plane bytes) filled by cp.async, then the
// operand buffer (the NX bf16 parts of x and the code tile, per-token sums
// of x, scale/zero) that the mma reads.
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
  static_assert(TOTAL >= 8 * 1024 * 4, "xu_split<8> scratch");
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
// into one ring stage: x rows (16-byte copies, rows at or past M zero),
// the pack block's scale and zero row, the plane words (4-byte copies,
// columns at or past N zero).
template <int BITS>
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
    const bool ok = col < N;
    cp_async<4>(pl + w * 4, ok ? src + col : a.plane0, ok);
  }
}

// One ring stage into an operand buffer: x -> its NX bf16 parts (x_hi =
// bf16(x), x_lo = bf16(x - x_hi), ...; row-major (token, k)) and
// xsum[token] = sum_k of their sum; the plane words -> codes as bf16
// (k, n); scale/zero copied.  Thread t converts x chunks t + 256 i (16
// threads per token row, reduced by shuffles) and the codes of columns
// 4 (t % 32) .. +3 at rows k = t / 32 + 8 i.
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

// Block (64-token tile x, column tile).  With u given, column tiles
// 0 .. XU_CHUNKS-1 are the rank-space blocks: each writes xu_part (1, M, R)
// for one 8-token chunk of its token tile (if a row of it has a non-zero
// mask, for rank < min(R, rank_cap)); tile y >= XU_CHUNKS is weight
// column tile y - XU_CHUNKS.  A weight block writes dst (M, N) f32 =
// x @ dequant(W) for its 64 x 128 tile: warp (wm, wn) owns rows wm*32..
// and columns wn*32.. as 2 x 4 m16n8 fragments.  Two blocks share an SM,
// so one converts its next pack block while the other runs its mma.
template <int BITS>
__global__ void __launch_bounds__(WARPS * 32, 2)
qmm_mma_kernel(Args a, const int8_t* __restrict__ u,
               const float* __restrict__ mask,
               const int* __restrict__ rank_cap, float* __restrict__ dst,
               float* __restrict__ xu_part, int R) {
  using S = MmaSmem<BITS>;
  extern __shared__ __align__(16) char smem[];
  const int M = a.C, K = a.K, N = a.N;
  const int m0 = blockIdx.x * MM_BM;
  int ty = blockIdx.y;
  if (u != nullptr) {
    if (ty < XU_CHUNKS) {              // a rank-space block
      const int c0 = m0 + ty * 8;
      const int r_end = rank_limit(rank_cap, R);
      bool any = false;
      for (int c = 0; c < 8; ++c)
        any |= c0 + c < M && (mask == nullptr || mask[c0 + c] != 0.f);
      if (any && r_end > 0)
        xu_split<8>(a.x, u, xu_part, reinterpret_cast<float*>(smem), M, K,
                    R, r_end, c0, 0, 0, K);
      return;
    }
    ty -= XU_CHUNKS;
  }
  const int n0 = ty * BN;
  char* ring = smem;
  const MmaOperands<S::NX> op(smem + S::RING * S::STAGE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tq = lane % 4;       // fragment row / column pair
  const int n_pb = K / PACK;

  // ldmatrix lane addresses: lane l names row l % 8 of 8x8 matrix l / 8.
  // A (x4): matrices (rows +0/+8) x (k +0/+8) -> a0a1, a2a3, a4a5, a6a7.
  // B (x4.trans): (k +0/+8) x (n +0/+8) -> b0b1, b2b3 of two n8 tiles.
  const int lr = lane % 8, lm = lane / 8;
  const uint32_t a_off =
      ((wm * MM_WM + (lm % 2) * 8 + lr) * A_LD + (lm / 2) * 8) * 2;
  const uint32_t ax_s = smem_addr(op.ax) + a_off;
  const uint32_t bt_s = smem_addr(op.bt) +
      (((lm % 2) * 8 + lr) * B_LD + wn * 32 + (lm / 2) * 8) * 2;

  float acc[MM_MT][4][4];
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
    if (s < n_pb) mma_load_stage<BITS>(a, ring + s * S::STAGE, s, m0, n0);
    cp_async_commit();
  }
  for (int pb = 0; pb < n_pb; ++pb) {
    cp_async_wait<S::RING - 2>();       // this thread's copies of pb landed
    __syncthreads();                    // everyone's; last block's mma done
    const int nx = pb + S::RING - 1;
    if (nx < n_pb)
      mma_load_stage<BITS>(a, ring + (nx % S::RING) * S::STAGE, nx, m0, n0);
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
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * MM_WM + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + 2 * tq;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<float2*>(dst + (size_t)row * N + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * N + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <int BITS>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const Args& a,
                       const int8_t* u, const float* mask,
                       const int* rank_cap, float* dst, float* xu_part,
                       int R) {
  constexpr int bytes = MmaSmem<BITS>::TOTAL;
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_mma_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  qmm_mma_kernel<BITS><<<grid, WARPS * 32, bytes, stream>>>(
      a, u, mask, rank_cap, dst, xu_part, R);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The arguments of all three entry points:
// x (M,K) f32; plane0/plane1 (K*p/8,N) u8 (plane1 null unless bits==3);
// scale/zero (K/G,N) f32; u (K,R) i8 or null (no compensation: u_scale, v,
// v_scale, mask, rank_cap and xu_part are then ignored); u_scale (1,R) f32;
// v (R,N) i8; v_scale (R,1) f32; mask (M,) f32 or null (= all ones);
// rank_cap (1,) i32 or null (= R); partial (KS,M,N) and xu_part (KS,M,R)
// f32 scratch; out (M,N) f32.  The K splits cover kch pack blocks each:
// KS = ceil((K/64) / kch).
// Requires K % 64 == 0, group_size % 64 == 0, K % group_size == 0,
// N % 4 == 0, R <= 1024; the mma path also KS == 1, kch == K/64 and x
// 16-byte aligned.
#define QMM_PARAMS                                                          \
  const float *x, const uint8_t *plane0, const uint8_t *plane1,             \
      const float *scale, const float *zero, const int8_t *u,               \
      const float *u_scale, const int8_t *v, const float *v_scale,          \
      const float *mask, const int *rank_cap, float *partial,               \
      float *xu_part, float *out, int M, int K, int N, int R, int KS,       \
      int kch, int bits, int group_size, cudaStream_t stream
#define QMM_ARGS                                                            \
  x, plane0, plane1, scale, zero, u, u_scale, v, v_scale, mask, rank_cap,   \
      partial, xu_part, out, M, K, N, R, KS, kch, bits, group_size, stream

// The CUDA-core split-K path (the one quant_matmul_forward takes for
// M < kMmaMinM).
int quant_matmul_splitk(QMM_PARAMS) {
  if (M <= 0) return (int)cudaGetLastError();
  // every split non-empty, all splits together covering K
  if (KS <= 0 || kch <= 0 || (KS - 1) * kch >= K / PACK ||
      KS * kch < K / PACK || R > MAXR ||
      (u != nullptr && R <= 0))
    return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, plane0, plane1, scale, zero, M, K, N, group_size};
  const int ct = token_tile(M);
  // one more column of blocks for the rank-space partials
  const dim3 grid((M + ct - 1) / ct, (N + BN - 1) / BN + (u != nullptr),
                  KS);
  switch (bits) {
    case 1: launch_splitk<1>(ct, grid, stream, a, u, mask, rank_cap, partial, xu_part, R, kch); break;
    case 2: launch_splitk<2>(ct, grid, stream, a, u, mask, rank_cap, partial, xu_part, R, kch); break;
    case 3: launch_splitk<3>(ct, grid, stream, a, u, mask, rank_cap, partial, xu_part, R, kch); break;
    case 4: launch_splitk<4>(ct, grid, stream, a, u, mask, rank_cap, partial, xu_part, R, kch); break;
    case 8: launch_splitk<8>(ct, grid, stream, a, u, mask, rank_cap, partial, xu_part, R, kch); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const dim3 g2(M, (N + RED_THREADS * 4 - 1) / (RED_THREADS * 4));
  qmm_reduce_kernel<<<g2, RED_THREADS, 0, stream>>>(
      partial, u != nullptr ? xu_part : nullptr, v, u_scale, v_scale, mask,
      rank_cap, out, M, N, R, KS);
  return (int)cudaGetLastError();
}

// The tensor-core path (the one quant_matmul_forward takes for
// M >= kMmaMinM).  Without compensation the mma kernel writes out itself
// (one launch); with it, partial, and the reduce pass adds xu @ V.
int quant_matmul_mma(QMM_PARAMS) {
  if (M <= 0) return (int)cudaGetLastError();
  if (KS != 1 || kch != K / PACK || R > MAXR || (u != nullptr && R <= 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, plane0, plane1, scale, zero, M, K, N, group_size};
  const dim3 grid((M + MM_BM - 1) / MM_BM,
                  (N + BN - 1) / BN + (u != nullptr ? XU_CHUNKS : 0));
  float* dst = u != nullptr ? partial : out;
  cudaError_t e;
  switch (bits) {
    case 1: e = launch_mma<1>(grid, stream, a, u, mask, rank_cap, dst, xu_part, R); break;
    case 2: e = launch_mma<2>(grid, stream, a, u, mask, rank_cap, dst, xu_part, R); break;
    case 3: e = launch_mma<3>(grid, stream, a, u, mask, rank_cap, dst, xu_part, R); break;
    case 4: e = launch_mma<4>(grid, stream, a, u, mask, rank_cap, dst, xu_part, R); break;
    case 8: e = launch_mma<8>(grid, stream, a, u, mask, rank_cap, dst, xu_part, R); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (u != nullptr) {
    const dim3 g2(M, (N + RED_THREADS * 4 - 1) / (RED_THREADS * 4));
    qmm_reduce_kernel<<<g2, RED_THREADS, 0, stream>>>(
        partial, xu_part, v, u_scale, v_scale, mask, rank_cap, out, M, N, R,
        1);
  }
  return (int)cudaGetLastError();
}

// The entry point: the tensor-core path from kMmaMinM tokens, else split-K.
int quant_matmul_forward(QMM_PARAMS) {
  return M >= kMmaMinM ? quant_matmul_mma(QMM_ARGS)
                       : quant_matmul_splitk(QMM_ARGS);
}

#undef QMM_PARAMS
#undef QMM_ARGS

}  // extern "C"
