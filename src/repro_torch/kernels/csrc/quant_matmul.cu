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
// What bounds it on the H100: at decode the bytes of the packed planes +
// f32 scale/zero + int8 U/V (about 9.8 MB per projection, 2.9 us at
// 3.35 TB/s); at prefill the CUDA-core arithmetic (2*M*K*N, 0.77 ms for a
// 3072 x 8192 projection at 67 TFLOP/s f32).
//
// What the design does about that:
//  * At E = 1 the fused kernel's grid (tokens/ct, N/128) has 64 blocks for
//    w1/w3 and 24 for w2 at decode, on 132 SMs.  qmm_splitk_kernel also
//    splits K over blocks (grid z), chosen by the wrapper so that the
//    decode grid holds at least two blocks per SM with at least one pack
//    block per warp.  Each block runs the fused kernel's K walk
//    (quant_tile.cuh) over its K split and writes an f32 partial.
//  * One extra column of blocks (grid y = N/128) computes the rank-space
//    partial x @ U of each (token tile, K split) while the other blocks
//    walk the weights (rows whose mask is 0 skipped), so xu costs no
//    launch of its own; its threads split the rows 32 ways and take 4
//    ranks each, so its loads are independent and many are in flight.
//  * qmm_reduce_kernel sums the K splits in a fixed order (no atomics, so
//    the result is the same from run to run), reduces xu and scales it by
//    mask, rank cap, us and vs, and adds xu @ V.  Two launches per
//    projection in all; at prefill the grid is large without a split
//    (K splits = 1) and the second pass only adds the epilogue.
//
// Plain C interface (route b of the build): the entry point returns
// cudaGetLastError() after its launches.
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

}  // namespace

extern "C" {

// x (M,K) f32; plane0/plane1 (K*p/8,N) u8 (plane1 null unless bits==3);
// scale/zero (K/G,N) f32; u (K,R) i8 or null (no compensation: u_scale, v,
// v_scale, mask, rank_cap and xu_part are then ignored); u_scale (1,R) f32;
// v (R,N) i8; v_scale (R,1) f32; mask (M,) f32 or null (= all ones);
// rank_cap (1,) i32 or null (= R); partial (KS,M,N) and xu_part (KS,M,R)
// f32 scratch; out (M,N) f32.  The K splits cover kch pack blocks each:
// KS = ceil((K/64) / kch).
// Requires K % 64 == 0, group_size % 64 == 0, K % group_size == 0,
// N % 4 == 0, R <= 1024.
int quant_matmul_forward(const float* x, const uint8_t* plane0,
                         const uint8_t* plane1, const float* scale,
                         const float* zero, const int8_t* u,
                         const float* u_scale, const int8_t* v,
                         const float* v_scale, const float* mask,
                         const int* rank_cap, float* partial, float* xu_part,
                         float* out, int M, int K, int N, int R, int KS,
                         int kch, int bits, int group_size,
                         cudaStream_t stream) {
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

}  // extern "C"
