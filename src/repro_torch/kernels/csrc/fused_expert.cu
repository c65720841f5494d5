// Fused expert projection for Hopper: bit-plane unpack + HQQ dequant at
// each expert's true width + router-masked low-rank compensation + gate.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::
// fused_expert_matmul_pallas (body _fused_kernel).  For every expert e:
//
//   ye[e] = (xe[e] @ dequant_e(W) + mask_r((xe[e]*me[e]) @ (U_e*us_e))
//            * vs_e @ V_e) * ge[e]
//
// What bounds it on the H100: at decode (C = a few tokens per expert) the
// bytes of the packed planes + f32 scale/zero + int8 U/V, read once; the
// arithmetic is ~C multiply-adds per weight.  At prefill (C = B*P) every
// weight meets C tokens and the CUDA-core arithmetic bounds it.
//
// What the design does about that:
//  * The rank-space activation xu = (x*me) @ (U*us) * vs is computed ONCE
//    per (expert, token, rank) by a two-stage pre-pass
//    (fused_expert_xu_partial_kernel over K splits, then
//    fused_expert_xu_reduce_kernel); the TPU body recomputed it inside
//    every N tile.  Ranks at or above min(rank_cap, ranks[e]) are exact
//    zeros and are neither computed nor read, and tokens whose
//    compensation mask is 0 skip the V epilogue, so only the factors the
//    router actually selects leave device memory.
//  * The main kernel (fused_expert_kernel) runs one block per (token tile,
//    128-column tile, expert).  Its 8 warps split K by 64-row pack blocks
//    (quant_tile.cuh: warp_k_walk, shared with quant_matmul.cu); each lane
//    owns 4 adjacent columns, so one 32-bit load per plane row brings 4
//    columns of packed codes (coalesced 128 B per warp), and the codes are
//    unpacked in registers.  Planes whose bit offset is at or above
//    expert_bits[e] are masked to zero.  Up to 4 bits, a warp loads its
//    next pack block into registers while it computes the current one.
//  * Dequantization is factored per pack block: sum_k x*(q-z)*s =
//    s*(sum_k x*q - z*sum_k x), so the inner loop is one byte-permute, one
//    add and C multiply-adds per weight; codes become floats with the
//    2^23 exponent trick instead of the slow integer-to-float convert.
//  * Dispatch fills each expert's capacity slots from 0, so rows[e] (the
//    expert's token count) bounds the work: a token tile past it writes
//    zeros and reads no weights, and an expert no token was routed to
//    costs nothing (at decode, batch 4 leaves some of the 8 idle; at
//    exact-capacity prefill, about 3/4 of every expert's slots are empty).
//  * The 8 warps' partial sums meet once in shared memory; the epilogue
//    adds xu @ V, multiplies by the gate and stores f32.
//
// Plain C interface (route b of the build): every entry point returns
// cudaGetLastError() after its launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace quant_tile;

constexpr int XU_TILE_C = 8;    // tokens per block of the pre-pass
constexpr int XU_TILE_R = 128;  // ranks per block of the pre-pass

__device__ __forceinline__ int rank_end(const int* rank_cap,
                                        const int* ranks, int e, int R) {
  int r = min(R, ranks[e]);
  if (rank_cap != nullptr) r = min(r, rank_cap[0]);
  return max(r, 0);
}

// Rank-space pre-pass, stage 1: partial[e, c, ks, r] = sum over the
// ks-th K split of x[e,c,k] * me[e,c] * u[e,k,r], for r < min(R, rank_cap,
// ranks[e]).  K is split over blocks so that the one or two experts that
// carry a compensator still spread over many SMs.  Tiles whose mask is
// all zero and ranks past the end are skipped; stage 2 never reads them.
__global__ void __launch_bounds__(XU_TILE_R)
fused_expert_xu_partial_kernel(const float* __restrict__ x,
                               const int8_t* __restrict__ u,
                               const float* __restrict__ me,
                               const int* __restrict__ rank_cap,
                               const int* __restrict__ ranks,
                               float* __restrict__ partial,
                               int C, int K, int R, int KS) {
  const int ctiles = (C + XU_TILE_C - 1) / XU_TILE_C;
  const int e = blockIdx.z / ctiles;
  const int c0 = (blockIdx.z % ctiles) * XU_TILE_C;
  const int ks = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = blockIdx.x * XU_TILE_R + tid;
  const int r_end = rank_end(rank_cap, ranks, e, R);
  if (blockIdx.x * XU_TILE_R >= r_end) return;
  bool any = false;
  for (int c = 0; c < XU_TILE_C; ++c)
    any |= (c0 + c < C) && me[(size_t)e * C + c0 + c] != 0.f;
  if (!any) return;
  const int kch = ((K / PACK + KS - 1) / KS) * PACK;
  const int k_begin = ks * kch, k_end = min(K, k_begin + kch);

  __shared__ float xs[XU_TILE_C][PACK];
  float acc[XU_TILE_C];
#pragma unroll
  for (int c = 0; c < XU_TILE_C; ++c) acc[c] = 0.f;
  const int8_t* ue = u + (size_t)e * K * R;
  for (int k0 = k_begin; k0 < k_end; k0 += PACK) {
    for (int i = tid; i < XU_TILE_C * PACK; i += XU_TILE_R) {
      const int c = i / PACK, kk = i % PACK;
      float val = 0.f;
      if (c0 + c < C) {
        const size_t row = (size_t)e * C + c0 + c;
        val = x[row * K + k0 + kk] * me[row];
      }
      xs[c][kk] = val;
    }
    __syncthreads();
    if (r < r_end) {
#pragma unroll 16
      for (int kk = 0; kk < PACK; ++kk) {
        const float uv = (float)ue[(size_t)(k0 + kk) * R + r];
#pragma unroll
        for (int c = 0; c < XU_TILE_C; ++c) acc[c] += xs[c][kk] * uv;
      }
    }
    __syncthreads();
  }
  if (r < r_end) {
    for (int c = 0; c < XU_TILE_C && c0 + c < C; ++c)
      partial[(((size_t)e * C + c0 + c) * KS + ks) * R + r] = acc[c];
  }
}

// Stage 2: xu[e, c, r] = sum_ks partial * us[e,r] * vs[e,r] for the tokens
// whose mask is set (the only rows the main kernel reads).
__global__ void fused_expert_xu_reduce_kernel(const float* __restrict__ partial,
                                              const float* __restrict__ u_scale,
                                              const float* __restrict__ v_scale,
                                              const float* __restrict__ me,
                                              const int* __restrict__ rank_cap,
                                              const int* __restrict__ ranks,
                                              float* __restrict__ xu,
                                              int C, int R, int KS) {
  const int e = blockIdx.y, c = blockIdx.x;
  const size_t row = (size_t)e * C + c;
  if (me[row] == 0.f) return;
  const int r_end = rank_end(rank_cap, ranks, e, R);
  for (int r = threadIdx.x; r < r_end; r += blockDim.x) {
    float s = 0.f;
    for (int ks = 0; ks < KS; ++ks) s += partial[(row * KS + ks) * R + r];
    xu[row * R + r] = s * u_scale[(size_t)e * R + r] * v_scale[(size_t)e * R + r];
  }
}

// Block (token tile, column tile, expert); 8 warps split the K walk by
// pack blocks, each warp loading its next pack block while it computes
// the current one (for widths up to 4 bits, where registers allow).
template <int BITS, int CT>
__global__ void __launch_bounds__(WARPS * 32)
fused_expert_kernel(Args a,
                    const float* __restrict__ xu,
                    const int8_t* __restrict__ v,
                    const float* __restrict__ me,
                    const float* __restrict__ ge,
                    const int* __restrict__ rank_cap,
                    const int* __restrict__ ranks,
                    const int* __restrict__ expert_bits,
                    float* __restrict__ out, int R) {
  const int C = a.C, K = a.K, N = a.N;
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * CT;
  const int n0 = blockIdx.y * BN;
  // slots at or past rows[e] hold no token: their outputs are zero and a
  // tile made only of them reads no weights
  const int occ = a.rows != nullptr ? min(a.rows[e], C) : C;
  if (c0 >= occ) {
    for (int idx = threadIdx.x; idx < CT * BN; idx += WARPS * 32) {
      const int c = idx / BN, n = n0 + idx % BN;
      if (c0 + c < C && n < N) out[((size_t)e * C + c0 + c) * N + n] = 0.f;
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * 4;
  const bool col_ok = col < N;
  const int eb = expert_bits[e];
  // a plane whose bit offset is at or above the expert's true width
  // carries no information and is masked out of the unpack
  const uint32_t keep0 = eb > 0 ? 0xFFFFFFFFu : 0u;
  const uint32_t keep1 = eb > 2 ? 0xFFFFFFFFu : 0u;

  __shared__ __align__(16) float smem[WARPS * CT * BN];
  float* xs = smem + warp * CT * PACK;            // this warp's x tile

  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

  warp_k_walk<BITS, CT>(a, occ, e, c0, 0, K / PACK, warp, lane, col, col_ok,
                        keep0, keep1, xs, acc);

  // cross-warp reduction through shared memory
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      smem[(warp * CT + c) * BN + lane * 4 + i] = acc[c][i];
  __syncthreads();

  const int r_end = rank_end(rank_cap, ranks, e, R);
  for (int idx = threadIdx.x; idx < CT * BN; idx += WARPS * 32) {
    const int c = idx / BN, nn = idx % BN;
    const int n = n0 + nn;
    if (c0 + c >= C || n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += smem[(w * CT + c) * BN + nn];
    const size_t row = (size_t)e * C + c0 + c;
    if (me[row] != 0.f) {
      // compensation epilogue: + xu @ V (scales folded into xu)
      const float* xur = xu + row * R;
      const int8_t* ve = v + (size_t)e * R * N + n;
      float comp = 0.f;
      for (int r = 0; r < r_end; ++r) comp += xur[r] * (float)ve[(size_t)r * N];
      y += comp;
    }
    if (ge != nullptr) y *= ge[row];
    out[row * N + n] = y;
  }
}

template <int BITS>
void launch_main(int ct, dim3 grid, cudaStream_t stream, const Args& a,
                 const float* xu, const int8_t* v, const float* me,
                 const float* ge, const int* rank_cap, const int* ranks,
                 const int* expert_bits, float* out, int R) {
  const dim3 block(WARPS * 32);
#define FE_LAUNCH(CTV)                                                   \
  fused_expert_kernel<BITS, CTV><<<grid, block, 0, stream>>>(            \
      a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R)
  switch (ct) {
    case 1: FE_LAUNCH(1); break;
    case 2: FE_LAUNCH(2); break;
    case 4: FE_LAUNCH(4); break;
    default: FE_LAUNCH(8); break;
  }
#undef FE_LAUNCH
}

}  // namespace

extern "C" {

// x (E,C,K) f32; plane0/plane1 (E,K*p/8,N) u8 (plane1 null unless bits==3);
// scale/zero (E,K/G,N) f32; u (E,K,R) i8; u_scale (E,1,R); v (E,R,N) i8;
// v_scale (E,R,1); me (E,C) f32; ge (E,C) f32 or null; rank_cap (1,) i32 or
// null (= R); ranks (E,) i32 true ranks; expert_bits (E,) i32;
// rows (E,) i32 or null: slots at or past rows[e] hold no token (zero x,
// zero mask) and get zero output without reading weights;
// partial (E,C,KS,R) and xu (E,C,R) f32 scratch; out (E,C,N) f32.
// Requires K % 64 == 0, group_size % 64 == 0, K % group_size == 0, N % 4 == 0.
int fused_expert_forward(const float* x, const uint8_t* plane0,
                         const uint8_t* plane1, const float* scale,
                         const float* zero, const int8_t* u,
                         const float* u_scale, const int8_t* v,
                         const float* v_scale, const float* me,
                         const float* ge, const int* rank_cap,
                         const int* ranks, const int* expert_bits,
                         const int* rows, float* partial, float* xu,
                         float* out, int E, int C,
                         int K, int N, int R, int KS, int bits,
                         int group_size, cudaStream_t stream) {
  if (E <= 0 || C <= 0) return (int)cudaGetLastError();
  if (R > 0 && KS > 0) {
    const int ctiles = (C + XU_TILE_C - 1) / XU_TILE_C;
    const dim3 g1((R + XU_TILE_R - 1) / XU_TILE_R, KS, E * ctiles);
    fused_expert_xu_partial_kernel<<<g1, XU_TILE_R, 0, stream>>>(
        x, u, me, rank_cap, ranks, partial, C, K, R, KS);
    const dim3 g2(C, E);
    fused_expert_xu_reduce_kernel<<<g2, XU_TILE_R, 0, stream>>>(
        partial, u_scale, v_scale, me, rank_cap, ranks, xu, C, R, KS);
  }
  const Args a{x, rows, plane0, plane1, scale, zero, C, K, N, group_size};
  const int ct = token_tile(C);
  const dim3 grid((C + ct - 1) / ct, (N + BN - 1) / BN, E);
  switch (bits) {
    case 1: launch_main<1>(ct, grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 2: launch_main<2>(ct, grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 3: launch_main<3>(ct, grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 4: launch_main<4>(ct, grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 8: launch_main<8>(ct, grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
