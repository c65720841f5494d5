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
//  * Two main kernels, chosen by the capacity C (kFusedMmaMinC):
//
// Decode, C < kFusedMmaMinC: fused_expert_kernel, on the CUDA cores.  It
// runs one block per (token tile, 128-column tile, expert).  Its 8 warps
// split K by 64-row pack blocks (quant_tile.cuh: warp_k_walk, shared with
// quant_matmul.cu); each lane owns 4 adjacent columns, so one 32-bit load
// per plane row brings 4 columns of packed codes (coalesced 128 B per
// warp), and the codes are unpacked in registers.  Planes whose bit offset
// is at or above expert_bits[e] are masked to zero.  Up to 4 bits, a warp
// loads its next pack block into registers while it computes the current
// one.  Dequantization is factored per pack block: sum_k x*(q-z)*s =
// s*(sum_k x*q - z*sum_k x), so the inner loop is one byte-permute, one
// add and C multiply-adds per weight; codes become floats with the 2^23
// exponent trick instead of the slow integer-to-float convert.  The 8
// warps' partial sums meet once in shared memory.
//
// Prefill, C >= kFusedMmaMinC: fused_mma_kernel, on the tensor cores.  At
// Mixtral-8x7B prefill (E 8, C 1024, ~2048 occupied slots) one projection
// is ~241 GFLOP: 3.6 ms on the CUDA cores (67 TFLOP/s f32), 0.49 ms as two
// bf16 products on the tensor cores (989 TFLOP/s dense).  The block runs
// quant_mma.cuh's mma_tile (kernel 3's prefill tile: exact codes in bf16,
// x split into hi/lo bf16 parts, an f32 fold per pack block, 64 x 128
// tiles of 8 warps, 128 registers, two blocks per SM, a cp.async ring) on
// one expert's operands: the grid is (C/64, N/128, E), each block offsets
// x, the planes and scale/zero by its expert and loads rows at or past the
// expert's occupied count as zeros; a plane above expert_bits[e] is not
// read and loads as zeros.  The f32 accumulator tile is staged through the
// (then free) ring in shared memory for the epilogue.
//
// Why kFusedMmaMinC = 96: on dispatch-like inputs (top-2 of 8 experts,
// C = T tokens) one Mixtral-8x7B MoE layer (w1 + w3 + w2, 2 bits) takes
// about as long on either path at C 64 (within 2%, either way round) and
// 22% less on the tensor cores at C 96 (chip_smoke.py prints the
// crossover, PERF.md records it): a 64-token tile costs the same however
// few of its slots are occupied, while the CUDA cores' time grows with
// every 8 occupied slots.
//
// Both main kernels:
//  * Dispatch fills each expert's capacity slots from 0, so rows[e] (the
//    expert's token count) bounds the work: a token tile past it writes
//    zeros and reads no weights, and an expert no token was routed to
//    costs nothing (at decode, batch 4 leaves some of the 8 idle; at
//    exact-capacity prefill, about 3/4 of every expert's slots are empty).
//  * The epilogue adds xu @ V for rows whose mask is set (ranks below
//    min(rank_cap, ranks[e])), multiplies by the gate and stores f32.
//
// Plain C interface (route b of the build): every entry point returns
// cudaGetLastError() after its launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"
#include "quant_tile.cuh"

namespace {

using namespace quant_tile;

constexpr int XU_TILE_C = 8;    // tokens per block of the pre-pass
constexpr int XU_TILE_R = 128;  // ranks per block of the pre-pass
constexpr int kFusedMmaMinC = 96;   // capacity from which the mma path runs
constexpr int EP_LD = BN + 8;   // f32 row stride of the staged output tile

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

// Block (64-token tile, 128-column tile, expert) on the tensor cores.
// out[e, c, n] for c < occ = min(rows[e], C): (x @ dequant_e(W) + [me != 0]
// xu @ V[:r_end]) * ge; slots at or past occ get exact zeros.
template <int BITS>
__global__ void __launch_bounds__(WARPS * 32, 2)
fused_mma_kernel(Args a,
                 const float* __restrict__ xu,
                 const int8_t* __restrict__ v,
                 const float* __restrict__ me,
                 const float* __restrict__ ge,
                 const int* __restrict__ rank_cap,
                 const int* __restrict__ ranks,
                 const int* __restrict__ expert_bits,
                 float* __restrict__ out, int R) {
  extern __shared__ __align__(16) char smem[];
  const int C = a.C, K = a.K, N = a.N;
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * MM_BM;
  const int n0 = blockIdx.y * BN;
  const int occ = a.rows != nullptr ? min(a.rows[e], C) : C;
  float* oute = out + (size_t)e * C * N;
  if (m0 >= occ) {           // no token in this tile: zeros, no weights read
    for (int idx = threadIdx.x; idx < MM_BM * BN / 4; idx += WARPS * 32) {
      const int m = m0 + idx / (BN / 4), n = n0 + (idx % (BN / 4)) * 4;
      if (m < C && n < N)
        *reinterpret_cast<float4*>(oute + (size_t)m * N + n) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  // expert e's operands as one (occ, K) x (K, N) product, in shared
  // memory so that the K loop reloads them instead of holding them in
  // registers: the loader zero-fills the rows at or past occ, and a plane
  // at or above the expert's true width is null (loaded as zeros)
  __shared__ Args ae;
  if (threadIdx.x == 0) {
    const int eb = expert_bits[e];
    const size_t groups = (size_t)(K / a.group_size) * N;
    ae = Args{a.x + (size_t)e * C * K, nullptr,
              eb > 0 ? a.plane0 + (size_t)e * K * Fmt<BITS>::P0 / 8 * N
                     : nullptr,
              Fmt<BITS>::P1 && eb > 2
                  ? a.plane1 + (size_t)e * K * Fmt<BITS>::P1 / 8 * N
                  : nullptr,
              a.scale + e * groups, a.zero + e * groups, occ, K, N,
              a.group_size};
  }
  __syncthreads();
  float acc[MM_MT][4][4];
  mma_tile<BITS, true>(ae, smem, m0, n0, acc);

  // stage the accumulator tile through the ring (every copy has landed;
  // the barrier waits for the last mma's operand reads)
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < MM_MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = tile + (wm * MM_WM + i * 16 + g) * EP_LD + wn * 32 +
                   j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * EP_LD) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();

  // epilogue: a warp per token row, 4 columns per lane
  const int r_end = rank_end(rank_cap, ranks, e, R);
  for (int idx = threadIdx.x; idx < MM_BM * BN / 4; idx += WARPS * 32) {
    const int c = idx / (BN / 4), nn = (idx % (BN / 4)) * 4;
    const int m = m0 + c, n = n0 + nn;
    if (m >= C || n >= N) continue;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < occ) {
      y = *reinterpret_cast<const float4*>(tile + c * EP_LD + nn);
      const size_t row = (size_t)e * C + m;
      if (me[row] != 0.f) {
        // compensation epilogue: + xu @ V (scales folded into xu)
        const float* xur = xu + row * R;
        const int8_t* ve = v + (size_t)e * R * N + n;
        float4 comp = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < r_end; ++r) {
          const char4 vv = *reinterpret_cast<const char4*>(ve + (size_t)r * N);
          const float xr = xur[r];
          comp.x += xr * (float)vv.x; comp.y += xr * (float)vv.y;
          comp.z += xr * (float)vv.z; comp.w += xr * (float)vv.w;
        }
        y.x += comp.x; y.y += comp.y; y.z += comp.z; y.w += comp.w;
      }
      if (ge != nullptr) {
        const float gv = ge[row];
        y.x *= gv; y.y *= gv; y.z *= gv; y.w *= gv;
      }
    }
    *reinterpret_cast<float4*>(oute + (size_t)m * N + n) = y;
  }
}

template <int BITS>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const Args& a,
                       const float* xu, const int8_t* v, const float* me,
                       const float* ge, const int* rank_cap, const int* ranks,
                       const int* expert_bits, float* out, int R) {
  constexpr int bytes = MmaSmem<BITS>::TOTAL;
  static_assert(bytes >= MM_BM * EP_LD * 4, "the staged output tile");
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mma_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  fused_mma_kernel<BITS><<<grid, WARPS * 32, bytes, stream>>>(
      a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R);
  return cudaSuccess;
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

// The arguments of all four entry points:
// x (E,C,K) f32; plane0/plane1 (E,K*p/8,N) u8 (plane1 null unless bits==3);
// scale/zero (E,K/G,N) f32; u (E,K,R) i8; u_scale (E,1,R); v (E,R,N) i8;
// v_scale (E,R,1); me (E,C) f32; ge (E,C) f32 or null; rank_cap (1,) i32 or
// null (= R); ranks (E,) i32 true ranks; expert_bits (E,) i32;
// rows (E,) i32 or null: slots at or past rows[e] hold no token (zero x,
// zero mask) and get zero output without reading weights;
// partial (E,C,KS,R) and xu (E,C,R) f32 scratch; out (E,C,N) f32.
// Requires K % 64 == 0, group_size % 64 == 0, K % group_size == 0,
// N % 4 == 0; the tensor-core main kernel also x 16-byte and v 4-byte
// aligned.
#define FE_PARAMS                                                            \
  const float *x, const uint8_t *plane0, const uint8_t *plane1,              \
      const float *scale, const float *zero, const int8_t *u,                \
      const float *u_scale, const int8_t *v, const float *v_scale,           \
      const float *me, const float *ge, const int *rank_cap,                 \
      const int *ranks, const int *expert_bits, const int *rows,             \
      float *partial, float *xu, float *out, int E, int C, int K, int N,     \
      int R, int KS, int bits, int group_size, cudaStream_t stream
#define FE_ARGS                                                              \
  x, plane0, plane1, scale, zero, u, u_scale, v, v_scale, me, ge, rank_cap,  \
      ranks, expert_bits, rows, partial, xu, out, E, C, K, N, R, KS, bits,   \
      group_size, stream

// The rank-space pre-pass: xu = mask_r((x * me) @ U) with both factor
// scales folded in, the input of either main kernel's epilogue.
int fused_expert_prepass(FE_PARAMS) {
  if (E <= 0 || C <= 0 || R <= 0 || KS <= 0)
    return (int)cudaGetLastError();
  const int ctiles = (C + XU_TILE_C - 1) / XU_TILE_C;
  const dim3 g1((R + XU_TILE_R - 1) / XU_TILE_R, KS, E * ctiles);
  fused_expert_xu_partial_kernel<<<g1, XU_TILE_R, 0, stream>>>(
      x, u, me, rank_cap, ranks, partial, C, K, R, KS);
  const dim3 g2(C, E);
  fused_expert_xu_reduce_kernel<<<g2, XU_TILE_R, 0, stream>>>(
      partial, u_scale, v_scale, me, rank_cap, ranks, xu, C, R, KS);
  return (int)cudaGetLastError();
}

// The CUDA-core main kernel (the one fused_expert_forward takes for
// C < kFusedMmaMinC), reading xu as the pre-pass left it.
int fused_expert_simt(FE_PARAMS) {
  if (E <= 0 || C <= 0) return (int)cudaGetLastError();
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

// The tensor-core main kernel (the one fused_expert_forward takes for
// C >= kFusedMmaMinC), reading xu as the pre-pass left it.
int fused_expert_mma(FE_PARAMS) {
  if (E <= 0 || C <= 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{x, rows, plane0, plane1, scale, zero, C, K, N, group_size};
  const dim3 grid((C + MM_BM - 1) / MM_BM, (N + BN - 1) / BN, E);
  cudaError_t err;
  switch (bits) {
    case 1: err = launch_mma<1>(grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 2: err = launch_mma<2>(grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 3: err = launch_mma<3>(grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 4: err = launch_mma<4>(grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    case 8: err = launch_mma<8>(grid, stream, a, xu, v, me, ge, rank_cap, ranks, expert_bits, out, R); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One fused call: the pre-pass, then the main kernel by C.
int fused_expert_forward(FE_PARAMS) {
  const int rc = fused_expert_prepass(FE_ARGS);
  if (rc != 0) return rc;
  return C >= kFusedMmaMinC ? fused_expert_mma(FE_ARGS)
                            : fused_expert_simt(FE_ARGS);
}

#undef FE_ARGS
#undef FE_PARAMS

}  // extern "C"
