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
// Decode, M < kMmaMinM: qmm_decode_kernel, on CUDA cores, one launch.
// Its byte bound is the packed planes + f32 scale/zero + int8 U/V (about
// 9.8 MB per projection, 2.9 us at 3.35 TB/s); at 4 tokens the f32
// multiply-adds bound it about as much.  What holds it on the H100 is
// instruction issue: ~2200 instructions per warp per 64-row pack block
// at a 4-token tile (1024 of them multiply-adds, 512 the unpack), about
// 2.5 us per pack block per warp with 8 warps per SM, and ~6 us a call
// besides (launch, first loads, the cluster's sums; PERF.md).  So
// the grid spreads the pack blocks evenly over the SMs.
//  * At E = 1 a grid of (tokens/ct, N/128) has 64 blocks for w1/w3 and 24
//    for w2 at decode, on 132 SMs, so the kernel also splits K, over the
//    CS blocks of a thread-block cluster (CS <= 8).  The wrapper
//    (quant_matmul.py::qmm_splits) sizes CS from the clusters the card
//    holds at once (cudaOccupancyMaxActiveClusters): one wave, at most one
//    block per SM, the least pack blocks per warp (w1/w3: clusters of 2 x
//    24 pack blocks, w2: 4 x 32).  Each warp walks its pack blocks with
//    quant_tile.cuh's arithmetic, loading the next while it computes one.
//  * The blocks of a cluster sum their partials through distributed
//    shared memory: each puts its sums of the columns block q finishes
//    into q's shared memory, and q adds them in block order after a
//    cluster barrier.  No partials in device memory, no atomics, no second
//    launch.
//  * The rank-space work rides in the same cluster.  Up to kFuseRanks
//    ranks (rank_cap and R), each warp carries (x @ U) of its own pack
//    blocks' rows along the walk, loading U one pack block ahead; above
//    that a pass after the walk does.  Rank r's shares go to block r % CS,
//    which sums them in block order, scales them by mask, us and vs, and
//    multiplies them by its rows of V over the tile's columns with all 8
//    warps; a second cluster barrier, and each column's finisher adds those
//    sums in block order.  Every cluster recomputes x @ U for its token
//    tile: at rank 32 that is R/128 = 1/4 more multiply-adds than its
//    weights, which costs most at 8-token tiles (M > 4).
//
// Prefill, M >= kMmaMinM: qmm_mma_kernel, on the tensor cores.  The
// arithmetic bounds it: 2*M*K*N is 0.78 ms for a 3072 x 8192 projection at
// M 1024 on the CUDA cores (67 TFLOP/s f32), 0.104 ms as two bf16
// products (x's hi and lo parts) on the tensor cores (989 TFLOP/s dense).
//  * The block tile is quant_mma.cuh's mma_tile (shared with
//    fused_expert.cu at prefill): exact integer codes as bf16, x split into
//    bf16 hi + lo parts (a third part for 8-bit codes), mma.sync m16n8k16
//    with an f32 fold acc += s * (t - z * xsum) per 64-row pack block, one
//    block per (64 tokens, 128 columns), 8 warps of 32 x 32, 128
//    registers, so two blocks share an SM, and a cp.async ring.  Ragged M
//    and N are masked (zero fill on load, guarded stores), not padded.
//  * What holds it back (tools/qmm_mma_ablation.py disables parts of the
//    loop on the H100): the mma.sync phase, the conversion and the loads
//    with their barriers each take about a third of the time and barely
//    overlap, even with two blocks per SM.  Neither interleaving the next
//    pack block's conversion into the mma nor producer/consumer warps nor
//    a deeper ring made it faster.  wgmma with TMA-fed shared-memory
//    operands is the next step.
//  * The rank-space partials come from 8 extra columns of blocks, one
//    8-token chunk each (xu_split), scheduled first.  K splits = 1; the
//    second launch adds the epilogue.
//  * Why kMmaMinM = 128: below it every call is one launch (the decode
//    kernel), compensated or not.  Per Llama-3.2-3B layer (w1 + w3 + w2,
//    2 bits) the decode kernel is faster up to M 48 and the mma path
//    from M 64 (chip_smoke.py prints the crossover, PERF.md records it);
//    between them the decode kernel's tail per wave and its x @ U per
//    cluster cost more than the mma path's two launches.
//
// The compensated mma path: qmm_reduce_kernel scales xu by mask, rank
// cap, us and vs and adds xu @ V in a second launch (at decode the one
// launch does it all).
//
// Plain C interface (route b of the build): each entry point returns
// cudaGetLastError() after its launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"
#include "quant_tile.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// decode: one launch, K split over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;    // blocks per cluster (the portable limit)

// Shared memory of one decode block, in floats, for a token tile of ct,
// clusters of cs blocks and rank R: `work` (the K walk's staged x, then
// the 8 warps' sums or the rank-space row slices: WARPS * ct * BN floats
// hold any of them); `xq`, the finished xu (ct, xch) of the xch ranks
// this block finishes; `ybox` and `ebox`, where each block of the cluster
// puts its sums of x @ W and of xu @ V for the ych columns this block
// finishes; `xbox`, the same for the x @ U sums of this block's ranks.
struct DecodeSmem {
  int ych, xch, xq, ybox, ebox, xbox, floats;
  __host__ __device__ DecodeSmem(int ct, int cs, int R) {
    ych = ((BN + cs - 1) / cs + 3) / 4 * 4;
    xch = (R + cs - 1) / cs;
    xq = WARPS * ct * BN;
    ybox = (xq + ct * xch + 3) / 4 * 4;     // float4 reads
    ebox = ybox + cs * ct * ych;
    xbox = ebox + (R > 0 ? cs * ct * ych : 0);
    floats = xbox + cs * ct * xch;
  }
};

constexpr int kFuseRanks = 32;    // ranks the K walk's warps carry along
constexpr int kVBatch = 4;        // rows of V a warp has in flight
constexpr uint32_t kBias = 0x80808080u;   // flips the sign bit of 4 int8s

// byte i of `biased` (4 int8 values XOR kBias, i.e. each plus 128 as an
// unsigned byte) as the float value of the signed byte: the 2^23 exponent
// trick, then 2^23 + 128 subtracted (exact)
__device__ __forceinline__ float s8_to_float(uint32_t biased, int i) {
  const uint32_t sel = (uint32_t)i | 0x7540u;   // bytes: [i, 0, 0, 0x4B]
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

// A 32-bit load through the read-only path, as a volatile asm statement:
// a run of them is issued in program order before the code after them, so
// a thread has the whole run in flight at once (the compiler may otherwise
// sink each load to its use and wait on them one by one).
__device__ __forceinline__ uint32_t ldg_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One lane's 16 rows of U for one pack block: rows pb*64 + 16*(lane/8) +
// j, ranks 4*(lane%8) .. +3, as stored (zeros past r_end, not read).
__device__ __forceinline__ void load_u_rows(uint32_t (&w)[16],
                                            const int8_t* __restrict__ u,
                                            int pb, int lane, int R,
                                            int r_end) {
  const int r = 4 * (lane % 8);
  const int8_t* ur = u + ((size_t)pb * PACK + 16 * (lane / 8)) * R + r;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    w[j] = r < r_end ? ldg_u32(ur + (size_t)j * R) : 0u;
}

// The decode kernel's K walk: quant_tile.cuh's warp_k_walk (the same
// loads and the same arithmetic per weight, so the same sums), and, when
// `xu` is set (r_end <= kFuseRanks), the rank-space product of the same
// rows carried along: the warp loads its next pack block's 64 rows of U
// with the next weights and, once x is staged, lane (g = lane/8, q =
// lane%8) adds x[c, k] * u[k, 4q + i] over its 16 rows k into uacc[c][i].
// The U rows of the block's pack blocks are each read once, one pack
// block ahead, where a pass after the walk waited on them again.
template <int BITS, int CT>
__device__ __forceinline__ void decode_walk(const Args& a, int c0,
                                            int pb_begin, int pb_end,
                                            int warp, int lane, int col,
                                            bool col_ok, float* xs,
                                            float (&acc)[CT][4], bool xu,
                                            const int8_t* __restrict__ u,
                                            int R, int r_end,
                                            float (&uacc)[CT][4]) {
  constexpr int P0 = Fmt<BITS>::P0;
  constexpr int P1 = Fmt<BITS>::P1;
  using T = Tile<BITS, CT>;
  constexpr int L0 = T::L0, L1 = T::L1;
  constexpr uint32_t M0 = ((1u << P0) - 1u) * 0x01010101u;
  constexpr uint32_t M1 = P1 ? ((1u << P1) - 1u) * 0x01010101u : 0u;
  constexpr bool PREFETCH = BITS <= 4;
  const int M = a.C;

  const int first = pb_begin + warp;
  T cur, nxt;
  uint32_t uw[16], un[16];
  if (first < pb_end) {
    load_tile<BITS, CT>(cur, a, M, first, 0, c0, lane, col, col_ok,
                        0xFFFFFFFFu, 0xFFFFFFFFu);
    if (xu) load_u_rows(uw, u, first, lane, R, r_end);
  }
  for (int pb = first; pb < pb_end; pb += WARPS) {
    const int pn = pb + WARPS;
    if (PREFETCH && pn < pb_end)
      load_tile<BITS, CT>(nxt, a, M, pn, 0, c0, lane, col, col_ok,
                          0xFFFFFFFFu, 0xFFFFFFFFu);
    if (xu && pn < pb_end) load_u_rows(un, u, pn, lane, R, r_end);
    // stage x; per-token sum of x over the block (zero-point term)
    float xsum[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      xs[c * PACK + lane] = cur.x[c][0];
      xs[c * PACK + lane + 32] = cur.x[c][1];
      float s = cur.x[c][0] + cur.x[c][1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
      xsum[c] = s;
    }
    __syncwarp();
    if (col_ok) {
      float t[CT][4];
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[c][i] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < PACK / 4; ++k4) {
        float4 xv[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c)
          xv[c] = *reinterpret_cast<const float4*>(xs + c * PACK + k4 * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = k4 * 4 + kk;
          // plane-0 chunk j sits at bit offset j*P0 of rows [j*L0, (j+1)*L0)
          uint32_t codes = (cur.w0[k % L0] >> ((k / L0) * P0)) & M0;
          if (P1) codes |= ((cur.w1[k % L1] >> ((k / L1) * P1)) & M1) << P0;
          float q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] = byte_to_float(codes, i);
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float xk = lane_of(xv[c], kk);
#pragma unroll
            for (int i = 0; i < 4; ++i) t[c][i] += xk * q[i];
          }
        }
      }
      const float sv[4] = {cur.s.x, cur.s.y, cur.s.z, cur.s.w};
      const float zv[4] = {cur.z.x, cur.z.y, cur.z.z, cur.z.w};
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[c][i] += sv[i] * (t[c][i] - zv[i] * xsum[c]);
    }
    if (xu) {
      const float* xr = xs + 16 * (lane / 8);
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        float4 xv[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c)
          xv[c] = *reinterpret_cast<const float4*>(xr + c * PACK + j4 * 4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float uq[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            uq[i] = s8_to_float(uw[j4 * 4 + jj] ^ kBias, i);
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float xk = lane_of(xv[c], jj);
#pragma unroll
            for (int i = 0; i < 4; ++i) uacc[c][i] += xk * uq[i];
          }
        }
      }
    }
    __syncwarp();
    if (xu) {
#pragma unroll
      for (int j = 0; j < 16; ++j) uw[j] = un[j];
    }
    if (PREFETCH) {
      cur = nxt;
    } else if (pn < pb_end) {
      load_tile<BITS, CT>(cur, a, M, pn, 0, c0, lane, col, col_ok,
                          0xFFFFFFFFu, 0xFFFFFFFFu);
    }
  }
}

// The rank-space share of one block: for ranks r < r_end and the tile's
// tokens c0.., the sum over rows [k_begin, k_end) of x[c0+c, k] * u[k, r],
// put into the xbox of the rank's owner (block r % CS of the cluster) at
// [part][c][r / CS].  Thread t takes ranks r0 + 4*(t%8) .. +3 and every
// 32nd row from t/8; the 32 row slices meet in xr (ct * 1024 floats).
template <int CT>
__device__ __forceinline__ void xu_share(cg::cluster_group& cluster,
                                         const float* __restrict__ x,
                                         const int8_t* __restrict__ u,
                                         float* xr, float* xbox, int M,
                                         int K, int R, int r_end, int c0,
                                         int CS, int part, int xch,
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
    __syncthreads();                  // xr is free (its last pass read)
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[(c * 32 + slice) * 32 + 4 * q + i] = acc[c][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * 32; idx += WARPS * 32) {
      const int c = idx / 32, rk = r0 + idx % 32;
      if (rk >= r_end) continue;
      float sum = 0.f;
#pragma unroll 8
      for (int sl = 0; sl < 32; ++sl)
        sum += xr[(c * 32 + sl) * 32 + idx % 32];
      cluster.map_shared_rank(xbox, rk % CS)[(part * CT + c) * xch + rk / CS] =
          sum;
    }
  }
}

// One decode projection in one launch.  Grid (CS, column tiles of 128,
// token tiles of CT) in clusters of (CS, 1, 1): the CS blocks of a
// cluster share one (token tile, column tile) and split K, block `part`
// walking pack blocks [part * kch, (part + 1) * kch) with its 8 warps
// (decode_walk).  The block sums its warps in order and puts each
// column's sum into the ybox of the block that finishes that column
// (block nn / ych of the cluster).  With compensation (u given, r_end =
// min(R, rank_cap) > 0, a row of the tile with a non-zero mask), the
// block also sums its rows of (x @ U) into the xbox of each rank's owner
// (rank r: block r % CS).  One cluster barrier; then each block finishes
// its own ranks (the CS shares in block order, times mask, us and vs),
// its 8 warps multiply them by those rows of V over the tile's 128
// columns, and the block puts each column's sum into its finisher's
// ebox; a second barrier, and each block finishes its columns: the CS
// sums of x @ W in block order, plus the CS sums of xu @ V in block
// order, stored once.  Sums in fixed orders, no atomics, no scratch in
// device memory.
template <int BITS, int CT>
__global__ void __launch_bounds__(WARPS * 32)
qmm_decode_kernel(Args a, const int8_t* __restrict__ u,
                  const float* __restrict__ u_scale,
                  const int8_t* __restrict__ v,
                  const float* __restrict__ v_scale,
                  const float* __restrict__ mask,
                  const int* __restrict__ rank_cap, float* __restrict__ out,
                  int R, int kch) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int M = a.C, K = a.K, N = a.N;
  const int CS = gridDim.x, part = blockIdx.x;
  const int n0 = blockIdx.y * BN, c0 = blockIdx.z * CT;
  const int pb_begin = part * kch;
  const int pb_end = min(K / PACK, pb_begin + kch);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * 4;
  const bool col_ok = col < N;
  const DecodeSmem L(CT, CS, u != nullptr ? R : 0);
  float* work = sm;
  float* ybox = sm + L.ybox;
  float* ebox = sm + L.ebox;
  float* xbox = sm + L.xbox;
  float* xq = sm + L.xq;
  // a block writes into the others' shared memory only once every block
  // of the cluster runs: arrive now, wait after the K walk
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the same for every block of the cluster: one token tile, one rank cap
  const int r_end = u != nullptr ? rank_limit(rank_cap, R) : 0;
  bool any = false;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    any |= c0 + c < M && (mask == nullptr || mask[c0 + c] != 0.f);
  const bool comp = r_end > 0 && any;
  // up to kFuseRanks ranks ride along the K walk; more take a pass after it
  const bool fuse = comp && r_end <= kFuseRanks && R % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(u) % 4 == 0;
  // what the epilogue reads first, loaded now so that the K walk hides
  // its latency: the mask and us * vs of the xu entry this thread
  // finishes (if it finishes one in the first pass), and this warp's
  // first kVBatch rows of V (this block's ranks j = warp, warp + 8, ...)
  // under the lane's columns
  const int own = comp && r_end > part ? (r_end - part + CS - 1) / CS : 0;
  float pre_mk = 0.f, pre_uv = 0.f;
  uint32_t pre_v[kVBatch];
  if (comp) {
    const int c = threadIdx.x / max(L.xch, 1);
    const int r = (threadIdx.x % max(L.xch, 1)) * CS + part;
    if (c < CT && r < r_end) {
      pre_mk = c0 + c >= M ? 0.f : mask != nullptr ? mask[c0 + c] : 1.f;
      pre_uv = u_scale[r] * v_scale[r];
    }
#pragma unroll
    for (int i = 0; i < kVBatch; ++i) {
      const int j = warp + WARPS * i;
      pre_v[i] = j < own && col_ok
                     ? ldg_u32(v + (size_t)(j * CS + part) * N + col) : 0u;
    }
  }

  float acc[CT][4], uacc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = uacc[c][i] = 0.f;
  decode_walk<BITS, CT>(a, c0, pb_begin, pb_end, warp, lane, col, col_ok,
                        work + warp * CT * PACK, acc, fuse, u, R, r_end,
                        uacc);
  __syncthreads();                    // the staged x rows are read
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      work[(warp * CT + c) * BN + lane * 4 + i] = acc[c][i];
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  __syncthreads();
  for (int idx = threadIdx.x; idx < CT * BN; idx += WARPS * 32) {
    const int c = idx / BN, nn = idx % BN;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += work[(w * CT + c) * BN + nn];
    cluster.map_shared_rank(ybox, nn / L.ych)
        [(part * CT + c) * L.ych + nn % L.ych] = y;
  }
  if (fuse) {
    // the warp's sums: its 4 row groups (lanes q, q+8, q+16, q+24), then
    // the block's: its warps in order, each rank's sum put in its owner's
    // xbox
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uacc[c][i] += __shfl_xor_sync(0xFFFFFFFFu, uacc[c][i], 8);
        uacc[c][i] += __shfl_xor_sync(0xFFFFFFFFu, uacc[c][i], 16);
      }
    __syncthreads();                  // the warp sums of the weights are read
    if (lane < 8) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          work[(warp * CT + c) * kFuseRanks + 4 * lane + i] = uacc[c][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * kFuseRanks; idx += WARPS * 32) {
      const int c = idx / kFuseRanks, rk = idx % kFuseRanks;
      if (rk >= r_end) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += work[(w * CT + c) * kFuseRanks + rk];
      cluster.map_shared_rank(xbox, rk % CS)
          [(part * CT + c) * L.xch + rk / CS] = sum;
    }
  } else if (comp) {
    __syncthreads();                  // the warp sums are read
    xu_share<CT>(cluster, a.x, u, work, xbox, M, K, R, r_end, c0, CS, part,
                 L.xch, pb_begin * PACK, pb_end * PACK);
  }
  cluster.sync();
  if (comp) {
    // this block's ranks r = j * CS + part below r_end: the CS shares in
    // block order, times the mask and us * vs
    for (int idx = threadIdx.x; idx < CT * L.xch; idx += WARPS * 32) {
      const int c = idx / L.xch, j = idx % L.xch, r = j * CS + part;
      float val = 0.f;
      if (r < r_end) {
        float sum = 0.f;
        for (int b = 0; b < CS; ++b) sum += xbox[(b * CT + c) * L.xch + j];
        float mk = pre_mk, uv = pre_uv;
        if (idx >= WARPS * 32) {
          mk = c0 + c >= M ? 0.f : mask != nullptr ? mask[c0 + c] : 1.f;
          uv = u_scale[r] * v_scale[r];
        }
        if (mk != 0.f) val = sum * mk * uv;
      }
      xq[idx] = val;
    }
    __syncthreads();
    // xq @ V over the tile's columns: warp w takes this block's ranks j =
    // w, w + 8, ... (kVBatch rows of V in flight), lane its 4 columns
    float e[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) e[c][i] = 0.f;
    for (int j0 = warp; j0 < own; j0 += WARPS * kVBatch) {
      uint32_t w[kVBatch];
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        const int j = j0 + WARPS * i;
        w[i] = j0 == warp ? pre_v[i]
               : j < own && col_ok
                   ? ldg_u32(v + (size_t)(j * CS + part) * N + col) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        const int j = j0 + WARPS * i;
        if (j < own) {
          float vq[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) vq[q] = s8_to_float(w[i] ^ kBias, q);
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float xv = xq[c * L.xch + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) e[c][q] += xv * vq[q];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        work[(warp * CT + c) * BN + lane * 4 + i] = e[c][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * BN; idx += WARPS * 32) {
      const int c = idx / BN, nn = idx % BN;
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) y += work[(w * CT + c) * BN + nn];
      cluster.map_shared_rank(ebox, nn / L.ych)
          [(part * CT + c) * L.ych + nn % L.ych] = y;
    }
    cluster.sync();
  }
  // this block's columns [part * ych, (part + 1) * ych) of the tile
  const int q4 = L.ych / 4;
  for (int idx = threadIdx.x; idx < CT * q4; idx += WARPS * 32) {
    const int c = idx / q4, j = (idx % q4) * 4;
    const int nn = part * L.ych + j, n = n0 + nn;
    if (c0 + c >= M || nn >= BN || n >= N) continue;
    const int at = c * L.ych + j;
    float4 y = *reinterpret_cast<const float4*>(ybox + at);
    for (int b = 1; b < CS; ++b) {
      const float4 p =
          *reinterpret_cast<const float4*>(ybox + at + b * CT * L.ych);
      y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
    }
    if (comp) {
      float4 t = *reinterpret_cast<const float4*>(ebox + at);
      for (int b = 1; b < CS; ++b) {
        const float4 p =
            *reinterpret_cast<const float4*>(ebox + at + b * CT * L.ych);
        t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
      }
      y.x += t.x; y.y += t.y; y.z += t.z; y.w += t.w;
    }
    *reinterpret_cast<float4*>(out + (size_t)(c0 + c) * N + n) = y;
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

// The decode kernel's shared memory for (ct, cs, R) in bytes, and the most
// a call of token tile CT asks for (cs <= kMaxCluster, R <= MAXR), to
// which each instantiation's limit is raised once.
inline size_t decode_smem(int ct, int cs, int R) {
  return sizeof(float) * (size_t)DecodeSmem(ct, cs, R).floats;
}
template <int CT>
size_t decode_smem_max() {
  size_t m = 0;
  for (int cs = 1; cs <= kMaxCluster; ++cs)
    m = m > decode_smem(CT, cs, MAXR) ? m : decode_smem(CT, cs, MAXR);
  return m;
}

template <int BITS, int CT>
cudaError_t decode_prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      qmm_decode_kernel<BITS, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)decode_smem_max<CT>());
  return e;
}

template <int BITS, int CT>
cudaLaunchConfig_t decode_config(cudaLaunchAttribute* attr, dim3 grid,
                                 int R, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = decode_smem(CT, grid.x, R);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BITS, int CT>
cudaError_t launch_decode_ct(dim3 grid, cudaStream_t stream, const Args& a,
                             const int8_t* u, const float* u_scale,
                             const int8_t* v, const float* v_scale,
                             const float* mask, const int* rank_cap,
                             float* out, int R, int kch) {
  cudaError_t e = decode_prepare<BITS, CT>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = decode_config<BITS, CT>(
      attr, grid, u != nullptr ? R : 0, stream);
  return cudaLaunchKernelEx(&cfg, qmm_decode_kernel<BITS, CT>, a, u, u_scale,
                            v, v_scale, mask, rank_cap, out, R, kch);
}

template <int BITS, int CT>
cudaError_t decode_occupancy_ct(int cs, int R, int* clusters, int* blocks) {
  cudaError_t e = decode_prepare<BITS, CT>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      decode_config<BITS, CT>(attr, dim3(cs, 1, 1), R, 0);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, qmm_decode_kernel<BITS, CT>, WARPS * 32, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, qmm_decode_kernel<BITS, CT>,
                                        &cfg);
}

// F<BITS, CT>::run(args...) for the run-time (bits, ct)
template <template <int, int> class F, typename... A>
cudaError_t decode_dispatch(int bits, int ct, A... args) {
#define QMM_CT(B)                                           \
  switch (ct) {                                             \
    case 1: return F<B, 1>::run(args...);                   \
    case 2: return F<B, 2>::run(args...);                   \
    case 4: return F<B, 4>::run(args...);                   \
    case 8: return F<B, 8>::run(args...);                   \
    default: return cudaErrorInvalidValue;                  \
  }
  switch (bits) {
    case 1: QMM_CT(1)
    case 2: QMM_CT(2)
    case 3: QMM_CT(3)
    case 4: QMM_CT(4)
    case 8: QMM_CT(8)
    default: return cudaErrorInvalidValue;
  }
#undef QMM_CT
  return cudaErrorInvalidValue;
}

template <int BITS, int CT>
struct DecodeLaunch {
  template <typename... A>
  static cudaError_t run(A... a) { return launch_decode_ct<BITS, CT>(a...); }
};
template <int BITS, int CT>
struct DecodeOccupancy {
  template <typename... A>
  static cudaError_t run(A... a) { return decode_occupancy_ct<BITS, CT>(a...); }
};

// ---------------------------------------------------------------------------
// prefill: the tensor-core path
// ---------------------------------------------------------------------------

constexpr int kMmaMinM = 128;         // tokens from which the mma path runs
constexpr int XU_CHUNKS = MM_BM / 8;  // rank-space blocks per token tile

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
  float acc[MM_MT][4][4];
  mma_tile<BITS>(a, smem, m0, n0, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tq = lane % 4;
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
  static_assert(bytes >= 8 * 1024 * 4, "xu_split<8> scratch");
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
// rank_cap (1,) i32 or null (= R); partial (M,N) and xu_part (M,R) f32
// scratch of the mma path (the decode path reads neither; null there);
// out (M,N) f32.  The K splits cover kch pack blocks each: KS =
// ceil((K/64) / kch), at most kMaxCluster on the decode path.
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

// The CUDA-core path (the one quant_matmul_forward takes for M <
// kMmaMinM): qmm_decode_kernel, one launch.  KS is the cluster size (the
// blocks splitting K), kch the pack blocks each block walks; partial and
// xu_part are not read and may be null.
int quant_matmul_splitk(QMM_PARAMS) {
  if (M <= 0) return (int)cudaGetLastError();
  // every split non-empty, all splits together covering K
  if (KS <= 0 || KS > kMaxCluster || kch <= 0 || (KS - 1) * kch >= K / PACK ||
      KS * kch < K / PACK || R > MAXR || (u != nullptr && R <= 0))
    return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, plane0, plane1, scale, zero, M, K, N, group_size};
  const int ct = token_tile(M);
  const dim3 grid(KS, (N + BN - 1) / BN, (M + ct - 1) / ct);
  const cudaError_t e = decode_dispatch<DecodeLaunch>(
      bits, ct, grid, stream, a, u, u_scale, v, v_scale, mask, rank_cap, out,
      R, kch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The decode kernel's occupancy for `bits`, M tokens, rank R (0: no
// compensation) and clusters of cs blocks: *clusters, the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters, which knows the SM
// count and how clusters pack), and *blocks, the blocks per SM.
int quant_matmul_decode_occupancy(int bits, int M, int R, int cs,
                                  int* clusters, int* blocks) {
  if (M <= 0 || cs <= 0 || cs > kMaxCluster || R < 0 || R > MAXR)
    return (int)cudaErrorInvalidValue;
  return (int)decode_dispatch<DecodeOccupancy>(bits, token_tile(M), cs, R,
                                               clusters, blocks);
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

// The entry point: the tensor-core path from kMmaMinM tokens, else the
// decode kernel.
int quant_matmul_forward(QMM_PARAMS) {
  return M >= kMmaMinM ? quant_matmul_mma(QMM_ARGS)
                       : quant_matmul_splitk(QMM_ARGS);
}

#undef QMM_PARAMS
#undef QMM_ARGS

}  // extern "C"
