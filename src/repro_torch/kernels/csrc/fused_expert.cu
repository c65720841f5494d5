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
// bytes of the packed planes + f32 scale/zero + int8 U/V, read once, would;
// the CUDA-core K walk below is held back by its instruction issue instead
// (about 3 instructions per weight to unpack, plus one multiply-add per
// token slot multiplied).  At prefill (C = B*P) every weight meets C
// tokens and the arithmetic bounds it, on the tensor cores.
//
// The rank-space work: xu = mask_r((x*me) @ (U*us)) * vs, then + xu @ V.
// Its bytes are the int8 U and V rows of the compensated experts below
// r_end = min(R, rank_cap, ranks[e]) and their scales: one DeepSeek-MoE
// expert of rank 1024 is 3.5 MB for w2 (K 1408, N 2048), about 1 us at
// 3.35 TB/s.  Ranks at or past r_end are exact zeros and are neither read
// nor computed; tokens whose mask is 0 get no xu.  At decode only a few
// experts are compensated, so the work is a few such slabs: to come near
// that bound each live slab has to spread over many SMs with many wide
// loads in flight, while the grid costs little where nothing is live
// (chip_smoke.py times the parts at decode, PERF.md §6).
//
// The pre-pass (fused_expert_xu_kernel), one launch:
//  * A work item is one (expert, token tile of CT, 128-rank tile) whose
//    token tile holds a compensated row and whose rank tile starts below
//    r_end; a cluster of CS blocks runs it.  Below kFusedMmaMinC, CS =
//    kXuCluster (8), so a rank-1024 expert spreads over 64 SMs, and the
//    grid is kXuSlots (32) clusters whatever E, C and R are: every block
//    enumerates the live items (a thread per (expert, token tile) pair
//    reads ranks[e], rank_cap and the tile's mask; a scan in shared memory
//    numbers the items) and cluster g runs items g, g + 32, ...  A grid
//    over every (expert, token tile, rank tile) would launch 4096 blocks
//    at DeepSeek's decode, nearly all dead, and their launch cost more
//    than the live work.  From kFusedMmaMinC (prefill, C/8
//    token tiles to spread) CS = 1 and the grid is one block per item, a
//    dead one returning at once.
//  * The cluster's blocks and each block's 8 warps split K into CS * 8
//    chunks, fixed by K.  A lane owns 4 adjacent ranks and loads 4 bytes of
//    each U row (a warp reads 128 contiguous bytes), 32 rows in flight at
//    once (volatile-asm loads: left to itself the compiler sank each load
//    to its use, and the warp waited on the 32 one after another); x * me
//    of the warp's rows is staged in shared memory and read as a
//    broadcast; int8 becomes float by a byte permute and one subtraction.
//  * Warp sums meet in shared memory; each block then writes its sums of
//    the entries block q finishes into q's shared memory (distributed
//    shared memory), one cluster barrier, and q adds them in block order.
//    Both orders are fixed.  The scales us * vs, loaded before the K walk,
//    are folded in last, and xu is stored only for rows whose mask is set.
//    No partial sums in device memory, no atomics.
//  * A token's xu is the same sum in the same order whatever other tokens
//    share the call, whichever cluster runs its item, and whatever C below
//    kFusedMmaMinC is (the token tile only changes which sums run side by
//    side), so the decode step (C 4) and a verify round (C 16) round alike.
//
// Decode, C < kFusedMmaMinC: fused_expert_kernel, on the CUDA cores.  It
// runs one block per (token tile of token_tile(C) slots, 128-column tile,
// expert).  The walk multiplies only as many slots as the tile holds
// tokens (walk_slots: the smallest of 1, 2, 4, 8 that holds them in an
// 8-slot tile, 1 or all slots in a smaller one): at DeepSeek-MoE's decode
// step most live experts hold one token of a 4-slot tile, and in a verify
// round (C 16) about two of 8.  A token's sum is the same chain of
// operations at any width, so its row does not depend on C or on the
// other tokens.  A tensor-core walk (exact bf16 codes against x's
// bf16 parts, the tokens as mma.sync's narrow operand, a persistent grid
// of live items) was measured slower at C 4 (PERF.md §6).  Its 8 warps
// split K by 64-row pack blocks (quant_tile.cuh: warp_k_walk, shared with
// quant_matmul.cu); each lane owns 4 adjacent columns, so one 32-bit load
// per plane row brings 4 columns of packed codes (coalesced 128 B per
// warp), and the codes are unpacked in registers.  Planes whose bit offset
// is at or above expert_bits[e] are masked to zero.  Up to 4 bits, a warp
// loads its next pack block into registers while it computes the current
// one.  Dequantization is factored per pack block: sum_k x*(q-z)*s =
// s*(sum_k x*q - z*sum_k x), so the inner loop is one byte-permute, one
// add and C multiply-adds per weight; codes become floats with the 2^23
// exponent trick instead of the slow integer-to-float convert.  The
// epilogue splits the rank walk the same way: warp w takes the rows of V
// below r_end in chunks of 32 (w, w + 8, ...), a lane loads 4 bytes of
// each row (its 4 columns; 128 B per warp, a chunk's 32 loads in flight
// at once) and reads xu, staged in shared memory, as a broadcast; only
// compensated rows are summed (a block-uniform branch: a row whose mask
// is 0 never reads its xu, which the pre-pass did not write).  The
// block's rows of V are prefetched to L2 before the K walk, so the rank
// walk after it waits on L2, not on device memory.  These sums go into
// the K walk's accumulators, and the 8 warps' sums meet once in shared
// memory.  The kernel keeps the occupancy the K walk alone had
// (kMainMinBlocks): left free, the compiler gave the decode step's
// instantiation (2 bits, 4 tokens) more registers for the epilogue, one
// block per SM instead of two, and its K walk slowed.
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
// (then free) ring in shared memory for the epilogue, a warp per token row
// adding xu @ V for rows whose mask is set.
//
// Why kFusedMmaMinC = 96: on dispatch-like inputs (top-2 of 8 experts,
// C = T tokens) one Mixtral-8x7B MoE layer (w1 + w3 + w2, 2 bits) takes
// about as long on either path at C 64 (within 2%, either way round) and
// 22% less on the tensor cores at C 96 (chip_smoke.py prints the
// crossover, PERF.md records it): a 64-token tile costs the same however
// few of its slots are occupied, while the CUDA cores' time grows with
// every 8 occupied slots.
//
// Both main kernels: dispatch fills each expert's capacity slots from 0,
// so rows[e] (the expert's token count) bounds the work: a token tile past
// it writes zeros and reads no weights, and an expert no token was routed
// to costs nothing (at decode, batch 4 leaves some of the 8 idle; at
// exact-capacity prefill, about 3/4 of every expert's slots are empty).
// Each multiplies by the gate and stores f32.
//
// Plain C interface (route b of the build): every entry point returns
// cudaGetLastError() after its launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"
#include "quant_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace quant_tile;

constexpr int kXuTileR = 128;   // ranks per pre-pass tile: 4 per lane
constexpr int kXuWarps = 8;     // warps per pre-pass block
constexpr int kXuRows = 32;     // K rows a pre-pass warp has in flight
constexpr int kXuCluster = 8;   // pre-pass blocks per cluster below kFusedMmaMinC
constexpr int kXuSlots = 32;    // pre-pass clusters below kFusedMmaMinC
constexpr int kFusedMmaMinC = 96;   // capacity from which the mma path runs
constexpr int EP_LD = BN + 8;   // f32 row stride of the staged output tile
constexpr uint32_t kBias = 0x80808080u;   // flips the sign bit of 4 int8s

__device__ __forceinline__ int rank_end(const int* rank_cap,
                                        const int* ranks, int e, int R) {
  int r = min(R, ranks[e]);
  if (rank_cap != nullptr) r = min(r, rank_cap[0]);
  return max(r, 0);
}

// byte i of `biased` (4 int8 values XOR kBias, i.e. each plus 128 as an
// unsigned byte) as the float value of the signed byte: the 2^23 exponent
// trick, then 2^23 + 128 subtracted (exact)
__device__ __forceinline__ float s8_to_float(uint32_t biased, int i) {
  const uint32_t sel = (uint32_t)i | 0x7540u;   // bytes: [i, 0, 0, 0x4B]
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

// A 32-bit load through the read-only path, as a volatile asm statement:
// a run of them is issued in program order before the code after them, so
// a warp has the whole run in flight at once (the compiler may otherwise
// sink each load to its use and wait on them one by one).
__device__ __forceinline__ uint32_t ldg_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// 4 int8 values at p (avail of them inside the row), by bytes
__device__ __forceinline__ uint32_t load_bytes4(const int8_t* p, int avail) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < avail) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return w;
}

// Shared memory of one pre-pass block: each warp's staged x rows during
// the K walk, then the warps' sums; and two inboxes (by item parity) where
// the cluster's blocks put their sums of this block's share of the item.
template <int CT>
struct XuSmem {
  union {
    float xs[kXuWarps][kXuRows][CT];
    float red[kXuWarps][CT][kXuTileR];
  };
  float inbox[2][CT * kXuTileR];
  // the scan of one round of kXuWarps * 32 (expert, token tile) pairs:
  // each pair's item count, first item and r_end; each warp's total
  int cnt[kXuWarps * 32], first[kXuWarps * 32], rend[kXuWarps * 32];
  int wtot[kXuWarps];
};

// One pre-pass work item, run by every block of a cluster of CS blocks
// (part = the block's rank in it): xu[e, c, r] = (sum_k x[e,c,k] *
// me[e,c] * u[e,k,r]) * us[e,r] * vs[e,r] for the tile's tokens c0.. whose
// mask is set and its ranks r0 .. r0 + 127 below r_end.  Block-uniform
// (cluster-uniform) control flow: every thread reaches every barrier.
template <int CT, int CS>
__device__ __forceinline__ void xu_item(XuSmem<CT>& sm, int e, int c0, int r0,
                                        int r_end, int part, int parity,
                                        const float* __restrict__ x,
                                        const int8_t* __restrict__ u,
                                        const float* __restrict__ u_scale,
                                        const float* __restrict__ v_scale,
                                        const float* __restrict__ me,
                                        float* __restrict__ xu, int C, int K,
                                        int R) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mv[CT];
  uint32_t masked = 0;              // bit c: token c0 + c is compensated
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    mv[c] = c0 + c < C ? me[(size_t)e * C + c0 + c] : 0.f;
    masked |= (uint32_t)(mv[c] != 0.f) << c;
  }
  const int r = r0 + 4 * lane;            // this lane's 4 ranks
  const bool live = r < r_end;
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 4 == 0;
  // K in CS * kXuWarps chunks, in (block, warp) order: fixed by K alone
  const int kch = (K + CS * kXuWarps - 1) / (CS * kXuWarps);
  const int kb = min(K, (part * kXuWarps + warp) * kch);
  const int ke = min(K, kb + kch);

  // the scales of the entry this thread finishes (below kFusedMmaMinC)
  constexpr int M = CT * kXuTileR / CS;   // entries a block owns
  static_assert(CS == 1 || M <= kXuWarps * 32, "one entry per thread");
  float us = 0.f, vs = 0.f;
  if (CS > 1 && threadIdx.x < M) {
    const int rk = r0 + (threadIdx.x * CS + part) % kXuTileR;
    if (rk < r_end) {
      us = u_scale[(size_t)e * R + rk];
      vs = v_scale[(size_t)e * R + rk];
    }
  }
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  const int8_t* ue = u + (size_t)e * K * R + r;
  const float* xe = x + ((size_t)e * C + c0) * K;
  for (int k0 = kb; k0 < ke; k0 += kXuRows) {
    const int n = min(kXuRows, ke - k0);  // warp-uniform
    // the U rows first (they wait on nothing; rows past the chunk and
    // dead lanes load a valid address and become zeros), then x of row
    // k0 + lane for every token of the tile, staged as x * me (a row of CT
    // floats, read back below as a broadcast)
    uint32_t w[kXuRows];
    if (vec) {
#pragma unroll
      for (int j = 0; j < kXuRows; ++j)
        w[j] = ldg_u32(live && j < n ? ue + (size_t)(k0 + j) * R : u);
    } else {
#pragma unroll
      for (int j = 0; j < kXuRows; ++j)
        w[j] = live && j < n
                   ? load_bytes4(ue + (size_t)(k0 + j) * R, R - r) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kXuRows; ++j)
      w[j] = live && j < n ? w[j] ^ kBias : kBias;
    float xv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c)
      xv[c] = lane < n && c0 + c < C ? xe[(size_t)c * K + k0 + lane] : 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) xv[c] = mv[c] != 0.f ? xv[c] * mv[c] : 0.f;
    if constexpr (CT % 4 == 0) {
#pragma unroll
      for (int c = 0; c < CT; c += 4)
        *reinterpret_cast<float4*>(&sm.xs[warp][lane][c]) =
            make_float4(xv[c], xv[c + 1], xv[c + 2], xv[c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) sm.xs[warp][lane][c] = xv[c];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kXuRows; ++j) {
      if (j < n) {
        float q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = s8_to_float(w[j], i);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float xc = sm.xs[warp][j][c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] += xc * q[i];
        }
      }
    }
    __syncwarp();
  }

  // the block's sum: its warps in order (red overlays the x rows)
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT; ++c)
    *reinterpret_cast<float4*>(&sm.red[warp][c][4 * lane]) =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  __syncthreads();
  // the cluster's sum: block q owns the entries idx = q (mod CS); each
  // block puts its sum of them in q's inbox (distributed shared memory),
  // one cluster barrier, then q sums its inbox in block order.  An inbox
  // is written again two items later, after q has passed the next item's
  // barrier, so it has been read by then.
  cg::cluster_group cluster = cg::this_cluster();
  for (int idx = threadIdx.x; idx < CT * kXuTileR; idx += kXuWarps * 32) {
    const int c = idx / kXuTileR, rr = idx % kXuTileR;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kXuWarps; ++w) sum += sm.red[w][c][rr];
    if constexpr (CS == 1) {
      const int rk = r0 + rr;
      if (rk < r_end && (masked >> c) & 1u)
        xu[((size_t)e * C + c0 + c) * R + rk] =
            sum * u_scale[(size_t)e * R + rk] * v_scale[(size_t)e * R + rk];
    } else {
      cluster.map_shared_rank(&sm.inbox[parity][0], idx % CS)
          [part * M + idx / CS] = sum;
    }
  }
  if constexpr (CS == 1) {
    __syncthreads();                // red is free for the next item
  } else {
    cluster.sync();
    const int j = threadIdx.x;      // M <= kXuWarps * 32
    if (j < M) {
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < CS; ++b) sum += sm.inbox[parity][b * M + j];
      const int idx = j * CS + part;
      const int c = idx / kXuTileR, rk = r0 + idx % kXuTileR;
      if (rk < r_end && (masked >> c) & 1u)
        xu[((size_t)e * C + c0 + c) * R + rk] = sum * us * vs;
    }
  }
}

// Whether token tile c0.. of expert e holds a compensated row.
template <int CT>
__device__ __forceinline__ bool tile_masked(const float* __restrict__ me,
                                            int e, int c0, int C) {
  bool any = false;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    any |= c0 + c < C && me[(size_t)e * C + c0 + c] != 0.f;
  return any;
}

// The rank-space pre-pass.  A work item is one (expert, token tile of CT,
// 128-rank tile) whose tile holds a compensated row and whose rank tile
// starts below r_end.
//  * CS == 1 (from kFusedMmaMinC): grid (rank tiles, token tiles, E), one
//    block per item, a dead item returning at once.
//  * CS > 1 (below it): grid (CS, kXuSlots) in clusters of (CS, 1, 1).
//    Every block enumerates the live items in (expert, token tile, rank
//    tile) order, kXuWarps * 32 (expert, token tile) pairs at a time, and
//    cluster g runs items g, g + kXuSlots, ...: the grid is fixed by
//    the shapes (no host sync) and small whatever E is, and an item's sums
//    do not depend on the cluster that runs it.
template <int CT, int CS>
__global__ void __launch_bounds__(kXuWarps * 32, 2)
fused_expert_xu_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ u,
                       const float* __restrict__ u_scale,
                       const float* __restrict__ v_scale,
                       const float* __restrict__ me,
                       const int* __restrict__ rank_cap,
                       const int* __restrict__ ranks,
                       float* __restrict__ xu, int E, int C, int K, int R) {
  __shared__ __align__(16) XuSmem<CT> sm;
  if constexpr (CS == 1) {
    const int e = blockIdx.z, c0 = blockIdx.y * CT;
    const int r0 = blockIdx.x * kXuTileR;
    const int r_end = rank_end(rank_cap, ranks, e, R);
    if (r0 >= r_end || !tile_masked<CT>(me, e, c0, C)) return;
    xu_item<CT, 1>(sm, e, c0, r0, r_end, 0, 0, x, u, u_scale, v_scale, me,
                   xu, C, K, R);
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int part = blockIdx.x, g = blockIdx.y;
    const int ctiles = (C + CT - 1) / CT, pairs = E * ctiles;
    constexpr int kRound = kXuWarps * 32;   // pairs scanned at once
    int base = 0;                   // items before this round of pairs
    int n_items = 0;                // items this cluster has run
    for (int p0 = 0; p0 < pairs; p0 += kRound) {
      // thread t: pair p0 + t, its item count (live rank tiles); a scan
      // within each warp, then the warps' totals in order
      const int p = p0 + threadIdx.x;
      int cnt = 0, rend = 0;
      if (p < pairs) {
        const int e = p / ctiles, c0 = (p % ctiles) * CT;
        rend = rank_end(rank_cap, ranks, e, R);
        if (rend > 0 && tile_masked<CT>(me, e, c0, C))
          cnt = (rend + kXuTileR - 1) / kXuTileR;
      }
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) sm.wtot[warp] = incl;
      __syncthreads();
      int off = base, total = 0;
#pragma unroll
      for (int w = 0; w < kXuWarps; ++w) {
        off += w < warp ? sm.wtot[w] : 0;
        total += sm.wtot[w];
      }
      sm.cnt[threadIdx.x] = cnt;
      sm.first[threadIdx.x] = off + incl - cnt;
      sm.rend[threadIdx.x] = rend;
      __syncthreads();
      // this cluster's items of the round: j = g (mod kXuSlots); every
      // warp finds the pair of item j the same way
      for (int j = base + ((g - base % kXuSlots) + kXuSlots) % kXuSlots;
           j < base + total; j += kXuSlots) {
        int src = -1;
        for (int t0 = 0; src < 0; t0 += 32) {
          const int c = sm.cnt[t0 + lane], f = sm.first[t0 + lane];
          const unsigned own =
              __ballot_sync(0xFFFFFFFFu, c > 0 && j >= f && j < f + c);
          if (own) src = t0 + __ffs(own) - 1;
        }
        const int ps = p0 + src;
        xu_item<CT, CS>(sm, ps / ctiles, (ps % ctiles) * CT,
                        (j - sm.first[src]) * kXuTileR, sm.rend[src], part,
                        n_items++ & 1, x, u, u_scale, v_scale, me, xu, C, K,
                        R);
      }
      base += total;
      __syncthreads();              // the round's scan is read
    }
  }
}

template <int CT, int CS>
cudaError_t launch_xu(dim3 grid, cudaStream_t stream, const float* x,
                      const int8_t* u, const float* u_scale,
                      const float* v_scale, const float* me,
                      const int* rank_cap, const int* ranks, float* xu, int E,
                      int C, int K, int R) {
  if constexpr (CS == 1) {
    fused_expert_xu_kernel<CT, 1><<<grid, kXuWarps * 32, 0, stream>>>(
        x, u, u_scale, v_scale, me, rank_cap, ranks, xu, E, C, K, R);
    return cudaSuccess;
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kXuWarps * 32, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, fused_expert_xu_kernel<CT, CS>, x, u,
                              u_scale, v_scale, me, rank_cap, ranks, xu, E, C,
                              K, R);
  }
}

// Blocks per SM the CUDA-core main kernel is compiled for: 2 (at most 128
// registers) where the K walk alone fits in 128 (token tiles of 1 or 2,
// and 4 up to 2 bits), so the epilogue's registers do not halve those
// instantiations' occupancy; else 1 (the walk alone needs more).
template <int BITS, int CT>
constexpr int kMainMinBlocks = CT <= 2 || (CT == 4 && BITS <= 2) ? 2 : 1;

// The K walk of a token tile of CT slots whose first CW hold its tokens:
// warp_k_walk at CW slots, so a weight costs CW multiply-adds per lane
// (slots past the expert's tokens read x as zero).  Each token's sum is
// the same chain of operations whatever CW and CT are, so its row does not
// depend on how many tokens share its tile.  acc[c] for c >= CW stays 0.
template <int BITS, int CT, int CW>
__device__ __forceinline__ void walk_slots(const Args& a, int occ, int e,
                                           int c0, int warp, int lane,
                                           int col, bool col_ok,
                                           uint32_t keep0, uint32_t keep1,
                                           float* xs, float (&acc)[CT][4]) {
  float w[CW][4];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) w[c][i] = 0.f;
  warp_k_walk<BITS, CW>(a, occ, e, c0, 0, a.K / PACK, warp, lane, col,
                        col_ok, keep0, keep1, xs, w);
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = w[c][i];
}

// Block (token tile, column tile, expert); 8 warps split the K walk by
// pack blocks, each warp loading its next pack block while it computes
// the current one (for widths up to 4 bits, where registers allow).
template <int BITS, int CT>
__global__ void __launch_bounds__(WARPS * 32, kMainMinBlocks<BITS, CT>)
fused_expert_kernel(Args a,
                    const float* __restrict__ xu,
                    const int8_t* __restrict__ v,
                    const float* __restrict__ me,
                    const float* __restrict__ ge,
                    const int* __restrict__ rank_cap,
                    const int* __restrict__ ranks,
                    const int* __restrict__ expert_bits,
                    float* __restrict__ out, int R) {
  const int C = a.C, N = a.N;
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

  // compensation: + xu @ V[:r_end] for the tile's compensated rows (scales
  // folded into xu).  Warp w takes the rank rows w*32.., (w+8)*32.., ...
  // of V; the tile's xu sits in shared memory (in stages of WARPS * BN
  // ranks) and is read as a broadcast.  Only compensated rows are summed
  // (a block-uniform branch per token): a row whose mask is 0 never reads
  // its xu, which the pre-pass did not write.  The block's rows of V are
  // prefetched to L2 before the K walk, so the rank walk after it waits
  // on L2.
  const int r_end = rank_end(rank_cap, ranks, e, R);
  uint32_t comp = 0;                // bit c: token c0 + c is compensated
#pragma unroll
  for (int c = 0; c < CT; ++c)
    comp |= (uint32_t)(c0 + c < occ && me[(size_t)e * C + c0 + c] != 0.f)
            << c;
  const int8_t* ve = v + (size_t)e * R * N + col;
  if (comp)
    for (int rr = warp * 32 + lane; rr < r_end; rr += WARPS * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          v + (size_t)e * R * N + (size_t)rr * N + n0));

  // the walk's token tile follows the tile's occupied slots, not C: a
  // tile holding one token costs one multiply-add per weight, not CT.  A
  // 2- or 4-slot tile walks 1 slot or all of them: a third walk beside
  // them spilled at the 128 registers of two blocks per SM and slowed the
  // rank walk more than it saved (PERF.md §6).  Each width is inlined
  // once (the conditions on CT fold at compile time).
  const int live = occ - c0;                    // >= 1 here; block-uniform
#define FE_WALK(CW)                                                       \
  walk_slots<BITS, CT, (CW < CT ? CW : CT)>(a, occ, e, c0, warp, lane, col, \
                                            col_ok, keep0, keep1, xs, acc)
  if (CT == 1 || live <= 1) FE_WALK(1);
  else if (CT != 8 || live > 4) FE_WALK(8);
  else if (live <= 2) FE_WALK(2);
  else FE_WALK(4);
#undef FE_WALK

  if (comp) {                       // block-uniform
    constexpr int kStage = WARPS * BN;          // ranks of xu per stage
    const float* xue = xu + ((size_t)e * C + c0) * R;
    for (int s0 = 0; s0 < r_end; s0 += kStage) {
      const int sn = min(kStage, r_end - s0);
      __syncthreads();              // smem is free (x tiles, last stage)
      // xu of the compensated rows, kStage / (WARPS * 32) loads in flight
      // per thread and token
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if ((comp >> c) & 1u) {
          constexpr int kPer = kStage / (WARPS * 32);
          float t[kPer];
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int rr = threadIdx.x + k * WARPS * 32;
            t[k] = rr < sn ? xue[(size_t)c * R + s0 + rr] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int rr = threadIdx.x + k * WARPS * 32;
            if (rr < sn) smem[rr * CT + c] = t[k];
          }
        }
      }
      __syncthreads();
      for (int rb = s0 + warp * 32; rb < s0 + sn; rb += WARPS * 32) {
        const int n = min(32, s0 + sn - rb);
        uint32_t vw[32];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          vw[j] = ldg_u32(col_ok && j < n ? ve + (size_t)(rb + j) * N : v);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (j < n) {
            const uint32_t wj = col_ok ? vw[j] ^ kBias : kBias;
            float q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) q[i] = s8_to_float(wj, i);
            const float* xr = smem + (rb - s0 + j) * CT;
#pragma unroll
            for (int c = 0; c < CT; ++c) {
              if ((comp >> c) & 1u) {
                const float xj = xr[c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[c][i] += xj * q[i];
              }
            }
          }
        }
      }
    }
  }

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
    if (c0 + c >= C || n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) y += smem[(w * CT + c) * BN + nn];
    const size_t row = (size_t)e * C + c0 + c;
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
// xu (E,C,R) f32 scratch (written only where the mask is set and r <
// r_end); out (E,C,N) f32.
// Requires K % 64 == 0, group_size % 64 == 0, K % group_size == 0,
// N % 4 == 0, v 4-byte aligned; the tensor-core main kernel also x
// 16-byte aligned.
#define FE_PARAMS                                                            \
  const float *x, const uint8_t *plane0, const uint8_t *plane1,              \
      const float *scale, const float *zero, const int8_t *u,                \
      const float *u_scale, const int8_t *v, const float *v_scale,           \
      const float *me, const float *ge, const int *rank_cap,                 \
      const int *ranks, const int *expert_bits, const int *rows, float *xu,  \
      float *out, int E, int C, int K, int N, int R, int bits,               \
      int group_size, cudaStream_t stream
#define FE_ARGS                                                              \
  x, plane0, plane1, scale, zero, u, u_scale, v, v_scale, me, ge, rank_cap,  \
      ranks, expert_bits, rows, xu, out, E, C, K, N, R, bits, group_size,    \
      stream

// The rank-space pre-pass: xu = mask_r((x * me) @ U) with both factor
// scales folded in, the input of either main kernel's epilogue.  One
// launch: kXuSlots clusters of kXuCluster blocks below kFusedMmaMinC, one
// block per (rank tile, token tile, expert) from it; token tiles of
// token_tile(C).
int fused_expert_prepass(FE_PARAMS) {
  if (E <= 0 || C <= 0 || R <= 0) return (int)cudaGetLastError();
  const int ct = token_tile(C);
  cudaError_t err;
#define XU_LAUNCH(CTV, CSV, GRID)                                            \
  launch_xu<CTV, CSV>(GRID, stream, x, u, u_scale, v_scale, me, rank_cap,    \
                      ranks, xu, E, C, K, R)
  if (C >= kFusedMmaMinC) {
    err = XU_LAUNCH(8, 1, dim3((R + kXuTileR - 1) / kXuTileR, (C + 7) / 8, E));
  } else {
    const dim3 grid(kXuCluster, kXuSlots);
    switch (ct) {
      case 1: err = XU_LAUNCH(1, kXuCluster, grid); break;
      case 2: err = XU_LAUNCH(2, kXuCluster, grid); break;
      case 4: err = XU_LAUNCH(4, kXuCluster, grid); break;
      default: err = XU_LAUNCH(8, kXuCluster, grid); break;
    }
  }
#undef XU_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The CUDA-core main kernel (the one fused_expert_forward takes for
// C < kFusedMmaMinC), reading xu as the pre-pass left it.
int fused_expert_simt(FE_PARAMS) {
  if (E <= 0 || C <= 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(v) % 4 != 0)
    return (int)cudaErrorInvalidValue;
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
