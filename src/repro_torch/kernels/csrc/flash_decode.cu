// Flash-decode attention for Hopper: one launch per call, the slots of a
// (row, kv-head) split over a thread-block cluster and merged in its
// distributed shared memory.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// flash_decode_attention (bodies _kernel / _wrap_noscale): GQA decode of
// one query token per row with an online softmax, mask pos >= 0 &&
// pos <= cur (&& pos > cur - window) for positions in any order (a ring
// cache is not sorted), and, for an int8 cache, the per-(slot, head) K/V
// scales folded into the scores and the probabilities so the dequantized
// cache never exists.
//
// What bounds it on the H100: bytes.  Each valid slot's K and V rows (and
// int8 scales) are read once and serve G = H/KVH query heads, a few
// operations per byte.
//
// What the earlier version (split + combine kernels) lost, and what this
// design does about it (numbers: NVIDIA H100 80GB HBM3, 700 W,
// tools/flash_decode_timing.py and chip_smoke.py, PERF.md §6):
// 1. Two launches and device-memory partials (split + combine kernels).
//    Now one launch: the unit of work is one (b, kvh) row, its slots
//    split over a cluster of CL blocks (CL in {1, 2, 4, 8}, launched with
//    cudaLaunchKernelEx and a cluster dimension).  Each block merges its
//    warps' (m, l, acc) in shared memory; the cluster's blocks then merge
//    through distributed shared memory (map_shared_rank, cluster.sync) in
//    rank order and write out (B, H, hd) directly.  Fixed orders
//    throughout: two calls give bitwise-equal outputs.
// 2. More than one wave, a third of the blocks idle.  The host picks CL
//    so that the grid is one resident wave (decode_attention.py::
//    launch_geometry, from cudaOccupancyMaxActiveClusters), and deals the
//    warp tiles of SPW slots round-robin over the cluster's warps, so a
//    cache filled from slot 0 keeps every warp busy.
// 3. No overlap of loads and compute.  Each warp walks its tiles through
//    its own ring of ST stages (3 for f32 rows, 4 for bf16/int8) filled
//    with 16-byte cp.async, ST - 1 tiles in flight while one is computed.
//    A tile's positions are copied ST tiles ahead of its rows, so a tile
//    whose slots are all masked issues no K/V copy; the masked slots of a
//    live tile are zero-filled without a read.
// 4. Narrow loads.  Rows move and are read as 16-byte vectors; int8
//    codes become floats by a byte permute and one subtraction.
// 5. Registers for the worst case, a 5-step shuffle per score.  LPS =
//    32 / SPW lanes own one slot (a quarter warp reads distinct banks:
//    rows of a multiple of 128 bytes swizzle their 16-byte chunks, shorter
//    rows are padded); each shuffle round runs over all G heads at once,
//    log2(LPS) rounds for the score, 5 - log2(LPS) for the tile's max.
//    Scores are in log2 units (q carries log2(e)), so exp2 is the
//    softmax's exp.  For the value sum a lane owns hd/32 dimensions and
//    the probabilities come through shared memory.  Templated on the
//    group size (1, 2, 3, 4, or 8 for 5..8): no spills at any
//    instantiation.
// 6. G 9..16 query heads per kv head (RecurrentGemma's MQA: G 16 at hd
//    256).  A GP 16 instantiation does not fit: its warp merge needs
//    kWarps * 16 * (HD + 2) * 4 = 66 KB at hd 256, more than the K/V ring
//    it reuses (48 KB in f32, 64 KB in bf16), and its online-softmax state
//    (16 x EPL accumulators and 5 x 16 per-head values per lane) would not
//    stay in the 255 registers of two blocks per SM.  So a kv head's G
//    query heads split into ceil(G / 2) query-head groups of 2, each a
//    block row of its own (grid y = KVH * groups, the GP 2 code as it
//    is): every group reads the kv head's K/V, mostly from L2, and the
//    grid has G / 2 times the rows to fill the card with at MQA's B * KVH
//    = B.  Measured at RecurrentGemma's ring (B 4, S 2048, hd 256; bf16 /
//    f32 ms, tools/flash_decode_timing.py, PERF.md PR 29): 2 groups of 8
//    0.0477 / 0.0528, 4 of 4 0.0421 / 0.0447, 8 of 2 0.0347 / 0.0399, 16
//    of 1 0.0430 / 0.0588 (its 64 rows take clusters of 4, not 8).
// Measured: S 512 (288 valid), Mixtral's shape, f32 0.016 ms (earlier
// 0.0205); S 32768 73% of the byte bound in f32 (earlier 41%), 63% in bf16
// (12%), 43% in int8 (6%).  At S 512 an empty kernel of the same launch
// shape already takes a third of the time.  What keeps long S below the
// bound is open (PERF.md §7); a variant with q in registers and the scores
// summed by a reduce-scatter over the lanes was slower.
//
// Block-table mode (paged KV cache; the PAGED instantiations): with a
// block table (B, MB) of int32 page ids (-1 = unmapped) and a page size PS
// (a power of two), k, v, the scales and kv_pos are a page pool (P, PS,
// ...) and slot s of row b (S = MB * PS logical slots) lives at flat row
// max(block[b][s / PS], 0) * PS + s % PS, its position forced to -1 where
// the entry is unmapped: the rule of the plain route (gather each row's
// view from the pool, then the contiguous kernel), so the two agree bit
// for bit.  Only the row address changes; the tiling, the cluster merge
// and the arithmetic are the contiguous mode's, and the pool's bytes are
// read once, never gathered.  A lane of a tile resolves its slot's flat
// row when the tile issues and hands it by shuffle to the lanes that copy
// the row; it also ballots which half of its 4-byte word the slot's int8
// scale is (the parity of the flat index, no longer the slot's); an
// unmapped page's positions are stored as -1 instead of copied.  The mode
// is a template flag, so the contiguous instantiations are the code they
// were (a run-time branch cost them 3-10% at S 32768 and 7% at S 512:
// more registers and the per-tile row lookups, PERF.md §6); the PAGED
// instantiations are a library of their own (flash_decode_paged.cu
// includes this file with FD_PAGED 1), so the two build in parallel.
//
// Multi-query mode (NQ > 1 query positions per row, each with its own
// position: the verify pass of speculative decoding): each (row, query)
// pair is a virtual row, blockIdx.z = b * NQ + i, that reads row b's K/V
// (or its block-table row) and runs exactly the tiling, online softmax
// and cluster merge of a single-query call at position cur_pos[b][i].
// The host gives it the cluster size a single-query call at the same
// (B, S) takes (not one sized for B * NQ rows), so each query's output
// equals that call's bit for bit.  The NQ queries of a row read its K/V
// NQ times (no tile is shared between them: ROADMAP B7).
//
// A row with no valid slot gives what the plain version and the TPU
// kernel give there, since their softmax runs over masked scores that are
// all equal: the mean over the row's S slots of V (times v_scale for an
// int8 cache).  The cluster finds such a row after its merge (every
// block's l is 0) and only then reads those V rows.  Decode never asks for
// such a row (the current token's slot is written before attention).
//
// Plain C interface (route b of the build): the entry point returns the
// launch's error code (a refused cluster launch included).
#ifndef FD_PAGED
#define FD_PAGED 0
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 4;          // K/V ring depth of each warp
constexpr int kStageBytes = 16384;     // K + V bytes of one block-wide stage
constexpr int kMaxCluster = 8;
constexpr int kMaxQueries = 8;         // query positions per row
constexpr float NEG = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shapes of one instantiation.  SPW (slots per warp tile) makes one
// block-wide stage kStageBytes; LPS lanes score one slot, each reading VPL
// 16-byte vectors of its row; a lane sums EPL dimensions of V.
template <typename T, int HD, int GP, bool PAGED = false>
struct Geo {
  // ring depth: 3 stages for f32 rows, 4 for narrower ones (measured:
  // PERF.md §6)
  static constexpr int ST = sizeof(T) == 4 ? kMaxStages - 1 : kMaxStages;
  static constexpr int PT = 2 * ST;                  // positions ring depth
  static constexpr int RB = HD * (int)sizeof(T);
  static constexpr int SPW0 = kStageBytes / (kWarps * 2 * RB);
  static constexpr int SPW = SPW0 < 1 ? 1 : (SPW0 > 32 ? 32 : SPW0);
  static constexpr int LPS = 32 / SPW;
  static constexpr int RV = RB / 16;
  static constexpr int VPL = RV / LPS;
  static constexpr int EPV = 16 / (int)sizeof(T);
  static constexpr int EPL = HD / 32;
  // A quarter warp reads 8 / LPS rows at once, LPS * 16 contiguous bytes
  // of each.  Rows of a multiple of 128 bytes swizzle their 16-byte chunks
  // (chunk ^ LPS * (row % (8 / LPS))) so those reads fall on distinct
  // banks; shorter rows are padded to a stride of LPS * 16 bytes modulo
  // 128.  Every slot reads q in the same order, a broadcast.
  static constexpr bool SWZ = LPS < 8 && RB % 128 == 0;
  static constexpr int PAD = LPS >= 8 || SWZ
                                 ? 0 : ((16 * LPS - RB) % 128 + 128) % 128;
  static constexpr int STRIDE = RB + PAD;
  static constexpr int STAGE = 2 * SPW * STRIDE;     // K rows, then V rows
  static constexpr int RING = kWarps * ST * STAGE;
  static constexpr int POS = kWarps * PT * SPW * 4;
  static constexpr int SCL = kWarps * ST * SPW * 8;    // k/v scale words
  // valid-slot bits per stage (and, paged, the scale words' hi-half bits)
  static constexpr int MASK = (PAGED ? 2 : 1) * kWarps * ST * 4;
  static constexpr int PB = ((kWarps * SPW * GP * 4 + 15) / 16) * 16;
  static constexpr int QS = GP * HD * 4;
  static constexpr int BM = ((2 * GP * 4 + 15) / 16) * 16;  // m, l
  static constexpr int BACC = GP * HD * 4;
  static constexpr int OFF_POS = RING;
  static constexpr int OFF_SCL = OFF_POS + POS;
  static constexpr int OFF_MASK = OFF_SCL + SCL;
  static constexpr int OFF_PB = OFF_MASK + MASK;
  static constexpr int OFF_Q = OFF_PB + PB;
  static constexpr int OFF_BM = OFF_Q + QS;
  static constexpr int OFF_BACC = OFF_BM + BM;
  static constexpr int SMEM = OFF_BACC + BACC;
  static_assert(RV % LPS == 0 && VPL >= 1, "row split");
  static_assert(EPL >= 1 && EPV % 4 == 0, "lane split");
  static_assert(kWarps * GP * (HD + 2) * 4 <= RING, "warp merge fits");
  static_assert(OFF_Q % 16 == 0, "alignment");
  // byte offset of 16-byte chunk ch of ring row j
  __device__ static int chunk(int j, int ch) {
    return j * STRIDE + (SWZ ? ch ^ (LPS * (j % (8 / LPS))) : ch) * 16;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// one 32-bit word of a row -> its elements as floats
template <typename T>
__device__ __forceinline__ void word_to_f(uint32_t w, float* out);
template <>
__device__ __forceinline__ void word_to_f<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void word_to_f<__nv_bfloat16>(uint32_t w,
                                                         float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xFFFF0000u);
}
// int8 codes: byte b ^ 0x80 placed under the exponent of 2^23 gives the
// float 2^23 + 128 + b exactly (a byte permute and a subtraction, no
// int-to-float conversion)
template <>
__device__ __forceinline__ void word_to_f<int8_t>(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) -
             8388736.f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// N consecutive elements of T at p (shared memory, aligned to their
// size) as floats, in the widest loads that fit
template <typename T, int N>
__device__ __forceinline__ void load_elems(const char* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  constexpr int PW = 4 / (int)sizeof(T);     // elements per 32-bit word
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[i];
      word_to_f<T>(r.x, out + (4 * i + 0) * PW);
      word_to_f<T>(r.y, out + (4 * i + 1) * PW);
      word_to_f<T>(r.z, out + (4 * i + 2) * PW);
      word_to_f<T>(r.w, out + (4 * i + 3) * PW);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    word_to_f<T>(r.x, out);
    word_to_f<T>(r.y, out + PW);
  } else if constexpr (BYTES == 4) {
    word_to_f<T>(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f(reinterpret_cast<const T*>(p)[e]);
  }
}

// q (B,NQ,H,HD) f32 pre-scaled; k/v (B,S,KVH,HD) T; ks/vs (B,S,KVH) bf16
// or null; kv_pos (B,S) i32; cur (B,NQ) i32; out (B,NQ,H,HD) f32.  Grid
// (CL, KVH * NSPL, B * NQ) in clusters of (CL, 1, 1): G query heads per kv
// head in NSPL groups of GS (<= GP; the last group may hold fewer).
// PAGED: block (B, S / PS) i32, and k/v (P,PS,KVH,HD), ks/vs (P,PS,KVH),
// kv_pos (P,PS) a page pool of n_rows = P * PS rows.
template <typename T, int HD, int GP, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const __nv_bfloat16* __restrict__ ks,
                    const __nv_bfloat16* __restrict__ vs,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ cur_pos,
                    const int* __restrict__ block, float* __restrict__ out,
                    int S, int H, int KVH, int G, int GS, int window,
                    int PS, int n_rows, int NQ) {
  using Gm = Geo<T, HD, GP, PAGED>;
  constexpr int SPW = Gm::SPW, LPS = Gm::LPS, EPV = Gm::EPV, EPL = Gm::EPL;
  constexpr int ST = Gm::ST, PT = Gm::PT, STAGE = Gm::STAGE, STRIDE = Gm::STRIDE;
  extern __shared__ __align__(16) char smem[];
  unsigned* mask_s = reinterpret_cast<unsigned*>(smem + Gm::OFF_MASK);
  float* pb_s = reinterpret_cast<float*>(smem + Gm::OFF_PB);
  float* q_s = reinterpret_cast<float*>(smem + Gm::OFF_Q);
  float* bm_s = reinterpret_cast<float*>(smem + Gm::OFF_BM);   // m[GP], l[GP]
  float* bacc_s = reinterpret_cast<float*>(smem + Gm::OFF_BACC);

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // vb: the virtual row (row b, query vb % NQ); K/V are row b's.
  // blockIdx.y: kv head kvh's query-head group sub, its GB heads from h0
  const int NSPL = gridDim.y / KVH;
  const int kvh = blockIdx.y / NSPL, sub = blockIdx.y % NSPL;
  const int h0 = kvh * G + sub * GS, GB = min(GS, G - sub * GS);
  const int vb = blockIdx.z, b = vb / NQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool scaled = ks != nullptr;
  const size_t n_scales = PAGED ? (size_t)n_rows * KVH
                                : (size_t)(gridDim.z / NQ) * S * KVH;
  // PAGED: log2(PS), this row's block-table row, and the flat pool row of
  // slot s (an unmapped entry reads page 0; its position is forced -1)
  const int ps_log2 = PAGED ? 31 - __clz(PS) : 0;
  const int* brow = PAGED ? block + (size_t)b * (S >> ps_log2) : nullptr;
  auto page_of = [&](int s) { return brow[s >> ps_log2]; };
  auto flat_row = [&](int s, int pg) {
    return max(pg, 0) * PS + (s & (PS - 1));
  };

  // this warp's tiles: u = gw, gw + NW, ... below NWT
  const int NW = CL * kWarps, gw = rank * kWarps + warp;
  const int NWT = (S + SPW - 1) / SPW;
  const int n = NWT > gw ? (NWT - 1 - gw) / NW + 1 : 0;
  int* pos_s = reinterpret_cast<int*>(smem + Gm::OFF_POS) +
               warp * PT * SPW;                 // [PT][SPW]
  uint32_t* scl_s = reinterpret_cast<uint32_t*>(smem + Gm::OFF_SCL) +
                    warp * ST * SPW * 2;          // [ST][2][SPW]
  char* ring = smem + (size_t)warp * ST * STAGE;

  // positions of tile t into the positions ring (cp.async)
  auto copy_pos = [&](int t) {
    const int s = (gw + NW * t) * SPW + lane;
    if (t < n && lane < SPW && s < S) {
      if constexpr (PAGED) {
        const int pg = page_of(s);
        if (pg < 0)
          pos_s[(t % PT) * SPW + lane] = -1;
        else
          cp_async4(pos_s + (t % PT) * SPW + lane,
                    kv_pos + flat_row(s, pg), 4);
      } else {
        cp_async4(pos_s + (t % PT) * SPW + lane,
                  kv_pos + (size_t)b * S + s, 4);
      }
    }
  };
  // Tile t: its K and V rows into ring stage t % ST by 16-byte
  // cp.async (a tile with no valid slot issues none; the masked rows of a
  // live tile are zero-filled without a read), the 4-byte words holding
  // its int8 scales, and the positions of tile t + ST; one commit
  // group.
  auto issue = [&](int t, int cur) {
    const int st = t % ST;
    const int s0 = (gw + NW * t) * SPW;
    bool ok = false;
    if (t < n && lane < SPW && s0 + lane < S) {
      const int pos = pos_s[(t % PT) * SPW + lane];
      ok = pos >= 0 && pos <= cur && (window <= 0 || pos > cur - window);
    }
    // PAGED: this lane's slot's flat row (the tile's last slot past S)
    int fr = 0;
    if constexpr (PAGED) {
      if (t < n && lane < SPW) {
        const int s = min(s0 + lane, S - 1);
        fr = flat_row(s, page_of(s));
      }
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ok);
    if (lane == 0) mask_s[warp * ST + st] = mask;
    if constexpr (PAGED) {
      // which half of its 4-byte word each slot's bf16 scale is
      const unsigned hi =
          __ballot_sync(0xFFFFFFFFu, (((size_t)fr * KVH + kvh) & 1) != 0);
      if (lane == 0) mask_s[kWarps * ST + warp * ST + st] = hi;
    }
    if (mask != 0u) {
      constexpr int CPR = Gm::RB / 16;        // 16-byte chunks of a row
      static_assert(!PAGED || SPW * CPR % 32 == 0,
                    "every lane shuffles alike");
      char* dk = ring + st * STAGE;
      char* dv = dk + SPW * STRIDE;
#pragma unroll
      for (int idx = lane; idx < SPW * CPR; idx += 32) {
        const int j = idx / CPR, ch = idx % CPR;
        const int src = (mask >> j) & 1u ? 16 : 0;
        size_t row;
        if constexpr (PAGED)
          row = (size_t)__shfl_sync(0xFFFFFFFFu, fr, j) * KVH + kvh;
        else
          row = ((size_t)b * S + min(s0 + j, S - 1)) * KVH + kvh;
        const size_t off = row * Gm::RB + ch * 16;
        cp_async16(dk + Gm::chunk(j, ch), reinterpret_cast<const char*>(k) + off, src);
        cp_async16(dv + Gm::chunk(j, ch), reinterpret_cast<const char*>(v) + off, src);
      }
      if (scaled && ok) {
        const size_t w = (PAGED ? (size_t)fr * KVH + kvh
                                : ((size_t)b * S + s0 + lane) * KVH + kvh) &
                         ~(size_t)1;
        const int nb = w + 1 < n_scales ? 4 : 2;
        uint32_t* sc = scl_s + st * 2 * SPW + lane;
        cp_async4(sc, ks + w, nb);
        cp_async4(sc + SPW, vs + w, nb);
      }
    }
    copy_pos(t + ST);
    cp_async_commit();
  };

  // online-softmax state: m replicated over the warp, l summed over lanes
  // at the end, acc[g] over this lane's EPL dimensions
  float m[GP], lp[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG;
    lp[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  const int j = lane / LPS, c = lane % LPS;

  // tile i from ring stage i % ST into (m, l, acc)
  auto compute = [&](int i) {
    const int st = i % ST;
    const unsigned mask = mask_s[warp * ST + st];
    if (mask == 0u) return;
    const char* kt = ring + st * STAGE;
    const char* vt = kt + SPW * STRIDE;
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
#pragma unroll
    for (int vi = 0; vi < Gm::VPL; ++vi) {
      const int vec = c + LPS * vi;
      float kf[EPV];
      load_elems<T, EPV>(kt + Gm::chunk(j, vec), kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * HD + vec * EPV);
#pragma unroll
        for (int e4 = 0; e4 < EPV / 4; ++e4) {
          const float4 qq = qv[e4];
          s[g] += qq.x * kf[4 * e4] + qq.y * kf[4 * e4 + 1] +
                  qq.z * kf[4 * e4 + 2] + qq.w * kf[4 * e4 + 3];
        }
      }
    }
    const bool ok = (mask >> j) & 1u;
    float ksc = 1.f, vsc = 1.f;
    if (scaled) {
      bool hi;
      if constexpr (PAGED) {
        hi = (mask_s[kWarps * ST + warp * ST + st] >> j) & 1u;
      } else {
        const int slot = (gw + NW * i) * SPW + j;
        hi = ((((size_t)b * S + slot) * KVH + kvh) & 1) != 0;
      }
      const uint32_t* sc = scl_s + st * 2 * SPW + j;
      ksc = __uint_as_float(hi ? (sc[0] & 0xFFFF0000u) : (sc[0] << 16));
      vsc = __uint_as_float(hi ? (sc[SPW] & 0xFFFF0000u) : (sc[SPW] << 16));
    }
    // each shuffle round over every head at once (the rounds of one head
    // depend on each other, the heads do not); scores are in log2 units
    // (q carries log2(e)), so exp2 is the softmax's exp
#pragma unroll
    for (int o = LPS / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] += __shfl_xor_sync(0xFFFFFFFFu, s[g], o);
    float mx[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) mx[g] = s[g] = ok ? s[g] * ksc : NEG;
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xFFFFFFFFu, mx[g], o));
    float alpha[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mn = fmaxf(m[g], mx[g]);
      alpha[g] = exp2f(m[g] - mn);
      const float p = ok ? exp2f(s[g] - mn) : 0.f;
      lp[g] = lp[g] * alpha[g] + (c == 0 ? p : 0.f);
      if (c == 0) pb_s[(warp * SPW + j) * GP + g] = ok ? p * vsc : 0.f;
      m[g] = mn;
    }
    __syncwarp();                   // pb_s
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e2 = 0; e2 < EPL; ++e2) acc[g][e2] *= alpha[g];
    constexpr int VB = EPL * (int)sizeof(T);       // V bytes of a lane
    static_assert(VB <= 16 || !Gm::SWZ, "a swizzled lane reads one chunk");
#pragma unroll
    for (int jj = 0; jj < SPW; ++jj) {
      float vf[EPL];
      const int o = lane * VB;
      load_elems<T, EPL>(vt + (VB > 16 ? jj * STRIDE + o
                                       : Gm::chunk(jj, o / 16) + o % 16), vf);
      const float* pj = pb_s + (warp * SPW + jj) * GP;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float p = pj[g];
#pragma unroll
        for (int e2 = 0; e2 < EPL; ++e2) acc[g][e2] += p * vf[e2];
      }
    }
  };

  // the positions of the first ST tiles, then the first stages of
  // the ring; q lands in shared memory meanwhile
#pragma unroll
  for (int t = 0; t < ST; ++t) copy_pos(t);
  cp_async_commit();
  const int cur = cur_pos[vb];
  for (int i = tid; i < GP * HD; i += kThreads)
    q_s[i] = i / HD < GB ? q[((size_t)vb * H + h0) * HD + i] * kLog2e
                         : 0.f;
  cp_async_wait<0>();
  __syncthreads();                  // q_s; every lane's positions
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) issue(t, cur);
  for (int i = 0; i < n; ++i) {
    __syncwarp();                   // stage (i - 1) % ST is free
    issue(i + ST - 1, cur);
    cp_async_wait<ST - 1>();   // tile i's rows and scales; the
    __syncwarp();                   // positions the next issue reads
    compute(i);
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring becomes the warp-merge area

  // merge the block's warps
  float* wm = reinterpret_cast<float*>(smem);          // [kWarps][GP]
  float* wl = wm + kWarps * GP;                        // [kWarps][GP]
  float* wacc = wl + kWarps * GP;                      // [kWarps][GP][HD]
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) lp[g] += __shfl_xor_sync(0xFFFFFFFFu, lp[g], o);
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane == 0) {
      wm[warp * GP + g] = m[g];
      wl[warp * GP + g] = lp[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      wacc[(warp * GP + g) * HD + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < GP * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * GP + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * GP + g] - M);
      L += wl[w * GP + g] * f;
      A += wacc[(w * GP + g) * HD + d] * f;
    }
    bacc_s[idx] = A;
    if (d == 0) {
      bm_s[g] = M;
      bm_s[GP + g] = L;
    }
  }

  // merge the cluster's blocks, in rank order, through distributed shared
  // memory; each block writes a share of the outputs
  cluster.sync();
  auto rbm = [&](int r) { return cluster.map_shared_rank(bm_s, r); };
  auto racc = [&](int r) { return cluster.map_shared_rank(bacc_s, r); };
  float Ltot = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < CL) Ltot += rbm(r)[GP];                    // head 0's l
  float* orow = out + ((size_t)vb * H + h0) * HD;
  if (Ltot > 0.f) {
    for (int idx = rank * kThreads + tid; idx < GB * HD;
         idx += CL * kThreads) {
      // every rank's values loaded at once, then summed in rank order
      const int g = idx / HD;
      float rm[kMaxCluster], rl[kMaxCluster], ra[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < CL) {
          rm[r] = rbm(r)[g];
          rl[r] = rbm(r)[GP + g];
          ra[r] = racc(r)[idx];
        }
      float M = NEG;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < CL) M = fmaxf(M, rm[r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < CL) {
          const float f = exp2f(rm[r] - M);
          L += rl[r] * f;
          A += ra[r] * f;
        }
      orow[idx] = A / L;
    }
  } else {
    // no valid slot in the row: the mean of V (x v_scale) over its S
    // slots, each block summing its own tiles' slots, then rank order
    cluster.sync();                 // every block is done reading bacc
    const int TS = kWarps * SPW, NT = (S + TS - 1) / TS;
    for (int d = tid; d < HD; d += kThreads) {
      float A = 0.f;
      for (int t = rank; t < NT; t += CL)
        for (int s = t * TS; s < min(S, t * TS + TS); ++s) {
          const size_t r =
              (PAGED ? (size_t)flat_row(s, page_of(s)) : (size_t)b * S + s) *
                  KVH + kvh;
          float val = to_f(v[r * HD + d]);
          if (scaled) val *= __bfloat162float(vs[r]);
          A += val;
        }
      bacc_s[d] = A;
    }
    cluster.sync();
    for (int idx = rank * kThreads + tid; idx < GB * HD;
         idx += CL * kThreads) {
      const int d = idx % HD;
      float A = 0.f;
      for (int r = 0; r < CL; ++r) A += racc(r)[d];
      orow[idx] = A / (float)S;
    }
  }
  cluster.sync();                   // no block leaves while it is read
}

template <typename T, int HD, int GP, bool PAGED>
cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int cl, int rows,
                               int groups, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, groups, rows);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Geo<T, HD, GP, PAGED>::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int HD, int GP, bool PAGED>
int prepare() {
  static int rc = -1;               // once per instantiation
  if (rc < 0)
    rc = (int)cudaFuncSetAttribute(flash_decode_kernel<T, HD, GP, PAGED>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Geo<T, HD, GP, PAGED>::SMEM);
  return rc;
}

// query heads per block row and query-head groups per kv head: all G in
// one group for G <= 8, groups of 2 for G 9..16 (design note 6)
constexpr int kMaxGroup = 16;
inline int group_heads(int G) { return G <= 8 ? G : 2; }
inline int splits_of(int G) {
  return (G + group_heads(G) - 1) / group_heads(G);
}

template <typename T, int HD, int GP, bool PAGED>
int launch_mode(const float* q, const void* k, const void* v, const void* ks,
                const void* vs, const int* kv_pos, const int* cur_pos,
                const int* block, float* out, int B, int S, int H, int KVH,
                int window, int cl, int PS, int n_rows, int nq,
                cudaStream_t stream) {
  int rc = prepare<T, HD, GP, PAGED>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const int G = H / KVH;
  const cudaLaunchConfig_t cfg = make_config<T, HD, GP, PAGED>(
      attr, cl, B * nq, KVH * splits_of(G), stream);
  rc = (int)cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<T, HD, GP, PAGED>, q, static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), kv_pos, cur_pos, block, out, S, H,
      KVH, G, group_heads(G), window, PS, n_rows, nq);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

template <typename T, int HD, int GP>
int max_clusters(int cl, int* n) {
  int rc = prepare<T, HD, GP, false>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      make_config<T, HD, GP, false>(attr, cl, 1, 1, 0);
  return (int)cudaOccupancyMaxActiveClusters(
      n, flash_decode_kernel<T, HD, GP, false>, &cfg);
}

// the group-size template for G query heads per kv head (a block row
// holds group_heads(G) of them)
inline int group_of(int G) {
  const int gs = G <= kMaxGroup ? group_heads(G) : -1;
  return gs <= 4 ? gs : 8;
}

// F<T, HD, GP>(...) for the run-time (kind, HD, G); cudaErrorInvalidValue
// where no instantiation exists
template <template <typename, int, int> class F, typename... A>
int dispatch(int kind, int HD, int G, A... args) {
#define FD_G(T, HDV)                                              \
  switch (group_of(G)) {                                          \
    case 1: return F<T, HDV, 1>::run(args...);                    \
    case 2: return F<T, HDV, 2>::run(args...);                    \
    case 3: return F<T, HDV, 3>::run(args...);                    \
    case 4: return F<T, HDV, 4>::run(args...);                    \
    case 8: return F<T, HDV, 8>::run(args...);                    \
    default: return (int)cudaErrorInvalidValue;                   \
  }
#define FD_HD(T)                                                  \
  switch (HD) {                                                   \
    case 32: FD_G(T, 32)                                          \
    case 64: FD_G(T, 64)                                          \
    case 128: FD_G(T, 128)                                        \
    case 256: FD_G(T, 256)                                        \
    default: return (int)cudaErrorInvalidValue;                   \
  }
  switch (kind) {
    case 0: FD_HD(float)
    case 1: FD_HD(__nv_bfloat16)
    case 2: FD_HD(int8_t)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_HD
#undef FD_G
  return (int)cudaErrorInvalidValue;
}

// this library's mode: the contiguous instantiations here, the PAGED ones
// in flash_decode_paged.cu (which includes this file with FD_PAGED 1)
template <typename T, int HD, int GP>
struct Launch {
  template <typename... A>
  static int run(A... a) {
    return launch_mode<T, HD, GP, (bool)FD_PAGED>(a...);
  }
};
template <typename T, int HD, int GP>
struct MaxClusters {
  static int run(int cl, int* n) { return max_clusters<T, HD, GP>(cl, n); }
};

inline bool cluster_ok(int cl) {
  return cl == 1 || cl == 2 || cl == 4 || cl == kMaxCluster;
}

inline bool args_ok(int B, int S, int H, int KVH, int cl, int kv_kind,
                    const void* k_scale, const void* v_scale, int nq) {
  return KVH > 0 && H % KVH == 0 && H / KVH <= kMaxGroup && B > 0 && S > 0 &&
         cluster_ok(cl) &&
         nq >= 1 && nq <= kMaxQueries &&
         (kv_kind == 2) == (k_scale != nullptr && v_scale != nullptr);
}

}  // namespace

extern "C" {

#if !FD_PAGED
// kv_kind: 0 = f32 cache, 1 = bf16 cache, 2 = int8 cache with bf16 scales.
// q (B,nq,H,HD), cur_pos (B,nq), out (B,nq,H,HD) f32: nq query positions
// per row (1 = single-query decode).  Requires HD in {32, 64, 128, 256},
// H/KVH <= 16, nq in 1..8, and cl (blocks per (row, query-head group), a
// cluster) in {1, 2, 4, 8}.
int flash_decode_forward(const float* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const int* kv_pos, const int* cur_pos, float* out,
                         int B, int S, int H, int KVH, int HD, int window,
                         int cl, int kv_kind, int nq, cudaStream_t stream) {
  if (!args_ok(B, S, H, KVH, cl, kv_kind, k_scale, v_scale, nq))
    return (int)cudaErrorInvalidValue;
  return dispatch<Launch>(kv_kind, HD, H / KVH, q, k, v, k_scale, v_scale,
                          kv_pos, cur_pos, static_cast<const int*>(nullptr),
                          out, B, S, H, KVH, window, cl, 0, B * S, nq,
                          stream);
}

// How many clusters of cl blocks of the instantiation for (kv_kind, HD,
// G) the card holds at once (cudaOccupancyMaxActiveClusters), in *n.  A
// paged call takes the cluster size of a contiguous one at its logical S,
// so the two deal the slots alike.
int flash_decode_max_clusters(int kv_kind, int HD, int G, int cl, int* n) {
  if (!cluster_ok(cl)) return (int)cudaErrorInvalidValue;
  return dispatch<MaxClusters>(kv_kind, HD, G, cl, n);
}
#else
// The block-table mode: as flash_decode_forward over a page pool, block
// (B, S / page_size) i32 page ids (-1 = unmapped) of a pool of num_pages
// pages of page_size (a power of two) slots.
int flash_decode_paged_forward(const float* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const int* kv_pos, const int* cur_pos,
                               const int* block, float* out, int B, int S,
                               int H, int KVH, int HD, int window, int cl,
                               int kv_kind, int page_size, int num_pages,
                               int nq, cudaStream_t stream) {
  if (!args_ok(B, S, H, KVH, cl, kv_kind, k_scale, v_scale, nq) ||
      block == nullptr || page_size <= 0 ||
      (page_size & (page_size - 1)) != 0 || S % page_size != 0 ||
      num_pages <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<Launch>(kv_kind, HD, H / KVH, q, k, v, k_scale, v_scale,
                          kv_pos, cur_pos, block, out, B, S, H, KVH, window,
                          cl, page_size, num_pages * page_size, nq, stream);
}
#endif

}  // extern "C"
