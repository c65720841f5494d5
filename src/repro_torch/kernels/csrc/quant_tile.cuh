// Shared device code of the quantized-matmul kernels (fused_expert.cu,
// quant_matmul.cu): one warp's walk over the 64-row pack blocks of a
// bit-plane-packed weight, for one token tile and one 128-column tile.
//
// Layout read (core/quantize.py): block-local bit planes, so the codes of
// 4 adjacent columns for one plane row sit in one 32-bit word.  A lane owns
// 4 columns, loads one word per plane row (coalesced 128 B per warp) and
// unpacks in registers; 3-bit weights combine the 2-bit and 1-bit planes.
// Dequantization is factored per pack block: sum_k x*(q-z)*s =
// s*(sum_k x*q - z*sum_k x), so the inner loop is one byte-permute, one add
// and CT multiply-adds per weight; codes become floats with the 2^23
// exponent trick instead of the slow integer-to-float convert.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace quant_tile {

constexpr int PACK = 64;        // K rows per packing block (PACK_BLOCK)
constexpr int BN = 128;         // output columns per block (4 per lane)
constexpr int WARPS = 8;        // warps per block of the main kernels

// byte i of `word`, as the float value of that byte (exact for 0..255):
// prmt builds the bit pattern of 2^23 + byte, then 2^23 is subtracted.
__device__ __forceinline__ float byte_to_float(uint32_t word, int i) {
  const uint32_t sel = (uint32_t)i | 0x7540u;   // bytes: [i, 0, 0, 0x4B]
  const uint32_t bits = __byte_perm(word, 0x4B000000u, sel);
  return __uint_as_float(bits) - 8388608.f;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int BITS> struct Fmt;
template <> struct Fmt<1> { static constexpr int P0 = 1, P1 = 0; };
template <> struct Fmt<2> { static constexpr int P0 = 2, P1 = 0; };
template <> struct Fmt<3> { static constexpr int P0 = 2, P1 = 1; };
template <> struct Fmt<4> { static constexpr int P0 = 4, P1 = 0; };
template <> struct Fmt<8> { static constexpr int P0 = 8, P1 = 0; };

// One warp's registers for one 64-row pack block: the packed codes of its
// 4 columns (one 32-bit word per plane row), their scale and zero, and
// the x values it stages into shared memory.
template <int BITS, int CT>
struct Tile {
  static constexpr int L0 = PACK * Fmt<BITS>::P0 / 8;
  static constexpr int L1 = Fmt<BITS>::P1 ? PACK * Fmt<BITS>::P1 / 8 : 1;
  uint32_t w0[L0];
  uint32_t w1[L1];
  float4 s, z;
  float x[CT][2];
};

// The operands of one (stack of) packed (K, N) weight(s): x (E, C, K) f32,
// plane0/plane1 (E, K*p/8, N) u8, scale/zero (E, K/G, N) f32.
struct Args {
  const float* x;
  const int* rows;      // (E,) occupied leading slots per expert, or null
  const uint8_t* plane0;
  const uint8_t* plane1;
  const float* scale;
  const float* zero;
  int C, K, N, group_size;
};

template <int BITS, int CT>
__device__ __forceinline__ void load_tile(Tile<BITS, CT>& t, const Args& a,
                                          int occ, int pb, int e, int c0,
                                          int lane,
                                          int col, bool col_ok,
                                          uint32_t keep0, uint32_t keep1) {
  using T = Tile<BITS, CT>;
  const float* xe = a.x + (size_t)e * a.C * a.K + pb * PACK + lane;
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      t.x[c][h] = (c0 + c < occ) ? xe[(size_t)(c0 + c) * a.K + 32 * h] : 0.f;
  if (col_ok) {
    const size_t rows0 = (size_t)a.K * Fmt<BITS>::P0 / 8;
    const uint8_t* p0 = a.plane0 + ((size_t)e * rows0 + (size_t)pb * T::L0) * a.N + col;
#pragma unroll
    for (int r = 0; r < T::L0; ++r)
      t.w0[r] = *reinterpret_cast<const uint32_t*>(p0 + (size_t)r * a.N) & keep0;
    if (Fmt<BITS>::P1) {
      const size_t rows1 = (size_t)a.K * Fmt<BITS>::P1 / 8;
      const uint8_t* p1 = a.plane1 + ((size_t)e * rows1 + (size_t)pb * T::L1) * a.N + col;
#pragma unroll
      for (int r = 0; r < T::L1; ++r)
        t.w1[r] = *reinterpret_cast<const uint32_t*>(p1 + (size_t)r * a.N) & keep1;
    }
    const int g = (pb * PACK) / a.group_size;
    const size_t sz = ((size_t)e * (a.K / a.group_size) + g) * a.N + col;
    t.s = *reinterpret_cast<const float4*>(a.scale + sz);
    t.z = *reinterpret_cast<const float4*>(a.zero + sz);
  }
}

// One warp's walk over pack blocks pb_begin + warp, + WARPS, ... below
// pb_end of expert e, tokens c0 .. c0+CT-1 (slots at or past occ read as
// zero), columns col .. col+3: acc[c][i] += sum over those rows of
// x[c0+c, k] * dequant(W)[k, col+i].  Planes are ANDed with keep0/keep1
// (a plane above an expert's true width is masked to zero).  Up to 4 bits,
// the warp loads its next pack block into registers while it computes the
// current one.  xs: this warp's CT*PACK floats of shared memory.  The loop
// bounds are warp-uniform, so every lane reaches the __syncwarp()s.
template <int BITS, int CT>
__device__ __forceinline__ void warp_k_walk(const Args& a, int occ, int e,
                                            int c0, int pb_begin, int pb_end,
                                            int warp, int lane, int col,
                                            bool col_ok, uint32_t keep0,
                                            uint32_t keep1, float* xs,
                                            float (&acc)[CT][4]) {
  constexpr int P0 = Fmt<BITS>::P0;
  constexpr int P1 = Fmt<BITS>::P1;
  using T = Tile<BITS, CT>;
  constexpr int L0 = T::L0, L1 = T::L1;
  constexpr uint32_t M0 = ((1u << P0) - 1u) * 0x01010101u;
  constexpr uint32_t M1 = P1 ? ((1u << P1) - 1u) * 0x01010101u : 0u;
  constexpr bool PREFETCH = BITS <= 4;

  const int first = pb_begin + warp;
  T cur, nxt;
  if (first < pb_end)
    load_tile<BITS, CT>(cur, a, occ, first, e, c0, lane, col, col_ok, keep0, keep1);
  for (int pb = first; pb < pb_end; pb += WARPS) {
    const int pn = pb + WARPS;
    if (PREFETCH && pn < pb_end)
      load_tile<BITS, CT>(nxt, a, occ, pn, e, c0, lane, col, col_ok, keep0, keep1);
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
    __syncwarp();
    if (PREFETCH) {
      cur = nxt;
    } else if (pn < pb_end) {
      load_tile<BITS, CT>(cur, a, occ, pn, e, c0, lane, col, col_ok, keep0, keep1);
    }
  }
}

// Token-tile width for C tokens: the smallest of 1, 2, 4, 8 that holds
// them (8 for more).
__host__ __device__ __forceinline__ int token_tile(int C) {
  return C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
}

}  // namespace quant_tile
