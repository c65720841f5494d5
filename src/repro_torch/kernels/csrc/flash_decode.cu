// Split-KV flash-decode attention for Hopper (one query token per row).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// flash_decode_attention (bodies _kernel / _wrap_noscale): GQA decode with
// an online softmax, mask pos >= 0 && pos <= cur (&& pos > cur - window),
// and, for an int8 cache, the per-(slot, head) K/V scales folded into the
// scores and the probabilities so the dequantized cache never exists.
//
// What bounds it on the H100: the bytes of the K/V rows of valid slots
// (plus positions and scales); each row is used for G = H/KVH query heads,
// a few operations per byte.
//
// What the design does about that: the TPU grid walks S in order on one
// core; here B*KVH (32 for Mixtral at batch 4) is far below 132 SMs, so S
// is split into chunks (flash-decoding).  flash_decode_split_kernel runs
// one block per (chunk, kv-head, batch row); its 4 warps take 8 slots at a
// time, a lane holds hd/32 elements of a row so one K row is one
// coalesced warp load that serves all G heads, the 8 rows' loads are in
// flight together, and an empty or masked slot is skipped before its K/V
// row is read.  Each warp keeps (m, l, acc) in
// registers; the warps merge in shared memory and write one partial per
// (row, head, chunk); flash_decode_combine_kernel merges the chunks.
//
// A row with no valid slot gives zeros (acc 0 over max(l, 1e-30)); the
// plain version and the TPU kernel give the mean of V over the row's
// slots there, since their softmax runs over masked scores that are all
// equal.  Decode never asks for such a row: the current token's slot is
// written before attention reads the cache.
//
// Plain C interface (route b of the build): the entry point returns
// cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAXG = 8;            // query heads per kv head
constexpr int KT = 8;              // slots per warp step
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float (&out)[EPL]) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) out[j] = to_f(p[j]);
}

// q (B,H,HD) f32 pre-scaled; k/v (B,S,KVH,HD) T; ks/vs (B,S,KVH) bf16 or
// null; kv_pos (B,S) i32; cur (B,) i32.  Writes pm/pl (B,H,NC) and
// pacc (B,H,NC,HD).
template <typename T, int EPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_split_kernel(const float* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v,
                          const __nv_bfloat16* __restrict__ ks,
                          const __nv_bfloat16* __restrict__ vs,
                          const int* __restrict__ kv_pos,
                          const int* __restrict__ cur_pos,
                          float* __restrict__ pm, float* __restrict__ pl,
                          float* __restrict__ pacc,
                          int S, int H, int KVH, int window, int chunk) {
  constexpr int HD = EPL * 32;
  const int ci = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cur = cur_pos[b];
  const int s_begin = ci * chunk;
  const int s_end = min(S, s_begin + chunk);

  float qr[MAXG][EPL];
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      acc[g][j] = 0.f;
      qr[g][j] = g < G ? q[((size_t)b * H + kvh * G + g) * HD + lane * EPL + j]
                       : 0.f;
    }
  }

  // Each warp takes KT consecutive slots per step: lane j reads slot j's
  // position, the valid rows' K and V loads are all issued before any is
  // used, and the online softmax folds the KT scores in at once.
  for (int base = s_begin + warp * KT; base < s_end; base += WARPS * KT) {
    int pos = -1;
    if (lane < KT && base + lane < s_end) pos = kv_pos[(size_t)b * S + base + lane];
    bool ok = pos >= 0 && pos <= cur;
    if (window > 0) ok = ok && pos > cur - window;
    const unsigned valid = __ballot_sync(0xFFFFFFFFu, ok) & ((1u << KT) - 1u);
    if (valid == 0u) continue;                         // warp-uniform
    float kr[KT][EPL], vr[KT][EPL], ksc[KT], vsc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      ksc[j] = 1.f;
      vsc[j] = 1.f;
      if (valid & (1u << j)) {
        const size_t row = ((size_t)b * S + base + j) * KVH + kvh;
        load_row<T, EPL>(k + row * HD + lane * EPL, kr[j]);
        load_row<T, EPL>(v + row * HD + lane * EPL, vr[j]);
        if (ks != nullptr) {
          ksc[j] = __bfloat162float(ks[row]);
          vsc[j] = __bfloat162float(vs[row]);
        }
      } else {
#pragma unroll
        for (int d = 0; d < EPL; ++d) kr[j][d] = vr[j][d] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float sc[KT];
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) d += qr[g][i] * kr[j][i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xFFFFFFFFu, d, o);
        sc[j] = d * ksc[j];
        if (valid & (1u << j)) mx = fmaxf(mx, sc[j]);
      }
      const float alpha = expf(m[g] - mx);
      float lsum = 0.f;
      float pv[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float p = (valid & (1u << j)) ? expf(sc[j] - mx) : 0.f;
        lsum += p;
        pv[j] = p * vsc[j];
      }
      l[g] = l[g] * alpha + lsum;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int j = 0; j < KT; ++j) a += pv[j] * vr[j][i];
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' states
  __shared__ float sm[WARPS][MAXG];
  __shared__ float sl[WARPS][MAXG];
  __shared__ float sacc[WARPS][MAXG][HD];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) sacc[warp][g][lane * EPL + j] = acc[g][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += WARPS * 32) {
    const int g = idx / HD, d = idx % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm[w][g] - M);
      L += sl[w][g] * f;
      A += sacc[w][g][d] * f;
    }
    const size_t hrow = ((size_t)b * H + kvh * G + g) * NC + ci;
    pacc[hrow * HD + d] = A;
    if (d == 0) {
      pm[hrow] = M;
      pl[hrow] = L;
    }
  }
}

// out (B,H,HD) f32 from the NC chunk partials of each (row, head).
__global__ void flash_decode_combine_kernel(const float* __restrict__ pm,
                                            const float* __restrict__ pl,
                                            const float* __restrict__ pacc,
                                            float* __restrict__ out,
                                            int NC, int HD) {
  const size_t bh = blockIdx.x;
  float M = NEG;
  for (int c = 0; c < NC; ++c) M = fmaxf(M, pm[bh * NC + c]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int c = 0; c < NC; ++c) {
      const float f = expf(pm[bh * NC + c] - M);
      L += pl[bh * NC + c] * f;
      A += pacc[(bh * NC + c) * HD + d] * f;
    }
    out[bh * HD + d] = A / fmaxf(L, 1e-30f);
  }
}

template <typename T>
int launch_split(dim3 grid, cudaStream_t stream, const float* q, const void* k,
                 const void* v, const void* ks, const void* vs,
                 const int* kv_pos, const int* cur_pos, float* pm, float* pl,
                 float* pacc, int S, int H, int KVH, int HD, int window,
                 int chunk) {
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const __nv_bfloat16* kst = static_cast<const __nv_bfloat16*>(ks);
  const __nv_bfloat16* vst = static_cast<const __nv_bfloat16*>(vs);
#define FD_LAUNCH(EPLV)                                                     \
  flash_decode_split_kernel<T, EPLV><<<grid, WARPS * 32, 0, stream>>>(      \
      q, kt, vt, kst, vst, kv_pos, cur_pos, pm, pl, pacc, S, H, KVH, window, \
      chunk)
  switch (HD) {
    case 32: FD_LAUNCH(1); break;
    case 64: FD_LAUNCH(2); break;
    case 128: FD_LAUNCH(4); break;
    case 256: FD_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// kv_kind: 0 = f32 cache, 1 = bf16 cache, 2 = int8 cache with bf16 scales.
// pm/pl (B,H,NC) and pacc (B,H,NC,HD) are f32 scratch; out (B,H,HD) f32.
// Requires HD in {32, 64, 128, 256} and H/KVH <= 8.
int flash_decode_forward(const float* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const int* kv_pos, const int* cur_pos, float* pm,
                         float* pl, float* pacc, float* out, int B, int S,
                         int H, int KVH, int HD, int window, int n_chunks,
                         int kv_kind, cudaStream_t stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > MAXG || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = (S + n_chunks - 1) / n_chunks;
  const dim3 grid(n_chunks, KVH, B);
  int rc;
  switch (kv_kind) {
    case 0: rc = launch_split<float>(grid, stream, q, k, v, nullptr, nullptr, kv_pos, cur_pos, pm, pl, pacc, S, H, KVH, HD, window, chunk); break;
    case 1: rc = launch_split<__nv_bfloat16>(grid, stream, q, k, v, nullptr, nullptr, kv_pos, cur_pos, pm, pl, pacc, S, H, KVH, HD, window, chunk); break;
    case 2: rc = launch_split<int8_t>(grid, stream, q, k, v, k_scale, v_scale, kv_pos, cur_pos, pm, pl, pacc, S, H, KVH, HD, window, chunk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  flash_decode_combine_kernel<<<B * H, HD < 128 ? HD : 128, 0, stream>>>(
      pm, pl, pacc, out, n_chunks, HD);
  return (int)cudaGetLastError();
}

}  // extern "C"
