// Decode-step attention: one query token per batch row against the packed
// KV caches of the serving path, grouped-query, causal up to `pos`.
//
// Replaces the TPU kernel ops/decode_attn.py of the JAX package:
// decode_attention (body _kernel), the decode half of models/llm.py
// _fused_forward.
//
// What it computes, per (batch row b, KV head h), with group = H / kv_heads
// query heads sharing the KV head:
//   - scores[g, t] = (q[b, h*group+g, :] . K[b, t, h*hd:(h+1)*hd]) * scale for
//     cache rows t = 0..pos, operands upcast to float32, float32 sums;
//   - a max-subtracted softmax over t in float32, p = exp(s - m) / sum;
//   - p rounded to V's type, then out[g, :] = sum_t p[g, t] * V[b, t, h*hd:...]
//     accumulated in float32 and cast to q's type.
// Rows beyond pos are never read (the TPU body reads them and masks their
// scores to -1e30, whose exp is exactly 0).
//
// What bounds it on the card: bytes. Each K and V row 0..pos is needed once
// (2 * (pos+1) * hd elements per block) against group * hd multiply-adds per
// element pair -- a few operations per byte, far below the card's ratio.
// Design: one block per (b, h), so every cache byte is read from device
// memory by exactly one block; no tile of the TPU layout is kept (its
// [group, S] lane layout and rows-per-program loop answer TPU tiling). A cache
// row's hd elements are spread over hd*sizeof(T)/16 neighbouring lanes, 16
// bytes each, so a warp reads whole rows coalesced and the block covers 16 or
// 32 rows in a pass (bfloat16, hd 128 or 64). Four passes' loads are issued
// before the first is used: a block has to keep ~16 KB in flight to cover the
// memory latency at its share of the card's rate.
//   phase 1: each lane multiplies its 16 bytes of the K row into `group`
//            partial dots against its columns of q, held in registers as
//            float32; the row's lanes add up by shuffles; scaled scores go to a float32
//            scratch [B, H, pos+1] that the wrapper allocates (so any S fits;
//            the scratch is 1/18 of the K/V bytes at hd 128 and stays in L2);
//   phase 2: one warp per query head: max, exp and sum by warp shuffles, then
//            p = e / sum rounded to V's type, written back over the scores;
//   phase 3: the same lane layout over V: group x (16 bytes' worth of)
//            float32 accumulators per lane, the row slots of a warp summed by
//            shuffles, the warps through shared memory, result cast to q's type.
// Measured on the H100 the kernel is not at its byte bound: with one block of
// 8 warps per SM, phase 1's multiply-add chains and shuffle trees are bound by
// instruction latency and take half the kernel's time, caches hot or cold
// (tools/decode_attn_phases.py). Tensor-core products (mma) and a split of S
// over several blocks are the steps that would change that.
// The two products use explicit fmaf (the library's --fmad=false only stops
// the compiler from fusing on its own); the kernel is held to a tolerance
// against its plain PyTorch version, not to bits (sum order and expf differ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxGroup = 8;
constexpr int kUnroll = 4;  // cache rows a lane has in flight

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes (aligned) of consecutive elements as float32: 4 floats or 8 bfloat16
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                   T* __restrict__ out, float* __restrict__ scores, int S, int kv_heads,
                   int group, int pos, float scale) {
  constexpr int E = 16 / (int)sizeof(T);  // elements in a lane's 16 bytes
  constexpr int LPR = HD / E;             // lanes per cache row
  constexpr int RPW = kWarp / LPR;        // rows per warp in a pass
  constexpr int RB = kWarps * RPW;        // rows per block in a pass
  static_assert(LPR >= 1 && LPR <= kWarp && kWarp % LPR == 0, "a row must fit a warp");
  __shared__ __align__(16) float red[kWarps * kMaxGroup * HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int col = (lane % LPR) * E;           // this lane's columns of a row
  const int slot = warp * RPW + lane / LPR;   // this lane's row within a pass
  const int H = kv_heads * group;
  const int C = kv_heads * HD;
  const int n = pos + 1;  // live cache rows
  const T* qb = q + ((size_t)b * H + (size_t)h * group) * HD + col;
  const T* kb = kc + (size_t)b * S * C + (size_t)h * HD + col;
  const T* vb = vc + (size_t)b * S * C + (size_t)h * HD + col;
  float* sb = scores + ((size_t)b * H + (size_t)h * group) * n;

  // this lane's columns of the group's query rows, in registers
  float qr[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      load16(qb + (size_t)g * HD, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.0f;
    }
  }

  // phase 1: scores[g, t]. kUnroll rows per lane are loaded before any is
  // used, so enough bytes are in flight to cover the memory latency; the loop
  // bound is the same for every lane of a warp (the shuffles need them all).
  for (int t0 = 0; t0 < n; t0 += RB * kUnroll) {
    float kv[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * RB + slot;
      if (t < n) {
        load16(kb + (size_t)t * C, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[u][e] = 0.0f;
      }
    }
    // all kUnroll x kMaxGroup partial dots, then their shuffle trees side by
    // side: no branch separates the chains, so they overlap (heads beyond
    // `group` multiply zeros and are not stored)
    float part[kUnroll][kMaxGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qr[g][e], kv[u][e], a);
        part[u][g] = a;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) part[u][g] += __shfl_xor_sync(0xffffffffu, part[u][g], off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * RB + slot;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group && col == 0 && t < n) sb[(size_t)g * n + t] = part[u][g] * scale;
      }
    }
  }
  __syncthreads();

  // phase 2: softmax over t, one warp per query head
  for (int g = warp; g < group; g += kWarps) {
    float* sg = sb + (size_t)g * n;
    float m = -3.0e38f;
    for (int t = lane; t < n; t += kWarp) m = fmaxf(m, sg[t]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int t = lane; t < n; t += kWarp) {
      const float e = expf(sg[t] - m);
      sg[t] = e;
      sum += e;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int t = lane; t < n; t += kWarp) sg[t] = round_to(__fdiv_rn(sg[t], sum), T());
  }
  __syncthreads();

  // phase 3: out[g, col..col+E) = sum_t p[g, t] * V[t, col..col+E)
  float acc[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }
  for (int t0 = slot; t0 < n; t0 += RB * kUnroll) {
    float v[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * RB;
      if (t < n) load16(vb + (size_t)t * C, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * RB;
      if (t < n) {
        float p[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) p[g] = g < group ? sb[(size_t)g * n + t] : 0.0f;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p[g], v[u][e], acc[g][e]);
        }
      }
    }
  }
  // the row slots of a warp, then the warps
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e];
#pragma unroll
        for (int off = LPR; off < kWarp; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane < LPR) red[(warp * kMaxGroup + g) * HD + col + e] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < group * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kMaxGroup + g) * HD + d];
    store_as(out + ((size_t)b * H + (size_t)h * group + g) * HD + d, s);
  }
}

template <typename T>
int launch_typed(const void* q, const void* kc, const void* vc, void* out, float* scores, int B,
                 int S, int kv_heads, int group, int hd, int pos, float scale, cudaStream_t stream) {
  const dim3 grid(kv_heads, B);
  if (hd == 64) {
    decode_attn_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, (T*)out, scores, S, kv_heads, group, pos, scale);
  } else if (hd == 128) {
    decode_attn_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, (T*)out, scores, S, kv_heads, group, pos, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, kv_heads*group, hd]; kc, vc [B, S, kv_heads*hd]; scores: float32
// scratch [B, kv_heads*group, pos+1]; dtype 0 = float32, 1 = bfloat16.
extern "C" int decode_attn_launch(const void* q, const void* kc, const void* vc, void* out,
                                  void* scores, int B, int S, int kv_heads, int group, int hd,
                                  int pos, float scale, int dtype, void* stream) {
  if (B <= 0 || kv_heads <= 0) return (int)cudaGetLastError();
  if (group < 1 || group > kMaxGroup || pos < 0 || pos >= S || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch_typed<float>(q, kc, vc, out, (float*)scores, B, S, kv_heads, group, hd, pos,
                               scale, (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, kc, vc, out, (float*)scores, B, S, kv_heads, group, hd,
                                       pos, scale, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
