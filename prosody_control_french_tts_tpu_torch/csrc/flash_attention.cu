// Causal flash attention for long training sequences, forward and backward,
// reading grouped-query K/V in place.
//
// Replaces the upstream Pallas TPU flash-attention op that the JAX package's
// model calls with attn_impl="flash" (models/llm.py Attention, the LoRA
// training step at L > 512): its forward body _flash_attention_kernel, its
// backward bodies _flash_attention_dkv_kernel and _flash_attention_dq_kernel.
// The JAX model repeats K/V to all heads because that op takes MHA; these
// kernels read KV head h / group for query head h instead (jnp.repeat's order).
//
// What it computes, per batch row b and query head h, on q [., L, H, hd] and
// k, v [., L, KVH, hd] given by their element strides (batch, row, head; the
// model's [B, L, H, hd] layout or the upstream [B, H, L, hd]), H = KVH group,
// L a multiple of 128:
//   forward:  s = (q k^T) * scale in float32, masked above the diagonal, an
//             online softmax over key tiles (running max m, running sum l, the
//             float32 accumulator rescaled per tile), p rounded to v's type
//             before the p v product, o = acc / l cast to q's type; the
//             residuals l and m (float32 [B, H, L], natural-log domain) are
//             written for the backward.
//   backward: di = rowsum(o * do) in float32; p = exp(s - m) / l recomputed
//             (never stored in device memory), dp = do v^T,
//             ds = (dp - di) * p * scale; dv = p^T do and dk = ds^T q with p
//             and ds rounded to the operands' type, dq = ds k, float32 sums;
//             dk and dv of a KV head summed over its group in head order.
//
// What bounds it on the card: operations (4 hd per (query, key) pair at or
// below the diagonal forward, 10 hd backward, against q, o read once and K/V
// at KVH heads), so the products stay on chip, on the tensor cores in
// bfloat16. No kernel holds a whole score row: L has no upper bound.
//
// bfloat16 (the training path): every product is wgmma.mma_async m64nNk16
// bf16 x bf16 -> float32, operands brought by TMA (cp.async.bulk.tensor, 4-D
// tensor maps over the strided layout, 128-byte swizzle, boxes of 64 columns)
// into shared memory. A block is three warpgroups: warpgroup 0 produces (one
// thread issues the copies; setmaxnreg gives its registers to the others),
// warpgroups 1 and 2 each own 64 of the block's 128 rows. Streamed tiles go
// through a ring of three stages with a full and an empty mbarrier each. The
// consumers wait without a trap (hopper.cuh: mbar_wait_bounded): a __trap
// after setmaxnreg.inc would hold them to the entry's 168 registers, and the
// dk/dv and hd-64 dq consumers need more. Blocks take their (b, h, tile) from
// a plan made in Python (ops/flash_attention.py: tile_plan): the longest
// tiles first, the heads of one KV group next to each other so that their
// K/V tiles are L2 hits; the hardware hands the blocks out in that order.
//   forward by (b, h, 128 query rows): Q once, K and V in 128-key tiles;
//     S = Q K^T (both K-major in shared memory), the online softmax on the
//     accumulator fragments in the exp2 domain (ex2.approx; row max and sum
//     over the quad of lanes that holds a row; tiles wholly below the
//     diagonal unmasked), then O += P V with P converted to bf16 in registers
//     as wgmma's A operand and V read MN-major (transpose-B). Tile kt's S is
//     issued with tile kt - 1's P V, and its softmax runs while that product
//     is in flight.
//   dq by (b, h, 128 query rows): writes di = rowsum(o do) and
//     lse2 = m log2(e) + log2(l) for the dk/dv kernel; K and V in tiles of
//     128 keys (hd 64) or 64 (hd 128); dP = dO V^T from shared memory,
//     dQ += dS K with dS from registers and K MN-major.
//   dk/dv by (b, h, 128 keys): K and V once, Q and dO in 64-query tiles with
//     their lse2 and di; S^T = K Q^T and dP^T = V dO^T directly, so that P^T
//     and dS^T sit in registers as the A operand of dV += P^T dO and
//     dK += dS^T Q. With a group of 1 dk and dv are written in bf16; otherwise
//     each block writes float32 partials [B, H, L, hd] and
//     flash_dkv_group_sum adds the group's heads in head order and casts once
//     (a cluster of the group's blocks adding through distributed shared
//     memory measured slower: PERF.md section 6).
//   No atomics anywhere, and every sum is taken in a fixed order, so two
//   backward runs give the same bits.
// What holds the bf16 kernels back on the card (PERF.md section 6,
// tools/flash_attention_phases.py, which also builds the designs tried and
// not kept): the softmax between the products, not the K/V stream from L2
// nor either product alone.
// float32 (tensor cores would take float32 through TF32): the same three
// kernels on the CUDA cores, tiles of 32 rows and 32 keys, 256 threads, each
// thread a 2 x 2 patch of the 32 x 32 score tile; the tile's scores or p go
// through shared memory for the row reductions and the second product. Its
// dk/dv block walks the group's heads in order, one accumulator for the group.
//
// The kernels are held to a tolerance against the plain PyTorch version
// (ops/flash_attention.py), not to bits: the upstream op rescales per
// 128-key tile and normalises every tile; these kernels keep the sum
// unnormalised and divide once, over tiles of 128 keys (bf16) or 32 (float32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;  // masked scores: exp gives exactly 0, as the upstream additive mask
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// element strides of a [batch, row, head, hd] view (hd contiguous)
struct Str {
  long long b, r, h;
};
__device__ __forceinline__ long long at(const Str& s, int b, int r, int h) { return b * s.b + r * s.r + h * s.h; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int T32 = 32;  // query rows and keys of a float32 tile
constexpr int PT = 36;   // row stride of a 32 x 32 tile of scores in shared memory

// 32 rows x HD floats (rows rs elements apart) -> shared [32][HD + 4]
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < T32 * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = *reinterpret_cast<const float4*>(src + r * rs + c);
  }
}

// c[a][b] = sum_d A[ty + 16a][d] * Bm[tx + 16b][d], both [32][HD + 4] float32
template <int HD>
__device__ __forceinline__ void nt_32x32(const float* A, const float* Bm, int ty, int tx, float (&c)[2][2]) {
  c[0][0] = c[0][1] = c[1][0] = c[1][1] = 0.0f;
  const float* a0p = A + ty * (HD + 4);
  const float* a1p = A + (ty + 16) * (HD + 4);
  const float* b0p = Bm + tx * (HD + 4);
  const float* b1p = Bm + (tx + 16) * (HD + 4);
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a0p + d);
    const float4 a1 = *reinterpret_cast<const float4*>(a1p + d);
    const float4 b0 = *reinterpret_cast<const float4*>(b0p + d);
    const float4 b1 = *reinterpret_cast<const float4*>(b1p + d);
    c[0][0] = fmaf(a0.x, b0.x, c[0][0]); c[0][0] = fmaf(a0.y, b0.y, c[0][0]);
    c[0][0] = fmaf(a0.z, b0.z, c[0][0]); c[0][0] = fmaf(a0.w, b0.w, c[0][0]);
    c[0][1] = fmaf(a0.x, b1.x, c[0][1]); c[0][1] = fmaf(a0.y, b1.y, c[0][1]);
    c[0][1] = fmaf(a0.z, b1.z, c[0][1]); c[0][1] = fmaf(a0.w, b1.w, c[0][1]);
    c[1][0] = fmaf(a1.x, b0.x, c[1][0]); c[1][0] = fmaf(a1.y, b0.y, c[1][0]);
    c[1][0] = fmaf(a1.z, b0.z, c[1][0]); c[1][0] = fmaf(a1.w, b0.w, c[1][0]);
    c[1][1] = fmaf(a1.x, b1.x, c[1][1]); c[1][1] = fmaf(a1.y, b1.y, c[1][1]);
    c[1][1] = fmaf(a1.z, b1.z, c[1][1]); c[1][1] = fmaf(a1.w, b1.w, c[1][1]);
  }
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// acc[a][c] += sum_{i < 32} P[(ty + 16a) * PT + i] * X[i][64c + 4tx .. +3],
// X [32][HD + 4] float32; NC = HD / 64 column groups per thread
template <int HD>
__device__ __forceinline__ void pv_32(const float* P, const float* X, int ty, int tx, float4 (&acc)[2][HD / 64]) {
  constexpr int NC = HD / 64;
#pragma unroll 2
  for (int i = 0; i < T32; i += 4) {
    const float4 p0 = *reinterpret_cast<const float4*>(P + ty * PT + i);
    const float4 p1 = *reinterpret_cast<const float4*>(P + (ty + 16) * PT + i);
    const float pa[4] = {p0.x, p0.y, p0.z, p0.w};
    const float pb[4] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(X + (i + j) * (HD + 4) + c * 64 + 4 * tx);
        axpy4(acc[0][c], pa[j], x);
        axpy4(acc[1][c], pb[j], x);
      }
    }
  }
}

// 32 rows (rs elements apart) from the accumulators
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, const float4 (&acc)[2][HD / 64], int ty, int tx, long long rs) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      *reinterpret_cast<float4*>(dst + (ty + 16 * a) * rs + c * 64 + 4 * tx) = acc[a][c];
    }
  }
}

// shared memory of a float32 kernel in floats: tiles [32][HD + 4], score tiles
// [32][PT], row statistics
template <int HD>
constexpr int f32_smem_floats(int kernel) {
  return kernel == 0 ? 3 * T32 * (HD + 4) + T32 * PT + 3 * T32        // forward: Q, K, V, P; m, l, alpha
                     : kernel == 1 ? 4 * T32 * (HD + 4) + T32 * PT + 3 * T32  // dq: Q, dO, K, V, dS; m, 1/l, di
                                   : 4 * T32 * (HD + 4) + 2 * T32 * PT + 3 * T32;  // dk/dv: K, V, Q, dO, P^T, dS^T
}

// One block per (h, b, 32 query rows), the longest tiles first.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, Str sq, Str sk, Str sv,
              Str so, int group, int L, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + T32 * (HD + 4);
  float* Vs = Ks + T32 * (HD + 4);
  float* Ps = Vs + T32 * (HD + 4);
  float* Ms = Ps + T32 * PT;
  float* Ls = Ms + T32;
  float* As = Ls + T32;

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / group;
  const size_t head = ((size_t)b * gridDim.x + h) * L;  // first row of (b, h) in l, m
  const int q0 = qt * T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  load_tile<HD>(Qs, q + at(sq, b, q0, h), sq.r);
  if (tid < T32) {
    Ms[tid] = kNeg;
    Ls[tid] = 0.0f;
  }
  float4 acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T32;
    load_tile<HD>(Ks, k + at(sk, b, k0, kvh), sk.r);
    load_tile<HD>(Vs, v + at(sv, b, k0, kvh), sv.r);
    __syncthreads();
    float c[2][2];
    nt_32x32<HD>(Qs, Ks, ty, tx, c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int r = ty + 16 * a;
        const int col = tx + 16 * bb;
        Ps[r * PT + col] = (kt == qt && col > r) ? kNeg : c[a][bb] * scale;
      }
    }
    __syncthreads();
    // online softmax: a warp per row, a lane per key
    for (int r = warp; r < T32; r += kWarps) {
      const float x = Ps[r * PT + lane];
      const float m_prev = Ms[r];
      const float m_next = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_next);
      const float sum = warp_sum(p);
      Ps[r * PT + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        As[r] = alpha;
        Ms[r] = m_next;
        Ls[r] = sum + alpha * Ls[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float alpha = As[ty + 16 * a];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        acc[a][cc].x *= alpha;
        acc[a][cc].y *= alpha;
        acc[a][cc].z *= alpha;
        acc[a][cc].w *= alpha;
      }
    }
    pv_32<HD>(Ps, Vs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float inv = 1.0f / Ls[ty + 16 * a];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      acc[a][cc].x *= inv;
      acc[a][cc].y *= inv;
      acc[a][cc].z *= inv;
      acc[a][cc].w *= inv;
    }
  }
  store_rows<HD>(o + at(so, b, q0, h), acc, ty, tx, so.r);
  if (tid < T32) {
    l_out[head + q0 + tid] = Ls[tid];
    m_out[head + q0 + tid] = Ms[tid];
  }
}

// One block per (h, b, 32 query rows), the longest tiles first; writes di.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ l_in,
             const float* __restrict__ m_in, float* __restrict__ di_out, float* __restrict__ dq, Str sq, Str sk,
             Str sv, Str so, Str sdo, Str sdq, int group, int L, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* DOs = Qs + T32 * (HD + 4);
  float* Ks = DOs + T32 * (HD + 4);
  float* Vs = Ks + T32 * (HD + 4);
  float* Ps = Vs + T32 * (HD + 4);
  float* Ms = Ps + T32 * PT;
  float* ILs = Ms + T32;
  float* Ds = ILs + T32;

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / group;
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int q0 = qt * T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  load_tile<HD>(Qs, q + at(sq, b, q0, h), sq.r);
  load_tile<HD>(DOs, dout + at(sdo, b, q0, h), sdo.r);
  __syncthreads();
  for (int r = warp; r < T32; r += kWarps) {  // di = rowsum(o * do), a warp per row
    const float* orow = o + at(so, b, q0 + r, h);
    float sum = 0.0f;
    for (int d = lane; d < HD; d += kWarp) sum = fmaf(orow[d], DOs[r * (HD + 4) + d], sum);
    sum = warp_sum(sum);
    if (lane == 0) {
      Ds[r] = sum;
      di_out[head + q0 + r] = sum;
      Ms[r] = m_in[head + q0 + r];
      ILs[r] = 1.0f / l_in[head + q0 + r];
    }
  }
  float4 acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T32;
    load_tile<HD>(Ks, k + at(sk, b, k0, kvh), sk.r);
    load_tile<HD>(Vs, v + at(sv, b, k0, kvh), sv.r);
    __syncthreads();
    float s[2][2], dp[2][2];
    nt_32x32<HD>(Qs, Ks, ty, tx, s);
    nt_32x32<HD>(DOs, Vs, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int col = tx + 16 * bb;
        const float p = (kt == qt && col > r) ? 0.0f : expf(s[a][bb] * scale - Ms[r]) * ILs[r];
        Ps[r * PT + col] = (dp[a][bb] - Ds[r]) * p * scale;  // ds
      }
    }
    __syncthreads();
    pv_32<HD>(Ps, Ks, ty, tx, acc);
    __syncthreads();
  }
  store_rows<HD>(dq + at(sdq, b, q0, h), acc, ty, tx, sdq.r);
}

// One block per (KV head, b, 32 keys), the longest first: for each head of
// the group in order, the query tiles from the diagonal to the end; one
// accumulator for the group.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ l_in, const float* __restrict__ m_in,
              const float* __restrict__ di_in, float* __restrict__ dk, float* __restrict__ dv, Str sq, Str sk,
              Str sv, Str sdo, Str sdk, Str sdv, int group, int L, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + T32 * (HD + 4);
  float* Qs = Vs + T32 * (HD + 4);
  float* DOs = Qs + T32 * (HD + 4);
  float* Pt = DOs + T32 * (HD + 4);  // [key][query]
  float* Dt = Pt + T32 * PT;         // [key][query]
  float* Ms = Dt + T32 * PT;
  float* ILs = Ms + T32;
  float* Ds = ILs + T32;

  const int jt = blockIdx.z;  // key tile: the lowest walks the most query tiles and starts first
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int H = gridDim.x * group;
  const int j0 = jt * T32;
  const int nt = L / T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  load_tile<HD>(Ks, k + at(sk, b, j0, kvh), sk.r);
  load_tile<HD>(Vs, v + at(sv, b, j0, kvh), sv.r);
  float4 acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t head = ((size_t)b * H + h) * L;
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * T32;
      load_tile<HD>(Qs, q + at(sq, b, i0, h), sq.r);
      load_tile<HD>(DOs, dout + at(sdo, b, i0, h), sdo.r);
      if (tid < T32) {
        Ms[tid] = m_in[head + i0 + tid];
        ILs[tid] = 1.0f / l_in[head + i0 + tid];
        Ds[tid] = di_in[head + i0 + tid];
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      nt_32x32<HD>(Ks, Qs, ty, tx, s);   // s^T: [key ty + 16a][query tx + 16b]
      nt_32x32<HD>(Vs, DOs, ty, tx, dp);  // dp^T
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int key = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int qr = tx + 16 * bb;
          const float p = (it == jt && key > qr) ? 0.0f : expf(s[a][bb] * scale - Ms[qr]) * ILs[qr];
          Pt[key * PT + qr] = p;
          Dt[key * PT + qr] = (dp[a][bb] - Ds[qr]) * p * scale;
        }
      }
      __syncthreads();
      pv_32<HD>(Pt, DOs, ty, tx, acc_v);  // dv += p^T do
      pv_32<HD>(Dt, Qs, ty, tx, acc_k);   // dk += ds^T q
      __syncthreads();
    }
  }
  store_rows<HD>(dk + at(sdk, b, j0, kvh), acc_k, ty, tx, sdk.r);
  store_rows<HD>(dv + at(sdv, b, j0, kvh), acc_v, ty, tx, sdv.r);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kThreadsTC = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int BM = 128;          // rows of a block: query rows (forward, dq) or keys (dk/dv), 64 per consumer
constexpr int QN = 64;           // queries of a dk/dv tile
constexpr int STAGES = 3;        // ring of streamed tiles
constexpr int STAT_BYTES = 1024; // a dk/dv stage's lse2 and di (2 x 64 floats), padded to a swizzle atom

// A tile of `rows` x HD bf16 in shared memory is HD / 64 boxes of rows x 128
// bytes (one 128-byte swizzle row per tile row), box c holding columns
// 64c .. 64c + 63; every box starts on a 1024-byte boundary.
__host__ __device__ constexpr int tile_bytes(int rows, int hd) { return rows * hd * 2; }

// dq's key tile: 128 keys at hd 64; 64 at hd 128, where S, dP and dQ must fit
// one consumer's registers together
__host__ __device__ constexpr int dq_keys(int hd) { return hd == 64 ? 128 : 64; }

// dynamic shared memory of a bf16 kernel (0 forward, 1 dq, 2 dk/dv): 1024 to
// align, the tiles, 2 STAGES + 1 barriers
__host__ __device__ constexpr int bf16_smem_bytes(int kernel, int hd) {
  return 1024 + 8 * (2 * STAGES + 1) +
         (kernel == 0   ? tile_bytes(BM, hd) + STAGES * 2 * tile_bytes(BM, hd)
          : kernel == 1 ? 2 * tile_bytes(BM, hd) + STAGES * 2 * tile_bytes(dq_keys(hd), hd)
                        : 2 * tile_bytes(BM, hd) + STAGES * (2 * tile_bytes(QN, hd) + STAT_BYTES));
}

// K-major operand (the contraction, hd, contiguous): rows row0 .. row0 + 63 (A)
// or all (B) of a tile of `rows` rows, contraction step kk (16 columns)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major B (the output columns, hd, contiguous; the tile's rows are the
// contraction): contraction step ks (16 rows); boxes of 64 columns rows x 128
// bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int ks) {
  return smem_desc(tile + ks * 16 * 128, rows * 128, 1024);
}

// d = A B (accumulate 0) or d += A B, m64nNk16, both operands in shared memory, B K-major
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 128) {
    wgmma_n128<0>(d, da, db, accumulate);
  } else {
    wgmma_n64<0>(d, da, db, accumulate);
  }
}
// d += A B, m64nNk16, A from registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 128) {
    wgmma_rs_n128<1>(d, a, db, 1);
  } else {
    wgmma_rs_n64<1>(d, a, db, 1);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, far below the bf16 rounding of p that follows)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments (k-steps of 16 columns) of a product whose left operand is
// the m64 x NC accumulator c, rounded to bf16: wgmma's accumulator layout
// (c[4j + 2h + e] at row 8h + lane/4 of the warp's 16, column 8j + 2(lane%4)
// + e) is its A layout two column groups at a time.
template <int NC>
__device__ __forceinline__ void to_frags(const float (&c)[NC / 2], uint32_t (&a)[NC / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < NC / 16; ++ks) {
    const int j0 = 2 * ks, j1 = 2 * ks + 1;
    a[ks][0] = pack_bf16(c[4 * j0], c[4 * j0 + 1]);
    a[ks][1] = pack_bf16(c[4 * j0 + 2], c[4 * j0 + 3]);
    a[ks][2] = pack_bf16(c[4 * j1], c[4 * j1 + 1]);
    a[ks][3] = pack_bf16(c[4 * j1 + 2], c[4 * j1 + 3]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// Producer: the HD / 64 boxes of `rows` rows from `row` of head `head`, batch b
template <int HD>
__device__ __forceinline__ void load_tile_tma(uint32_t dst, const CUtensorMap* map, int head, int row, int b, int rows,
                                              uint32_t bar) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load_4d(dst + c * rows * 128, map, 64 * c, head, row, b, bar);
}

// One block's barriers: `once` (the tiles loaded once), full[STAGES] and
// empty[STAGES] of the ring; initialised by thread 0 before the roles split.
struct Bars {
  uint32_t once, full0, empty0;
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};
__device__ __forceinline__ Bars bars_setup(uint32_t at) {
  Bars b{at, at + 8, at + 8 + 8 * STAGES};
  if (threadIdx.x == 0) {
    mbar_init(b.once, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(b.full(s), 1);
      mbar_init(b.empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return b;
}

struct Stage {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1u;
    }
  }
};

// A consumer thread's place: warpgroup half (rows 64 half ..), local row of
// its first accumulator row (the second is 8 below), column offset in a group of 8
struct Place {
  int half, row, colq;
  __device__ __forceinline__ Place() {
    const int t = threadIdx.x % 128;
    half = threadIdx.x / 128 - 1;
    row = 64 * half + 16 * (t / 32) + (t % 32) / 4;
    colq = 2 * (t % 4);
  }
};

// Forward, one block per plan item (b, h, 128 query rows).
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ plan, bf16* __restrict__ o, Str so,
               float* __restrict__ l_out, float* __restrict__ m_out, int H, int group, int L, float scale) {
  constexpr int TILE = tile_bytes(BM, HD);
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_q = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t s_kv = s_q + TILE;  // stage s: K at s_kv + 2 s TILE, V after it
  const Bars bar = bars_setup(s_kv + STAGES * 2 * TILE);
  const int b = plan[3 * blockIdx.x], h = plan[3 * blockIdx.x + 1], qt = plan[3 * blockIdx.x + 2];
  const int q0 = qt * BM;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(bar.once, TILE);
      load_tile_tma<HD>(s_q, &tm_q, h, q0, b, BM, bar.once);
      Stage st;
      for (int kt = 0; kt <= qt; ++kt) {
        mbar_wait(bar.empty(st.s), st.phase ^ 1u);
        mbar_expect_tx(bar.full(st.s), 2 * TILE);
        const uint32_t sk = s_kv + st.s * 2 * TILE;
        load_tile_tma<HD>(sk, &tm_k, kvh, kt * BM, b, BM, bar.full(st.s));
        load_tile_tma<HD>(sk + TILE, &tm_v, kvh, kt * BM, b, BM, bar.full(st.s));
        st.advance();
      }
    }
    return;
  }
  setmaxnreg_inc<240>();
  const Place at_;
  const bool signals = threadIdx.x % 128 == 0;
  const float c2 = scale * kLog2e;
  float m[2] = {kNeg, kNeg};  // running row max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};  // this thread's share of the running row sum
  float acc[HD / 2], s[BM / 2];
  uint32_t pa[BM / 16][4];  // p of the previous tile, bf16, wgmma's A operand
  zero(acc);
  // S = Q K^T of the tile in stage `stage`, issued as one wgmma group
  auto issue_s = [&](int stage) {
    const uint32_t sk = s_kv + stage * 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma_ss<BM>(s, kmajor(s_q, BM, 64 * at_.half, kk), kmajor(sk, BM, 0, kk), kk);
    wgmma_commit();
  };
  // O += P V of the tile in stage `stage`, one wgmma group
  auto issue_pv = [&](int stage) {
    const uint32_t sv = s_kv + stage * 2 * TILE + TILE;
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) mma_rs<HD>(acc, pa[ks], mnmajor(sv, BM, ks));
    wgmma_commit();
  };
  // the online softmax of tile kt's scores in s (exp2 domain): s becomes p,
  // returns the rescale of the earlier tiles' sums in alpha
  auto softmax = [&](int kt, float (&alpha)[2]) {
    const bool diag = kt == qt;  // key tile kt and query tile qt share their local indices
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (diag && 8 * j + at_.colq + (i & 1) > at_.row + 8 * (i >> 1)) s[4 * j + i] = kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[4 * j + i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mn = fmaxf(m[r], fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, 2)) * c2);
      alpha[r] = fast_exp2(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      s[i] = fast_exp2(fmaf(s[i], c2, -m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
  };
  // Tile kt's S is issued before tile kt - 1's P V, and its softmax runs while
  // that product is in flight (wgmma groups complete in order).
  mbar_wait_bounded(bar.once, 0);
  Stage st;
  mbar_wait_bounded(bar.full(st.s), st.phase);
  wgmma_fence();
  issue_s(st.s);
  wgmma_wait<0>();
  pin(s);
  float alpha[2];
  softmax(0, alpha);
  to_frags<BM>(s, pa);
  for (int kt = 1; kt <= qt; ++kt) {
    const int prev = st.s;
    st.advance();
    mbar_wait_bounded(bar.full(st.s), st.phase);
    wgmma_fence();
    issue_s(st.s);
    issue_pv(prev);
    wgmma_wait<1>();
    pin(s);
    softmax(kt, alpha);
    wgmma_wait<0>();
    pin(acc);
    if (signals) mbar_arrive(bar.empty(prev));
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    to_frags<BM>(s, pa);
  }
  wgmma_fence();
  issue_pv(st.s);
  wgmma_wait<0>();
  pin(acc);
  if (signals) mbar_arrive(bar.empty(st.s));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + at_.row + 8 * r;
    const float inv = 1.0f / sum;
    bf16* orow = o + at(so, b, row, h) + at_.colq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if (at_.colq == 0) {
      const size_t idx = ((size_t)b * H + h) * L + row;
      l_out[idx] = sum;
      m_out[idx] = m[r] * kLn2;
    }
  }
}

// dq, one block per plan item (b, h, 128 query rows); writes di and lse2 of its rows.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const int* __restrict__ plan, const bf16* __restrict__ o, Str so, const bf16* __restrict__ dout, Str sdo,
              const float* __restrict__ l_in, const float* __restrict__ m_in, float* __restrict__ di_out,
              float* __restrict__ lse2_out, bf16* __restrict__ dq, Str sdq, int H, int group, int L, float scale) {
  constexpr int KN = dq_keys(HD);
  constexpr int QT = tile_bytes(BM, HD);
  constexpr int KT = tile_bytes(KN, HD);
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_q = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + QT;
  const uint32_t s_kv = s_do + QT;  // stage s: K at s_kv + 2 s KT, V after it
  const Bars bar = bars_setup(s_kv + STAGES * 2 * KT);
  const int b = plan[3 * blockIdx.x], h = plan[3 * blockIdx.x + 1], qt = plan[3 * blockIdx.x + 2];
  const int q0 = qt * BM;
  const int n_kt = (q0 + BM) / KN;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(bar.once, 2 * QT);
      load_tile_tma<HD>(s_q, &tm_q, h, q0, b, BM, bar.once);
      load_tile_tma<HD>(s_do, &tm_do, h, q0, b, BM, bar.once);
      Stage st;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(bar.empty(st.s), st.phase ^ 1u);
        mbar_expect_tx(bar.full(st.s), 2 * KT);
        const uint32_t sk = s_kv + st.s * 2 * KT;
        load_tile_tma<HD>(sk, &tm_k, kvh, kt * KN, b, KN, bar.full(st.s));
        load_tile_tma<HD>(sk + KT, &tm_v, kvh, kt * KN, b, KN, bar.full(st.s));
        st.advance();
      }
    }
    return;
  }
  setmaxnreg_inc<240>();
  const Place at_;
  const bool signals = threadIdx.x % 128 == 0;
  const int lane = threadIdx.x % 32;
  const float c2 = scale * kLog2e;
  const int row0 = q0 + 64 * at_.half;  // the warpgroup's first row
  // di = rowsum(o * do) and lse2 of the warpgroup's 64 rows, two threads a
  // row (each half of hd, float32 sums), while the first tiles are in flight;
  // the rows of a warp are its own lanes' (row 16 w + i by lanes 2i, 2i + 1)
  float di_row, lse2_row;
  {
    const int t = threadIdx.x % 128;
    const int row = row0 + t / 2;
    const int c0 = (t % 2) * (HD / 2);
    const bf16* orow = o + at(so, b, row, h) + c0;
    const bf16* drow = dout + at(sdo, b, row, h) + c0;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < HD / 2; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(op[i]);
        const float2 d = __bfloat1622float2(dp[i]);
        sum = fmaf(a.x, d.x, sum);
        sum = fmaf(a.y, d.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const size_t idx = ((size_t)b * H + h) * L + row;
    const float lse2 = fmaf(m_in[idx], kLog2e, log2f(l_in[idx]));
    if (t % 2 == 0) {
      di_out[idx] = sum;
      lse2_out[idx] = lse2;
    }
    di_row = sum;
    lse2_row = lse2;
  }
  float di[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    di[r] = __shfl_sync(0xffffffffu, di_row, 2 * (lane / 4) + 16 * r);
    lse2[r] = __shfl_sync(0xffffffffu, lse2_row, 2 * (lane / 4) + 16 * r);
  }
  float acc[HD / 2], s[KN / 2], dp[KN / 2];
  zero(acc);
  mbar_wait_bounded(bar.once, 0);
  Stage st;
  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t sk = s_kv + st.s * 2 * KT;
    const int k0 = kt * KN;
    mbar_wait_bounded(bar.full(st.s), st.phase);
    if (k0 <= row0 + 63) {  // else every key of the tile is above the warpgroup's rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma_ss<KN>(s, kmajor(s_q, BM, 64 * at_.half, kk), kmajor(sk, KN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_ss<KN>(dp, kmajor(s_do, BM, 64 * at_.half, kk), kmajor(sk + KT, KN, 0, kk), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const bool mask = k0 + KN - 1 > row0;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool masked = mask && k0 + 8 * j + at_.colq + (i & 1) > q0 + at_.row + 8 * r;
          const float p = masked ? 0.0f : fast_exp2(fmaf(s[4 * j + i], c2, -lse2[r]));
          dp[4 * j + i] = (dp[4 * j + i] - di[r]) * p * scale;  // ds
        }
      }
      uint32_t da[KN / 16][4];
      to_frags<KN>(dp, da);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KN / 16; ++ks) mma_rs<HD>(acc, da[ks], mnmajor(sk, KN, ks));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
    }
    if (signals) mbar_arrive(bar.empty(st.s));
    st.advance();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* drow = dq + at(sdq, b, q0 + at_.row + 8 * r, h) + at_.colq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) *reinterpret_cast<uint32_t*>(drow + 8 * j) = pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// dk/dv, one block per plan item (b, h, 128 keys): the 64-query tiles from the
// diagonal to the end, with their lse2 and di. group 1: dk, dv in bf16;
// otherwise float32 partials [B, H, L, hd] for flash_dkv_group_sum.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dkv_bf16(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const int* __restrict__ plan, const float* __restrict__ lse2_in, const float* __restrict__ di_in,
               float* __restrict__ dk_part, float* __restrict__ dv_part, bf16* __restrict__ dk, Str sdk,
               bf16* __restrict__ dv, Str sdv, int H, int group, int L, float scale) {
  constexpr int KVT = tile_bytes(BM, HD);
  constexpr int QT = tile_bytes(QN, HD);
  constexpr int SB = 2 * QT + STAT_BYTES;  // a stage: Q, dO, then lse2 and di
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_k = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t s_v = s_k + KVT;
  const uint32_t s_st = s_v + KVT;
  const Bars bar = bars_setup(s_st + STAGES * SB);
  const unsigned char* gen = smem_tc + (s_k - smem_u32(smem_tc));  // generic address of s_k
  const int b = plan[3 * blockIdx.x], h = plan[3 * blockIdx.x + 1], jt = plan[3 * blockIdx.x + 2];
  const int k0 = jt * BM;
  const int t0 = k0 / QN, nt = L / QN;
  const size_t head = ((size_t)b * H + h) * L;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(bar.once, 2 * KVT);
      load_tile_tma<HD>(s_k, &tm_k, kvh, k0, b, BM, bar.once);
      load_tile_tma<HD>(s_v, &tm_v, kvh, k0, b, BM, bar.once);
      Stage st;
      for (int t = t0; t < nt; ++t) {
        mbar_wait(bar.empty(st.s), st.phase ^ 1u);
        const uint32_t sq = s_st + st.s * SB;
        mbar_expect_tx(bar.full(st.s), 2 * QT + 2 * QN * 4);
        load_tile_tma<HD>(sq, &tm_q, h, t * QN, b, QN, bar.full(st.s));
        load_tile_tma<HD>(sq + QT, &tm_do, h, t * QN, b, QN, bar.full(st.s));
        bulk_load(sq + 2 * QT, lse2_in + head + t * QN, QN * 4, bar.full(st.s));
        bulk_load(sq + 2 * QT + QN * 4, di_in + head + t * QN, QN * 4, bar.full(st.s));
        st.advance();
      }
    }
    return;
  }
  setmaxnreg_inc<240>();
  const Place at_;
  const bool signals = threadIdx.x % 128 == 0;
  const float c2 = scale * kLog2e;
  const int kw = k0 + 64 * at_.half;  // the warpgroup's first key
  float acc_k[HD / 2], acc_v[HD / 2], s[QN / 2], dp[QN / 2];
  zero(acc_k);
  zero(acc_v);
  mbar_wait_bounded(bar.once, 0);
  Stage st;
  for (int t = t0; t < nt; ++t) {
    const uint32_t sq = s_st + st.s * SB;
    const uint32_t sdo = sq + QT;
    const int qa = t * QN;  // the tile's first query
    mbar_wait_bounded(bar.full(st.s), st.phase);
    if (qa + QN - 1 >= kw) {  // else every query of the tile is above the warpgroup's keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma_ss<QN>(s, kmajor(s_k, BM, 64 * at_.half, kk), kmajor(sq, QN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma_ss<QN>(dp, kmajor(s_v, BM, 64 * at_.half, kk), kmajor(sdo, QN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const float* lse2 = reinterpret_cast<const float*>(gen + (sq + 2 * QT - s_k));
      const float* di = lse2 + QN;
      const bool mask = qa < kw + 63;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * j + at_.colq + (i & 1);  // the query's column in the tile
          const bool masked = mask && k0 + at_.row + 8 * (i >> 1) > qa + qc;
          const float p = masked ? 0.0f : fast_exp2(fmaf(s[4 * j + i], c2, -lse2[qc]));
          dp[4 * j + i] = (dp[4 * j + i] - di[qc]) * p * scale;  // ds^T
          s[4 * j + i] = p;                                      // p^T
        }
      }
      uint32_t pa[QN / 16][4], da[QN / 16][4];
      to_frags<QN>(s, pa);
      to_frags<QN>(dp, da);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < QN / 16; ++ks) {
        mma_rs<HD>(acc_v, pa[ks], mnmajor(sdo, QN, ks));
        mma_rs<HD>(acc_k, da[ks], mnmajor(sq, QN, ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc_v);
      pin(acc_k);
    }
    if (signals) mbar_arrive(bar.empty(st.s));
    st.advance();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + at_.row + 8 * r;
    if (group == 1) {
      bf16* krow = dk + at(sdk, b, key, h) + at_.colq;
      bf16* vrow = dv + at(sdv, b, key, h) + at_.colq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) = pack_bf16(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) = pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
      }
    } else {
      const size_t off = (head + key) * HD + at_.colq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(dk_part + off + 8 * j) = make_float2(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + off + 8 * j) = make_float2(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dk, dv [b, row, KV head] = the float32 partials of the group's heads added
// in head order, cast once; a thread per 4 columns of a row.
__global__ void flash_dkv_group_sum(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                                    bf16* __restrict__ dk, Str sdk, bf16* __restrict__ dv, Str sdv, int B, int KVH,
                                    int group, int L, int hd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c4 = hd / 4;
  if (i >= (long long)B * KVH * L * c4) return;
  const int c = (int)(i % c4) * 4;
  long long rest = i / c4;
  const int row = (int)(rest % L);
  rest /= L;
  const int kvh = (int)(rest % KVH);
  const int b = (int)(rest / KVH);
  const int H = KVH * group;
  float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
  for (int g = 0; g < group; ++g) {
    const size_t idx = (((size_t)b * H + kvh * group + g) * L + row) * hd + c;
    const float4 a = *reinterpret_cast<const float4*>(dk_part + idx);
    const float4 d = *reinterpret_cast<const float4*>(dv_part + idx);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += d.x; sv.y += d.y; sv.z += d.z; sv.w += d.w;
  }
  *reinterpret_cast<uint2*>(dk + at(sdk, b, row, kvh) + c) = make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
  *reinterpret_cast<uint2*>(dv + at(sdv, b, row, kvh) + c) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// dynamic shared memory of a kernel in bytes: kernel 0 forward, 1 dq, 2 dk/dv
template <int HD>
constexpr int smem_bytes(int kernel, bool bf) {
  return bf ? bf16_smem_bytes(kernel, HD) : f32_smem_floats<HD>(kernel) * (int)sizeof(float);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The tensor map of a [B, L, heads, HD] bf16 view with element strides s, read
// in boxes of `rows` rows x 64 columns of one head
int view_map(CUtensorMap* map, const void* base, const Str& s, int B, int heads, int L, int hd, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)s.h * 2, (uint64_t)s.r * 2, (uint64_t)s.b * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return tensor_map_4d(map, base, dims, strides, box);
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* l, float* m, const int* plan, int B, int H,
        int KVH, int L, const Str* st, float scale, bool bf, cudaStream_t stream) {
  const int bytes = smem_bytes<HD>(0, bf);
  const int group = H / KVH;
  int rc;
  if (bf) {
    CUtensorMap tq, tk, tv;
    if ((rc = view_map(&tq, q, st[0], B, H, L, HD, BM))) return rc;
    if ((rc = view_map(&tk, k, st[1], B, KVH, L, HD, BM))) return rc;
    if ((rc = view_map(&tv, v, st[2], B, KVH, L, HD, BM))) return rc;
    if ((rc = set_smem(flash_fwd_bf16<HD>, bytes))) return rc;
    flash_fwd_bf16<HD><<<B * H * (L / BM), kThreadsTC, bytes, stream>>>(tq, tk, tv, plan, (bf16*)o, st[3], l, m, H,
                                                                        group, L, scale);
  } else {
    if ((rc = set_smem(flash_fwd_f32<HD>, bytes))) return rc;
    flash_fwd_f32<HD><<<dim3(H, B, L / T32), kThreads, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, l, m, st[0], st[1], st[2], st[3], group, L, scale);
  }
  return (int)cudaGetLastError();
}

// st: q, k, v, o, do, dq, dk, dv
template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* l, const float* m,
        float* di, float* lse2, float* dk_part, float* dv_part, void* dq, void* dk, void* dv, const int* plan_q,
        const int* plan_k, int B, int H, int KVH, int L, const Str* st, float scale, bool bf, cudaStream_t stream) {
  const int bq = smem_bytes<HD>(1, bf);
  const int bkv = smem_bytes<HD>(2, bf);
  const int group = H / KVH;
  int rc;
  if (bf) {
    CUtensorMap tq, tdo, tk, tv, tk2, tv2, tq2, tdo2;
    if ((rc = view_map(&tq, q, st[0], B, H, L, HD, BM))) return rc;
    if ((rc = view_map(&tdo, dout, st[4], B, H, L, HD, BM))) return rc;
    if ((rc = view_map(&tk, k, st[1], B, KVH, L, HD, dq_keys(HD)))) return rc;
    if ((rc = view_map(&tv, v, st[2], B, KVH, L, HD, dq_keys(HD)))) return rc;
    if ((rc = view_map(&tk2, k, st[1], B, KVH, L, HD, BM))) return rc;
    if ((rc = view_map(&tv2, v, st[2], B, KVH, L, HD, BM))) return rc;
    if ((rc = view_map(&tq2, q, st[0], B, H, L, HD, QN))) return rc;
    if ((rc = view_map(&tdo2, dout, st[4], B, H, L, HD, QN))) return rc;
    const int blocks = B * H * (L / BM);
    if ((rc = set_smem(flash_dq_bf16<HD>, bq))) return rc;
    flash_dq_bf16<HD><<<blocks, kThreadsTC, bq, stream>>>(tq, tdo, tk, tv, plan_q, (const bf16*)o, st[3],
                                                          (const bf16*)dout, st[4], l, m, di, lse2, (bf16*)dq, st[5],
                                                          H, group, L, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = set_smem(flash_dkv_bf16<HD>, bkv))) return rc;
    flash_dkv_bf16<HD><<<blocks, kThreadsTC, bkv, stream>>>(tk2, tv2, tq2, tdo2, plan_k, lse2, di, dk_part, dv_part,
                                                            (bf16*)dk, st[6], (bf16*)dv, st[7], H, group, L, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (group > 1) {
      const long long n = (long long)B * KVH * L * (HD / 4);
      flash_dkv_group_sum<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(dk_part, dv_part, (bf16*)dk, st[6],
                                                                           (bf16*)dv, st[7], B, KVH, group, L, HD);
    }
  } else {
    if ((rc = set_smem(flash_dq_f32<HD>, bq))) return rc;
    flash_dq_f32<HD><<<dim3(H, B, L / T32), kThreads, bq, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout, l, m, di, (float*)dq,
        st[0], st[1], st[2], st[3], st[4], st[5], group, L, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = set_smem(flash_dkv_f32<HD>, bkv))) return rc;
    flash_dkv_f32<HD><<<dim3(KVH, B, L / T32), kThreads, bkv, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, l, m, di, (float*)dk, (float*)dv,
        st[0], st[1], st[2], st[4], st[6], st[7], group, L, scale);
  }
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int KVH, int L, int hd, int dtype) {
  return B > 0 && B <= 65535 && KVH > 0 && H > 0 && H <= 65535 && H % KVH == 0 && L >= 128 && L % 128 == 0 &&
         L / T32 <= 65535 && (long long)B * H * (L / BM) < (1ll << 31) && (hd == 64 || hd == 128) &&
         (dtype == 0 || dtype == 1);
}

// n strides (b, r, h) each, in elements: positive, and multiples of 16 bytes
// (TMA's rule, and float4 loads in float32)
bool strides_ok(const long long* s, int n, int dtype, Str* out) {
  const long long unit = dtype == 1 ? 8 : 4;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j) {
      if (s[3 * i + j] <= 0 || s[3 * i + j] % unit != 0) return false;
    }
    out[i] = Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  }
  return true;
}

}  // namespace

// q, o [B, L, H, hd] and k, v [B, L, KVH, hd] as element strides (batch, row,
// head; hd contiguous): strides = 12 values, q, k, v, o; l, m float32
// [B, H, L] (out); plan int32 [n_plan, 3] (b, h, query tile of 128) for the
// bf16 kernel, n_plan = B H L / 128; dtype 0 = float32 (CUDA-core kernel),
// 1 = bfloat16 (wgmma kernel).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v, void* o, void* l, void* m,
                                     const void* plan, int n_plan, int B, int H, int KVH, int L, int hd,
                                     const long long* strides, float scale, int dtype, void* stream) {
  Str st[4];
  if (!shape_ok(B, H, KVH, L, hd, dtype) || !strides_ok(strides, 4, dtype, st) ||
      (dtype == 1 && n_plan != B * H * (L / BM))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)plan;
  return hd == 64 ? fwd<64>(q, k, v, o, (float*)l, (float*)m, p, B, H, KVH, L, st, scale, dtype == 1, s)
                  : fwd<128>(q, k, v, o, (float*)l, (float*)m, p, B, H, KVH, L, st, scale, dtype == 1, s);
}

// o is the forward's output, dout like q (strides = 24 values: q, k, v, o, do,
// dq, dk, dv); l, m from the forward; di, lse2 float32 [B, H, L] scratch;
// dk_part, dv_part float32 [B, H, L, hd] scratch (bf16 with H > KVH only);
// plan_q as the forward's, plan_k (b, h, key tile of 128) for dk/dv. Kernels:
// dq (writes di, lse2), then dk/dv, then (bf16, H > KVH) the group sum.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                     const void* l, const void* m, void* di, void* lse2, void* dk_part, void* dv_part,
                                     void* dq, void* dk, void* dv, const void* plan_q, const void* plan_k, int n_plan,
                                     int B, int H, int KVH, int L, int hd, const long long* strides, float scale,
                                     int dtype, void* stream) {
  Str st[8];
  if (!shape_ok(B, H, KVH, L, hd, dtype) || !strides_ok(strides, 8, dtype, st) ||
      (dtype == 1 && (n_plan != B * H * (L / BM) || (H > KVH && (dk_part == nullptr || dv_part == nullptr))))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* lf = (const float*)l;
  const float* mf = (const float*)m;
  const int* pq = (const int*)plan_q;
  const int* pk = (const int*)plan_k;
  float* d = (float*)di;
  float* e = (float*)lse2;
  float* kp = (float*)dk_part;
  float* vp = (float*)dv_part;
  return hd == 64 ? bwd<64>(q, k, v, o, dout, lf, mf, d, e, kp, vp, dq, dk, dv, pq, pk, B, H, KVH, L, st, scale,
                            dtype == 1, s)
                  : bwd<128>(q, k, v, o, dout, lf, mf, d, e, kp, vp, dq, dk, dv, pq, pk, B, H, KVH, L, st, scale,
                             dtype == 1, s);
}

// The dynamic shared memory the kernel `kernel` (0 forward, 1 dq, 2 dk/dv) of
// dtype (0 float32, 1 bfloat16) asks for at head dim hd, in bytes; -1 for
// other arguments.
extern "C" int flash_attn_smem_bytes(int kernel, int hd, int dtype) {
  if (kernel < 0 || kernel > 2 || (hd != 64 && hd != 128) || (dtype != 0 && dtype != 1)) return -1;
  return hd == 64 ? smem_bytes<64>(kernel, dtype == 1) : smem_bytes<128>(kernel, dtype == 1);
}
