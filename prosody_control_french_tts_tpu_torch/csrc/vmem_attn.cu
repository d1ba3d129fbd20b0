// Causal grouped-query attention for short training sequences, forward and
// backward, with whole score rows kept on chip.
//
// Replaces the TPU kernels of ops/vmem_attn.py of the JAX package:
// causal_attention_vmem (forward body _fwd_kernel, backward body _bwd_kernel),
// the attention of the LoRA training step (models/llm.py Attention,
// attn_impl="vmem").
//
// What it computes, per batch row b and query head h (KV head h / group):
//   forward:  s = (q k^T) * scale in float32, -1e30 above the diagonal, row max
//             m, p = exp(s - m), l = sum p, o = (p rounded to v's type) v in
//             float32, divided by l after the product, cast to q's type. It
//             also writes lse = m + log l (float32 [B, H, L]) for the backward.
//   backward: p = exp(s - lse) (the normalised probabilities, recomputed, never
//             stored in device memory), dp = do v^T, delta = rowsum(dp * p),
//             ds = p * (dp - delta) * scale rounded to q's type, dq = ds k,
//             dk = ds^T q and dv = (p rounded to v's type)^T do, both summed
//             over the group's query heads in float32 and cast once.
// Layout is the caller's: q, o, do, dq [B, L, H, hd]; k, v, dk, dv
// [B, L, KVH, hd], contiguous; no transposed copy is made.
//
// What bounds it on the card: operations (4 L^2 hd per head forward, 10 L^2 hd
// backward, against L hd elements read), so what matters is keeping the
// products on chip. The TPU body holds a whole [L, L] float32 score matrix
// in VMEM (1 MB at L 512); a block here has 227 KB of shared memory, so:
//   forward, one block per (b, h, tile of 32 query rows): the tile's
//     [32, L] float32 scores stay in shared memory (64 KB at L 512), K tiles of
//     32 keys are streamed for the scores, then V tiles for the second
//     product. The softmax is the TPU kernel's whole-row one (no online
//     rescale, same rounding points). Keys beyond the tile's last row are
//     never read. About 100 KB of shared memory: two blocks per SM.
//   backward, two kernels, no atomics, deterministic:
//     dq by (b, h, query tile): p and dp rows in shared memory (two [32, L]
//       float32 buffers), delta written for the second kernel, dq = ds k.
//     dk/dv by (b, KV head, tile of 32 keys): K and V tiles resident, a loop
//       over the group's query heads and the query tiles at or below the key
//       tile, float32 accumulators in registers, one cast at the end. This
//       takes the place of the TPU grid's revisited dk/dv block.
// Products run on the CUDA cores (explicit fmaf on float32 copies of the
// operands in shared memory); tensor-core tiles are a later step. The kernels
// are held to a tolerance against the plain PyTorch version, not to bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int BQ = 32;  // query rows per tile
constexpr int BK = 32;  // keys per tile
constexpr int PT = 36;  // row stride of the transposed [keys][rows] tiles
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows x HD elements (row stride `stride` elements) -> float32 [rows][HD + 4]
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride, int rows) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = load4(src + (size_t)r * stride + c);
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

// acc[a][c] += sum_{i < 32} P[(ty + 16a) * ldp + i] * X[i][64c + 4tx .. +3],
// X [32][HD + 4] float32; NC = HD / 64 column groups per thread
template <int HD>
__device__ __forceinline__ void pv_32(const float* P, int ldp, const float* X, int ty, int tx,
                                      float4 (&acc)[2][HD / 64]) {
  constexpr int NC = HD / 64;
#pragma unroll 2
  for (int i = 0; i < 32; i += 4) {
    const float4 p0 = *reinterpret_cast<const float4*>(P + ty * ldp + i);
    const float4 p1 = *reinterpret_cast<const float4*>(P + (ty + 16) * ldp + i);
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

template <int HD>
constexpr int fwd_smem_floats(int L) { return (BQ + BK) * (HD + 4) + BQ * (L + 4) + BQ; }
template <int HD>
constexpr int dq_smem_floats(int L) { return (2 * BQ + BK) * (HD + 4) + 2 * BQ * (L + 4) + BQ; }
template <int HD>
constexpr int dkv_smem_floats() { return 4 * 32 * (HD + 4) + 2 * 32 * PT + 64; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int L, int H, int KVH, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  const int SL = L + 4;
  float* Qs = smem;
  float* KVs = Qs + BQ * (HD + 4);
  float* Ss = KVs + BK * (HD + 4);
  float* Ls = Ss + BQ * SL;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest tiles start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int nk = q0 + BQ;  // keys this tile can see
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const T* qb = q + ((size_t)b * L + q0) * qs + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;

  load_tile<T, HD>(Qs, qb, qs, BQ);
  // scores
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    float c[2][2];
    nt_32x32<HD>(Qs, KVs, ty, tx, c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int row = ty + 16 * a;
        const int col = k0 + tx + 16 * bb;
        Ss[row * SL + col] = col <= q0 + row ? c[a][bb] * scale : kNeg;
      }
    }
  }
  __syncthreads();
  // whole-row softmax numerators, rounded to v's type; the sum is of the unrounded ones
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  for (int row = warp; row < BQ; row += kWarps) {
    float* sr = Ss + row * SL;
    float m = kNeg;
    for (int j = lane; j < nk; j += kWarp) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < nk; j += kWarp) {
      const float e = expf(sr[j] - m);
      sum += e;
      sr[j] = round_to(e, T());
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Ls[row] = sum;
      lse[((size_t)b * H + h) * L + q0 + row] = m + logf(sum);
    }
  }
  // o = p v
  float4 acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(KVs, vb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    pv_32<HD>(Ss + k0, SL, KVs, ty, tx, acc);
  }
  T* ob = o + ((size_t)b * L + q0) * qs + (size_t)h * HD;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = ty + 16 * a;
    const float l = Ls[row];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 r = acc[a][c];
      r.x = __fdiv_rn(r.x, l); r.y = __fdiv_rn(r.y, l); r.z = __fdiv_rn(r.z, l); r.w = __fdiv_rn(r.w, l);
      store4(ob + (size_t)row * qs + c * 64 + 4 * tx, r);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq and delta, by query tile
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int L, int H, int KVH,
                        float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  const int SL = L + 4;
  float* Qs = smem;
  float* DOs = Qs + BQ * (HD + 4);
  float* KVs = DOs + BQ * (HD + 4);
  float* Ss = KVs + BK * (HD + 4);
  float* Ds = Ss + BQ * SL;
  float* Es = Ds + BQ * SL;  // lse of the tile's rows

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int nk = q0 + BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const size_t rowbase = ((size_t)b * L + q0) * qs + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;
  const size_t statbase = ((size_t)b * H + h) * L + q0;

  load_tile<T, HD>(Qs, q + rowbase, qs, BQ);
  load_tile<T, HD>(DOs, dout + rowbase, qs, BQ);
  if (tid < BQ) Es[tid] = lse[statbase + tid];
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    float c[2][2];
    nt_32x32<HD>(Qs, KVs, ty, tx, c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int row = ty + 16 * a;
        const int col = k0 + tx + 16 * bb;
        Ss[row * SL + col] = col <= q0 + row ? expf(c[a][bb] * scale - Es[row]) : 0.0f;
      }
    }
    __syncthreads();
    load_tile<T, HD>(KVs, vb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    nt_32x32<HD>(DOs, KVs, ty, tx, c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) Ds[(ty + 16 * a) * SL + k0 + tx + 16 * bb] = c[a][bb];
    }
  }
  __syncthreads();
  // delta = rowsum(dp * p); ds = p * (dp - delta) * scale, rounded to q's type
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  for (int row = warp; row < BQ; row += kWarps) {
    const float* pr = Ss + row * SL;
    float* dr = Ds + row * SL;
    float sum = 0.0f;
    for (int j = lane; j < nk; j += kWarp) sum = fmaf(dr[j], pr[j], sum);
    sum = warp_sum(sum);
    if (lane == 0) delta[statbase + row] = sum;
    for (int j = lane; j < nk; j += kWarp) dr[j] = round_to(pr[j] * (dr[j] - sum) * scale, T());
  }
  // dq = ds k
  float4 acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<T, HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    pv_32<HD>(Ds + k0, SL, KVs, ty, tx, acc);
  }
  T* ob = dq + rowbase;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) store4(ob + (size_t)(ty + 16 * a) * qs + c * 64 + 4 * tx, acc[a][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk and dv, by key tile, summed over the group's query heads
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int L, int H, int KVH, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + 32 * (HD + 4);
  float* Qs = Vs + 32 * (HD + 4);
  float* DOs = Qs + 32 * (HD + 4);
  float* Pt = DOs + 32 * (HD + 4);  // [key][row], p rounded to v's type
  float* St = Pt + 32 * PT;         // [key][row], ds rounded to q's type
  float* Es = St + 32 * PT;         // lse of the query tile's rows
  float* Dl = Es + 32;              // delta of the query tile's rows

  const int jt = blockIdx.x;  // key tile 0 has the most query tiles and starts first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KVH;
  const int j0 = jt * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const size_t kvbase = ((size_t)b * L + j0) * ks + (size_t)kvh * HD;

  load_tile<T, HD>(Ks, k + kvbase, ks, BK);
  load_tile<T, HD>(Vs, v + kvbase, ks, BK);
  float4 acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int q0 = j0; q0 < L; q0 += BQ) {
      const size_t rowbase = ((size_t)b * L + q0) * qs + (size_t)h * HD;
      const size_t statbase = ((size_t)b * H + h) * L + q0;
      __syncthreads();
      load_tile<T, HD>(Qs, q + rowbase, qs, BQ);
      load_tile<T, HD>(DOs, dout + rowbase, qs, BQ);
      if (tid < 32) Es[tid] = lse[statbase + tid];
      else if (tid < 64) Dl[tid - 32] = delta[statbase + tid - 32];
      __syncthreads();
      float s[2][2], dp[2][2];
      nt_32x32<HD>(Qs, Ks, ty, tx, s);
      nt_32x32<HD>(DOs, Vs, ty, tx, dp);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int row = ty + 16 * a;  // query row within the tile
          const int col = tx + 16 * bb;  // key within the tile
          const float p = j0 + col <= q0 + row ? expf(s[a][bb] * scale - Es[row]) : 0.0f;
          Pt[col * PT + row] = round_to(p, T());
          St[col * PT + row] = round_to(p * (dp[a][bb] - Dl[row]) * scale, T());
        }
      }
      __syncthreads();
      pv_32<HD>(Pt, PT, DOs, ty, tx, acc_v);  // dv[key] += p^T do
      pv_32<HD>(St, PT, Qs, ty, tx, acc_k);   // dk[key] += ds^T q
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = kvbase + (size_t)(ty + 16 * a) * ks + c * 64 + 4 * tx;
      store4(dk + off, acc_k[a][c]);
      store4(dv + off, acc_v[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int HD>
int fwd_typed(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
              int KVH, float scale, cudaStream_t stream) {
  const int bytes = fwd_smem_floats<HD>(L) * (int)sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(vmem_attn_fwd_kernel<T, HD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_fwd_kernel<T, HD><<<dim3(L / BQ, H, B), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, L, H, KVH, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_typed(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              float* delta, void* dq, void* dk, void* dv, int B, int L, int H, int KVH, float scale,
              cudaStream_t stream) {
  const int bytes_q = dq_smem_floats<HD>(L) * (int)sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(vmem_attn_bwd_dq_kernel<T, HD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_q);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_bwd_dq_kernel<T, HD><<<dim3(L / BQ, H, B), kThreads, bytes_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, L, H, KVH, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int bytes_kv = dkv_smem_floats<HD>() * (int)sizeof(float);
  rc = cudaFuncSetAttribute(vmem_attn_bwd_dkv_kernel<T, HD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_kv);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_bwd_dkv_kernel<T, HD><<<dim3(L / BK, KVH, B), kThreads, bytes_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, L, H, KVH,
      scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int L, int H, int KVH, int hd) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && KVH > 0 && H % KVH == 0 && L >= BQ &&
         L % BQ == 0 && L <= 512 && (hd == 64 || hd == 128);
}

}  // namespace

// q, o [B, L, H, hd]; k, v [B, L, KVH, hd]; lse float32 [B, H, L];
// dtype 0 = float32, 1 = bfloat16.
extern "C" int vmem_attn_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                    int B, int L, int H, int KVH, int hd, float scale, int dtype,
                                    void* stream) {
  if (!shape_ok(B, L, H, KVH, hd) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return hd == 64 ? fwd_typed<float, 64>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s)
                    : fwd_typed<float, 128>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s);
  }
  return hd == 64 ? fwd_typed<__nv_bfloat16, 64>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s)
                  : fwd_typed<__nv_bfloat16, 128>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s);
}

// dout, dq like q; dk, dv like k; lse (from the forward) and delta (scratch)
// float32 [B, H, L]. Two kernels: dq (writes delta), then dk/dv.
extern "C" int vmem_attn_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
                                    int L, int H, int KVH, int hd, float scale, int dtype,
                                    void* stream) {
  if (!shape_ok(B, L, H, KVH, hd) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)lse;
  float* d = (float*)delta;
  if (dtype == 0) {
    return hd == 64 ? bwd_typed<float, 64>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s)
                    : bwd_typed<float, 128>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s);
  }
  return hd == 64
             ? bwd_typed<__nv_bfloat16, 64>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s)
             : bwd_typed<__nv_bfloat16, 128>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s);
}
