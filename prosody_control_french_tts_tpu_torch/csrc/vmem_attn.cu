// Causal grouped-query attention for short training sequences, forward and
// backward, with the scores kept on chip.
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
// products on chip and on the tensor cores. The TPU body holds a whole [L, L]
// float32 score matrix in VMEM (1 MB at L 512); a block here has 227 KB of
// shared memory. Two designs, chosen by the operands' type:
//
// bfloat16 (the training path: bf16 frozen base). Every product runs on the
// tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> float32, operands fetched by
// ldmatrix from bf16 tiles in shared memory whose rows are padded by 16 bytes
// (conflict-free for ldmatrix and 16-byte cp.async); the tiles are 64 rows,
// four warps of 16 rows each, 128 threads. K/V (forward, dq) and Q/dO/lse/
// delta (dk/dv) tiles are brought by cp.async into two buffers, the next
// tile's copy in flight while the current one's products run.
//   forward, one block per (b, h, 64 query rows), the longest tiles first:
//     online softmax (running max and sum in the exp2 domain, the float32
//     accumulator rescaled per key tile); scores stay in registers and p goes
//     into the p v product as a bf16 register operand. Rounding point that
//     moved: p is rounded to bf16 as exp(s - running max), not exp(s - row
//     max), and the rescale by exp(old max - new max) is applied to the
//     float32 sum. lse = m + log l is written for the backward.
//   backward, three kernels, no atomics, deterministic:
//     dq by (b, h, 64 query rows): delta = rowsum(dO * O) of its rows in
//       float32 from the saved output (the TPU kernel takes rowsum(dp * p); the
//       two are equal up to O's bf16 rounding), written for the dk/dv kernel;
//       K and V tiles streamed; p = exp(s - lse), ds = p (dp - delta) scale
//       rounded to bf16 as the TPU kernel does; dq = ds k.
//     dk/dv by the rows of a work plan (query head, key tile a, key tile b),
//       computed by ops/vmem_attn.py:dkv_plan: key tiles {j, n-1-j} pair up so
//       that every block walks n + 1 query tiles; each query tile is cut into
//       four 16-row steps, and steps wholly above the diagonal are skipped.
//       dk and dv of one query head go to float32 partials [B, L, H, hd].
//     reduce: dk, dv = the sum of the group's partials in head order, in
//       float32, cast once to bf16.
//
// float32 (held to 2e-5 / 1e-5 of the plain version; tensor cores would
// take float32 through TF32): the CUDA-core design. Forward, one block per
// (b, h, tile of 32 query rows): the tile's [32, L] float32 scores stay in
// shared memory, K tiles of 32 keys are streamed for the scores, then V tiles
// for the second product, with the TPU kernel's whole-row softmax (no online
// rescale, same rounding points). Backward, two kernels: dq by (b, h, query
// tile) with p and dp rows in shared memory and delta written for the second
// kernel; dk/dv by (b, KV head, tile of 32 keys) looping over the group's
// query heads and the query tiles at or below the key tile. Products are
// explicit fmaf on float32 operands in shared memory.
//
// The kernels are held to a tolerance against the plain PyTorch version, not
// to bits.

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

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// rows x HD floats (row stride `stride` elements) -> shared [rows][HD + 4]
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride, int rows) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = *reinterpret_cast<const float4*>(src + (size_t)r * stride + c);
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int L, int H, int KVH, float scale) {
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
  const float* qb = q + ((size_t)b * L + q0) * qs + (size_t)h * HD;
  const float* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;

  load_tile<HD>(Qs, qb, qs, BQ);
  // scores
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
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
  // whole-row softmax numerators and their sum
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
      sr[j] = e;
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
    load_tile<HD>(KVs, vb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    pv_32<HD>(Ss + k0, SL, KVs, ty, tx, acc);
  }
  float* ob = o + ((size_t)b * L + q0) * qs + (size_t)h * HD;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int L, int H, int KVH,
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
  const float* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;
  const size_t statbase = ((size_t)b * H + h) * L + q0;

  load_tile<HD>(Qs, q + rowbase, qs, BQ);
  load_tile<HD>(DOs, dout + rowbase, qs, BQ);
  if (tid < BQ) Es[tid] = lse[statbase + tid];
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
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
    load_tile<HD>(KVs, vb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    nt_32x32<HD>(DOs, KVs, ty, tx, c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) Ds[(ty + 16 * a) * SL + k0 + tx + 16 * bb] = c[a][bb];
    }
  }
  __syncthreads();
  // delta = rowsum(dp * p); ds = p * (dp - delta) * scale
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  for (int row = warp; row < BQ; row += kWarps) {
    const float* pr = Ss + row * SL;
    float* dr = Ds + row * SL;
    float sum = 0.0f;
    for (int j = lane; j < nk; j += kWarp) sum = fmaf(dr[j], pr[j], sum);
    sum = warp_sum(sum);
    if (lane == 0) delta[statbase + row] = sum;
    for (int j = lane; j < nk; j += kWarp) dr[j] = pr[j] * (dr[j] - sum) * scale;
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
    load_tile<HD>(KVs, kb + (size_t)k0 * ks, ks, BK);
    __syncthreads();
    pv_32<HD>(Ds + k0, SL, KVs, ty, tx, acc);
  }
  float* ob = dq + rowbase;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) store4(ob + (size_t)(ty + 16 * a) * qs + c * 64 + 4 * tx, acc[a][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk and dv, by key tile, summed over the group's query heads
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
vmem_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                         int L, int H, int KVH, float scale) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + 32 * (HD + 4);
  float* Qs = Vs + 32 * (HD + 4);
  float* DOs = Qs + 32 * (HD + 4);
  float* Pt = DOs + 32 * (HD + 4);  // [key][row], p
  float* St = Pt + 32 * PT;         // [key][row], ds
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

  load_tile<HD>(Ks, k + kvbase, ks, BK);
  load_tile<HD>(Vs, v + kvbase, ks, BK);
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
      load_tile<HD>(Qs, q + rowbase, qs, BQ);
      load_tile<HD>(DOs, dout + rowbase, qs, BQ);
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
          Pt[col * PT + row] = p;
          St[col * PT + row] = p * (dp[a][bb] - Dl[row]) * scale;
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
// bfloat16: tensor-core tiles (mma.sync m16n8k16, float32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kT = 128;  // threads of a bf16 block: four warps of 16 rows
constexpr int kRows = 64;  // rows of a bf16 tile (queries or keys)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 fills zeros (rows past L)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A tile of kRows rows x HD bf16 in shared memory, rows padded by 8 elements
// (16 bytes): the 8 row addresses of an ldmatrix fall in 8 distinct 16-byte
// bank groups.
template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;                       // elements per row
  static constexpr int BYTES = kRows * LD * 2;
};

// rows [0, valid) of a [rows, HD] bf16 slab with row stride `stride` -> a
// shared tile at `dst`; rows at or past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, size_t stride, int valid) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < kRows * CH; i += kT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bf16* g = src + (size_t)min(r, valid - 1) * stride + c;
    cp_async16(dst + (uint32_t)(r * Tile<HD>::LD + c) * 2, g, r < valid ? 16 : 0);
  }
}

// 64 floats (one tile's lse or delta) -> shared, zeros past L; L is a
// multiple of 32, so a 4-float chunk is wholly in or out. Threads t = 0-15.
__device__ __forceinline__ void load_stat_async(uint32_t dst, const float* src, int valid, int t) {
  if (t >= 0 && t < 16) cp_async16(dst + t * 16, src + min(4 * t, valid - 4), 4 * t < valid ? 16 : 0);
}

// acc[16 x 8 NT] += A[16 x KD] B[8 NT x KD]^T; A and B row-major bf16 tiles in
// shared memory (a, b: addresses of their first rows; ld* in bytes)
template <int KD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t a, int lda, uint32_t b, int ldb, int lane) {
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
  for (int k = 0; k < KD; k += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * lda + (k + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n * 8 + (lane & 7) + (lane >> 4) * 8) * ldb + (k + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x 8 NT] += P[16 x 16 KS] X[16 KS x 8 NT]; P in registers as KS A
// fragments, X a row-major bf16 tile in shared memory (x: address of its
// first row, read transposed by ldmatrix)
template <int KS, int NT>
__device__ __forceinline__ void mma_px(float (&acc)[NT][4], const uint32_t (&p)[KS][4], uint32_t x, int ldx, int lane) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, x + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx + (n * 8 + (lane >> 4) * 8) * 2);
      mma_bf16(acc[n], p[k], bf[0], bf[1]);
      mma_bf16(acc[n + 1], p[k], bf[2], bf[3]);
    }
  }
}

// the A fragment of k-step t of a product whose left operand is the 16 x 16KS
// accumulator c (n-tiles 2t and 2t+1), rounded to bf16
template <int NT>
__device__ __forceinline__ void to_a_frags(const float (&c)[NT][4], uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    a[t][0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
    a[t][1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
    a[t][2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
    a[t][3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
  }
}

// Accumulator element e of n-tile nt sits at row (lane / 4) + 8 (e / 2),
// column 8 nt + 2 (lane % 4) + e % 2 of the 16 x 8 NT tile.

template <int HD>
__global__ void __launch_bounds__(kT)
vmem_attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   bf16* __restrict__ o, float* __restrict__ lse, int L, int H, int KVH, float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_q = smem_u32(smem_b);
  const uint32_t s_k = s_q + TL::BYTES;       // two buffers
  const uint32_t s_v = s_k + 2 * TL::BYTES;   // two buffers

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest tiles start first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const bf16* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;

  load_tile_async<HD>(s_q, q + ((size_t)b * L + q0) * qs + (size_t)h * HD, qs, min(kRows, L - q0));
  load_tile_async<HD>(s_k, kb, ks, min(kRows, L));
  load_tile_async<HD>(s_v, vb, ks, min(kRows, L));
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNeg, kNeg};  // running row max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};  // this thread's share of the running row sum
  const float c2 = scale * kLog2e;
  const uint32_t a_q = s_q + warp * 16 * TL::LD * 2;
  const int row0 = q0 + warp * 16 + g;  // query rows row0, row0 + 8

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      const int kn = (kt + 1) * kRows;
      load_tile_async<HD>(s_k + (buf ^ 1) * TL::BYTES, kb + (size_t)kn * ks, ks, min(kRows, L - kn));
      load_tile_async<HD>(s_v + (buf ^ 1) * TL::BYTES, vb + (size_t)kn * ks, ks, min(kRows, L - kn));
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    mma_abt<HD, 8>(s, a_q, TL::LD * 2, s_k + buf * TL::BYTES, TL::LD * 2, lane);
    const int k0 = kt * kRows;
    const bool diag = kt == qt;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * c2;
        if (diag && k0 + n * 8 + 2 * tig + (e & 1) > row0 + 8 * (e >> 1)) x = kNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    uint32_t p[4][4];
    to_a_frags<8>(s, p);
    mma_px<4, NO>(acc, p, s_v + buf * TL::BYTES, TL::LD * 2, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float sum = quad_sum(l[r]);
    if (row >= L) continue;
    bf16* orow = o + ((size_t)b * L + row) * qs + (size_t)h * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(acc[n][2 * r] / sum, acc[n][2 * r + 1] / sum);
    }
    if (tig == 0) lse[((size_t)b * H + h) * L + row] = (m[r] + log2f(sum)) * kLn2;
  }
}

template <int HD>
__global__ void __launch_bounds__(kT)
vmem_attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                      float* __restrict__ delta, bf16* __restrict__ dq, int L, int H, int KVH, float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_q = smem_u32(smem_b);
  const uint32_t s_do = s_q + TL::BYTES;
  const uint32_t s_k = s_do + TL::BYTES;      // two buffers
  const uint32_t s_v = s_k + 2 * TL::BYTES;   // two buffers
  const bf16* DOs = reinterpret_cast<const bf16*>(smem_b + TL::BYTES);
  float* Dl = reinterpret_cast<float*>(smem_b + 6 * TL::BYTES);  // delta of the tile's rows

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const size_t rowbase = ((size_t)b * L + q0) * qs + (size_t)h * HD;
  const size_t statbase = ((size_t)b * H + h) * L + q0;
  const bf16* kb = k + (size_t)b * L * ks + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * ks + (size_t)kvh * HD;

  load_tile_async<HD>(s_q, q + rowbase, qs, min(kRows, L - q0));
  load_tile_async<HD>(s_do, dout + rowbase, qs, min(kRows, L - q0));
  cp_async_commit();
  load_tile_async<HD>(s_k, kb, ks, min(kRows, L));
  load_tile_async<HD>(s_v, vb, ks, min(kRows, L));
  cp_async_commit();
  cp_async_wait_prev();
  __syncthreads();

  // delta = rowsum(dO * O) of the warp's 16 rows, float32 (the first K/V
  // tiles are in flight meanwhile)
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float sum = 0.0f;
    if (q0 + r < L) {
      const bf16* orow = o + rowbase + (size_t)r * qs;
      for (int d = 2 * lane; d < HD; d += 2 * kWarp) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(DOs + r * TL::LD + d));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
        sum = fmaf(a.x, c.x, sum);
        sum = fmaf(a.y, c.y, sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Dl[r] = sum;
      if (q0 + r < L) delta[statbase + r] = sum;
    }
  }
  __syncwarp();
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row0 + 8 * r < L ? lse[statbase + warp * 16 + g + 8 * r] * kLog2e : 0.0f;
    dl[r] = Dl[warp * 16 + g + 8 * r];
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float c2 = scale * kLog2e;
  const uint32_t a_q = s_q + warp * 16 * TL::LD * 2;
  const uint32_t a_do = s_do + warp * 16 * TL::LD * 2;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      const int kn = (kt + 1) * kRows;
      load_tile_async<HD>(s_k + (buf ^ 1) * TL::BYTES, kb + (size_t)kn * ks, ks, min(kRows, L - kn));
      load_tile_async<HD>(s_v + (buf ^ 1) * TL::BYTES, vb + (size_t)kn * ks, ks, min(kRows, L - kn));
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
    mma_abt<HD, 8>(s, a_q, TL::LD * 2, s_k + buf * TL::BYTES, TL::LD * 2, lane);
    mma_abt<HD, 8>(dp, a_do, TL::LD * 2, s_v + buf * TL::BYTES, TL::LD * 2, lane);
    const int k0 = kt * kRows;
    const bool diag = kt == qt;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = diag && k0 + n * 8 + 2 * tig + (e & 1) > row0 + 8 * r;
        const float p = masked ? 0.0f : exp2f(s[n][e] * c2 - lse2[r]);
        s[n][e] = p * (dp[n][e] - dl[r]) * scale;  // ds
      }
    }
    uint32_t ds[4][4];
    to_a_frags<8>(s, ds);
    mma_px<4, NO>(acc, ds, s_k + buf * TL::BYTES, TL::LD * 2, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    bf16* drow = dq + ((size_t)b * L + row) * qs + (size_t)h * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) *reinterpret_cast<uint32_t*>(drow + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// One block per (batch row, row of the work plan). A plan row is (query head,
// key tile a, key tile b or -1); the block walks, for each of its key tiles j,
// the query tiles j .. n-1 and writes that head's dk and dv rows of the tile
// to the float32 partials [B, L, H, hd].
template <int HD>
__global__ void __launch_bounds__(kT)
vmem_attn_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ plan,
                       float* __restrict__ dk_part, float* __restrict__ dv_part, int L, int H, int KVH,
                       float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_k = smem_u32(smem_b);
  const uint32_t s_v = s_k + TL::BYTES;
  const uint32_t s_q = s_v + TL::BYTES;       // two buffers
  const uint32_t s_do = s_q + 2 * TL::BYTES;  // two buffers
  const float* Es = reinterpret_cast<const float*>(smem_b + 6 * TL::BYTES);  // [2][64] lse
  const float* Dl = Es + 2 * kRows;                                          // [2][64] delta
  const uint32_t s_e = smem_u32(Es);
  const uint32_t s_d = smem_u32(Dl);

  const int b = blockIdx.x;
  const int* row = plan + 3 * blockIdx.y;
  const int h = row[0];
  const int kvh = h / (H / KVH);
  const int nt = (L + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t qs = (size_t)H * HD;
  const size_t ks = (size_t)KVH * HD;
  const bf16* qb = q + (size_t)b * L * qs + (size_t)h * HD;
  const bf16* dob = dout + (size_t)b * L * qs + (size_t)h * HD;
  const float* eb = lse + ((size_t)b * H + h) * L;
  const float* db = delta + ((size_t)b * H + h) * L;
  const float c2 = scale * kLog2e;

  auto load_query_tile = [&](int i, int buf) {
    const int r0 = i * kRows;
    const int valid = min(kRows, L - r0);
    load_tile_async<HD>(s_q + buf * TL::BYTES, qb + (size_t)r0 * qs, qs, valid);
    load_tile_async<HD>(s_do + buf * TL::BYTES, dob + (size_t)r0 * qs, qs, valid);
    load_stat_async(s_e + buf * kRows * 4, eb + r0, valid, tid);
    load_stat_async(s_d + buf * kRows * 4, db + r0, valid, tid - 16);
  };

  for (int which = 1; which <= 2; ++which) {
    const int j = row[which];
    if (j < 0) break;
    const int j0 = j * kRows;
    const size_t kvbase = ((size_t)b * L + j0) * ks + (size_t)kvh * HD;
    load_tile_async<HD>(s_k, k + kvbase, ks, min(kRows, L - j0));
    load_tile_async<HD>(s_v, v + kvbase, ks, min(kRows, L - j0));
    load_query_tile(j, 0);
    cp_async_commit();

    float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.0f;
      acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.0f;
    }
    const uint32_t a_k = s_k + warp * 16 * TL::LD * 2;
    const uint32_t a_v = s_v + warp * 16 * TL::LD * 2;
    const int key0 = j0 + warp * 16 + g;  // keys key0, key0 + 8

    for (int i = j; i < nt; ++i) {
      const int buf = (i - j) & 1;
      if (i + 1 < nt) load_query_tile(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      const float* e_t = Es + buf * kRows;
      const float* d_t = Dl + buf * kRows;
#pragma unroll 1
      for (int qc = 0; qc < 4; ++qc) {
        const int ql0 = 16 * qc;
        // steps wholly above the diagonal, and steps past L
        if ((i == j && qc < warp) || i * kRows + ql0 >= L) continue;
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
          dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
        }
        const uint32_t b_q = s_q + buf * TL::BYTES + ql0 * TL::LD * 2;
        const uint32_t b_do = s_do + buf * TL::BYTES + ql0 * TL::LD * 2;
        mma_abt<HD, 2>(st, a_k, TL::LD * 2, b_q, TL::LD * 2, lane);    // s^T = k q^T
        mma_abt<HD, 2>(dpt, a_v, TL::LD * 2, b_do, TL::LD * 2, lane);  // dp^T = v do^T
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = ql0 + n * 8 + 2 * tig + (e & 1);
            const int query = i * kRows + ql;
            const bool live = key0 + 8 * (e >> 1) <= query && query < L;
            const float p = live ? exp2f(st[n][e] * c2 - e_t[ql] * kLog2e) : 0.0f;
            dpt[n][e] = p * (dpt[n][e] - d_t[ql]) * scale;  // ds^T
            st[n][e] = p;
          }
        }
        uint32_t pa[1][4], dsa[1][4];
        to_a_frags<2>(st, pa);
        to_a_frags<2>(dpt, dsa);
        mma_px<1, NO>(acc_v, pa, b_do, TL::LD * 2, lane);  // dv += p^T do
        mma_px<1, NO>(acc_k, dsa, b_q, TL::LD * 2, lane);  // dk += ds^T q
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= L) continue;
      const size_t off = (((size_t)b * L + key) * H + h) * HD + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(dk_part + off + n * 8) = make_float2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + off + n * 8) = make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      }
    }
  }
}

// dk, dv [B, L, KVH, hd] bf16 = the sum over the group's query heads, in head
// order, of the float32 partials [B, L, H, hd]; blockIdx.y 0 is dk, 1 is dv
__global__ void __launch_bounds__(256)
vmem_attn_bwd_reduce(const float* __restrict__ dk_part, const float* __restrict__ dv_part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, size_t rows, int H, int KVH, int hd) {
  const float* part = blockIdx.y ? dv_part : dk_part;
  bf16* out = blockIdx.y ? dv : dk;
  const int group = H / KVH;
  const int per_row = hd / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows * per_row; i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / per_row;  // (b, l, kvh) row of the output
    const int d = (int)(i % per_row) * 4;
    const float* src = part + ((r / KVH) * H + (r % KVH) * group) * hd + d;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int gi = 1; gi < group; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(src + (size_t)gi * hd);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    uint2 raw;
    raw.x = pack_bf16(s.x, s.y);
    raw.y = pack_bf16(s.z, s.w);
    *reinterpret_cast<uint2*>(out + r * hd + d) = raw;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
            int KVH, float scale, cudaStream_t stream) {
  const int bytes = fwd_smem_floats<HD>(L) * (int)sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(vmem_attn_fwd_kernel<HD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_fwd_kernel<HD><<<dim3(L / BQ, H, B), kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, L, H, KVH, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            float* delta, void* dq, void* dk, void* dv, int B, int L, int H, int KVH, float scale,
            cudaStream_t stream) {
  const int bytes_q = dq_smem_floats<HD>(L) * (int)sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(vmem_attn_bwd_dq_kernel<HD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_q);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_bwd_dq_kernel<HD><<<dim3(L / BQ, H, B), kThreads, bytes_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq, L, H, KVH,
      scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int bytes_kv = dkv_smem_floats<HD>() * (int)sizeof(float);
  rc = cudaFuncSetAttribute(vmem_attn_bwd_dkv_kernel<HD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_kv);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_bwd_dkv_kernel<HD><<<dim3(L / BK, KVH, B), kThreads, bytes_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dk, (float*)dv, L,
      H, KVH, scale);
  return (int)cudaGetLastError();
}

// dynamic shared memory of a bf16 kernel in bytes; kernel 0 forward (Q and
// two K and two V tiles), 1 dq (Q, dO, two K, two V, the rows' delta), 2 dk/dv
// (K, V, two Q, two dO, two tiles' lse and delta)
template <int HD>
constexpr int bf16_smem_bytes(int kernel) {
  return kernel == 0 ? 5 * Tile<HD>::BYTES
                     : 6 * Tile<HD>::BYTES + (kernel == 1 ? 1 : 4) * kRows * (int)sizeof(float);
}

template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H, int KVH,
             float scale, cudaStream_t stream) {
  const int bytes = bf16_smem_bytes<HD>(0);
  cudaError_t rc = cudaFuncSetAttribute(vmem_attn_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  const int nq = (L + kRows - 1) / kRows;
  vmem_attn_fwd_bf16<HD><<<dim3(H, B, nq), kT, bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                                 (bf16*)o, lse, L, H, KVH, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
             float* delta, const int* plan, int n_plan, float* dk_part, float* dv_part, void* dq, void* dk,
             void* dv, int B, int L, int H, int KVH, float scale, cudaStream_t stream) {
  const int bytes_q = bf16_smem_bytes<HD>(1);
  cudaError_t rc =
      cudaFuncSetAttribute(vmem_attn_bwd_dq_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_q);
  if (rc != cudaSuccess) return (int)rc;
  const int nq = (L + kRows - 1) / kRows;
  vmem_attn_bwd_dq_bf16<HD><<<dim3(H, B, nq), kT, bytes_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, lse, delta, (bf16*)dq, L,
      H, KVH, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int bytes_kv = bf16_smem_bytes<HD>(2);
  rc = cudaFuncSetAttribute(vmem_attn_bwd_dkv_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_kv);
  if (rc != cudaSuccess) return (int)rc;
  vmem_attn_bwd_dkv_bf16<HD><<<dim3(B, n_plan), kT, bytes_kv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, plan, dk_part, dv_part, L, H,
      KVH, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const size_t rows = (size_t)B * L * KVH;
  const size_t blocks = (rows * (HD / 4) + 255) / 256;
  vmem_attn_bwd_reduce<<<dim3((unsigned)(blocks < 8192 ? blocks : 8192), 2), 256, 0, stream>>>(
      dk_part, dv_part, (bf16*)dk, (bf16*)dv, rows, H, KVH, HD);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int L, int H, int KVH, int hd) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && KVH > 0 && H % KVH == 0 && L >= BQ &&
         L % BQ == 0 && L <= 512 && (hd == 64 || hd == 128);
}

}  // namespace

// q, o [B, L, H, hd]; k, v [B, L, KVH, hd]; lse float32 [B, H, L];
// dtype 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
extern "C" int vmem_attn_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                    int B, int L, int H, int KVH, int hd, float scale, int dtype,
                                    void* stream) {
  if (!shape_ok(B, L, H, KVH, hd) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return hd == 64 ? fwd_f32<64>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s)
                    : fwd_f32<128>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s);
  }
  return hd == 64 ? fwd_bf16<64>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s)
                  : fwd_bf16<128>(q, k, v, o, (float*)lse, B, L, H, KVH, scale, s);
}

// float32 only. dout, dq like q; dk, dv like k; lse (from the forward) and
// delta (scratch) float32 [B, H, L]. Two kernels: dq (writes delta), then dk/dv.
extern "C" int vmem_attn_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
                                    int L, int H, int KVH, int hd, float scale, void* stream) {
  if (!shape_ok(B, L, H, KVH, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)lse;
  float* d = (float*)delta;
  return hd == 64 ? bwd_f32<64>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s)
                  : bwd_f32<128>(q, k, v, dout, e, d, dq, dk, dv, B, L, H, KVH, scale, s);
}

// The dynamic shared memory the bf16 kernel `kernel` (0 forward, 1 dq, 2
// dk/dv) asks for at head dim hd, in bytes; -1 for other arguments.
extern "C" int vmem_attn_bf16_smem_bytes(int kernel, int hd) {
  if (kernel < 0 || kernel > 2 || (hd != 64 && hd != 128)) return -1;
  return hd == 64 ? bf16_smem_bytes<64>(kernel) : bf16_smem_bytes<128>(kernel);
}

// bfloat16. o is the forward's output, dout like q; lse float32 [B, H, L]
// from the forward; delta float32 [B, H, L] scratch; plan int32 [n_plan, 3]
// (query head, key tile a, key tile b or -1; ops/vmem_attn.py:dkv_plan);
// dk_part, dv_part float32 [B, L, H, hd] scratch. Three kernels: dq (writes
// delta), dk/dv partials by plan row, the group sum.
extern "C" int vmem_attn_bwd_bf16_launch(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* lse, void* delta, const void* plan,
                                         int n_plan, void* dk_part, void* dv_part, void* dq, void* dk, void* dv,
                                         int B, int L, int H, int KVH, int hd, float scale, void* stream) {
  if (!shape_ok(B, L, H, KVH, hd) || n_plan < 1 || n_plan > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)lse;
  float* d = (float*)delta;
  const int* pl = (const int*)plan;
  float* pk = (float*)dk_part;
  float* pv = (float*)dv_part;
  return hd == 64 ? bwd_bf16<64>(q, k, v, o, dout, e, d, pl, n_plan, pk, pv, dq, dk, dv, B, L, H, KVH, scale, s)
                  : bwd_bf16<128>(q, k, v, o, dout, e, d, pl, n_plan, pk, pv, dq, dk, dv, B, L, H, KVH, scale, s);
}
