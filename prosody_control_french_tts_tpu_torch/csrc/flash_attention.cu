// Causal flash attention for long training sequences, forward and backward.
//
// Replaces the upstream Pallas TPU flash-attention op that the JAX package's
// model calls with attn_impl="flash" (models/llm.py Attention, the LoRA
// training step at L > 512): its forward body _flash_attention_kernel, its
// backward bodies _flash_attention_dkv_kernel and _flash_attention_dq_kernel.
//
// What it computes, per batch row b and head h, on q, k, v [B, H, L, hd]
// (K/V repeated to all heads by the caller), L a multiple of 128:
//   forward:  s = (q k^T) * scale in float32, masked above the diagonal, an
//             online softmax over key tiles (running max m, running sum l, the
//             float32 accumulator rescaled per tile), p rounded to v's type
//             before the p v product, o = acc / l cast to q's type; the
//             residuals l and m (float32 [B, H, L], natural-log domain) are
//             written for the backward.
//   backward: di = rowsum(o * do) in float32; p = exp(s - m) * (1 / l)
//             recomputed (never stored in device memory), dp = do v^T,
//             ds = (dp - di) * p * scale; dv = p^T do and dk = ds^T q with p
//             and ds rounded to the operands' type, dq = ds k, float32 sums.
//
// What bounds it on the card: operations (4 hd per (query, key) pair at or
// below the diagonal forward, 10 hd backward, against 4 L hd elements read
// per head), so the products stay on chip, on the tensor cores in bfloat16.
// Unlike kernel G's float32 design (csrc/vmem_attn.cu), no kernel holds a
// whole score row: L has no upper bound.
//
// bfloat16 (the training path): mma.sync.m16n8k16 bf16 x bf16 -> float32,
// operands fetched by ldmatrix from bf16 tiles in shared memory whose rows are
// padded by 16 bytes; tiles of 64 rows, four warps of 16 rows, 128 threads;
// the tiles streamed by a kernel's loop are brought by cp.async into two
// buffers, the next tile's copy in flight while the current one's products
// run. Scores and p stay in registers.
//   forward by (h, b, 64 query rows), the longest tiles first: key tiles
//     0 .. the diagonal, online softmax in the exp2 domain.
//   dq by (h, b, 64 query rows): di of its rows from O and dO, written for the
//     dk/dv kernel; K and V tiles streamed; dq = ds k.
//   dk/dv by (h, b, 64 keys), the longest first: the query tiles at or below
//     the diagonal streamed with their m, l and di; each cut into four 16-row
//     steps, steps wholly above the diagonal skipped; dk and dv written once.
//   dq and dk/dv are the upstream split: no atomics, and every sum is taken in
//   a fixed order, so two backward runs give the same bits.
// float32 (tensor cores would take float32 through TF32): the same three
// kernels on the CUDA cores, tiles of 32 rows and 32 keys, 256 threads, each
// thread a 2 x 2 patch of the 32 x 32 score tile; the tile's scores or p go
// through shared memory for the row reductions and the second product.
//
// The kernels are held to a tolerance against the plain PyTorch version
// (ops/flash_attention.py), not to bits: the upstream op rescales per
// 128-key tile and normalises every tile; these kernels keep the sum
// unnormalised and divide once, over tiles of 64 (bf16) or 32 (float32) keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;  // masked scores: exp gives exactly 0, as the upstream additive mask
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// 32 rows x HD floats (row stride HD) -> shared [32][HD + 4]
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < T32 * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = *reinterpret_cast<const float4*>(src + (size_t)r * HD + c);
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

template <int HD>
__device__ __forceinline__ void store_rows(float* dst, const float4 (&acc)[2][HD / 64], int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      *reinterpret_cast<float4*>(dst + (size_t)(ty + 16 * a) * HD + c * 64 + 4 * tx) = acc[a][c];
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
              float* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int L, float scale) {
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
  const size_t head = ((size_t)b * gridDim.x + h) * L;  // first row of (b, h)
  const int q0 = qt * T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  load_tile<HD>(Qs, q + (head + q0) * HD);
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
    load_tile<HD>(Ks, k + (head + k0) * HD);
    load_tile<HD>(Vs, v + (head + k0) * HD);
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
  store_rows<HD>(o + (head + q0) * HD, acc, ty, tx);
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
             const float* __restrict__ m_in, float* __restrict__ di_out, float* __restrict__ dq, int L, float scale) {
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
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int q0 = qt * T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  load_tile<HD>(Qs, q + (head + q0) * HD);
  load_tile<HD>(DOs, dout + (head + q0) * HD);
  __syncthreads();
  for (int r = warp; r < T32; r += kWarps) {  // di = rowsum(o * do), a warp per row
    const float* orow = o + (head + q0 + r) * HD;
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
    load_tile<HD>(Ks, k + (head + k0) * HD);
    load_tile<HD>(Vs, v + (head + k0) * HD);
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
  store_rows<HD>(dq + (head + q0) * HD, acc, ty, tx);
}

// One block per (h, b, 32 keys), the longest first: query tiles from the
// diagonal to the end.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ l_in, const float* __restrict__ m_in,
              const float* __restrict__ di_in, float* __restrict__ dk, float* __restrict__ dv, int L, float scale) {
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
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int j0 = jt * T32;
  const int nt = L / T32;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  load_tile<HD>(Ks, k + (head + j0) * HD);
  load_tile<HD>(Vs, v + (head + j0) * HD);
  float4 acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int it = jt; it < nt; ++it) {
    const int i0 = it * T32;
    load_tile<HD>(Qs, q + (head + i0) * HD);
    load_tile<HD>(DOs, dout + (head + i0) * HD);
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
  store_rows<HD>(dk + (head + j0) * HD, acc_k, ty, tx);
  store_rows<HD>(dv + (head + j0) * HD, acc_v, ty, tx);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles (mma.sync m16n8k16, float32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kT = 128;    // threads of a bf16 block: four warps of 16 rows
constexpr int kRows = 64;  // rows of a bf16 tile (queries or keys)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
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
  static constexpr int LD = HD + 8;  // elements per row
  static constexpr int BYTES = kRows * LD * 2;
};

// 64 rows of HD bf16 (row stride HD: the [B, H, L, hd] layout) -> a shared tile
template <int HD>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < kRows * CH; i += kT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    cp_async16(dst + (uint32_t)(r * Tile<HD>::LD + c) * 2, src + (size_t)r * HD + c);
  }
}

// 64 floats (one tile's m, l or di) -> shared; threads t = 0-15
__device__ __forceinline__ void load_stat_async(uint32_t dst, const float* src, int t) {
  if (t >= 0 && t < 16) cp_async16(dst + t * 16, src + 4 * t);
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
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int L, float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_q = smem_u32(smem_b);
  const uint32_t s_k = s_q + TL::BYTES;      // two buffers
  const uint32_t s_v = s_k + 2 * TL::BYTES;  // two buffers

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest tiles start first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const bf16* kb = k + head * HD;
  const bf16* vb = v + head * HD;

  load_tile_async<HD>(s_q, q + (head + q0) * HD);
  load_tile_async<HD>(s_k, kb);
  load_tile_async<HD>(s_v, vb);
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
      const size_t kn = (size_t)(kt + 1) * kRows * HD;
      load_tile_async<HD>(s_k + (buf ^ 1) * TL::BYTES, kb + kn);
      load_tile_async<HD>(s_v + (buf ^ 1) * TL::BYTES, vb + kn);
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
    bf16* orow = o + (head + row) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(acc[n][2 * r] / sum, acc[n][2 * r + 1] / sum);
    }
    if (tig == 0) {
      l_out[head + row] = sum;
      m_out[head + row] = m[r] * kLn2;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kT)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ l_in,
              const float* __restrict__ m_in, float* __restrict__ di_out, bf16* __restrict__ dq, int L, float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_q = smem_u32(smem_b);
  const uint32_t s_do = s_q + TL::BYTES;
  const uint32_t s_k = s_do + TL::BYTES;     // two buffers
  const uint32_t s_v = s_k + 2 * TL::BYTES;  // two buffers
  const bf16* DOs = reinterpret_cast<const bf16*>(smem_b + TL::BYTES);
  float* Dl = reinterpret_cast<float*>(smem_b + 6 * TL::BYTES);  // di of the tile's rows

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const bf16* kb = k + head * HD;
  const bf16* vb = v + head * HD;

  load_tile_async<HD>(s_q, q + (head + q0) * HD);
  load_tile_async<HD>(s_do, dout + (head + q0) * HD);
  cp_async_commit();
  load_tile_async<HD>(s_k, kb);
  load_tile_async<HD>(s_v, vb);
  cp_async_commit();
  cp_async_wait_prev();
  __syncthreads();

  // di = rowsum(dO * O) of the warp's 16 rows, float32 (the first K/V tiles
  // are in flight meanwhile)
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const bf16* orow = o + (head + q0 + r) * HD;
    float sum = 0.0f;
    for (int d = 2 * lane; d < HD; d += 2 * kWarp) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(DOs + r * TL::LD + d));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
      sum = fmaf(a.x, c.x, sum);
      sum = fmaf(a.y, c.y, sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Dl[r] = sum;
      di_out[head + q0 + r] = sum;
    }
  }
  __syncwarp();
  const int row0 = q0 + warp * 16 + g;
  float m2[2], il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m2[r] = m_in[head + row0 + 8 * r] * kLog2e;
    il[r] = 1.0f / l_in[head + row0 + 8 * r];
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
      const size_t kn = (size_t)(kt + 1) * kRows * HD;
      load_tile_async<HD>(s_k + (buf ^ 1) * TL::BYTES, kb + kn);
      load_tile_async<HD>(s_v + (buf ^ 1) * TL::BYTES, vb + kn);
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
        const float p = masked ? 0.0f : exp2f(s[n][e] * c2 - m2[r]) * il[r];
        s[n][e] = (dp[n][e] - dl[r]) * p * scale;  // ds
      }
    }
    uint32_t ds[4][4];
    to_a_frags<8>(s, ds);
    mma_px<4, NO>(acc, ds, s_k + buf * TL::BYTES, TL::LD * 2, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* drow = dq + (head + row0 + 8 * r) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) *reinterpret_cast<uint32_t*>(drow + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// One block per (h, b, 64 keys), the longest first: the query tiles from the
// diagonal to the end, with their m, l and di.
template <int HD>
__global__ void __launch_bounds__(kT)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ l_in, const float* __restrict__ m_in,
               const float* __restrict__ di_in, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, float scale) {
  using TL = Tile<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t s_k = smem_u32(smem_b);
  const uint32_t s_v = s_k + TL::BYTES;
  const uint32_t s_q = s_v + TL::BYTES;       // two buffers
  const uint32_t s_do = s_q + 2 * TL::BYTES;  // two buffers
  float* St = reinterpret_cast<float*>(smem_b + 6 * TL::BYTES);  // [2 buffers][m, l, di][64]
  const uint32_t s_st = smem_u32(St);

  const int jt = blockIdx.z;  // key tile: the lowest walks the most query tiles and starts first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = ((size_t)b * gridDim.x + h) * L;
  const int j0 = jt * kRows;
  const int nt = L / kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float c2 = scale * kLog2e;

  auto load_query_tile = [&](int i, int buf) {
    const size_t r0 = head + (size_t)i * kRows;
    load_tile_async<HD>(s_q + buf * TL::BYTES, q + r0 * HD);
    load_tile_async<HD>(s_do + buf * TL::BYTES, dout + r0 * HD);
    const uint32_t st = s_st + buf * 3 * kRows * 4;
    load_stat_async(st, m_in + r0, tid);
    load_stat_async(st + kRows * 4, l_in + r0, tid - 16);
    load_stat_async(st + 2 * kRows * 4, di_in + r0, tid - 32);
  };

  load_tile_async<HD>(s_k, k + (head + j0) * HD);
  load_tile_async<HD>(s_v, v + (head + j0) * HD);
  load_query_tile(jt, 0);
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

  for (int i = jt; i < nt; ++i) {
    const int buf = (i - jt) & 1;
    if (i + 1 < nt) load_query_tile(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    float* st = St + buf * 3 * kRows;
    if (tid < kRows) {  // m -> m log2(e), l -> 1 / l, in place
      st[tid] *= kLog2e;
      st[kRows + tid] = 1.0f / st[kRows + tid];
    }
    __syncthreads();
    const float* m2_t = st;
    const float* il_t = st + kRows;
    const float* d_t = st + 2 * kRows;
#pragma unroll 1
    for (int qc = 0; qc < 4; ++qc) {
      const int ql0 = 16 * qc;
      if (i == jt && qc < warp) continue;  // steps wholly above the diagonal
      float st_[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        st_[n][0] = st_[n][1] = st_[n][2] = st_[n][3] = 0.0f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
      }
      const uint32_t b_q = s_q + buf * TL::BYTES + ql0 * TL::LD * 2;
      const uint32_t b_do = s_do + buf * TL::BYTES + ql0 * TL::LD * 2;
      mma_abt<HD, 2>(st_, a_k, TL::LD * 2, b_q, TL::LD * 2, lane);   // s^T = k q^T
      mma_abt<HD, 2>(dpt, a_v, TL::LD * 2, b_do, TL::LD * 2, lane);  // dp^T = v do^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = ql0 + n * 8 + 2 * tig + (e & 1);
          const int query = i * kRows + ql;
          const bool live = key0 + 8 * (e >> 1) <= query;
          const float p = live ? exp2f(st_[n][e] * c2 - m2_t[ql]) * il_t[ql] : 0.0f;
          dpt[n][e] = (dpt[n][e] - d_t[ql]) * p * scale;  // ds^T
          st_[n][e] = p;
        }
      }
      uint32_t pa[1][4], dsa[1][4];
      to_a_frags<2>(st_, pa);
      to_a_frags<2>(dpt, dsa);
      mma_px<1, NO>(acc_v, pa, b_do, TL::LD * 2, lane);  // dv += p^T do
      mma_px<1, NO>(acc_k, dsa, b_q, TL::LD * 2, lane);  // dk += ds^T q
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = (head + key0 + 8 * r) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) = pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) = pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// dynamic shared memory of a kernel in bytes: kernel 0 forward, 1 dq, 2 dk/dv;
// bf16: 0 Q and two K and two V tiles; 1 Q, dO, two K, two V, the rows' di;
// 2 K, V, two Q, two dO, two tiles' m, l and di
template <int HD>
constexpr int smem_bytes(int kernel, bool bf) {
  return bf ? (kernel == 0 ? 5 * Tile<HD>::BYTES : 6 * Tile<HD>::BYTES + (kernel == 1 ? 1 : 6) * kRows * (int)sizeof(float))
            : f32_smem_floats<HD>(kernel) * (int)sizeof(float);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* l, float* m, int B, int H, int L, float scale,
        bool bf, cudaStream_t stream) {
  const int bytes = smem_bytes<HD>(0, bf);
  if (bf) {
    int rc = set_smem(flash_fwd_bf16<HD>, bytes);
    if (rc) return rc;
    flash_fwd_bf16<HD><<<dim3(H, B, L / kRows), kT, bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                                      (bf16*)o, l, m, L, scale);
  } else {
    int rc = set_smem(flash_fwd_f32<HD>, bytes);
    if (rc) return rc;
    flash_fwd_f32<HD><<<dim3(H, B, L / T32), kThreads, bytes, stream>>>((const float*)q, (const float*)k,
                                                                         (const float*)v, (float*)o, l, m, L, scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* l, const float* m,
        float* di, void* dq, void* dk, void* dv, int B, int H, int L, float scale, bool bf, cudaStream_t stream) {
  const int bq = smem_bytes<HD>(1, bf);
  const int bkv = smem_bytes<HD>(2, bf);
  int rc;
  if (bf) {
    if ((rc = set_smem(flash_dq_bf16<HD>, bq))) return rc;
    flash_dq_bf16<HD><<<dim3(H, B, L / kRows), kT, bq, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                                  (const bf16*)o, (const bf16*)dout, l, m, di,
                                                                  (bf16*)dq, L, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = set_smem(flash_dkv_bf16<HD>, bkv))) return rc;
    flash_dkv_bf16<HD><<<dim3(H, B, L / kRows), kT, bkv, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                                    (const bf16*)dout, l, m, di, (bf16*)dk,
                                                                    (bf16*)dv, L, scale);
  } else {
    if ((rc = set_smem(flash_dq_f32<HD>, bq))) return rc;
    flash_dq_f32<HD><<<dim3(H, B, L / T32), kThreads, bq, stream>>>((const float*)q, (const float*)k,
                                                                     (const float*)v, (const float*)o,
                                                                     (const float*)dout, l, m, di, (float*)dq, L,
                                                                     scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = set_smem(flash_dkv_f32<HD>, bkv))) return rc;
    flash_dkv_f32<HD><<<dim3(H, B, L / T32), kThreads, bkv, stream>>>((const float*)q, (const float*)k,
                                                                       (const float*)v, (const float*)dout, l, m,
                                                                       di, (float*)dk, (float*)dv, L, scale);
  }
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int L, int hd, int dtype) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && L >= 128 && L % 128 == 0 && L / T32 <= 65535 &&
         (hd == 64 || hd == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// q, k, v, o [B, H, L, hd] contiguous; l, m float32 [B, H, L] (out);
// dtype 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v, void* o, void* l, void* m, int B,
                                     int H, int L, int hd, float scale, int dtype, void* stream) {
  if (!shape_ok(B, H, L, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hd == 64 ? fwd<64>(q, k, v, o, (float*)l, (float*)m, B, H, L, scale, dtype == 1, s)
                  : fwd<128>(q, k, v, o, (float*)l, (float*)m, B, H, L, scale, dtype == 1, s);
}

// o is the forward's output, dout like q; l, m from the forward; di float32
// [B, H, L] scratch; dq like q, dk and dv like k. Two kernels: dq (writes di),
// then dk/dv.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                     const void* l, const void* m, void* di, void* dq, void* dk, void* dv, int B,
                                     int H, int L, int hd, float scale, int dtype, void* stream) {
  if (!shape_ok(B, H, L, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lf = (const float*)l;
  const float* mf = (const float*)m;
  float* d = (float*)di;
  return hd == 64 ? bwd<64>(q, k, v, o, dout, lf, mf, d, dq, dk, dv, B, H, L, scale, dtype == 1, s)
                  : bwd<128>(q, k, v, o, dout, lf, mf, d, dq, dk, dv, B, H, L, scale, dtype == 1, s);
}

// The dynamic shared memory the kernel `kernel` (0 forward, 1 dq, 2 dk/dv) of
// dtype (0 float32, 1 bfloat16) asks for at head dim hd, in bytes; -1 for
// other arguments.
extern "C" int flash_attn_smem_bytes(int kernel, int hd, int dtype) {
  if (kernel < 0 || kernel > 2 || (hd != 64 && hd != 128) || (dtype != 0 && dtype != 1)) return -1;
  return hd == 64 ? smem_bytes<64>(kernel, dtype == 1) : smem_bytes<128>(kernel, dtype == 1);
}
