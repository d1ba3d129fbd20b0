// Fused LM-head + cross-entropy, forward and backward: the [N, V] logits are
// never written to device memory.
//
// Replaces the TPU kernels of ops/fused_ce.py of the JAX package:
// linear_ce_rows (forward body _fwd_kernel, backward body _bwd_kernel), the
// loss of the LoRA training step (models/llm.py causal_lm_loss_fused).
//
// What it computes, for h [N, D], W [D, V] (both float32 or both bfloat16) and
// targets tgt [N] int32:
//   forward:  l = h W in float32; per row the running max m and sum
//             s = sum exp(l - m) over the vocabulary (online rescale, as the
//             TPU kernel's sweep over vocab tiles) and the target's logit;
//             lse = m + log s, nll = lse - l[tgt]; both float32 [N].
//   backward: for the incoming per-row gradient g [N]:
//             coef = (exp(l - lse) - onehot(tgt)) * g rounded to W's type,
//             dh = coef W^T in float32 [N, D]. No dW (the head is frozen).
//
// What bounds it on the card: operations (2 N D V forward, 4 N D V backward;
// W is read a few times, the logits never leave the chip). Design:
//   forward: the TPU grid (N / 1024, V / 512) sweeps the vocabulary in order
//     with scratch carried between grid steps. Here N is about 2,000 rows, so
//     row tiles alone would leave most of the 132 SMs idle: the grid is
//     (vocabulary split, row tile of 128). A block walks its split's 128-column
//     tiles, computes each 128 x 128 logits tile in registers (8 x 8 per
//     thread, operands staged through shared memory as float32), folds it into
//     the running (m, s, picked) of its rows, and writes one partial triple
//     per row; a second small kernel combines the splits with the same rescale.
//   backward: a [rows, D] float32 accumulator does not fit a block, and
//     atomics per vocab tile would be far too many. The vocabulary is walked
//     in chunks (a few thousand columns): per chunk one kernel recomputes the
//     logits tiles and writes coef into an [N, chunk] scratch in W's type
//     (small enough to stay in the 50 MB L2), and a second kernel adds
//     coef W_chunk^T into the 128 x 128 tile of dh that each block owns
//     (float32, read-modify-write by one owner: no atomics, deterministic).
// All three products share one 128 x 128 output tile per block and one
// epilogue layout (8 x 8 values per thread). In float32 the tile is a
// shared-memory loop of depth 16 on the CUDA cores with explicit fmaf. In
// bfloat16 it runs on the tensor cores through plain warp-level wmma tiles
// (16 x 16 x 16, float32 accumulators, eight warps of 32 x 64 each, operands
// staged through shared memory with the next step's global loads in flight),
// and the accumulators pass through shared memory to reach the same epilogue.
// wgmma and TMA staging are a later step. Held to a tolerance against the
// plain PyTorch version, not to bits (sum order and expf differ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TM = 128;       // rows of an output tile
constexpr int TN = 128;       // columns of an output tile
constexpr int TK = 16;        // contraction depth per staged step
constexpr int LDS = TM + 4;   // row stride of the staged [TK][128] operands
constexpr float kNeg = -1e30f;
// the tensor-core tile (bfloat16)
constexpr int WK = 32;        // contraction depth per staged step
constexpr int LDT = WK + 8;   // row stride (elements) of a staged [128][WK] operand
constexpr int LDB = TN + 8;   // row stride (elements) of the staged K-major [WK][128] operand
constexpr int LDC = TN + 4;   // row stride (floats) of the accumulator tile in shared memory
constexpr int kSmemScalar = 2 * TK * LDS * (int)sizeof(float);
constexpr int kSmemTensor = TM * LDC * (int)sizeof(float);  // the operands alias it

template <typename T>
constexpr int smem_bytes() { return sizeof(T) == 2 ? kSmemTensor : kSmemScalar; }

// 8 consecutive float32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// row / column of accumulator index i (0..7) for thread coordinate t (0..15):
// two groups of four neighbours, 64 apart
__device__ __forceinline__ int tile_index(int t, int i) { return (i < 4 ? 0 : 64) + 4 * t + (i & 3); }

// acc[i][j] = sum_k A[row_i][k] * Bop[k][col_j] over K (a multiple of TK), for
// one 128 x 128 tile. A is row-major with the contraction contiguous (lda
// elements between rows); rows at or beyond rows_valid read as zero.
// B_KMAJOR: B is [K][cols] row-major (ldb between contraction steps);
// otherwise B is [cols][K] row-major (ldb between columns). As, Bs: float32
// [TK][LDS] each.
template <typename T, bool B_KMAJOR>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ A, size_t lda, int rows_valid,
                                          const T* __restrict__ B, size_t ldb, int K,
                                          float (&acc)[8][8], float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int ar = tid / 2;        // loader: one of 128 rows
  const int ak = (tid % 2) * 8;  // loader: 8 of the 16 contraction steps
  const int bk = tid / 16;       // K-major loader: contraction step
  const int bc = (tid % 16) * 8; // K-major loader: 8 of the 128 columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += TK) {
    float a8[8], b8[8];
    if (ar < rows_valid) {
      load8(A + (size_t)ar * lda + k0 + ak, a8);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) a8[i] = 0.0f;
    }
    if (B_KMAJOR) {
      load8(B + (size_t)(k0 + bk) * ldb + bc, b8);
    } else {
      load8(B + (size_t)ar * ldb + k0 + ak, b8);
    }
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int i = 0; i < 8; ++i) As[(ak + i) * LDS + ar] = a8[i];
    if (B_KMAJOR) {
      *reinterpret_cast<float4*>(Bs + bk * LDS + bc) = make_float4(b8[0], b8[1], b8[2], b8[3]);
      *reinterpret_cast<float4*>(Bs + bk * LDS + bc + 4) = make_float4(b8[4], b8[5], b8[6], b8[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[(ak + i) * LDS + ar] = b8[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDS + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LDS + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * LDS + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// The same tile on the tensor cores, bfloat16 operands: see gemm_tile for the
// arguments (K a multiple of WK). Warp w owns rows 32 (w / 2) and columns
// 64 (w % 2) of the tile as 2 x 4 wmma accumulators; at the end they are
// written to shared memory (over the staged operands) and read back in
// gemm_tile's 8 x 8 per-thread layout.
template <bool B_KMAJOR>
__device__ __forceinline__ void gemm_tile_tc(const __nv_bfloat16* __restrict__ A, size_t lda,
                                             int rows_valid, const __nv_bfloat16* __restrict__ B,
                                             size_t ldb, int K, float (&acc)[8][8],
                                             unsigned char* smem) {
  using namespace nvcuda;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [128][LDT]
  __nv_bfloat16* Bs = As + TM * LDT;  // K-major [WK][LDB], else [128][LDT]
  float* Cs = reinterpret_cast<float*>(smem);  // [128][LDC]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(c[m][n], 0.0f);
  }
  // each thread stages two 16-byte pieces of either operand per step
  uint4 ra[2], rb[2];
  auto load_regs = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece / 4;
      const int kc = (piece % 4) * 8;
      ra[i] = r < rows_valid ? *reinterpret_cast<const uint4*>(A + (size_t)r * lda + k0 + kc)
                             : make_uint4(0u, 0u, 0u, 0u);
      if (B_KMAJOR) {
        rb[i] = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + piece / 16) * ldb + (piece % 16) * 8);
      } else {
        rb[i] = *reinterpret_cast<const uint4*>(B + (size_t)r * ldb + k0 + kc);
      }
    }
  };
  load_regs(0);
  for (int k0 = 0; k0 < K; k0 += WK) {
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece / 4;
      const int kc = (piece % 4) * 8;
      *reinterpret_cast<uint4*>(As + r * LDT + kc) = ra[i];
      if (B_KMAJOR) {
        *reinterpret_cast<uint4*>(Bs + (piece / 16) * LDB + (piece % 16) * 8) = rb[i];
      } else {
        *reinterpret_cast<uint4*>(Bs + r * LDT + kc) = rb[i];
      }
    }
    __syncthreads();
    if (k0 + WK < K) load_regs(k0 + WK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) wmma::load_matrix_sync(a[m], As + (wm * 32 + m * 16) * LDT + kk, LDT);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (B_KMAJOR) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + kk * LDB + wn * 64 + n * 16, LDB);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(c[m][n], a[m], b, c[m][n]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Bs + (wn * 64 + n * 16) * LDT + kk, LDT);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(c[m][n], a[m], b, c[m][n]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the staged operands
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::store_matrix_sync(Cs + (wm * 32 + m * 16) * LDC + wn * 64 + n * 16, c[m][n], LDC,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* row = Cs + tile_index(ty, i) * LDC;
    const float4 lo = *reinterpret_cast<const float4*>(row + 4 * tx);
    const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * tx);
    acc[i][0] = lo.x; acc[i][1] = lo.y; acc[i][2] = lo.z; acc[i][3] = lo.w;
    acc[i][4] = hi.x; acc[i][5] = hi.y; acc[i][6] = hi.z; acc[i][7] = hi.w;
  }
  // the caller's next tile starts with a __syncthreads() before it stages operands
}

// one output tile by the route of the operands' type
__device__ __forceinline__ void tile_product_kmajor(const float* A, size_t lda, int rows_valid, const float* B,
                                                    size_t ldb, int K, float (&acc)[8][8], unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);
  gemm_tile<float, true>(A, lda, rows_valid, B, ldb, K, acc, As, As + TK * LDS);
}
__device__ __forceinline__ void tile_product_kmajor(const __nv_bfloat16* A, size_t lda, int rows_valid,
                                                    const __nv_bfloat16* B, size_t ldb, int K,
                                                    float (&acc)[8][8], unsigned char* smem) {
  gemm_tile_tc<true>(A, lda, rows_valid, B, ldb, K, acc, smem);
}
__device__ __forceinline__ void tile_product_nt(const float* A, size_t lda, int rows_valid, const float* B,
                                                size_t ldb, int K, float (&acc)[8][8], unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);
  gemm_tile<float, false>(A, lda, rows_valid, B, ldb, K, acc, As, As + TK * LDS);
}
__device__ __forceinline__ void tile_product_nt(const __nv_bfloat16* A, size_t lda, int rows_valid,
                                                const __nv_bfloat16* B, size_t ldb, int K,
                                                float (&acc)[8][8], unsigned char* smem) {
  gemm_tile_tc<false>(A, lda, rows_valid, B, ldb, K, acc, smem);
}

// reductions over the 16 threads (one half warp) that share a tile row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// forward: grid (splits, row tiles). partials: float32 [3][splits][N] = m, s, picked.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ tgt,
                    float* __restrict__ partials, int N, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int r0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int tiles = V / TN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles, t_begin + tiles_per_split);

  float m[8], s[8], picked[8];
  int target[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    s[i] = 0.0f;
    picked[i] = 0.0f;
    const int row = r0 + tile_index(ty, i);
    target[i] = row < N ? tgt[row] : -1;
  }
  float acc[8][8];
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * TN;
    tile_product_kmajor(h + (size_t)r0 * D, D, N - r0, w + c0, V, D, acc, smem);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, acc[i][j]);
      tmax = row_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        part += expf(acc[i][j] - m_new);
        if (c0 + tile_index(tx, j) == target[i]) picked[i] += acc[i][j];
      }
      part = row_sum(part);
      s[i] = s[i] * expf(m[i] - m_new) + part;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p = row_sum(picked[i]);
    const int row = r0 + tile_index(ty, i);
    if (tx == 0 && row < N) {
      partials[((size_t)0 * splits + split) * N + row] = m[i];
      partials[((size_t)1 * splits + split) * N + row] = s[i];
      partials[((size_t)2 * splits + split) * N + row] = p;
    }
  }
}

// forward, second pass: combine the splits' (m, s, picked) per row
__global__ void fused_ce_combine_kernel(const float* __restrict__ partials, float* __restrict__ nll,
                                        float* __restrict__ lse, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = kNeg, s = 0.0f, p = 0.0f;
  for (int k = 0; k < splits; ++k) {
    const float mk = partials[((size_t)0 * splits + k) * N + row];
    const float sk = partials[((size_t)1 * splits + k) * N + row];
    const float m_new = fmaxf(m, mk);
    s = s * expf(m - m_new) + sk * expf(mk - m_new);
    m = m_new;
    p += partials[((size_t)2 * splits + k) * N + row];
  }
  const float e = m + logf(s);
  lse[row] = e;
  nll[row] = e - p;
}

// backward, first kernel of a chunk: grid (column tiles of the chunk, row
// tiles). coef [N][ldc] in W's type, columns v0 .. v0 + chunk width.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_coef_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ tgt,
                     const float* __restrict__ lse, const float* __restrict__ g,
                     T* __restrict__ coef, int N, int D, int V, int v0, int ldc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = v0 + blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float acc[8][8];
  tile_product_kmajor(h + (size_t)r0 * D, D, N - r0, w + c0, V, D, acc, smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + tile_index(ty, i);
    if (row >= N) continue;
    const float e = lse[row];
    const float gr = g[row];
    const int target = tgt[row];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float out[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = half * 4 + jj;
        const float onehot = c0 + tile_index(tx, j) == target ? 1.0f : 0.0f;
        out[jj] = (expf(acc[i][j] - e) - onehot) * gr;
      }
      store4(coef + (size_t)row * ldc + (c0 - v0) + tile_index(tx, half * 4), out);
    }
  }
}

// backward, second kernel of a chunk: grid (D / 128, row tiles).
// dh[rows, d tile] (+)= coef[rows, chunk] W[d tile, v0 .. v0 + width]^T
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_dh_kernel(const T* __restrict__ coef, const T* __restrict__ w, float* __restrict__ dh, int N,
                   int D, int V, int v0, int width, int ldc, int first) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float acc[8][8];
  tile_product_nt(coef + (size_t)r0 * ldc, ldc, N - r0, w + (size_t)d0 * V + v0, V, width, acc, smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + tile_index(ty, i);
    if (row >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* p = dh + (size_t)row * D + d0 + tile_index(tx, half * 4);
      float4 r = make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                             acc[i][half * 4 + 3]);
      if (!first) {
        const float4 old = *reinterpret_cast<const float4*>(p);
        r.x += old.x; r.y += old.y; r.z += old.z; r.w += old.w;
      }
      *reinterpret_cast<float4*>(p) = r;
    }
  }
}

template <typename T>
int fwd_typed(const void* h, const void* w, const int* tgt, float* nll, float* lse, float* partials,
              int N, int D, int V, int splits, int tiles_per_split, cudaStream_t stream) {
  const int row_tiles = (N + TM - 1) / TM;
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem_bytes<T>());
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_fwd_kernel<T><<<dim3(splits, row_tiles), kThreads, smem_bytes<T>(), stream>>>(
      (const T*)h, (const T*)w, tgt, partials, N, D, V, tiles_per_split);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partials, nll, lse, N, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* h, const void* w, const int* tgt, const float* lse, const float* g,
              void* coef, float* dh, int N, int D, int V, int chunk, cudaStream_t stream) {
  const int row_tiles = (N + TM - 1) / TM;
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_coef_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem_bytes<T>());
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(fused_ce_dh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (rc != cudaSuccess) return (int)rc;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int width = min(chunk, V - v0);
    fused_ce_coef_kernel<T><<<dim3(width / TN, row_tiles), kThreads, smem_bytes<T>(), stream>>>(
        (const T*)h, (const T*)w, tgt, lse, g, (T*)coef, N, D, V, v0, chunk);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    fused_ce_dh_kernel<T><<<dim3(D / TN, row_tiles), kThreads, smem_bytes<T>(), stream>>>(
        (const T*)coef, (const T*)w, dh, N, D, V, v0, width, chunk, v0 == 0 ? 1 : 0);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaSuccess;
}

bool shape_ok(int N, int D, int V) {
  return N > 0 && N <= 65535 * TM && D > 0 && D % TN == 0 && V > 0 && V % TN == 0;
}

}  // namespace

// h [N, D], w [D, V] (dtype 0 = float32, 1 = bfloat16), tgt int32 [N];
// nll, lse float32 [N]; partials float32 scratch [3, splits, N]; the
// vocabulary's V / 128 column tiles are dealt tiles_per_split to a split.
extern "C" int fused_ce_fwd_launch(const void* h, const void* w, const void* tgt, void* nll, void* lse,
                                   void* partials, int N, int D, int V, int splits,
                                   int tiles_per_split, int dtype, void* stream) {
  if (!shape_ok(N, D, V) || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < V / TN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return fwd_typed<float>(h, w, (const int*)tgt, (float*)nll, (float*)lse, (float*)partials, N, D, V,
                            splits, tiles_per_split, s);
  }
  if (dtype == 1) {
    return fwd_typed<__nv_bfloat16>(h, w, (const int*)tgt, (float*)nll, (float*)lse, (float*)partials,
                                    N, D, V, splits, tiles_per_split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// lse from the forward, g float32 [N]; coef: scratch [N, chunk] in w's type
// (chunk a multiple of 128); dh float32 [N, D], fully written.
extern "C" int fused_ce_bwd_launch(const void* h, const void* w, const void* tgt, const void* lse,
                                   const void* g, void* coef, void* dh, int N, int D, int V, int chunk,
                                   int dtype, void* stream) {
  if (!shape_ok(N, D, V) || chunk < TN || chunk % TN != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return bwd_typed<float>(h, w, (const int*)tgt, (const float*)lse, (const float*)g, coef,
                            (float*)dh, N, D, V, chunk, s);
  }
  if (dtype == 1) {
    return bwd_typed<__nv_bfloat16>(h, w, (const int*)tgt, (const float*)lse, (const float*)g, coef,
                                    (float*)dh, N, D, V, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}
