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
// W is read a few times, the logits never leave the chip). The TPU grid
// (N / 1024, V / 512) sweeps the vocabulary in order with scratch carried
// between grid steps; here N is about 2,000 rows, so row tiles alone would
// leave most of the 132 SMs idle. The plan, in both types:
//   forward: grid (vocabulary split, row tile of 128). A block walks its
//     split's column tiles, folds each logits tile into the running
//     (m, s, picked) of its rows and writes one partial triple per row; a
//     second small kernel combines the splits with the same rescale.
//     ops/fused_ce.py:split_plan sizes the splits so that the grid is a whole
//     number of waves where the shapes allow it.
//   backward: a [rows, D] float32 accumulator does not fit a block, and
//     atomics per vocab tile would be far too many. The vocabulary is walked
//     in chunks (ops/fused_ce.py:chunk_plan): per chunk one kernel recomputes
//     the logits tiles and writes coef into an [N, chunk] scratch in W's type
//     (small enough to stay in the 50 MB L2), and a second kernel adds
//     coef W_chunk^T into the tile of dh that each block owns (float32,
//     read-modify-write by one owner: no atomics, the same bits every run).
//
// bfloat16 (the training path): every product is wgmma.mma_async
// m64nNk16 bf16 x bf16 -> float32 from shared memory, operands staged by TMA
// (cp.async.bulk.tensor, 128-byte swizzle) through a 4-stage ring with a full
// and an empty mbarrier per stage. A block is three warpgroups: warpgroup 0
// is the producer (one thread issues the copies; setmaxnreg gives its
// registers to the others), warpgroups 1 and 2 each multiply a 64-row half
// of the 128-row output tile. A stage is 64 deep: A = 128 rows x 128 bytes,
// B = N columns x 128 bytes. One mainloop serves the three products:
//   forward and coef: A = h (K-major), B = W[k0:k0+64, c0:c0+256], contiguous
//     along the output columns (MN-major, wgmma's transpose-B), loaded as four
//     64 x 64 boxes; output tiles 128 x 256, row tiles the fastest block
//     index so that the blocks in flight share their W tiles (W then passes
//     through L2 about once); the coef kernel is persistent, one block per SM
//     walking the chunk's tiles, so a block's next loads overlap its
//     epilogue. The epilogues read wgmma's
//     accumulator layout in place: a row's 256 columns sit in one quad of
//     lanes, so each thread keeps a running (max, sum) of its own 64 columns
//     per row in the exp2 domain and the quad merges them once at the end;
//     nothing goes through shared memory.
//   dh: A = coef (K-major), B = W[d0:d0+N, v0:v0+w] rows, contiguous in the
//     contraction (K-major, plain TN); output tiles 128 x 224 where D allows
//     (the 7B and bench widths: ops/fused_ce.py:dh_cols fills the waves),
//     128 x 128 elsewhere.
// The ragged last row tile is zero-filled by TMA on load; the epilogues guard
// rows >= N. TMA descriptors are encoded per call on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint) and passed
// by value as __grid_constant__ parameters, so a CUDA-graph capture keeps
// them. One block per SM (197,696 bytes of shared memory, 168 registers).
//
// What bounds the bfloat16 kernels on the card (H100 SXM at 700 W, PERF.md
// section 6, tools/fused_ce_timing.py): the wgmma mainloop. At the 7B shape
// the forward runs at about 82 % of the bf16 peak and its mainloop alone at
// 86 %, the epilogue (while the tensor cores wait) taking the rest; the
// backward at about 70 %: dh at 75 %, the coef kernel at 70 %, its mainloop
// slower than the forward's. At D 896 the mainloop of a tile is short and
// the epilogues weigh more (15 % of the forward, 45 % of the coef kernel).
//
// float32 (held to 1e-5 of the plain version; tensor cores would take float32
// through TF32): 128 x 128 output tiles, a shared-memory loop of depth 16 on
// the CUDA cores with explicit fmaf, 8 x 8 values per thread.
//
// Held to a tolerance against the plain PyTorch version, not to bits (sum
// order and exp differ).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int TM = 128;       // rows of an output tile
constexpr int TN = 128;       // columns of an output tile
constexpr int TK = 16;        // contraction depth per staged step
constexpr int LDS = TM + 4;   // row stride of the staged [TK][128] operands
constexpr int kSmemScalar = 2 * TK * LDS * (int)sizeof(float);

// 8 consecutive float32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// row / column of accumulator index i (0..7) for thread coordinate t (0..15):
// two groups of four neighbours, 64 apart
__device__ __forceinline__ int tile_index(int t, int i) { return (i < 4 ? 0 : 64) + 4 * t + (i & 3); }

// acc[i][j] = sum_k A[row_i][k] * Bop[k][col_j] over K (a multiple of TK), for
// one 128 x 128 tile. A is row-major with the contraction contiguous (lda
// elements between rows); rows at or beyond rows_valid read as zero.
// B_KMAJOR: B is [K][cols] row-major (ldb between contraction steps);
// otherwise B is [cols][K] row-major (ldb between columns). smem: float32
// [TK][LDS] for each operand.
template <bool B_KMAJOR>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A, size_t lda, int rows_valid,
                                          const float* __restrict__ B, size_t ldb, int K,
                                          float (&acc)[8][8], unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + TK * LDS;
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
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w, const int* __restrict__ tgt,
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
    gemm_tile<true>(h + (size_t)r0 * D, D, N - r0, w + c0, V, D, acc, smem);
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

// forward, second pass (both types): combine the splits' (m, s, picked) per row
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
// tiles). coef [N][ldc] float32, columns v0 .. v0 + chunk width.
__global__ void __launch_bounds__(kThreads)
fused_ce_coef_kernel(const float* __restrict__ h, const float* __restrict__ w, const int* __restrict__ tgt,
                     const float* __restrict__ lse, const float* __restrict__ g,
                     float* __restrict__ coef, int N, int D, int V, int v0, int ldc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = v0 + blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float acc[8][8];
  gemm_tile<true>(h + (size_t)r0 * D, D, N - r0, w + c0, V, D, acc, smem);
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
      *reinterpret_cast<float4*>(coef + (size_t)row * ldc + (c0 - v0) + tile_index(tx, half * 4)) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

// backward, second kernel of a chunk: grid (D / 128, row tiles).
// dh[rows, d tile] (+)= coef[rows, chunk] W[d tile, v0 .. v0 + width]^T
__global__ void __launch_bounds__(kThreads)
fused_ce_dh_kernel(const float* __restrict__ coef, const float* __restrict__ w, float* __restrict__ dh, int N,
                   int D, int V, int v0, int width, int ldc, int first) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float acc[8][8];
  gemm_tile<false>(coef + (size_t)r0 * ldc, ldc, N - r0, w + (size_t)d0 * V + v0, V, width, acc, smem);
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kThreadsTC = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int BM = 128;          // rows of an output tile, 64 per consumer warpgroup
constexpr int BK = 64;           // contraction per stage: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 4;
constexpr int VT = 256;          // vocabulary columns of a forward / coef tile
constexpr int A_BYTES = BM * BK * 2;
constexpr int HALF_BYTES = 64 * BK * 2;  // one consumer's 64 rows of A; one 64-column box of B
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int stage_bytes(int cols) { return A_BYTES + cols * BK * 2; }
// 1024 bytes to align the ring (128-byte swizzle atoms), the ring, its barriers
__host__ __device__ constexpr int tc_smem_bytes(int cols) { return 1024 + STAGES * stage_bytes(cols) + 2 * STAGES * 8; }

// d (+)= A B for one m64nNk16 step; accumulate = 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n224(float (&d)[112], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, %115;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

template <int COLS, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[COLS / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(COLS == 256 || COLS == 224 || COLS == 128, "wgmma width");
  if constexpr (COLS == 256) {
    wgmma_n256<TRANS_B>(d, da, db, accumulate);
  } else if constexpr (COLS == 224) {
    wgmma_n224<TRANS_B>(d, da, db, accumulate);
  } else {
    wgmma_n128<TRANS_B>(d, da, db, accumulate);
  }
}

// The stage ring: STAGES buffers of [A 128 x 64 | B COLS x 64] bf16, a full
// barrier (one arrival: the producer's expect_tx, plus the copies' bytes) and
// an empty barrier (one arrival per consumer warpgroup) per stage.
struct Ring {
  uint32_t base;   // stage 0, 1024-byte aligned
  uint32_t full;   // STAGES barriers of 8 bytes
  uint32_t empty;  // STAGES barriers of 8 bytes
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

template <int COLS>
__device__ __forceinline__ Ring ring_setup(unsigned char* smem) {
  Ring r;
  r.base = (smem_u32(smem) + 1023u) & ~1023u;
  r.full = r.base + STAGES * stage_bytes(COLS);
  r.empty = r.full + STAGES * 8;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// Producer (one thread): KT stages of one output tile. A: rows
// [a_row, a_row + 128) of tensor map ta, contraction from a_k. B: if B_MN,
// rows a contraction step each (from b_k) and COLS contiguous columns from
// b_n, as COLS / 64 boxes of 64 x 64; else COLS rows from b_n with the
// contraction contiguous (from b_k), one box.
template <int COLS, bool B_MN>
__device__ __forceinline__ void produce_tile(Ring& r, const CUtensorMap* ta, int a_k, int a_row, const CUtensorMap* tb,
                                             int b_k, int b_n, int KT) {
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t full = r.full + 8 * r.stage;
    mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
    mbar_expect_tx(full, stage_bytes(COLS));
    const uint32_t a = r.base + r.stage * stage_bytes(COLS);
    tma_load_2d(a, ta, a_k + kt * BK, a_row, full);
    if (B_MN) {
#pragma unroll
      for (int q = 0; q < COLS / 64; ++q) tma_load_2d(a + A_BYTES + q * HALF_BYTES, tb, b_n + 64 * q, b_k + kt * BK, full);
    } else {
      tma_load_2d(a + A_BYTES, tb, b_k + kt * BK, b_n, full);
    }
    r.advance();
  }
}

// Consumer warpgroup `half` (rows 64 half .. 64 half + 63 of the tile): acc =
// A B over KT stages. One wgmma group stays in flight: a stage is released
// once the group after it has been issued and its own has completed.
template <int COLS, int TRANS_B>
__device__ __forceinline__ void consume_tile(Ring& r, float (&acc)[COLS / 2], int half, int KT) {
  const bool signals = threadIdx.x % 128 == 0;
  int prev = -1;
  pin(acc);
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t a = r.base + r.stage * stage_bytes(COLS) + half * HALF_BYTES;
    const uint32_t b = r.base + r.stage * stage_bytes(COLS) + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = smem_desc(a + 32 * k, 16, 1024);
      const uint64_t db = TRANS_B ? smem_desc(b + k * 16 * 128, HALF_BYTES, 1024) : smem_desc(b + 32 * k, 16, 1024);
      wgmma<COLS, TRANS_B>(acc, da, db, (kt | k) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && signals) mbar_arrive(r.empty + 8 * prev);
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  pin(acc);
  if (signals) mbar_arrive(r.empty + 8 * prev);
}

// A consumer thread's place in wgmma's accumulator layout: acc[4 j + 2 h + e]
// is row row0 + 8 h, column 8 j + colq + e of its warpgroup's 64-row half.
struct Slot {
  int row0;
  int colq;
  __device__ __forceinline__ Slot(int r0, int half) {
    const int t = threadIdx.x % 128;
    row0 = r0 + 64 * half + 16 * (t / 32) + (t % 32) / 4;
    colq = 2 * (t % 4);
  }
};

// forward: grid (row tiles, splits), 256-column tiles: the blocks of one
// split are neighbours, so a wave's blocks read each W tile together and W
// passes through L2 about once. partials: float32 [3][splits][N] = m, s,
// picked (m in natural-log units).
__global__ void __launch_bounds__(kThreadsTC, 1)
fused_ce_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                         const int* __restrict__ tgt, float* __restrict__ partials, int N, int D, int V,
                         int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];  // the ring aligns itself to 1024
  Ring ring = ring_setup<VT>(smem);
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int r0 = blockIdx.x * BM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(V / VT, t_begin + tiles_per_split);
  const int KT = D / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = t_begin; t < t_end; ++t) produce_tile<VT, true>(ring, &tm_h, 0, r0, &tm_w, 0, t * VT, KT);
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int half = wg - 1;
  const Slot at(r0, half);
  float m[2] = {kNeg, kNeg}, s[2] = {0.0f, 0.0f}, picked[2] = {0.0f, 0.0f};
  int target[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = at.row0 + 8 * h;
    target[h] = row < N ? tgt[row] : -1;
  }
  float acc[VT / 2];
#pragma unroll
  for (int i = 0; i < VT / 2; ++i) acc[i] = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    consume_tile<VT, 1>(ring, acc, half, KT);
    const int c0 = t * VT;
    // each thread folds its own 64 columns of each row (exp2 domain); the
    // quad merges at the end
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < VT / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      const float m_new = fmaxf(m[h], mx * kLog2e);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < VT / 8; ++j) {
        part += exp2f(fmaf(acc[4 * j + 2 * h], kLog2e, -m_new));
        part += exp2f(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -m_new));
      }
      s[h] = s[h] * exp2f(m[h] - m_new) + part;
      m[h] = m_new;
      const int rel = target[h] - c0 - at.colq;
      if (rel >= 0 && rel < VT && (rel & 7) < 2) {
#pragma unroll
        for (int j = 0; j < VT / 8; ++j) {
          if (j == (rel >> 3)) picked[h] += (rel & 1) ? acc[4 * j + 2 * h + 1] : acc[4 * j + 2 * h];
        }
      }
    }
  }
  const bool writer = threadIdx.x % 4 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mq = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float sq = s[h] * exp2f(m[h] - mq);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    float p = picked[h];
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    const int row = at.row0 + 8 * h;
    if (writer && row < N) {
      partials[((size_t)0 * splits + split) * N + row] = mq * kLn2;
      partials[((size_t)1 * splits + split) * N + row] = sq;
      partials[((size_t)2 * splits + split) * N + row] = p;
    }
  }
}

// backward, first kernel of a chunk: persistent, one block per SM walks the
// chunk's tiles i = blockIdx.x, + gridDim.x, ... with the row tile fastest
// (row i % row_tiles, 256-column tile i / row_tiles), so that the producer
// loads a block's next tile while its consumers finish the last one, and the
// blocks of a round share their W tiles. coef [N][ldc] bf16, columns
// v0 .. v0 + width.
__global__ void __launch_bounds__(kThreadsTC, 1)
fused_ce_coef_bf16_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                          const int* __restrict__ tgt, const float* __restrict__ lse, const float* __restrict__ g,
                          __nv_bfloat16* __restrict__ coef, int N, int D, int v0, int width, int ldc) {
  extern __shared__ __align__(128) unsigned char smem[];  // the ring aligns itself to 1024
  Ring ring = ring_setup<VT>(smem);
  const int row_tiles = (N + BM - 1) / BM;
  const int tiles = row_tiles * (width / VT);
  const int KT = D / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        produce_tile<VT, true>(ring, &tm_h, 0, (i % row_tiles) * BM, &tm_w, 0, v0 + (i / row_tiles) * VT, KT);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int half = wg - 1;
  float acc[VT / 2];
#pragma unroll
  for (int i = 0; i < VT / 2; ++i) acc[i] = 0.0f;
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int c0 = v0 + (i / row_tiles) * VT;
    const Slot at((i % row_tiles) * BM, half);
    consume_tile<VT, 1>(ring, acc, half, KT);
    // coef = (p - onehot) g straight from the accumulators, rounded to bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = at.row0 + 8 * h;
      if (row >= N) continue;
      const float e2 = lse[row] * kLog2e;
      const float gr = g[row];
      const int target = tgt[row];
      __nv_bfloat16* out = coef + (size_t)row * ldc + (c0 - v0) + at.colq;
#pragma unroll
      for (int j = 0; j < VT / 8; ++j) {
        const int col = c0 + 8 * j + at.colq;
        float p0 = exp2f(fmaf(acc[4 * j + 2 * h], kLog2e, -e2));
        float p1 = exp2f(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -e2));
        if (col == target) p0 -= 1.0f;
        if (col + 1 == target) p1 -= 1.0f;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(p0 * gr, p1 * gr);
      }
    }
  }
}

// backward, second kernel of a chunk: grid (row tiles, D / COLS): a wave
// covers every row tile of a few dh column tiles, so each slice of the W
// chunk is read by all row tiles together and the coef scratch (in L2 from
// the first kernel) is what is read again.
// dh[rows, d0 .. d0 + COLS) (+)= coef[rows, chunk] W[d0 .. d0 + COLS, v0 .. v0 + width]^T
template <int COLS>
__global__ void __launch_bounds__(kThreadsTC, 1)
fused_ce_dh_bf16_kernel(const __grid_constant__ CUtensorMap tm_coef, const __grid_constant__ CUtensorMap tm_wk,
                        float* __restrict__ dh, int N, int D, int v0, int width, int first) {
  extern __shared__ __align__(128) unsigned char smem[];  // the ring aligns itself to 1024
  Ring ring = ring_setup<COLS>(smem);
  const int d0 = blockIdx.y * COLS;
  const int r0 = blockIdx.x * BM;
  const int KT = width / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce_tile<COLS, false>(ring, &tm_coef, 0, r0, &tm_wk, v0, d0, KT);
    return;
  }
  setmaxnreg_inc<232>();
  const int half = wg - 1;
  const Slot at(r0, half);
  float acc[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.0f;
  consume_tile<COLS, 0>(ring, acc, half, KT);
  // dh (+)= acc: the tile's one owner writes it on the first chunk, adds after
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = at.row0 + 8 * h;
    if (row >= N) continue;
    float* out = dh + (size_t)row * D + d0 + at.colq;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      float2 r = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (!first) {
        const float2 old = *reinterpret_cast<const float2*>(out + 8 * j);
        r.x += old.x;
        r.y += old.y;
      }
      *reinterpret_cast<float2*>(out + 8 * j) = r;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int fwd_f32(const float* h, const float* w, const int* tgt, float* nll, float* lse, float* partials, int N, int D,
            int V, int splits, int tiles_per_split, cudaStream_t stream) {
  const int row_tiles = (N + TM - 1) / TM;
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemScalar);
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_fwd_kernel<<<dim3(splits, row_tiles), kThreads, kSmemScalar, stream>>>(h, w, tgt, partials, N, D, V,
                                                                                 tiles_per_split);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partials, nll, lse, N, splits);
  return (int)cudaGetLastError();
}

int fwd_bf16(const void* h, const void* w, const int* tgt, float* nll, float* lse, float* partials, int N, int D,
             int V, int splits, int tiles_per_split, cudaStream_t stream) {
  CUtensorMap tm_h, tm_w;
  int err = tensor_map(&tm_h, h, D, N, (uint64_t)D * 2, BK, BM);
  if (err == 0) err = tensor_map(&tm_w, w, V, D, (uint64_t)V * 2, 64, BK);
  if (err != 0) return err;
  const int bytes = tc_smem_bytes(VT);
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_fwd_bf16_kernel<<<dim3((N + BM - 1) / BM, splits), kThreadsTC, bytes, stream>>>(tm_h, tm_w, tgt, partials,
                                                                                         N, D, V, tiles_per_split);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partials, nll, lse, N, splits);
  return (int)cudaGetLastError();
}

int bwd_f32(const float* h, const float* w, const int* tgt, const float* lse, const float* g, float* coef, float* dh,
            int N, int D, int V, int chunk, cudaStream_t stream) {
  const int row_tiles = (N + TM - 1) / TM;
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_coef_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemScalar);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(fused_ce_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemScalar);
  if (rc != cudaSuccess) return (int)rc;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int width = min(chunk, V - v0);
    fused_ce_coef_kernel<<<dim3(width / TN, row_tiles), kThreads, kSmemScalar, stream>>>(h, w, tgt, lse, g, coef, N,
                                                                                        D, V, v0, chunk);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    fused_ce_dh_kernel<<<dim3(D / TN, row_tiles), kThreads, kSmemScalar, stream>>>(coef, w, dh, N, D, V, v0, width,
                                                                                  chunk, v0 == 0 ? 1 : 0);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaSuccess;
}

template <int COLS>
int dh_bf16(const CUtensorMap& tm_coef, const CUtensorMap& tm_wk, float* dh, int N, int D, int v0, int width, int first,
            cudaStream_t stream) {
  const int bytes = tc_smem_bytes(COLS);
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_dh_bf16_kernel<COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  fused_ce_dh_bf16_kernel<COLS><<<dim3((N + BM - 1) / BM, D / COLS), kThreadsTC, bytes, stream>>>(tm_coef, tm_wk, dh, N,
                                                                                                 D, v0, width, first);
  return (int)cudaGetLastError();
}

int bwd_bf16(const void* h, const void* w, const int* tgt, const float* lse, const float* g, __nv_bfloat16* coef,
             float* dh, int N, int D, int V, int chunk, int dh_cols, cudaStream_t stream) {
  CUtensorMap tm_h, tm_w, tm_coef, tm_wk;
  int err = tensor_map(&tm_h, h, D, N, (uint64_t)D * 2, BK, BM);
  if (err == 0) err = tensor_map(&tm_w, w, V, D, (uint64_t)V * 2, 64, BK);
  if (err == 0) err = tensor_map(&tm_coef, coef, chunk, N, (uint64_t)chunk * 2, BK, BM);
  if (err == 0) err = tensor_map(&tm_wk, w, V, D, (uint64_t)V * 2, BK, dh_cols);
  if (err != 0) return err;
  const int bytes = tc_smem_bytes(VT);
  cudaError_t rc = cudaFuncSetAttribute(fused_ce_coef_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  int device = 0, sms = 0;
  rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return (int)rc;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int width = min(chunk, V - v0);
    const int tiles = (N + BM - 1) / BM * (width / VT);
    fused_ce_coef_bf16_kernel<<<min(tiles, sms), kThreadsTC, bytes, stream>>>(tm_h, tm_w, tgt, lse, g, coef, N, D, v0,
                                                                              width, chunk);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    const int first = v0 == 0 ? 1 : 0;
    err = dh_cols == 224 ? dh_bf16<224>(tm_coef, tm_wk, dh, N, D, v0, width, first, stream)
                         : dh_bf16<128>(tm_coef, tm_wk, dh, N, D, v0, width, first, stream);
    if (err != 0) return err;
  }
  return (int)cudaSuccess;
}

bool rows_ok(int N) { return N > 0 && N <= 65535 * TM; }

}  // namespace

// Dynamic shared memory a launcher passes: dtype 0 = float32 (any kernel),
// 1 = bfloat16 with `cols` output columns per tile (256: forward and coef;
// 224 or 128: dh). -1 for a width with no kernel.
extern "C" int fused_ce_smem_bytes(int dtype, int cols) {
  if (dtype == 0) return kSmemScalar;
  if (dtype == 1 && (cols == 256 || cols == 224 || cols == 128)) return tc_smem_bytes(cols);
  return -1;
}

// h [N, D], w [D, V] (dtype 0 = float32, 1 = bfloat16), tgt int32 [N];
// nll, lse float32 [N]; partials float32 scratch [3, splits, N]; the
// vocabulary's column tiles (128 wide in float32, 256 in bfloat16) are dealt
// tiles_per_split to a split.
extern "C" int fused_ce_fwd_launch(const void* h, const void* w, const void* tgt, void* nll, void* lse,
                                   void* partials, int N, int D, int V, int splits, int tiles_per_split, int dtype,
                                   void* stream) {
  const int tile = dtype == 1 ? VT : TN;
  if (!rows_ok(N) || D <= 0 || D % 128 != 0 || V <= 0 || V % tile != 0 || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < V / tile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return fwd_f32((const float*)h, (const float*)w, (const int*)tgt, (float*)nll, (float*)lse, (float*)partials, N,
                   D, V, splits, tiles_per_split, s);
  }
  if (dtype == 1) {
    return fwd_bf16(h, w, (const int*)tgt, (float*)nll, (float*)lse, (float*)partials, N, D, V, splits,
                    tiles_per_split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// lse from the forward, g float32 [N]; coef: scratch [N, chunk] in w's type
// (chunk a multiple of the column tile: 128 in float32, 256 in bfloat16); dh
// float32 [N, D], fully written, in tiles of dh_cols columns (128 in float32;
// 224 or 128 dividing D in bfloat16).
extern "C" int fused_ce_bwd_launch(const void* h, const void* w, const void* tgt, const void* lse, const void* g,
                                   void* coef, void* dh, int N, int D, int V, int chunk, int dh_cols, int dtype,
                                   void* stream) {
  const int tile = dtype == 1 ? VT : TN;
  const bool cols_ok = dtype == 1 ? (dh_cols == 224 || dh_cols == 128) : dh_cols == TN;
  if (!rows_ok(N) || D <= 0 || D % 128 != 0 || V <= 0 || V % tile != 0 || chunk < tile || chunk % tile != 0 ||
      !cols_ok || D % dh_cols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return bwd_f32((const float*)h, (const float*)w, (const int*)tgt, (const float*)lse, (const float*)g,
                   (float*)coef, (float*)dh, N, D, V, chunk, s);
  }
  if (dtype == 1) {
    return bwd_bf16(h, w, (const int*)tgt, (const float*)lse, (const float*)g, (__nv_bfloat16*)coef, (float*)dh, N,
                    D, V, chunk, dh_cols, s);
  }
  return (int)cudaErrorInvalidValue;
}
