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
// What bounds it on the card: bytes in principle -- each K and V row 0..pos
// is needed once, against group * hd multiply-adds per element pair -- but at
// the serving shapes (a few hundred rows of 256 or 128 bytes per (b, h)) a
// chain of latencies comes first: the launch, one round of loads, the three
// cluster barriers and the softmax's steps between them (measured by phase
// with tools/decode_attn_phases.py; PERF.md section 6). Two blocks a cluster
// measured faster than one (more rows a block) and than four or eight (a
// cluster barrier costs more with more blocks). Design: one launch; one thread-block cluster of C blocks per (b, h)
// (C from ops/decode_attn.py split_plan: it depends on the shapes only, never
// on pos), launched with cudaLaunchKernelEx and a cluster-dimension
// attribute. Block r of the cluster takes the live rows
// [r*ceil(n/C), min(n, (r+1)*ceil(n/C))), n = pos + 1; a block with no rows
// still takes part in every cluster barrier, with max -inf and sum 0.
//   - Staging: the block's K and V rows go to shared memory in 64-row tiles by
//     16-byte cp.async, through a ring of two slots per tile of its rows (K
//     tiles first, then V tiles), at most kMaxStages: at the serving shapes
//     every tile of the block is requested before the first wait.
//   - q.K (bfloat16): mma.sync m16n8k16 with float32 accumulators; A = the
//     group's query rows padded to 16, B = 16 K rows per warp in their natural
//     (.col) layout, read by ldmatrix. Scaled scores go to shared memory.
//   - Exchange, with the TPU kernel's rounding points, 16 threads a query
//     row: each block stores its row maxima into every block's shared memory
//     (distributed shared memory) before a cluster barrier, so after it each
//     block forms the global max m from local reads; the same again for the
//     sums of exp(s - m), added in rank order; then
//     p = round_to_V_dtype(exp(s - m) / sum).
//   - P.V (bfloat16): mma.sync, A = p from shared memory, B = V through
//     ldmatrix.trans; each warp owns a quarter of the head's columns over all
//     of the block's rows, so no reduction across warps.
//   - Combine: each block stores its float32 partial [group, hd] into rank 0's
//     shared memory; after a third cluster barrier rank 0 adds the C partials
//     in rank order and casts to q's type, 16 bytes of output a thread.
// One launch, no scratch in device memory, no atomics: the result has the
// same bits from call to call.
// float32 (the tests' upcast) keeps the same staging, exchange and combine
// with CUDA-core products (explicit fmaf; the library's --fmad=false only
// stops the compiler from fusing on its own). The kernel is held to a
// tolerance against its plain PyTorch version, not to bits (sum order, expf).
// Comments "// [phase: ...]" mark the lines tools/decode_attn_phases.py cuts
// to time the phases by subtraction; every barrier stays in every cut.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxGroup = 8;
constexpr int kMaxCluster = 8;
constexpr int kTileRows = 64;  // cache rows of a staged tile: 16 per warp
constexpr int kMaxStages = 8;  // ring slots at most
constexpr int kMaxSmem = 232448;

template <typename T, int HD>
struct Geom {
  static constexpr int E = 16 / (int)sizeof(T);          // elements of a 16-byte chunk
  static constexpr int LD = HD + E;                      // shared row stride: rows padded by 16 bytes
  static constexpr int TILE = kTileRows * LD * (int)sizeof(T);
  static constexpr int QTILE = 16 * LD * (int)sizeof(T);  // the group's query rows, padded to 16
};

// A launch's shared memory: ring of `stages` tiles | q tile | scores
// [8][rows_pad] | partials [C][8][HD] (rank 0's are read) | maxima [C][8] |
// sums [C][8]. The ring takes two slots per tile of a block's rows (its K and
// its V tile), at most kMaxStages, fewer where shared memory runs out.
struct LaunchPlan {
  int rows_pad;
  int stages;
  size_t smem;
};
template <typename T, int HD>
LaunchPlan launch_plan(int S, int C) {
  using G = Geom<T, HD>;
  LaunchPlan p;
  const int rows = (S + C - 1) / C;
  p.rows_pad = (rows + kTileRows - 1) / kTileRows * kTileRows;
  const size_t fixed = G::QTILE + (size_t)kMaxGroup * p.rows_pad * 4 + (size_t)C * kMaxGroup * HD * 4 +
                       2 * (size_t)C * kMaxGroup * 4;
  p.stages = min(kMaxStages, max(2, 2 * (p.rows_pad / kTileRows)));
  while (p.stages > 2 && fixed + (size_t)p.stages * G::TILE > (size_t)kMaxSmem) --p.stages;
  p.smem = fixed + (size_t)p.stages * G::TILE;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

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
// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, float32 accumulator d0..d3
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }


// rows [0, valid) of a [rows, HD] slab with row stride `stride` (elements) ->
// shared tile at `dst` (row stride LD); rows at or past `valid` are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const T* src, size_t stride, int rows, int valid) {
  using G = Geom<T, HD>;
  constexpr int CH = HD / G::E;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * G::E;
    const T* g = src + (size_t)min(r, max(valid - 1, 0)) * stride + c;
    cp_async16(dst + (uint32_t)(r * G::LD + c) * (uint32_t)sizeof(T), g, r < valid ? 16 : 0);
  }
}

// q.K of one staged tile: scores[g][key0 + row] = (q_g . K_row) * scale for
// the tile's rows below `valid`.
template <typename T, int HD>
__device__ __forceinline__ void tile_scores(const T* q_s, const T* k_s, float* scores, int rows_pad, int key0,
                                            int valid, int group, float scale) {
  using G = Geom<T, HD>;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if constexpr (sizeof(T) == 2) {
    // warp w: the tile's rows 16w .. 16w + 15 (two n-tiles of 8)
    if (16 * warp >= valid) return;
    const uint32_t a = smem_u32(q_s);
    const uint32_t b = smem_u32(k_s + 16 * warp * G::LD);
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int k = 0; k < HD; k += 16) {
      uint32_t af[4], bfr[4];
      ldsm_x4(af, a + ((lane & 15) * G::LD + k + (lane >> 4) * 8) * 2);
      ldsm_x4(bfr, b + (((lane & 7) + (lane >> 4) * 8) * G::LD + k + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(s[0][0], s[0][1], s[0][2], s[0][3], af, bfr[0], bfr[1]);  // [phase: qk]
      mma_bf16(s[1][0], s[1][1], s[1][2], s[1][3], af, bfr[2], bfr[3]);  // [phase: qk]
    }
    // accumulator element e of n-tile nt: query row lane / 4 (+8 for e >= 2,
    // padding), cache row 16w + 8nt + 2(lane % 4) + e % 2
    const int g = lane >> 2;
    if (g < group) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * warp + 8 * nt + 2 * (lane & 3) + e;
          if (row < valid) scores[g * rows_pad + key0 + row] = s[nt][e] * scale;
        }
      }
    }
  } else {
    // CUDA cores: one (query row, cache row) dot per thread and pass
    for (int i = threadIdx.x; i < kMaxGroup * kTileRows; i += kThreads) {
      const int g = i / kTileRows;
      const int row = i % kTileRows;
      if (g >= group || row >= valid) continue;
      const T* qg = q_s + g * G::LD;
      const T* kr = k_s + row * G::LD;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc = fmaf(to_f32(qg[d]), to_f32(kr[d]), acc);  // [phase: qk]
      scores[g * rows_pad + key0 + row] = acc * scale;
    }
  }
}

// Accumulators of P.V: bfloat16 -- warp w owns columns [w HD/4, (w+1) HD/4),
// NT n-tiles of 8; float32 -- thread i owns (g, d) pairs i, i + 128, ...
template <typename T, int HD>
struct PV {
  static constexpr int NT = HD / (8 * kWarps);
  static constexpr int N = sizeof(T) == 2 ? NT * 4 : kMaxGroup * HD / kThreads;
};

// acc += P[:, key0 .. key0 + 64) V_tile, P = p in shared memory (zeros past
// the block's rows; V rows past them are zeros too)
template <typename T, int HD>
__device__ __forceinline__ void tile_pv(float (&acc)[PV<T, HD>::N], const float* scores, int rows_pad, int key0,
                                        const T* v_s, int group) {
  using G = Geom<T, HD>;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if constexpr (sizeof(T) == 2) {
    constexpr int NT = PV<T, HD>::NT;
    const int g = lane >> 2;
    const int c = 2 * (lane & 3);
    const uint32_t x = smem_u32(v_s + warp * (HD / kWarps));
    const bool row = g < group;
#pragma unroll
    for (int ks = 0; ks < kTileRows / 16; ++ks) {
      // A fragment of p: rows g (and g + 8: padding), keys 16ks + c, +1, +8, +9;
      // rows g >= group are loaded too (never written: the loads wait behind
      // no branch) and replaced by zeros
      const float* pg = scores + g * rows_pad + key0 + 16 * ks + c;
      const float2 lo = *reinterpret_cast<const float2*>(pg);
      const float2 hi = *reinterpret_cast<const float2*>(pg + 8);
      uint32_t a[4] = {row ? pack_bf16(lo.x, lo.y) : 0u, 0u, row ? pack_bf16(hi.x, hi.y) : 0u, 0u};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, x + ((16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * G::LD + n * 8 + (lane >> 4) * 8) * 2);
        float* d = acc + 4 * n;
        mma_bf16(d[0], d[1], d[2], d[3], a, bfr[0], bfr[1]);  // [phase: pv]
        mma_bf16(d[4], d[5], d[6], d[7], a, bfr[2], bfr[3]);  // [phase: pv]
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PV<T, HD>::N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int g = i / HD;
      const int d = i % HD;
      if (g >= group) continue;
      const float* pg = scores + g * rows_pad + key0;
      float a = acc[j];
#pragma unroll 8
      for (int r = 0; r < kTileRows; ++r) a = fmaf(pg[r], to_f32(v_s[r * G::LD + d]), a);  // [phase: pv]
      acc[j] = a;
    }
  }
}

// all but the newest n committed cp.async groups have landed (n < kMaxStages)
static_assert(kMaxStages == 8, "cp_async_wait_n covers n < 8");
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// 16 neighbouring lanes (one query row in the exchange): max and sum
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// E consecutive float32 values -> 16 bytes of T
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                           T* __restrict__ out, int S, int kv_heads, int group, int pos, int rows_pad,
                           int stages, float scale) {
  using G = Geom<T, HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = kv_heads * group;
  const int CC = kv_heads * HD;  // elements of a cache row
  const int n = pos + 1;         // live cache rows
  const int chunk = (n + C - 1) / C;
  const int r0 = min(n, rank * chunk);
  const int R = min(n, r0 + chunk) - r0;  // this block's rows (0 possible)
  const int tiles = (R + kTileRows - 1) / kTileRows;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + (size_t)stages * G::TILE);
  float* scores = reinterpret_cast<float*>(smem + (size_t)stages * G::TILE + G::QTILE);  // [8][rows_pad]
  float* part = scores + kMaxGroup * rows_pad;                                             // [C][8][HD]
  float* red_max = part + C * kMaxGroup * HD;                                              // [C][8]
  float* red_sum = red_max + C * kMaxGroup;                                                // [C][8]
  auto slot = [&](int i) { return ring + (size_t)(i % stages) * (G::TILE / (int)sizeof(T)); };

  const T* kb = kc + ((size_t)b * S + r0) * CC + (size_t)h * HD;
  const T* vb = vc + ((size_t)b * S + r0) * CC + (size_t)h * HD;
  // load i of the block: K tiles 0 .. tiles-1, then V tiles (empty groups past
  // the end); `stages` ring slots, so at the serving shapes every load of the
  // block is in flight before the first wait
  auto issue = [&](int i) {
    if (i < 2 * tiles) {
      const int t = i < tiles ? i : i - tiles;
      load_rows_async<T, HD>(smem_u32(slot(i)), (i < tiles ? kb : vb) + (size_t)t * kTileRows * CC, CC,  // [phase: staging]
                             kTileRows, min(kTileRows, R - t * kTileRows));  // [phase: staging]
    }
    cp_async_commit();
  };
  load_rows_async<T, HD>(smem_u32(q_s), q + ((size_t)b * H + (size_t)h * group) * HD, HD, 16, group);
  for (int i = 0; i < stages - 1; ++i) issue(i);

  // q.K over the block's K tiles
  for (int i = 0; i < tiles; ++i) {
    issue(i + stages - 1);  // into the slot consumed at step i - 1
    cp_async_wait_n(stages - 1);
    __syncthreads();
    tile_scores<T, HD>(q_s, slot(i), scores, rows_pad, i * kTileRows, min(kTileRows, R - i * kTileRows), group,
                       scale);
    __syncthreads();
  }

  // softmax exchange across the cluster: 16 threads a query row, all rows at
  // once; each block pushes its row maxima, then its sums, into every block's
  // shared memory (slot [rank]) before a cluster barrier, so after it every
  // block reads the C values locally
  const int g = tid >> 4;
  const int u = tid & 15;
  const bool live = g < group;
  float* srow = scores + g * rows_pad;
  float m = -CUDART_INF_F;
  if (live) {
    for (int t = u; t < R; t += 16) m = fmaxf(m, srow[t]);  // [phase: exchange]
  }
  m = max16(m);
  if (live && u < C) *cluster.map_shared_rank(red_max + rank * kMaxGroup + g, u) = m;
  cluster.sync();  // every block's row maxima are in every block
  m = -CUDART_INF_F;
  for (int r = 0; r < C; ++r) m = fmaxf(m, red_max[r * kMaxGroup + g]);  // a max is exact: any order
  float sum = 0.0f;
  if (live) {
    for (int t = u; t < R; t += 16) {  // [phase: exchange]
      const float e = expf(srow[t] - m);
      srow[t] = e;
      sum += e;
    }
  }
  sum = sum16(sum);
  if (live && u < C) *cluster.map_shared_rank(red_sum + rank * kMaxGroup + g, u) = sum;
  cluster.sync();  // every block's sums are in every block
  sum = 0.0f;
  for (int r = 0; r < C; ++r) sum += red_sum[r * kMaxGroup + g];  // rank order
  if (live) {
    for (int t = u; t < tiles * kTileRows; t += 16) {  // [phase: exchange]
      srow[t] = t < R ? round_to(__fdiv_rn(srow[t], sum), T()) : 0.0f;
    }
  }
  __syncthreads();

  // P.V over the block's V tiles
  float acc[PV<T, HD>::N];
#pragma unroll
  for (int j = 0; j < PV<T, HD>::N; ++j) acc[j] = 0.0f;
  for (int i = tiles; i < 2 * tiles; ++i) {
    issue(i + stages - 1);
    cp_async_wait_n(stages - 1);
    __syncthreads();
    tile_pv<T, HD>(acc, scores, rows_pad, (i - tiles) * kTileRows, slot(i), group);
    __syncthreads();
  }
  cp_async_wait<0>();

  // this block's float32 partial -> rank 0's shared memory
  float* dst = cluster.map_shared_rank(part, 0) + (size_t)rank * kMaxGroup * HD;
  if constexpr (sizeof(T) == 2) {
    const int warp = tid / kWarp;
    const int lane = tid % kWarp;
    const int gq = lane >> 2;
    if (gq < group) {
#pragma unroll
      for (int nt = 0; nt < PV<T, HD>::NT; ++nt) {
        const int col = warp * (HD / kWarps) + 8 * nt + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dst + gq * HD + col) = make_float2(acc[4 * nt], acc[4 * nt + 1]);  // [phase: push]
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PV<T, HD>::N; ++j) {
      const int i = tid + j * kThreads;
      if (i / HD < group) dst[i] = acc[j];  // [phase: push]
    }
  }
  cluster.sync();  // all partials are in rank 0; no block touches another's memory after this
  if (rank != 0) return;
  // 16 bytes of the output a thread: the C partials added in rank order
  for (int i = tid; i < group * (HD / G::E); i += kThreads) {
    const float* p0 = part + i * G::E;
    float v[G::E];
#pragma unroll
    for (int e = 0; e < G::E; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p0 + e);
      v[e] = x.x;
      v[e + 1] = x.y;
      v[e + 2] = x.z;
      v[e + 3] = x.w;
    }
    for (int r = 1; r < C; ++r) {
#pragma unroll
      for (int e = 0; e < G::E; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p0 + (size_t)r * kMaxGroup * HD + e);
        v[e] += x.x;
        v[e + 1] += x.y;
        v[e + 2] += x.z;
        v[e + 3] += x.w;
      }
    }
    store16(out + ((size_t)b * H + (size_t)h * group) * HD + (size_t)i * G::E, v);
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* kc, const void* vc, void* out, int B, int S, int kv_heads,
                 int group, int pos, float scale, int C, cudaStream_t stream) {
  const LaunchPlan p = launch_plan<T, HD>(S, C);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // the attribute is the current card's: set once on each card (bit d of `sized`)
  static unsigned long long sized = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attn_cluster_kernel<T, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    sized |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, kv_heads, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attn_cluster_kernel<T, HD>, (const T*)q, (const T*)kc,
                                           (const T*)vc, (T*)out, S, kv_heads, group, pos, p.rows_pad, p.stages,
                                           scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* kc, const void* vc, void* out, int B, int S, int kv_heads, int group,
              int hd, int pos, float scale, int C, cudaStream_t stream) {
  if (hd == 64) return launch_typed<T, 64>(q, kc, vc, out, B, S, kv_heads, group, pos, scale, C, stream);
  if (hd == 128) return launch_typed<T, 128>(q, kc, vc, out, B, S, kv_heads, group, pos, scale, C, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out [B, kv_heads*group, hd]; kc, vc [B, S, kv_heads*hd]; dtype 0 =
// float32, 1 = bfloat16; C blocks per cluster (1 .. 8), one cluster per
// (b, KV head).
extern "C" int decode_attn_launch(const void* q, const void* kc, const void* vc, void* out, int B, int S,
                                  int kv_heads, int group, int hd, int pos, float scale, int dtype, int C,
                                  void* stream) {
  if (B <= 0 || kv_heads <= 0) return (int)cudaGetLastError();
  if (group < 1 || group > kMaxGroup || pos < 0 || pos >= S || B > 65535 || kv_heads > 65535 || C < 1 ||
      C > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch_hd<float>(q, kc, vc, out, B, S, kv_heads, group, hd, pos, scale, C, (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch_hd<bf16>(q, kc, vc, out, B, S, kv_heads, group, hd, pos, scale, C, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a launch asks for (dtype 0 float32, 1 bfloat16).
extern "C" int decode_attn_smem_bytes(int dtype, int hd, int S, int C) {
  if (C < 1 || (hd != 64 && hd != 128)) return -1;
  if (dtype == 1) return (int)(hd == 64 ? launch_plan<bf16, 64>(S, C) : launch_plan<bf16, 128>(S, C)).smem;
  return (int)(hd == 64 ? launch_plan<float, 64>(S, C) : launch_plan<float, 128>(S, C)).smem;
}
