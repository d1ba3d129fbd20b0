// Batched Praat pitch path finder (Viterbi over the per-frame candidates).
//
// Replaces the TPU kernel ops/viterbi_pallas.py of the JAX package:
// viterbi_pallas_batched (forward and backward pallas_calls), dispatched by
// ops/pitch.py viterbi_batched.
//
// What it computes, per segment s (inputs [S, F, K], K <= 32):
//   psi[0][k] = delta[0][k]
//   total[j]  = psi[t-1][j] - cost(j -> k)
//   back[t][k] = first argmax_j total[j];  psi[t][k] = max_j total[j] + delta[t][k]
//   cost(j -> k) = 0 if neither voiced, jump_cost*|lf_j - lf_k| if both,
//                  vuv_cost otherwise
// then backtracks from the first argmax of psi[F-1] and writes
// f0[s][t] = voiced ? freq : 0 at the chosen candidate. This is the
// back-pointer form of ops/pitch.py _viterbi_sequential; the Pallas kernel's
// alpha/beta decomposition was the TPU's way around a sequential grid.
// Scores are not renormalised (the plain version does not either), so both
// round the same way.
//
// What bounds it on the card: neither bytes nor operations but the chain of
// F - 1 dependent steps (the DP is sequential in t), then F dependent steps
// of the backtrack. A step's critical path is what psi[t] needs of psi[t-1]:
// a broadcast of psi, one subtract, a max over K values and one add.
// Design: one block of four warps per segment.
//   - Warp 0 runs the chain. Lane = (candidate k, half of j): for K <= 16 a
//     lane takes 8 predecessors j, for K <= 32 all 32 (KMAX, a template
//     parameter, so every loop over j is unrolled). Within a step only psi is
//     broadcast: 8 (or 32) independent shuffles that pipeline. The max is a
//     tree of fmaxf (exact, so the value equals the sequential one up to the
//     sign of a zero, which no comparison sees), then one shfl_xor merges the
//     two halves. The first argmax rides beside the values off the chain: the
//     tree pairs neighbours, so the left operand always holds the smaller j
//     and ties keep it (torch.argmax's first index, ties at -inf included).
//   - Warps 1-3 work a tile of frames ahead: they stage delta, lf and voiced
//     of the next tile in shared memory (plain coalesced loads: a frame's K
//     floats start 4-byte aligned only, so 16-byte copies do not fit) and
//     compute its transition costs cost[t][k][j] with the same operations in
//     the same order as the plain version, so nothing of the cost is left on
//     the chain. They also store the previous tile's back-pointers (uint8,
//     gathered in shared memory by warp 0) to device memory as one coalesced
//     run. One __syncthreads per tile hands the buffers over.
//   - The backtrack (warp 0) follows the back-pointers with one shuffle per
//     frame, the next tile's rows loaded while the current one is walked, and
//     writes the path's candidate indices; then all four warps turn them into
//     f0 in parallel.
// A load that sits behind a branch waits for its own round of latency, so the
// helpers load whole rows, padding included, and select afterwards.
// Arithmetic: explicit round-to-nearest intrinsics (and --fmad=false), so
// the path equals the plain PyTorch version's bit for bit.
//
// Comments "// [phase: ...]" mark what tools/viterbi_phases.py cuts to time
// the pieces by subtraction.
// viterbi_latency_probe times the two kinds of dependent step the chain is
// made of (a shuffle; a float add or max) for the chain's floor in
// chip_smoke.py.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;                // warp 0: the chain; warps 1-3: the helpers
constexpr int kHelpers = kThreads - kWarp;
constexpr int kBackTile = 32;                // frames per backtrack tile

template <int KMAX>
struct Plan {
  static constexpr int HALVES = kWarp / KMAX;       // lanes per candidate k
  static constexpr int JPL = KMAX / HALVES;         // predecessors j per lane
  static constexpr int TF = 16384 / (KMAX * KMAX);  // frames per tile: 64 (KMAX 16) or 16 (KMAX 32)
  // a k's row of costs is padded by 4 floats, so the 16-byte loads of the
  // lanes of a quarter warp fall in distinct banks
  static constexpr int KS = KMAX + 4;
  // shared memory: two buffers of cost [TF][KMAX k][KS j] and delta
  // [TF][KMAX] floats and of back [TF][KMAX] bytes; one staging buffer of lf
  // (floats) and voiced (bytes) for frames t0 - 1 .. t0 + TF - 1
  static constexpr int COST = TF * KMAX * KS;
  static constexpr int ROW = TF * KMAX;
  static constexpr int IN = (TF + 1) * KMAX;
  static constexpr int BYTES = (2 * COST + 2 * ROW + IN) * 4 + 2 * ROW + IN;
};

__device__ __forceinline__ void helper_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kHelpers) : "memory");
}

// Warps 1-3: stage frames [t0, t0 + nf) of one segment and compute their
// transition costs (from frame t - 1) into buffer `buf`.
template <int KMAX>
__device__ __forceinline__ void produce(const float* __restrict__ delta, const float* __restrict__ lf,
                                        const uint8_t* __restrict__ voiced, size_t base, int t0, int nf,
                                        int K, float vuv_cost, float jump_cost, float* cost_s,
                                        float* delta_s, float* lf_s, uint8_t* v_s, int h) {
  // every load of the tile is issued, unconditionally (indices clamped into
  // the tile), before the first store, so the tile waits for one round of
  // memory latency
  constexpr int PER = ((Plan<KMAX>::TF + 1) * KMAX + kHelpers - 1) / kHelpers;
  const int n_in = (nf + 1) * K, n_d = nf * K;
  const float* lf0 = lf + base + (size_t)(t0 - 1) * K;
  const uint8_t* v0 = voiced + base + (size_t)(t0 - 1) * K;
  const float* d0 = delta + base + (size_t)t0 * K;
  float lfr[PER], dr[PER];
  uint8_t vr[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = h + u * kHelpers;
    lfr[u] = lf0[min(i, n_in - 1)];
    vr[u] = v0[min(i, n_in - 1)];
    dr[u] = d0[min(i, n_d - 1)];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = h + u * kHelpers;
    const int o = (i / K) * KMAX + i % K;
    if (i < n_in) {
      lf_s[o] = lfr[u];
      v_s[o] = vr[u];
    }
    if (i < n_d) delta_s[o] = dr[u];
  }
  helper_sync();
  // one (frame, k) row of KMAX costs a thread: 0 between two unvoiced
  // candidates, the jump cost between two voiced ones, vuv_cost otherwise;
  // padded j or k get 0 (psi of a padded j is -inf, a padded k's lane never
  // updates). The previous frame's KMAX values are loaded whole, padding
  // included, so no load waits behind a branch: the selects below compile to
  // predicated moves.
  for (int p = h; p < nf * KMAX; p += kHelpers) {
    const int r = p / KMAX, k = p % KMAX;
    const bool vk = v_s[(r + 1) * KMAX + k] != 0;
    const float lk = lf_s[(r + 1) * KMAX + k];
    float lj[KMAX];
    uint32_t vj[KMAX / 4];
#pragma unroll
    for (int j = 0; j < KMAX; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(lf_s + r * KMAX + j);
      lj[j] = x.x;
      lj[j + 1] = x.y;
      lj[j + 2] = x.z;
      lj[j + 3] = x.w;
      vj[j / 4] = *reinterpret_cast<const uint32_t*>(v_s + r * KMAX + j);
    }
    float c[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const bool voj = ((vj[j / 4] >> (8 * (j % 4))) & 0xffu) != 0;
      const float jump = __fmul_rn(jump_cost, fabsf(__fsub_rn(lj[j], lk)));
      const float cj = (voj && vk) ? jump : ((voj || vk) ? vuv_cost : 0.0f);
      c[j] = (j < K && k < K) ? cj : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < KMAX; j += 4) {
      *reinterpret_cast<float4*>(cost_s + (r * KMAX + k) * Plan<KMAX>::KS + j) =  // [phase: costs]
          make_float4(c[j], c[j + 1], c[j + 2], c[j + 3]);                          // [phase: costs]
    }
  }
  helper_sync();  // lf_s / v_s are free for the next tile
}

// Warps 1-3: back-pointers of frames [t0, t0 + nf) from shared to device memory.
template <int KMAX>
__device__ __forceinline__ void store_back(uint8_t* __restrict__ back, size_t base, int t0, int nf,
                                           int K, const uint8_t* back_s, int h) {
  for (int i = h; i < nf * K; i += kHelpers) {
    back[base + (size_t)t0 * K + i] = back_s[(i / K) * KMAX + i % K];
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ delta, const float* __restrict__ lf,
               const uint8_t* __restrict__ voiced, const float* __restrict__ freq,
               uint8_t* __restrict__ back, float* __restrict__ f0, int F, int K, float vuv_cost,
               float jump_cost) {
  using P = Plan<KMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cost_s = reinterpret_cast<float*>(smem);  // [2][COST]
  float* delta_s = cost_s + 2 * P::COST;           // [2][ROW]
  float* lf_s = delta_s + 2 * P::ROW;              // [IN]
  uint8_t* back_s = reinterpret_cast<uint8_t*>(lf_s + P::IN);  // [2][ROW]
  uint8_t* v_s = back_s + 2 * P::ROW;              // [IN]

  const int seg = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const size_t base = (size_t)seg * F * K;
  const int steps = F - 1;  // frames 1 .. F-1
  const int tiles = (steps + P::TF - 1) / P::TF;
  auto tile_frames = [&](int n) { return min(P::TF, steps - n * P::TF); };

  if (warp > 0 && tiles > 0) {
    produce<KMAX>(delta, lf, voiced, base, 1, tile_frames(0), K, vuv_cost, jump_cost, cost_s, delta_s,
                  lf_s, v_s, tid - kWarp);
  }

  const int k = lane % KMAX;
  const int half = lane / KMAX;
  const int j0 = half * P::JPL;
  const bool act = k < K;
  float psi = act ? delta[base + k] : -CUDART_INF_F;
  __syncthreads();

  for (int n = 0; n < tiles; ++n) {
    const int buf = n & 1;
    const int nf = tile_frames(n);
    if (warp == 0) {
      const float* cs = cost_s + buf * P::COST + (k * P::KS + j0);
      const float* ds = delta_s + buf * P::ROW + k;
      uint8_t* bs = back_s + buf * P::ROW + k;
      // a step's costs and delta are loaded one step ahead, off the chain
      float c[P::JPL], cn[P::JPL];
      auto load_step = [&](float (&dst)[P::JPL], int tt) {
#pragma unroll
        for (int i = 0; i < P::JPL; i += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(cs + tt * KMAX * P::KS + i);
          dst[i] = v4.x;
          dst[i + 1] = v4.y;
          dst[i + 2] = v4.z;
          dst[i + 3] = v4.w;
        }
        return ds[tt * KMAX];
      };
      float d = load_step(c, 0);
#pragma unroll 2
      for (int tt = 0; tt < nf; ++tt) {  // [phase: chain]
        const float dn = load_step(cn, min(tt + 1, nf - 1));
        float val[P::JPL];
        int idx[P::JPL];
#pragma unroll
        for (int i = 0; i < P::JPL; ++i) {
          val[i] = __fsub_rn(__shfl_sync(kFull, psi, j0 + i), c[i]);
          idx[i] = j0 + i;
        }
        // neighbours pair up, so the left operand holds the smaller j's
#pragma unroll
        for (int w = P::JPL; w > 1; w /= 2) {
#pragma unroll
          for (int i = 0; i < w / 2; ++i) {
            const bool right = val[2 * i + 1] > val[2 * i];
            idx[i] = right ? idx[2 * i + 1] : idx[2 * i];
            val[i] = fmaxf(val[2 * i], val[2 * i + 1]);
          }
        }
        float best = val[0];
        int best_j = idx[0];
        if constexpr (P::HALVES == 2) {  // half 0 holds j < KMAX / 2, half 1 the rest
          const float ov = __shfl_xor_sync(kFull, best, KMAX);
          const int oi = __shfl_xor_sync(kFull, best_j, KMAX);
          const bool take = half ? ov >= best : ov > best;
          best_j = take ? oi : best_j;
          best = fmaxf(best, ov);
        }
        if (act) psi = __fadd_rn(best, d);
        if (act && half == 0) bs[tt * KMAX] = (uint8_t)best_j;
#pragma unroll
        for (int i = 0; i < P::JPL; ++i) c[i] = cn[i];
        d = dn;
      }
    } else {
      if (n + 1 < tiles) {
        produce<KMAX>(delta, lf, voiced, base, 1 + (n + 1) * P::TF, tile_frames(n + 1), K, vuv_cost,
                      jump_cost, cost_s + (buf ^ 1) * P::COST, delta_s + (buf ^ 1) * P::ROW, lf_s, v_s,
                      tid - kWarp);
      }
      if (n > 0) {
        store_back<KMAX>(back, base, 1 + (n - 1) * P::TF, tile_frames(n - 1), K, back_s + (buf ^ 1) * P::ROW,
                         tid - kWarp);
      }
    }
    __syncthreads();
  }
  if (warp > 0 && tiles > 0) {
    store_back<KMAX>(back, base, 1 + (tiles - 1) * P::TF, tile_frames(tiles - 1), K,
                     back_s + ((tiles - 1) & 1) * P::ROW, tid - kWarp);
  }
  __syncthreads();

  int* path = reinterpret_cast<int*>(f0) + (size_t)seg * F;
  if (warp == 0) {
    // first argmax of the last frame's scores (padded lanes hold -inf and
    // the largest index, so they lose every tie)
    float bv = psi;
    int bi = act ? k : 0x7fffffff;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // backtrack in tiles of kBackTile frames, lane c holding candidate c of
    // each row; the next tile's rows are loaded while this one is walked
    const bool row = lane < K;
    int cur = bi;
    int bp[kBackTile], nx[kBackTile];
    auto load = [&](int (&dst)[kBackTile], int t_hi) {  // unconditional loads, clamped in range
#pragma unroll
      for (int q = 0; q < kBackTile; ++q) {
        const int t = max(t_hi - q, 0);  // rows t <= 0 are never followed
        dst[q] = (int)back[base + (size_t)t * K + (row ? lane : 0)];
      }
    };
    load(bp, F - 1);
    for (int t_hi = F - 1; t_hi >= 0; t_hi -= kBackTile) {
      load(nx, t_hi - kBackTile);
#pragma unroll
      for (int q = 0; q < kBackTile; ++q) {
        const int t = t_hi - q;
        if (t < 0) break;
        if (lane == 0) path[t] = cur;
        cur = __shfl_sync(kFull, bp[q], cur);  // [phase: backtrack]
      }
#pragma unroll
      for (int q = 0; q < kBackTile; ++q) bp[q] = nx[q];
    }
  }
  __syncthreads();
  // the path's candidates -> f0, in place over the path
#pragma unroll 4
  for (int t = tid; t < F; t += kThreads) {
    const size_t o = base + (size_t)t * K + path[t];
    f0[(size_t)seg * F + t] = voiced[o] ? freq[o] : 0.0f;
  }
}

template <int KMAX>
int launch_kmax(const void* delta, const void* lf, const void* voiced, const void* freq, void* back,
                void* f0, int S, int F, int K, float vuv_cost, float jump_cost, cudaStream_t stream) {
  // the attribute is the current card's: set once on each card (bit d of `sized`)
  static unsigned long long sized = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(viterbi_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Plan<KMAX>::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized |= bit;
  }
  viterbi_kernel<KMAX><<<S, kThreads, Plan<KMAX>::BYTES, stream>>>(
      (const float*)delta, (const float*)lf, (const uint8_t*)voiced, (const float*)freq, (uint8_t*)back,
      (float*)f0, F, K, vuv_cost, jump_cost);
  return (int)cudaGetLastError();
}

// One warp: `steps` dependent shuffles (op 0) or `steps` dependent float
// add-then-max pairs (op 1); out[lane] keeps the result alive.
__global__ void latency_probe_kernel(float* out, int op, int steps, float a) {
  const int lane = threadIdx.x;
  const int src = (lane + 1) % kWarp;
  float x = lane * 1.0e-3f;
  if (op == 0) {
#pragma unroll 8
    for (int i = 0; i < steps; ++i) x = __shfl_sync(kFull, x, src);
  } else {
#pragma unroll 8
    for (int i = 0; i < steps; ++i) x = fmaxf(__fadd_rn(x, a), -a);
  }
  out[lane] = x;
}

}  // namespace

// delta, lf, freq float32 and voiced uint8 [S, F, K]; back uint8 scratch
// [S, F, K]; f0 float32 [S, F]. K <= 32.
extern "C" int viterbi_launch(const void* delta, const void* lf, const void* voiced,
                              const void* freq, void* back, void* f0, int S, int F, int K,
                              float vuv_cost, float jump_cost, void* stream) {
  if (S <= 0 || F <= 0) return (int)cudaGetLastError();
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (K <= 16) {
    return launch_kmax<16>(delta, lf, voiced, freq, back, f0, S, F, K, vuv_cost, jump_cost,
                           (cudaStream_t)stream);
  }
  return launch_kmax<32>(delta, lf, voiced, freq, back, f0, S, F, K, vuv_cost, jump_cost,
                         (cudaStream_t)stream);
}

// Dynamic shared memory of the instantiation for K <= kmax (16 or 32).
extern "C" int viterbi_smem_bytes(int kmax) { return kmax <= 16 ? Plan<16>::BYTES : Plan<32>::BYTES; }

// out: float32 [32] scratch; op 0 shuffles, op 1 add + max pairs.
extern "C" int viterbi_latency_probe(void* out, int op, int steps, void* stream) {
  latency_probe_kernel<<<1, kWarp, 0, (cudaStream_t)stream>>>((float*)out, op, steps, 0.5f);
  return (int)cudaGetLastError();
}
