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
// F dependent steps (the DP is sequential in t). Design: one warp per
// segment, candidates on lanes; each step broadcasts the previous frame's
// scores by warp shuffles, so the state never leaves registers; the next
// frame's inputs are loaded one step ahead to hide their latency. The
// back-pointers go to an int16 [S, F, K] scratch in device memory; the
// backtrack loads them a tile of frames at a time, one row per lane, so
// the loads do not wait on the path.
//
// Arithmetic: explicit round-to-nearest intrinsics (and --fmad=false), so
// the path equals the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;  // frames per backtrack tile

__global__ void viterbi_kernel(const float* __restrict__ delta, const float* __restrict__ lf,
                               const uint8_t* __restrict__ voiced,
                               const float* __restrict__ freq, int16_t* __restrict__ back,
                               float* __restrict__ f0, int S, int F, int K, float vuv_cost,
                               float jump_cost) {
  const int seg = blockIdx.x;
  const int lane = threadIdx.x;
  if (seg >= S) return;
  const size_t base = (size_t)seg * F * K;
  const bool act = lane < K;

  float psi = act ? delta[base + lane] : -CUDART_INF_F;
  float lf_prev = act ? lf[base + lane] : 0.0f;
  int v_prev = act ? (int)voiced[base + lane] : 0;

  // inputs of frame t, loaded one step ahead
  float d_nx = 0.0f, lf_nx = 0.0f;
  int v_nx = 0;
  if (F > 1 && act) {
    d_nx = delta[base + K + lane];
    lf_nx = lf[base + K + lane];
    v_nx = voiced[base + K + lane];
  }
  for (int t = 1; t < F; ++t) {
    const float d = d_nx, lf_cur = lf_nx;
    const int v_cur = v_nx;
    if (t + 1 < F && act) {
      const size_t o = base + (size_t)(t + 1) * K + lane;
      d_nx = delta[o];
      lf_nx = lf[o];
      v_nx = voiced[o];
    }
    float best = -CUDART_INF_F;
    int best_j = 0;
    for (int j = 0; j < K; ++j) {
      const float pj = __shfl_sync(kFull, psi, j);
      const float lfj = __shfl_sync(kFull, lf_prev, j);
      const int vj = __shfl_sync(kFull, v_prev, j);
      float cost;
      if (!vj && !v_cur) {
        cost = 0.0f;
      } else if (vj && v_cur) {
        cost = __fmul_rn(jump_cost, fabsf(__fsub_rn(lfj, lf_cur)));
      } else {
        cost = vuv_cost;
      }
      const float total = __fsub_rn(pj, cost);
      if (j == 0 || total > best) {
        best = total;
        best_j = j;
      }
    }
    if (act) {
      psi = __fadd_rn(best, d);
      back[base + (size_t)t * K + lane] = (int16_t)best_j;
    }
    lf_prev = lf_cur;
    v_prev = v_cur;
  }

  // first argmax of the last frame's scores (lanes >= K hold -inf)
  float bv = psi;
  int bi = act ? lane : 0x7fffffff;
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }

  // backtrack: tiles of kTile frames, lane c holds candidate c of each row
  int cur = bi;
  for (int t_hi = F - 1; t_hi >= 0; t_hi -= kTile) {
    int16_t bp[kTile];
    float fr[kTile];
    uint8_t vo[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int t = t_hi - q;
      bp[q] = 0;
      fr[q] = 0.0f;
      vo[q] = 0;
      if (t >= 0 && act) {
        const size_t o = base + (size_t)t * K + lane;
        bp[q] = t > 0 ? back[o] : 0;
        fr[q] = freq[o];
        vo[q] = voiced[o];
      }
    }
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int t = t_hi - q;
      if (t < 0) break;
      const float f = __shfl_sync(kFull, fr[q], cur);
      const int v = __shfl_sync(kFull, (int)vo[q], cur);
      const int prev = __shfl_sync(kFull, (int)bp[q], cur);
      if (lane == 0) f0[(size_t)seg * F + t] = v ? f : 0.0f;
      cur = prev;
    }
  }
}

}  // namespace

extern "C" int viterbi_launch(const void* delta, const void* lf, const void* voiced,
                              const void* freq, void* back, void* f0, int S, int F, int K,
                              float vuv_cost, float jump_cost, void* stream) {
  if (S <= 0 || F <= 0) return (int)cudaGetLastError();
  viterbi_kernel<<<S, kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)delta, (const float*)lf, (const uint8_t*)voiced, (const float*)freq,
      (int16_t*)back, (float*)f0, S, F, K, vuv_cost, jump_cost);
  return (int)cudaGetLastError();
}
