// Pitch candidates: local maxima of the normalised autocorrelation -> the k
// strongest -> parabolic interpolation, in one pass over r.
//
// Replaces the TPU kernel ops/pallas_kernels.py of the JAX package:
// topk_parabolic (body _candidates_kernel), which ops/pitch.py _pitch_frames
// dispatches for the Boersma candidate stage.
//
// What it computes, per frame row of r [rows, L] (float32):
//   - local maxima at interior lags min_lag <= i < max_lag: r[i] > r[i-1],
//     r[i] >= r[i+1], r[i] > half_vth (= 0.5 * voicing threshold);
//   - the k strongest in descending order, ties to the smallest lag;
//   - for each, the parabolic lag i + clip(dr/d2r, -1, 1) and the strength
//     rv + 0.5*dr*offset with the UNCLIPPED offset;
//   - lag_f, strength (float32) and valid (uint8) [rows, k], zeros past the
//     row's real maxima.
//
// What bounds it on the card: bytes. It reads r once (rows*L*4 bytes) and
// writes 9*rows*k bytes; the work per element is a few compares. Design: one
// warp per row, lanes stride over the lags (coalesced loads), the row's
// scores stay in registers, and each of the k rounds is a warp-shuffle
// argmax in registers -- r is read from device memory once, where the plain
// formulation re-reads the whole [rows, L] tensor in every round.
//
// Arithmetic: every multiply/add/divide is an explicit round-to-nearest
// intrinsic (and the library is built with --fmad=false), so the results are
// the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 16;  // L <= 512
constexpr int kWarpsPerBlock = 8;

__global__ void pitch_candidates_kernel(const float* __restrict__ r, float* __restrict__ lag_f,
                                        float* __restrict__ strength, uint8_t* __restrict__ valid,
                                        int rows, int L, int k, int min_lag, int max_lag,
                                        float half_vth) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  const float* rr = r + (size_t)row * L;

  float score[kMaxPerLane];
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q) {
    const int i = lane + kWarp * q;
    float s = -CUDART_INF_F;
    if (i < L && i >= min_lag && i < max_lag) {
      const float c = rr[i];
      if (c > rr[i - 1] && c >= rr[i + 1] && c > half_vth) s = c;
    }
    score[q] = s;
  }

  float* out_lag = lag_f + (size_t)row * k;
  float* out_str = strength + (size_t)row * k;
  uint8_t* out_val = valid + (size_t)row * k;

  for (int s = 0; s < k; ++s) {
    // lane-local best (lags rise with q, so strict > keeps the first)
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      if (score[q] > bv) {
        bv = score[q];
        bi = lane + kWarp * q;
      }
    }
    // warp argmax: larger value wins, equal values go to the smaller lag
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (!(bv > -CUDART_INF_F)) {  // no maxima left: the rest of the row is zeros
      for (int t = s + lane; t < k; t += kWarp) {
        out_lag[t] = 0.0f;
        out_str[t] = 0.0f;
        out_val[t] = 0;
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      if (lane + kWarp * q == bi) score[q] = -CUDART_INF_F;
    }
    if (lane == 0) {
      const float rv = rr[bi];
      const float rl = rr[bi - 1];
      const float rp = rr[bi + 1];
      const float dr = __fmul_rn(0.5f, __fsub_rn(rp, rl));
      const float d2r = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, rv), rl), rp);
      const float offset = fabsf(d2r) > 1e-12f ? __fdiv_rn(dr, d2r) : 0.0f;
      const float clipped = fminf(fmaxf(offset, -1.0f), 1.0f);
      out_lag[s] = __fadd_rn((float)bi, clipped);
      out_str[s] = __fadd_rn(rv, __fmul_rn(__fmul_rn(0.5f, dr), offset));
      out_val[s] = 1;
    }
  }
}

}  // namespace

extern "C" int pitch_candidates_launch(const void* r, void* lag_f, void* strength, void* valid,
                                       int rows, int L, int k, int min_lag, int max_lag,
                                       float half_vth, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaGetLastError();
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pitch_candidates_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)r, (float*)lag_f, (float*)strength, (uint8_t*)valid, rows, L, k, min_lag,
      max_lag, half_vth);
  return (int)cudaGetLastError();
}
