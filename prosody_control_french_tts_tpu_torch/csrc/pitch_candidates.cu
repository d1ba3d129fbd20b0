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
// What bounds it on the card: bytes. It reads the lags min_lag - 1 ..
// max_lag of each row of r once and writes 9*rows*k bytes; the work per
// element is a few compares, so the instructions a row costs decide how
// close to that it comes. Design, compact then rank, one warp per row:
//   1. detect: lane l holds lags l + 32q (q < P, P = ceil(L/32) a template
//      argument, 1 to 32: L up to 1024, the lags of a 44.1 kHz signal down
//      to a ~45 Hz pitch floor) from coalesced loads of the needed lags only; a row with
//      no lag above half_vth (silence and most unvoiced frames) stops here;
//      in the others each neighbour r[i-1], r[i+1] comes from the next lane
//      by one shuffle;
//   2. compact: a __ballot_sync per register and __popc of the lanes below
//      give each maximum its place in a list in lag order, kept in the
//      warp's slice of shared memory with its lag and both neighbours
//      (maxima are never adjacent, so a row has at most (max_lag - min_lag
//      + 1) / 2 of them);
//   3. rank: the lane that takes list entry j (j = lane, lane + 32, ...: one
//      round for the usual row of at most 32 maxima, more rounds for the
//      rest) counts the entries that beat it -- a larger value, or an equal
//      value at a smaller lag, i.e. an earlier entry -- which is its place in
//      the plain version's order of k masked argmax rounds;
//   4. every entry ranked below k runs the parabolic step from the
//      neighbours it carries and stores its three outputs at its rank, all
//      lanes at once; slots from the row's count up to k get zeros.
// No block barrier: warps are independent, each synchronises its lanes only.
//
// Arithmetic: every multiply/add/divide is an explicit round-to-nearest
// intrinsic (and the library is built with --fmad=false), so the results are
// the plain PyTorch version's bit for bit. The lines marked // [phase: ...]
// are cut by tools/pitch_candidates_phases.py to split the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 32;  // L <= 1024
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Entries of a warp's maxima list for lags [min_lag, max_lag): no two maxima
// are adjacent (r[i] > r[i-1] and r[i-1] >= r[i] cannot both hold).
__host__ __device__ inline int list_cap(int min_lag, int max_lag) {
  return max_lag > min_lag ? (max_lag - min_lag + 1) / 2 : 0;
}

// Shared memory of one block: four arrays (value, lag, r[i-1], r[i+1]) of
// list_cap entries per warp (at most 65,408 bytes, at L 1024).
inline int smem_bytes(int min_lag, int max_lag) { return kWarpsPerBlock * 4 * list_cap(min_lag, max_lag) * 4; }
constexpr int kDefaultSmem = 48 * 1024;  // a launch may ask for more only with the kernel's attribute raised

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    pitch_candidates_kernel(const float* __restrict__ r, float* __restrict__ lag_f, float* __restrict__ strength,
                            uint8_t* __restrict__ valid, int rows, int L, int k, int min_lag, int max_lag,
                            float half_vth) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp: no block barrier follows
  const int cap = list_cap(min_lag, max_lag);
  float* s_val = smem + (size_t)warp * 4 * cap;
  int* s_lag = reinterpret_cast<int*>(s_val + cap);
  float* s_lo = s_val + 2 * cap;
  float* s_hi = s_val + 3 * cap;
  const float* rr = r + (size_t)row * L;

  // the lags that the maxima read, one coalesced load a register
  float v[P];
  bool above = false;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = lane + kWarp * q;
    v[q] = (i >= min_lag - 1 && i <= max_lag) ? __ldg(rr + i) : 0.0f;
    above = above || v[q] > half_vth;
  }

  // 1-2. a row with no lag above half_vth (silence, most unvoiced frames)
  // holds no maximum; in the others, detect, then compact by ballot: entry
  // n + (maxima of the lower lanes)
  int n = 0;
  if (__any_sync(kFull, above)) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = lane + kWarp * q;
      const float c = v[q];
      // r[i-1]: lane l - 1's register q; lane 0 takes lane 31's register q - 1
      float lo = __shfl_sync(kFull, (lane == kWarp - 1 && q > 0) ? v[q > 0 ? q - 1 : 0] : c, (lane + kWarp - 1) % kWarp);  // [phase: detection]
      // r[i+1]: lane l + 1's register q; lane 31 takes lane 0's register q + 1
      float hi = __shfl_sync(kFull, (lane == 0 && q + 1 < P) ? v[q + 1 < P ? q + 1 : q] : c, (lane + 1) % kWarp);  // [phase: detection]
      bool is_max = c > half_vth;
      is_max = is_max && i >= min_lag && i < max_lag && c > lo && c >= hi;  // [phase: detection]
      const unsigned ballot = __ballot_sync(kFull, is_max);
      if (is_max) {  // [phase: compaction]
        const int j = n + __popc(ballot & below);  // [phase: compaction]
        s_val[j] = c;  // [phase: compaction]
        s_lag[j] = i;  // [phase: compaction]
        s_lo[j] = lo;  // [phase: compaction]
        s_hi[j] = hi;  // [phase: compaction]
      }  // [phase: compaction]
      n += __popc(ballot);
    }
    __syncwarp();
  }

  float* out_lag = lag_f + (size_t)row * k;
  float* out_str = strength + (size_t)row * k;
  uint8_t* out_val = valid + (size_t)row * k;

  // 3-4. rank each entry against the whole list, then store at its rank
  for (int j = lane; j < n; j += kWarp) {  // [phase: rank]
    const float c = s_val[j];
    int rank = 0;
    for (int e = 0; e < n; ++e) {
      const float o = s_val[e];
      rank += (o > c || (o == c && e < j)) ? 1 : 0;
    }
    if (rank < k) {
      const float rv = c;
      float lagv = (float)s_lag[j];
      float str = rv;
      const float rl = s_lo[j];  // [phase: parabola]
      const float rp = s_hi[j];  // [phase: parabola]
      const float dr = __fmul_rn(0.5f, __fsub_rn(rp, rl));  // [phase: parabola]
      const float d2r = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, rv), rl), rp);  // [phase: parabola]
      const float offset = fabsf(d2r) > 1e-12f ? __fdiv_rn(dr, d2r) : 0.0f;  // [phase: parabola]
      lagv = __fadd_rn(lagv, fminf(fmaxf(offset, -1.0f), 1.0f));  // [phase: parabola]
      str = __fadd_rn(rv, __fmul_rn(__fmul_rn(0.5f, dr), offset));  // [phase: parabola]
      out_lag[rank] = lagv;
      out_str[rank] = str;
      out_val[rank] = 1;
    }
  }
  // the slots past the row's maxima
  for (int t = min(n, k) + lane; t < k; t += kWarp) {
    out_lag[t] = 0.0f;
    out_str[t] = 0.0f;
    out_val[t] = 0;
  }
}

template <int P>
int launch(const float* r, float* lag_f, float* strength, uint8_t* valid, int rows, int L, int k, int min_lag,
           int max_lag, float half_vth, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int smem = smem_bytes(min_lag, max_lag);
  if (smem > kDefaultSmem) {  // lags above ~800 (a pitch floor under ~55 Hz at 44.1 kHz)
    const cudaError_t e =
        cudaFuncSetAttribute(pitch_candidates_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  pitch_candidates_kernel<P><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(r, lag_f, strength, valid, rows, L,
                                                                              k, min_lag, max_lag, half_vth);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const float*, float*, float*, uint8_t*, int, int, int, int, int, float, cudaStream_t);

template <int... Ps>
struct Table {
  static constexpr Launcher fns[sizeof...(Ps)] = {&launch<Ps>...};
};

}  // namespace

// Dynamic shared memory that a launch for lags [min_lag, max_lag) asks for.
extern "C" int pitch_candidates_smem_bytes(int min_lag, int max_lag) { return smem_bytes(min_lag, max_lag); }

extern "C" int pitch_candidates_launch(const void* r, void* lag_f, void* strength, void* valid, int rows, int L,
                                       int k, int min_lag, int max_lag, float half_vth, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaGetLastError();
  if (L < 1 || L > kWarp * kMaxPerLane || min_lag < 1 || max_lag > L - 1) return (int)cudaErrorInvalidValue;
  using T = Table<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                  28, 29, 30, 31, 32>;
  const int P = (L + kWarp - 1) / kWarp;
  return T::fns[P - 1]((const float*)r, (float*)lag_f, (float*)strength, (uint8_t*)valid, rows, L, k, min_lag,
                       max_lag, half_vth, (cudaStream_t)stream);
}
