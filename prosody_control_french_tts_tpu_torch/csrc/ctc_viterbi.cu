// CTC forced alignment: the Viterbi over the blank-interleaved label states,
// forward and backtrack, one block per sequence.
//
// Replaces the JAX package's align/ctc.py:ctc_forced_align, a lax.scan over
// frames (forward, :72) and a second one backward (:88) inside one jitted
// program: XLA, not a Pallas kernel. As a loop of PyTorch operations it would
// be about 8 launches a frame, and Final Transcribe aligns a whole OUT.wav in
// one call (thousands of frames, S = 2L + 1 in the thousands).
//
// What it computes, per sequence b, with e = emit[b] [T, S] (the frame
// log-probabilities of each state's label) and the valid lengths
// n_in = input_len[b], n_lab = label_len[b]:
//   alpha_0[s] = e[0, s] for s < 2 (and s < 2 n_lab + 1), else NEG
//   for t = 1 .. min(T, n_in) - 1:
//     m = max(alpha[s], alpha[s-1], skip[s] ? alpha[s-2] : NEG), the first of
//         equal candidates winning (stay, then s-1, then s-2); back[t-1][s] =
//         0, 1 or 2 for it
//     alpha[s] = s < 2 n_lab + 1 ? m + e[t, s] : NEG
//   frames from n_in on leave alpha as it is;
//   end: 2 n_lab (the last blank) if alpha[2 n_lab] >= alpha[2 n_lab - 1],
//        else 2 n_lab - 1 (the last label; 0 when n_lab = 0);
//   score = max of the two; states[t] = the end state for t >= n_in - 1, and
//   states[t - 1] = states[t] - back[t - 1][states[t]] below.
// The add is rounded on its own (__fadd_rn; the build has --fmad=false), as
// in the plain PyTorch version (ops/ctc_viterbi.py:ctc_viterbi_plain), so the
// two agree bit for bit.
//
// Design. A thread holds kK consecutive states in registers (kK in 2, 4, 8,
// 16; the least that fits S in 1,024 threads). The two states before its
// first come from the thread before it by two shuffles, and for lane 0 from
// shared memory, where lane 31 of every warp leaves its last two states each
// frame (double-buffered: one barrier a frame). The frame's emissions are
// loaded one frame ahead. Back-pointers are int8 in global memory
// [B, T - 1, S]. The backtrack runs in the same launch: the path falls by at
// most 2 states a frame, so the block stages the pointers of the next kWin
// frames over the 2 kWin + 1 states the path can reach into shared memory,
// and one thread walks them there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kWin = 64;                // frames of a backtrack window
constexpr int kWinCols = 2 * kWin + 1;  // states the path can reach in a window

template <int kK>
__global__ void __launch_bounds__(kMaxThreads)
    ctc_viterbi_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ skip,
                       const int* __restrict__ input_len, const int* __restrict__ label_len,
                       int8_t* __restrict__ back, int* __restrict__ states, float* __restrict__ score, int T, int S) {
  __shared__ float edge[2][kMaxThreads / 32][2];  // [buffer][warp][second-last, last]
  __shared__ float ends[2];
  __shared__ int cur_state;
  __shared__ int8_t win[kWin][kWinCols];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = tid * kK;
  const float* e = emit + (long long)b * T * S;
  int8_t* bk = back + (long long)b * (T > 1 ? T - 1 : 0) * S;
  const int n_lab = label_len[b];
  const int n_valid_states = 2 * n_lab + 1;
  const int n_in = input_len[b];
  const int Tv = n_in < 1 ? 1 : (n_in > T ? T : n_in);  // frames 1 .. Tv - 1 advance alpha

  float a[kK];
  bool sk[kK];
  float e_next[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int s = s0 + j;
    float v = kNeg;
    if (s < 2 && s < S && s < n_valid_states) v = e[s];
    a[j] = v;
    sk[j] = s < S && skip[(long long)b * S + s];
    e_next[j] = (Tv > 1 && s < S) ? e[(long long)S + s] : 0.0f;
  }
  if (lane == 31) {  // frame t reads buffer t & 1, written at the end of frame t - 1 (here for frame 0)
    edge[1][warp][0] = a[kK - 2];
    edge[1][warp][1] = a[kK - 1];
  }
  __syncthreads();

  for (int t = 1; t < Tv; ++t) {
    float ec[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      ec[j] = e_next[j];
      const int s = s0 + j;
      if (t + 1 < Tv && s < S) e_next[j] = e[(long long)(t + 1) * S + s];
    }
    // the two states before this thread's first, as they were at frame t - 1
    float p2 = __shfl_up_sync(0xffffffffu, a[kK - 2], 1);
    float p1 = __shfl_up_sync(0xffffffffu, a[kK - 1], 1);
    if (lane == 0) {
      p2 = warp > 0 ? edge[t & 1][warp - 1][0] : kNeg;
      p1 = warp > 0 ? edge[t & 1][warp - 1][1] : kNeg;
    }
    float na[kK];
    int8_t ptr[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const int s = s0 + j;
      const float stay = a[j];
      const float f1 = j >= 1 ? a[j - 1] : p1;
      const float f2raw = j >= 2 ? a[j - 2] : (j == 1 ? p1 : p2);
      const float f2 = sk[j] ? f2raw : kNeg;
      float m = stay;
      int8_t best = 0;
      if (f1 > m) { m = f1; best = 1; }
      if (f2 > m) { m = f2; best = 2; }
      na[j] = s < n_valid_states ? __fadd_rn(m, ec[j]) : kNeg;
      ptr[j] = best;
    }
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      a[j] = na[j];
      const int s = s0 + j;
      if (s < S) bk[(long long)(t - 1) * S + s] = ptr[j];
    }
    if (lane == 31) {
      edge[(t + 1) & 1][warp][0] = a[kK - 2];
      edge[(t + 1) & 1][warp][1] = a[kK - 1];
    }
    __syncthreads();
  }

  // the end state and the score
  const int endA = 2 * n_lab;
  const int endB = endA - 1 > 0 ? endA - 1 : 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int s = s0 + j;
    if (s == endA) ends[0] = a[j];
    if (s == endB) ends[1] = a[j];
  }
  __syncthreads();
  if (tid == 0) {
    const float sa = ends[0], sb = ends[1];
    const int last = sa >= sb ? endA : endB;
    score[b] = sa >= sb ? sa : sb;
    cur_state = last;
    for (int t = Tv - 1; t < T; ++t) states[(long long)b * T + t] = last;
  }
  __syncthreads();

  // backtrack, kWin frames a window: frame t's state is states[t + 1] -
  // back[t][states[t + 1]], for t = Tv - 2 down to 0
  for (int hi = Tv - 2; hi >= 0; hi -= kWin) {
    const int lo = hi - kWin + 1 > 0 ? hi - kWin + 1 : 0;
    const int st = cur_state;
    const int c0 = st - 2 * kWin > 0 ? st - 2 * kWin : 0;
    const int rows = hi - lo + 1;
    for (int k = tid; k < rows * kWinCols; k += blockDim.x) {
      const int r = k / kWinCols, c = k % kWinCols;
      if (c0 + c < S) win[r][c] = bk[(long long)(lo + r) * S + c0 + c];
    }
    __syncthreads();
    if (tid == 0) {
      int s = st;
      for (int t = hi; t >= lo; --t) {
        s -= win[t - lo][s - c0];
        states[(long long)b * T + t] = s;
      }
      cur_state = s;
    }
    __syncthreads();
  }
}

template <int kK>
cudaError_t launch(const void* emit, const void* skip, const void* input_len, const void* label_len, void* back,
                   void* states, void* score, int B, int T, int S, cudaStream_t stream) {
  int threads = (S + kK - 1) / kK;
  threads = ((threads + 31) / 32) * 32;
  ctc_viterbi_kernel<kK><<<B, threads, 0, stream>>>((const float*)emit, (const uint8_t*)skip, (const int*)input_len,
                                                    (const int*)label_len, (int8_t*)back, (int*)states,
                                                    (float*)score, T, S);
  return cudaGetLastError();
}

}  // namespace

// States a thread holds for S states (0: S is past what one block can take).
extern "C" int ctc_viterbi_states_per_thread(int S) {
  for (int k = 2; k <= 16; k *= 2) {
    if ((S + k - 1) / k <= kMaxThreads) return k;
  }
  return 0;
}

// emit [B, T, S] float32, skip [B, S] uint8, input_len / label_len [B] int32,
// back [B, T - 1, S] int8 (workspace), states [B, T] int32, score [B] float32.
extern "C" int ctc_viterbi_launch(const void* emit, const void* skip, const void* input_len, const void* label_len,
                                  void* back, void* states, void* score, int B, int T, int S, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (ctc_viterbi_states_per_thread(S)) {
    case 2: return (int)launch<2>(emit, skip, input_len, label_len, back, states, score, B, T, S, st);
    case 4: return (int)launch<4>(emit, skip, input_len, label_len, back, states, score, B, T, S, st);
    case 8: return (int)launch<8>(emit, skip, input_len, label_len, back, states, score, B, T, S, st);
    case 16: return (int)launch<16>(emit, skip, input_len, label_len, back, states, score, B, T, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
