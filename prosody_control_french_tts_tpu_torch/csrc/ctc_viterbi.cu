// CTC forced alignment: the Viterbi over the blank-interleaved label states,
// forward and backtrack, one thread-block cluster per sequence.
//
// Replaces the JAX package's align/ctc.py:ctc_forced_align, a lax.scan over
// frames (forward, :72) and a second one backward (:88) inside one jitted
// program: XLA, not a Pallas kernel. As a loop of PyTorch operations it would
// be about 8 launches a frame, and Final Transcribe aligns a whole OUT.wav in
// one call (thousands of frames, S = 2L + 1 in the thousands).
//
// What it computes, per sequence b, with lp = log_probs[b] [T, V] (the frame
// log-probabilities), ext = ext[b] [S] (each state's label), e[t, s] =
// lp[t, ext[s]], and the valid lengths n_in = input_len[b], n_lab =
// label_len[b]:
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
// two agree bit for bit. The states are blank-interleaved: every even state
// carries the blank (ext[b, 0]) and never skips.
//
// What bounds it on the card: the forward pass is a chain of n_in - 1
// dependent frames over all S states, and each frame's work (a dozen or so
// instructions a state) has to be issued by the schedulers of the SMs that
// hold the states. Design:
// - A cluster of C blocks (C <= 8, on C SMs) splits the states; in a block a
//   thread holds kK consecutive states in registers (kK in 2, 4, 8, 16), with
//   its odd states' labels (as shared-memory byte offsets) and skip bits. The
//   two states before a thread's first come from the thread before it by two
//   shuffles; for lane 0 of a warp, from the warp before it, and for the
//   first warp of a block, from the last warp of the block before it.
// - No barrier a frame: the edges go on through tagged slots. The writer
//   stores each of the two values with the frame's number as one 64-bit word
//   (a single-copy-atomic store); the reader, its whole warp at once, reads
//   the slot until both words carry the frame it waits for. Between the warps
//   of a block the slots are in the block's shared memory, TF + 1 of them: a
//   block barrier ends each ring tile (TF frames) and keeps its warps within
//   a tile of each other. Between blocks the last warp writes the next
//   block's slots through distributed shared memory, kCrossSlots of them; the
//   next block tells it at each tile barrier how far it has read, and the
//   writer waits before it would overwrite a slot not yet read. A warp thus
//   runs ahead of the warps after it and the frames' latencies overlap.
//   Every wait gives up with a trap after kSpinLimit reads instead of
//   hanging.
// - Each block gathers its own emissions: the frames' log-probabilities
//   (V floats a frame, 192 bytes at V 48, against S floats of gathered
//   emissions) go into a ring of kTiles tiles of TF frames in shared memory
//   by asynchronous copies (16 bytes where the sequence's rows start
//   16-byte aligned, else 4), kTiles - 1 tiles ahead of the frame in use;
//   each thread reads lp[t, ext[s]] of its states there (one read for all
//   its blanks) at the top of the frame.
// - Back-pointers are packed 2 bits a state, 2 kK bits a thread a frame,
//   gathered in registers over 64 / kK frames and written as one 16-byte
//   store a thread. They stay in L2 for the backtrack (6.3 MB at S 3,265 and
//   7,673 frames).
// - Block 0 runs the backtrack after a cluster barrier, in windows of kWin
//   frames: the path falls by at most 2 states a frame, so a window entered
//   at state st needs the pointer words of states [st - 2 kWin, st], and the
//   next window those of [st - 4 kWin, st]. While thread 0 walks one window
//   in shared memory, the other threads stage the next one; in the walk, the
//   words the state two frames on can fall in are read before it is known.
// The lines marked // [phase: ...] are cut by tools/ctc_viterbi_phases.py to
// split the time.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;           // threads of a block (registers: up to 255 a thread)
constexpr int kMaxStates = 16383;          // states of a sequence (2L + 1)
constexpr int kMaxCluster = 8;             // blocks of a cluster (the portable limit)
constexpr int kTiles = 3;                  // ring slots: kTiles - 1 tiles in flight ahead
constexpr int kMaxTileFrames = 64;         // TF at most
constexpr int kRingBytes = 40 * 1024;      // the ring's shared memory at most
constexpr int kCrossSlots = 256;           // slots of the edge from the block before
constexpr int kWin = 64;                   // frames of a backtrack window
constexpr int kWinWords = 4 * kWin / 16 + 2;  // words covering states [st - 4 kWin, st]
constexpr int kWinBytes = 2 * kWin * kWinWords * 4;
constexpr long long kSpinLimit = 1ll << 28;   // reads of a slot before a wait gives up (seconds)

// Frames of a ring tile for V classes: a multiple of 4 (so every tile starts
// 16-byte aligned when the sequence does), 0 when V is too wide.
__host__ __device__ inline int tile_frames(int V) {
  if (V <= 0) return 0;
  int tf = kRingBytes / (kTiles * V * 4);
  tf = (tf < kMaxTileFrames ? tf : kMaxTileFrames) & ~3;
  return tf >= 4 ? tf : 0;
}

// Threads of each of the C blocks for S states at kK a thread: a whole number
// of warps.
__host__ __device__ inline int block_threads(int S, int kK, int C) {
  const int threads = (S + kK - 1) / kK;
  return ((threads + C - 1) / C + 31) / 32 * 32;
}

// Frames of packed pointers a thread gathers in registers before one 16-byte
// store: 2 kK bits a frame, 128 bits a store.
template <int kK>
__host__ __device__ constexpr int group_frames() { return 64 / kK; }

__host__ __device__ inline int pointer_groups(int T, int kK) {
  const int rows = T > 1 ? T - 1 : 1;
  return (rows + 64 / kK - 1) / (64 / kK);
}

// Dynamic shared memory of a block: the ring and the warps' edge slots, or
// the backtrack's two windows if more.
__host__ __device__ inline int smem_bytes(int TF, int V, int warps) {
  const int fwd = kTiles * TF * V * 4 + (TF + 1) * warps * 2 * 8;
  return fwd > kWinBytes ? fwd : kWinBytes;
}

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

__device__ __forceinline__ void count_spin(long long& n) {
  if (++n > kSpinLimit) __trap();
}

__device__ __forceinline__ void write_edge(volatile unsigned long long* slot, unsigned t, float p2, float p1) {
  const unsigned long long tag = (unsigned long long)t << 32;
  slot[0] = tag | __float_as_uint(p2);
  slot[1] = tag | __float_as_uint(p1);
}

// Issue the copies of tile m (frames m TF .. min((m + 1) TF, Tv) - 1) into
// its ring slot, and commit them as one group (possibly empty: every thread
// commits one group per call, so the group counts stay in step).
__device__ __forceinline__ void load_tile(float* ring, const float* lp, int m, int TF, int V, int Tv, bool vec, int tid,
                                          int nthreads) {
  const int f0 = m * TF;
  if (f0 < Tv) {
    const int rows = Tv - f0 < TF ? Tv - f0 : TF;
    const int n = rows * V;
    const float* src = lp + (long long)f0 * V;
    float* dst = ring + (m % kTiles) * TF * V;
    int i = 0;
    if (vec) {
      for (int q = tid; q < n / 4; q += nthreads) {
        __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);  // [phase: loads]
      }
      i = n / 4 * 4;
    }
    for (int q = i + tid; q < n; q += nthreads) {
      __pipeline_memcpy_async(dst + q, src + q, 4);  // [phase: loads]
    }
  }
  __pipeline_commit();
}

// Push one frame's packed pointers (2 kK bits) into a thread's 128-bit
// accumulator from the top: after group_frames() pushes, frame f of the
// group sits at bits [2 kK f, 2 kK (f + 1)).
template <int kK>
__device__ __forceinline__ void push_ptrs(uint32_t (&acc)[4], uint32_t pk) {
  if constexpr (kK == 16) {
    acc[0] = acc[1];
    acc[1] = acc[2];
    acc[2] = acc[3];
    acc[3] = pk;
  } else {
    acc[0] = __funnelshift_r(acc[0], acc[1], 2 * kK);
    acc[1] = __funnelshift_r(acc[1], acc[2], 2 * kK);
    acc[2] = __funnelshift_r(acc[2], acc[3], 2 * kK);
    acc[3] = __funnelshift_r(acc[3], pk, 2 * kK);
  }
}

// Word c of pointer row `row` (states 16 c .. 16 c + 15, 2 bits each), put
// together from the 16 / kK threads' entries that hold them; nt threads a
// sequence.
template <int kK>
__device__ __forceinline__ uint32_t row_word(const uint32_t* bk, int nt, int row, int c) {
  constexpr int G = group_frames<kK>();
  constexpr uint32_t mask = kK == 16 ? ~0u : (1u << (2 * kK)) - 1u;
  const int g = row / G, bit = (row - g * G) * 2 * kK;
  const uint32_t* e = bk + ((long long)g * nt + c * (16 / kK)) * 4 + (bit >> 5);
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 16 / kK; ++q) w |= (e[4 * q] >> (bit & 31) & mask) << (2 * kK * q);
  return w;
}

// One frame of a thread's kK states, downward (a[j - 1], a[j - 2] still
// hold frame t - 1): the best of stay, s - 1 and s - 2 (NEG where the skip is
// forbidden; the first of equal candidates wins), plus the state's emission
// (eb at the even states, the blanks; eo[j / 2] at the odd ones). Returns the
// packed pointers, 2 bits a state. kAllValid: every state of the thread is
// below 2 n_lab + 1 (else `valid` says which are).
template <int kK, bool kAllValid>
__device__ __forceinline__ uint32_t advance(float (&a)[kK], float p1, float p2, float eb, const float (&eo)[kK / 2],
                                            uint32_t skm, uint32_t valid) {
  uint32_t pk = 0;
#pragma unroll
  for (int j = kK - 1; j >= 0; --j) {
    const float stay = a[j];
    const float f1 = j >= 1 ? a[j - 1] : p1;
    const float f2 = (j & 1) && (skm >> j & 1) ? (j >= 2 ? a[j - 2] : p1) : kNeg;  // an even state never skips
    float m = stay;
    uint32_t best = 0;
    if (f1 > m) { m = f1; best = 1; }
    if (f2 > m) { m = f2; best = 2; }
    const float sum = __fadd_rn(m, (j & 1) ? eo[j / 2] : eb);  // [phase: chain]
    a[j] = kAllValid || (valid >> j & 1) ? sum : kNeg;  // [phase: chain]
    pk |= best << (2 * j);
  }
  return pk;
}

template <int kK>
__global__ void __launch_bounds__(kMaxThreads)
    ctc_viterbi_kernel(const float* __restrict__ log_probs, const int* __restrict__ ext, const int* __restrict__ skip,
                       const int* __restrict__ input_len, const int* __restrict__ label_len, uint32_t* __restrict__ back,
                       int* __restrict__ states, float* __restrict__ score, int T, int S, int V, int TF) {
  // dynamic shared memory: the forward's ring of kTiles tiles [TF, V], then
  // the warps' edge slots [TF + 1][warps][2]; block 0's backtrack windows
  // reuse it
  extern __shared__ __align__(16) float ring[];
  __shared__ unsigned long long xslots[kCrossSlots][2];  // the block before's edge, frame t in slot t % kCrossSlots
  __shared__ int xread;  // frames whose slots the block after has read (it writes this)
  __shared__ float ends[2];
  __shared__ int cur_state[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nb = blockDim.x;
  const int nt = C * nb;  // threads of the sequence
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = nb >> 5;
  const int s0 = (k * nb + tid) * kK;
  const float* lp = log_probs + (long long)b * T * V;
  const int n_lab = label_len[b];
  const int n_valid_states = 2 * n_lab + 1;
  const int n_in = input_len[b];
  const int Tv = n_in < 1 ? 1 : (n_in > T ? T : n_in);  // frames 1 .. Tv - 1 advance alpha
  const bool vec = ((reinterpret_cast<uintptr_t>(lp) & 15) == 0);
  const int D = TF + 1;  // a warp's edge slots: frame t's in slot t % D
  volatile unsigned long long* edges = reinterpret_cast<volatile unsigned long long*>(ring + kTiles * TF * V);
  const bool to_next = warp == warps - 1 && k + 1 < C;  // this warp's edge goes to the next block
  volatile unsigned long long* next_slots =
      k + 1 < C ? reinterpret_cast<volatile unsigned long long*>(cluster.map_shared_rank(&xslots[0][0], k + 1))
                : nullptr;
  volatile int* prev_read = k > 0 ? cluster.map_shared_rank(&xread, k - 1) : nullptr;

  for (int m = 0; m < kTiles; ++m) load_tile(ring, lp, m, TF, V, Tv, vec, tid, nb);

  // pointers: [groups][nt] 16-byte entries, group g holding a thread's
  // pointers of rows g G .. g G + G - 1 (G = group_frames<kK>())
  const uint32_t* bk = back + (long long)b * pointer_groups(T, kK) * nt * 4;
  uint4* bput = reinterpret_cast<uint4*>(back + (long long)b * pointer_groups(T, kK) * nt * 4) + k * nb + tid;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  int acc_frames = 0;

  // the labels of the thread's odd states as byte offsets into a ring row;
  // the even states' label is the blank, ext[b, 0]
  const uint32_t blank_off = (uint32_t)ext[(long long)b * S] * 4u;
  uint32_t off[kK / 2];
  uint32_t skm = 0, valid = 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int s = s0 + j;
    if (j & 1) off[j / 2] = s < S ? (uint32_t)ext[(long long)b * S + s] * 4u : blank_off;
    if (s < S && skip[(long long)b * S + s]) skm |= 1u << j;
    if (s < n_valid_states) valid |= 1u << j;
  }
  const bool all_valid = s0 + kK <= n_valid_states;
  auto at = [](const float* row, uint32_t o) -> float {
    return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(row) + o);
  };

  // Edge slots. A warp reads its predecessor's edge of frame t - 1 from
  // `in`: the warp before it in the block (the block's slots, D of them), or
  // for the first warp of a later block the xslots the block before writes,
  // or for the first warp of block 0 `none`, NEG that every frame accepts
  // (want_mask 0). It writes its own edge of frame t to `own`, and the last
  // warp of a block with a block after it also to that block's xslots
  // (`fwd`); every other warp writes that copy to `sink`, which no one reads.
  __shared__ unsigned long long none[2], sink[2];
  for (int q = tid; q < D * warps * 2; q += nb) edges[q] = ~0ull;  // no slot holds a frame yet
  for (int q = tid; q < kCrossSlots * 2; q += nb) (&xslots[0][0])[q] = ~0ull;
  if (tid == 0) {
    xread = 0;
    none[0] = none[1] = __float_as_uint(kNeg);
  }
  const volatile unsigned long long* in =
      warp > 0 ? edges + (warp - 1) * 2 : (k > 0 ? &xslots[0][0] : none);
  const int in_slots = warp > 0 ? D : (k > 0 ? kCrossSlots : 1);
  const int in_stride = warp > 0 ? warps * 2 : (k > 0 ? 2 : 0);
  const unsigned want_mask = warp > 0 || k > 0 ? ~0u : 0u;
  volatile unsigned long long* own = edges + warp * 2;
  const int own_stride = warps * 2;
  volatile unsigned long long* fwd = to_next ? next_slots : sink;
  const int fwd_slots = to_next ? kCrossSlots : 1;
  const int fwd_stride = to_next ? 2 : 0;
  int lim = to_next ? kCrossSlots : 0x7fffffff;  // a producer writes frames below lim without a look at xread
  __pipeline_wait_prior(kTiles - 1);  // tile 0 has landed
  cluster.sync();  // every block's slots are set before another block writes them
  float a[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    a[j] = (s0 + j < 2 && (valid >> j & 1)) ? at(ring, (j & 1) ? off[j / 2] : blank_off) : kNeg;
  }
  if (lane == 31) {
    write_edge(own, 0, a[kK - 2], a[kK - 1]);
    write_edge(fwd, 0, a[kK - 2], a[kK - 1]);
  }
  __syncthreads();

  // The frames of one tile, t up to t_end: one straight run of code a frame
  // but for the rare waits, so that the schedule can overlap its loads,
  // shuffles and stores with the chain; unrolled by two (timed against one,
  // four and eight by tools/ctc_viterbi_phases.py).
  const int tile_floats = TF * V;
  int t = 1, in_i = 0, own_i = 1 % D, fwd_i = 1 % fwd_slots;
  const volatile unsigned long long* in_at = in;  // frame t - 1's slot
  volatile unsigned long long* own_at = own + own_i * own_stride;  // frame t's
  volatile unsigned long long* fwd_at = fwd + fwd_i * fwd_stride;
  auto frames = [&](auto all_valid_tag, int t_end, const float* row) {
    constexpr bool kAllValid = decltype(all_valid_tag)::value;
#pragma unroll 2  // two frames a pass: one frame's stores and slot bumps overlap the next one's loads
    for (; t < t_end; ++t, row += V) {
      const volatile unsigned long long* src = in_at;
      unsigned long long x = src[0], y = src[1];
      float eb = 0.0f, eo[kK / 2];
#pragma unroll
      for (int j = 0; j < kK / 2; ++j) eo[j] = 0.0f;
      eb = at(row, blank_off);  // [phase: loads]
#pragma unroll
      for (int j = 0; j < kK / 2; ++j) eo[j] = at(row, off[j]);  // [phase: loads]
      // the two states before this thread's first, as they were at frame t - 1
      float p2 = __shfl_up_sync(kFull, a[kK - 2], 1);
      float p1 = __shfl_up_sync(kFull, a[kK - 1], 1);
      const unsigned want = (unsigned)(t - 1);
      for (long long n = 0; (((unsigned)(x >> 32) ^ want) | ((unsigned)(y >> 32) ^ want)) & want_mask;) {  // [phase: handoff]
        count_spin(n);
        x = src[0];
        y = src[1];
      }
      if (lane == 0) {
        p2 = __uint_as_float((unsigned)x);
        p1 = __uint_as_float((unsigned)y);
      }
      const uint32_t pk = advance<kK, kAllValid>(a, p1, p2, eb, eo, skm, valid);
      if (t >= lim) {  // a producer: the next block must be done with the slot's frame kCrossSlots before
        long long n = 0;
        for (lim = *(volatile int*)&xread + kCrossSlots; t >= lim; lim = *(volatile int*)&xread + kCrossSlots) {
          count_spin(n);
        }
      }
      if (lane == 31) {
        write_edge(own_at, (unsigned)t, a[kK - 2], a[kK - 1]);
        write_edge(fwd_at, (unsigned)t, a[kK - 2], a[kK - 1]);
      }
      push_ptrs<kK>(acc, pk);
      if (++acc_frames == group_frames<kK>()) {
        *bput = make_uint4(acc[0], acc[1], acc[2], acc[3]);  // [phase: stores]
        bput += nt;
        acc_frames = 0;
      }
      if (++in_i == in_slots) in_i = 0, in_at = in; else in_at += in_stride;
      if (++own_i == D) own_i = 0, own_at = own; else own_at += own_stride;
      if (++fwd_i == fwd_slots) fwd_i = 0, fwd_at = fwd; else fwd_at += fwd_stride;
    }
  };
  const bool warp_all_valid = __all_sync(kFull, all_valid);
  for (int m = 0;; ++m) {  // tile m: frames m TF .. (m + 1) TF - 1, in ring slot m % kTiles
    const int t_end = (m + 1) * TF < Tv ? (m + 1) * TF : Tv;
    const float* row = ring + (m % kTiles) * tile_floats + (t - m * TF) * V;
    if (warp_all_valid) {
      frames(Bool<true>{}, t_end, row);
    } else {
      frames(Bool<false>{}, t_end, row);
    }
    if (t >= Tv) break;
    __pipeline_wait_prior(kTiles - 2);  // tile m + 1 has landed
    __syncthreads();  // and every thread is done with tile m
    if (tid == 0 && k > 0) *prev_read = t - 1;  // every warp here read the slots of the frames below t - 1
    load_tile(ring, lp, m + kTiles, TF, V, Tv, vec, tid, nb);  // into tile m's slot
  }
  __pipeline_wait_prior(0);
  if (acc_frames > 0) {  // the last group, partly filled: its frames down to their places
    for (; acc_frames < group_frames<kK>(); ++acc_frames) push_ptrs<kK>(acc, 0u);
    *bput = make_uint4(acc[0], acc[1], acc[2], acc[3]);  // [phase: stores]
  }

  // the end state and the score, in block 0
  const int endA = 2 * n_lab;
  const int endB = endA - 1 > 0 ? endA - 1 : 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int s = s0 + j;
    if (s == endA) *cluster.map_shared_rank(&ends[0], 0) = a[j];
    if (s == endB) *cluster.map_shared_rank(&ends[1], 0) = a[j];
  }
  cluster.sync();  // the ends are in block 0, every pointer is stored, and no block reads another's memory after this
  if (k != 0) return;
  const float sa = ends[0], sb = ends[1];
  const int last = sa >= sb ? endA : endB;
  if (tid == 0) score[b] = sa >= sb ? sa : sb;
  for (int t = Tv - 1 + tid; t < T; t += nb) states[(long long)b * T + t] = last;

  // backtrack, kWin frames a window: frame t's state is states[t + 1] -
  // back[t][states[t + 1]], for t = Tv - 2 down to 0. Window i (frames hi_i
  // down to hi_i - kWin + 1) is staged in buffer i & 1 with the words of
  // states [ref_i - 4 kWin, ref_i], ref_0 the end state and ref_{i+1} the
  // state window i is entered with.
  const int RW = nt * kK / 16;  // words of 16 states' pointers in a row
  uint32_t* win = reinterpret_cast<uint32_t*>(ring);  // [2][kWin][kWinWords]
  const int loader0 = nb > 32 ? 32 : 1;  // threads loader0 .. stage while thread 0 walks
  auto stage = [&](int buf, int hi, int ref, int first, int step) {
    const int lo = hi - kWin + 1 > 0 ? hi - kWin + 1 : 0;
    const int w0 = (ref - 4 * kWin > 0 ? ref - 4 * kWin : 0) >> 4;
    uint32_t* dst = win + buf * kWin * kWinWords;
    for (int q = first; q < (hi - lo + 1) * kWinWords; q += step) {
      const int r = q / kWinWords, c = q - r * kWinWords;
      if (w0 + c < RW) dst[r * kWinWords + c] = row_word<kK>(bk, nt, lo + r, w0 + c);  // [phase: backtrack]
    }
  };
  int st = last;
  int ref = last;
  if (Tv >= 2) stage(0, Tv - 2, ref, tid, nb);
  __syncthreads();
  for (int i = 0, hi = Tv - 2; hi >= 0; ++i, hi -= kWin) {
    const int lo = hi - kWin + 1 > 0 ? hi - kWin + 1 : 0;
    if (tid == 0) {
      // The walk: row r's word at the state s of frame t + 1 gives the state
      // of frame t. The words of row r - 2 where the state of frame t - 1 can
      // be (its state lies in [s - 4, s]: one of two words) are read two
      // frames ahead, so no shared-memory load stands in the chain
      // (volatile: both candidates are read where written; a select of two
      // loads may otherwise become one load after the choice).
      const volatile uint32_t* w = win + (i & 1) * kWin * kWinWords - ((ref - 4 * kWin > 0 ? ref - 4 * kWin : 0) >> 4);
      auto word = [&](int r, int s) -> uint32_t { return w[(r > 0 ? r : 0) * kWinWords + ((s > 0 ? s : 0) >> 4)]; };
      int s = st, r = hi - lo;
      uint32_t cur = word(r, s);
      uint32_t a1 = word(r - 1, s), b1 = word(r - 1, s - 4);  // row r - 1 at [s - 4, s]
      int ref1 = s >> 4;
      for (; r >= 0; --r) {  // [phase: backtrack]
        const uint32_t a2 = word(r - 2, s), b2 = word(r - 2, s - 4);
        const int ns = s - (int)(cur >> ((s & 15) * 2) & 3u);
        states[(long long)b * T + lo + r] = ns;
        cur = (ns >> 4) == ref1 ? a1 : b1;
        a1 = a2;
        b1 = b2;
        ref1 = s >> 4;
        s = ns;
      }
      cur_state[i & 1] = s;
    } else if (tid >= loader0 && lo > 0) {
      stage((i + 1) & 1, lo - 1, st, tid - loader0, nb - loader0);
    }
    __syncthreads();
    ref = st;
    st = cur_state[i & 1];
  }
}

template <int kK>
cudaError_t launch(const void* lp, const void* ext, const void* skip, const void* input_len, const void* label_len,
                   void* back, void* states, void* score, int B, int T, int S, int V, int C, cudaStream_t stream) {
  const int nb = block_threads(S, kK, C);
  const int TF = tile_frames(V);
  const int smem = smem_bytes(TF, V, nb / 32);
  cudaError_t err = cudaFuncSetAttribute(ctc_viterbi_kernel<kK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(nb);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ctc_viterbi_kernel<kK>, (const float*)lp, (const int*)ext, (const int*)skip,
                           (const int*)input_len, (const int*)label_len, (uint32_t*)back, (int*)states, (float*)score,
                           T, S, V, TF);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// States a thread for S states by default (0: more than the kernel takes):
// 4, or 8 past what 8 blocks of 256 threads hold at 4. Measured at Final
// Transcribe's S 3,265 and a segment's S 301 on the H100
// (tools/ctc_viterbi_phases.py), 4 states a thread came first at both; 2
// gives a warp less work to hide its latencies with, 8 and 16 leave fewer
// warps.
extern "C" int ctc_viterbi_states_per_thread(int S) {
  if (S > kMaxStates) return 0;
  return S <= 4 * kMaxCluster * kMaxThreads ? 4 : 8;
}

// Blocks of the cluster for S states at kK a thread by default: about 4
// warps a block (8 blocks came first at S 3,265, 1 at S 301), at most 8.
extern "C" int ctc_viterbi_cluster_blocks(int S, int kK) {
  const int warps = ((S + kK - 1) / kK + 31) / 32;
  const int c = (warps + 3) / 4;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

// Frames of a ring tile at V classes (0: V is too wide for the ring).
extern "C" int ctc_viterbi_tile_frames(int V) { return tile_frames(V); }

// 32-bit words of a sequence's packed pointers at T frames, S states, kK
// states a thread and C blocks.
extern "C" long long ctc_viterbi_back_words(int T, int S, int kK, int C) {
  return (long long)pointer_groups(T, kK) * C * block_threads(S, kK, C) * 4;
}

// log_probs [B, T, V] float32; ext, skip [B, S] int32 (each state's label in
// [0, V), the even states the blank; whether it may come from s - 2, never
// an even state); input_len / label_len [B] int32; back [B,
// ctc_viterbi_back_words(T, S, kK, C)] uint32 (workspace); states [B, T]
// int32; score [B] float32. kK: states a thread (2, 4, 8 or 16), C: blocks a
// sequence (1 .. 8); 0 for the defaults.
extern "C" int ctc_viterbi_launch(const void* lp, const void* ext, const void* skip, const void* input_len,
                                  const void* label_len, void* back, void* states, void* score, int B, int T, int S,
                                  int V, int kK, int C, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaGetLastError();
  if (kK == 0) kK = ctc_viterbi_states_per_thread(S);
  if (C == 0) C = ctc_viterbi_cluster_blocks(S, kK);
  if (S > kMaxStates || tile_frames(V) == 0 || kK == 0 || C < 1 || C > kMaxCluster ||
      block_threads(S, kK, C) > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (kK) {
    case 2: return (int)launch<2>(lp, ext, skip, input_len, label_len, back, states, score, B, T, S, V, C, st);
    case 4: return (int)launch<4>(lp, ext, skip, input_len, label_len, back, states, score, B, T, S, V, C, st);
    case 8: return (int)launch<8>(lp, ext, skip, input_len, label_len, back, states, score, B, T, S, V, C, st);
    case 16: return (int)launch<16>(lp, ext, skip, input_len, label_len, back, states, score, B, T, S, V, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
