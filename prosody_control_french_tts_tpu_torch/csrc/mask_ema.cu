// Two-way exponential smoothing along time of a spectral mask [F, T]
// (float32, bins by frames): the time smoothing of the spectral-gate
// denoiser.
//
// Replaces the JAX package's audio/denoise.py:_denoise_core time smoothing,
// ema(ema(mask[:, ::-1])[:, ::-1]) with ema a lax.scan over frames: an XLA
// loop, not a Pallas kernel. What it computes, per bin f independently:
//   backward: u[T-1] = m[T-1], u[t] = a * u[t+1] + b * m[t] for t = T-2 .. 0
//   forward:  w[0] = u[0],     w[t] = a * w[t-1] + b * u[t] for t = 1 .. T-1
// with a = smooth and b = 1 - smooth (the scan's smooth * prev + (1 - smooth)
// * cur). Every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn, --fmad=false), as in the plain PyTorch loop
// (ops/mask_ema.py:mask_ema_plain), so the two agree bit for bit.
//
// What bounds it on the card: each bin's recurrence is a dependent chain of
// 2 (T - 1) multiply-add steps, and only F (513) bins exist, so one chain a
// bin can never go below the chain's latency (about 0.2 ms at T ~ 27,500)
// and keeps few SMs busy. The design splits every chain and verifies the
// split, so the work spreads over the card and the memory traffic (the mask
// read, the backward result written and read back, the result written)
// bounds it.
//
// Speculate and verify. A pass (backward, then forward over its result) is
// cut into chunks of kChunk frames in the pass's order. One thread takes one
// (bin, chunk): it restarts the recurrence W frames before its chunk (from
// that frame's value, as the pass starts from its first frame), runs the W
// warm-up steps, keeps the state it enters its chunk with, and runs the
// chunk. The recurrence forgets its start: the gap between two chains is
// multiplied by a each step and rounds away, and one step is a function of
// (state, input) alone, so a chain that enters the chunk with the true state
// bit for bit gives every value of the chunk exactly. Chunk 0 starts the
// pass and is exact. A fix-up launch then walks each bin's chunks in order
// (one warp a bin): it compares each chunk's entered state with the true
// output before it (32 chunks a ballot while nothing was recomputed), and
// recomputes from the true state a chunk that entered wrong (the warp stages
// the chunk's inputs, one lane runs the chain, the warp stores it), then
// compares the next chunk with that chunk's new last value. Every value is
// exact whatever smooth is; a mask that never forgets its start (smooth
// near 1) recomputes every chunk, which is the sequential chain again.
// Recomputed chunks are counted into a device counter.
//
// A speculative block is one warp of kChunks chunks of one bin: the frames
// it needs are staged in shared memory by 4-byte asynchronous copies
// (coalesced, any row length; rows of T floats are not 16-byte aligned), one
// slot of kChunk + 1 words a chunk so that the lanes, each in its own chunk,
// read distinct banks; the results are written in place after a barrier (a
// lane's warm-up reads the slot before its own, which that lane's neighbour
// overwrites) and stored back coalesced. The lines marked // [phase: ...]
// are cut by tools/mask_ema_phases.py to split the time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;          // frames of a chunk (C)
constexpr int kChunks = 32;          // chunks of a speculative block, one a lane
constexpr int kSlot = kChunk + 1;    // shared-memory words of a chunk's slot
constexpr int kFixWarps = 4;         // bins of a fix-up block, one a warp
constexpr unsigned kFull = 0xffffffffu;

// One step of the recurrence, each operation rounded on its own.
__device__ __forceinline__ float ema_step(float v, float x, float a, float b) {
  return __fadd_rn(__fmul_rn(a, v), __fmul_rn(b, x));
}

// The frame of pass position p (p = 0 is the pass's first frame).
template <bool kBackward>
__device__ __forceinline__ long long frame_of(long long p, long long T) {
  return kBackward ? T - 1 - p : p;
}

// Speculative pass: block (x, f) takes chunks k0 .. k0 + 31 of bin f, lane j
// chunk k0 + j. Shared slot q holds chunk k0 - 1 + q (slot 0 only its last W
// frames: the first lane's warm-up).
template <bool kBackward>
__global__ void __launch_bounds__(kChunks)
    ema_speculate(const float* __restrict__ src, float* __restrict__ dst, float* __restrict__ enter, long long T, int K,
                  float a, float b, int W) {
  __shared__ float xs[(kChunks + 1) * kSlot];
  const int f = blockIdx.y;
  const int j = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kChunks;
  const long long base = (k0 - 1) * kChunk;  // pass position of slot 0's first word
  const float* row = src + (long long)f * T;
  float* out = dst + (long long)f * T;
  const long long lo = k0 * kChunk - W > 0 ? k0 * kChunk - W : 0;
  const long long hi = (k0 + kChunks) * kChunk < T ? (k0 + kChunks) * kChunk : T;
  auto at = [&](long long p) -> float& {
    const unsigned r = (unsigned)(p - base);
    return xs[r + r / kChunk];
  };
  for (long long p = lo + j; p < hi; p += kChunks) {
    __pipeline_memcpy_async(&at(p), row + frame_of<kBackward>(p, T), sizeof(float));  // [phase: loads]
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const long long k = k0 + j;
  const long long p0 = k * kChunk;
  float* mine = xs + (j + 1) * kSlot;
  float v = 0.0f;
  if (p0 < T) {
    if (k == 0) {
      v = mine[0];  // the pass's first frame starts the recurrence
    } else {
      const int warm = (int)(p0 - W > 0 ? W : p0);  // frames of warm-up (fewer near the pass's start)
      const float* prev = xs + j * kSlot + kChunk - warm;
      v = prev[0];
#pragma unroll 8
      for (int i = 1; i < warm; ++i) v = ema_step(v, prev[i], a, b);  // [phase: chain]
      enter[(long long)f * K + k] = v;
    }
  }
  __syncthreads();  // every warm-up read is done before any lane overwrites a slot
  if (p0 < T) {
    const int n = (int)(T - p0 < kChunk ? T - p0 : kChunk);
    if (n == kChunk && k != 0) {
#pragma unroll 8
      for (int i = 0; i < kChunk; ++i) mine[i] = v = ema_step(v, mine[i], a, b);  // [phase: chain]
    } else {
      for (int i = k == 0 ? 1 : 0; i < n; ++i) mine[i] = v = ema_step(v, mine[i], a, b);  // [phase: chain]
    }
  }
  __syncthreads();
  for (long long p = k0 * kChunk + j; p < hi; p += kChunks) {
    out[frame_of<kBackward>(p, T)] = at(p);  // [phase: stores]
  }
}

// Fix-up: warp w of block x walks the chunks of bin x * kFixWarps + w in
// order. While nothing was recomputed, the entered states of 32 chunks are
// compared in one ballot with the speculative pass's outputs before them
// (exact, as every earlier chunk is); after a recomputed chunk, the next one
// is compared with its new last value. A chunk that entered wrong is
// recomputed from the true state and counted.
template <bool kBackward>
__global__ void __launch_bounds__(kFixWarps * 32)
    ema_fixup(const float* __restrict__ src, float* __restrict__ dst, const float* __restrict__ enter,
              unsigned long long* __restrict__ fixups, int F, long long T, int K, float a, float b) {
  __shared__ float buf[kFixWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int f = blockIdx.x * kFixWarps + w;
  if (f >= F) return;  // a whole warp; the block has no barrier
  const float* row = src + (long long)f * T;
  float* out = dst + (long long)f * T;
  const float* ent = enter + (long long)f * K;
  float* sb = buf[w];
  bool changed = false;  // the chunk before k was recomputed; `last` holds its last value
  float last = 0.0f;
  unsigned long long count = 0;
  int k = 1;
  while (k < K) {
    if (!changed) {
      const int kk = k + lane;
      bool bad = false;
      if (kk < K) {
        bad = __float_as_uint(ent[kk]) != __float_as_uint(out[frame_of<kBackward>((long long)kk * kChunk - 1, T)]);
      }
      const unsigned miss = __ballot_sync(kFull, bad);
      if (!miss) {
        k += 32;
        continue;
      }
      k += __ffs(miss) - 1;
      last = out[frame_of<kBackward>((long long)k * kChunk - 1, T)];
    } else if (__float_as_uint(ent[k]) == __float_as_uint(last)) {
      changed = false;
      ++k;
      continue;
    }
    // recompute chunk k from the true state `last`
    const long long p0 = (long long)k * kChunk;
    const int n = (int)(T - p0 < kChunk ? T - p0 : kChunk);
    for (int i = lane; i < n; i += 32) sb[i] = row[frame_of<kBackward>(p0 + i, T)];
    __syncwarp();
    if (lane == 0) {
      float v = last;
      for (int i = 0; i < n; ++i) sb[i] = v = ema_step(v, sb[i], a, b);
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) out[frame_of<kBackward>(p0 + i, T)] = sb[i];
    last = sb[n - 1];
    __syncwarp();  // every lane has read sb before the next chunk is staged
    changed = true;
    ++count;
    ++k;
  }
  if (lane == 0 && count) atomicAdd(fixups, count);
}

template <bool kBackward>
cudaError_t run_pass(const float* src, float* dst, float* enter, unsigned long long* fixups, int F, long long T, int K,
                     float a, float b, int W, cudaStream_t stream) {
  const dim3 grid((unsigned)((K + kChunks - 1) / kChunks), (unsigned)F);
  ema_speculate<kBackward><<<grid, kChunks, 0, stream>>>(src, dst, enter, T, K, a, b, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K < 2) return err;
  ema_fixup<kBackward><<<(F + kFixWarps - 1) / kFixWarps, kFixWarps * 32, 0, stream>>>(src, dst, enter, fixups, F, T, K, a, b);  // [phase: fixup]
  return cudaGetLastError();
}

}  // namespace

// Chunks of kChunk frames in T frames: the length of a bin's row of
// entered states.
extern "C" int mask_ema_chunks(long long T) { return (int)((T + kChunk - 1) / kChunk); }

// mask, out, scratch [F, T] float32 (scratch takes the backward pass),
// enter [F, mask_ema_chunks(T)] float32 (workspace), fixups one uint64 on
// the card (the recomputed chunks are added to it), warm-up frames W in
// [1, kChunk]. Four launches on the stream: each pass's speculative launch
// and its fix-up.
extern "C" int mask_ema_launch(const void* mask, void* out, void* scratch, void* enter, void* fixups, int F,
                               long long T, float a, float b, int W, void* stream) {
  if (F <= 0 || T <= 0) return (int)cudaGetLastError();
  if (W < 1 || W > kChunk || F > 65535) return (int)cudaErrorInvalidValue;
  const int K = mask_ema_chunks(T);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = run_pass<true>((const float*)mask, (float*)scratch, (float*)enter, (unsigned long long*)fixups, F,
                                   T, K, a, b, W, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_pass<false>((const float*)scratch, (float*)out, (float*)enter, (unsigned long long*)fixups, F, T, K,
                              a, b, W, st);
}
