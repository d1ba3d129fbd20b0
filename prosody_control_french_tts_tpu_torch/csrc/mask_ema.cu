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
// What bounds it on the card: the recurrence is a dependent chain of 2 (T-1)
// multiply-add steps per bin (a few hundred thousand cycles at T ~ 27,500),
// and only F (513) chains exist, so few warps run and the memory traffic
// (the mask read, the backward result written and read back, the result
// written) has to be hidden behind the chain by prefetch. Design: one thread
// per bin, one warp per block of 32 bins. The warp walks the frames in tiles
// of 32: a tile [32 bins x 32 frames] is brought into shared memory by
// asynchronous copies (each of the 32 copies of a lane is one coalesced
// 128-byte row of one bin), kDepth tiles in flight ahead of the one being
// used; each lane then takes its bin's 32 values into registers (rows padded
// to 33 words: no bank conflicts either way), runs its 32 steps there, puts
// the results back in place, and the warp stores the tile back coalesced.
// The backward pass writes out, and the forward pass reads out back tile by
// tile; a lane reads back exactly the addresses it stored, so a block-scope
// fence between the passes is all the ordering they need.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // bins of a block, one a lane
constexpr int kTile = 32;   // frames of a tile
constexpr int kPad = 33;    // shared-memory row stride of a tile, in words
constexpr int kDepth = 8;   // tiles in flight
constexpr int kTileWords = kLanes * kPad;

// Issue the asynchronous copies of the tile starting at frame t0 into slot,
// then commit them as one group (possibly empty: every lane commits one group
// per call, so the group counts stay in step across the warp).
__device__ __forceinline__ void load_tile(float* slot, const float* __restrict__ src, int F, long long T, int b0,
                                          long long t0, int lane) {
  const long long t = t0 + lane;
  if (t < T) {
#pragma unroll 8
    for (int j = 0; j < kLanes; ++j) {
      if (b0 + j < F) __pipeline_memcpy_async(slot + j * kPad + lane, src + (long long)(b0 + j) * T + t, sizeof(float));
    }
  }
  __pipeline_commit();
}

// One step of the recurrence, each operation rounded on its own.
__device__ __forceinline__ float ema_step(float v, float x, float a, float b) {
  return __fadd_rn(__fmul_rn(a, v), __fmul_rn(b, x));
}

// One pass over every frame of the block's bins: backward (from frame T - 1
// down) or forward (from frame 0 up), src to dst. A lane takes its bin's 32
// values of the tile into registers, runs the 32 steps on them (no branch in
// a full tile that does not start the pass), and puts them back for the
// warp's coalesced stores. The lines marked // [phase: ...] are cut by
// tools/mask_ema_phases.py to split the time.
template <bool kBackward>
__device__ void ema_pass(const float* src, float* dst, float* smem, int F, long long T, int b0, int lane, float a,
                         float b) {
  const long long tiles = (T + kTile - 1) / kTile;
  const long long first = kBackward ? T - 1 : 0;
  auto tile_start = [&](long long i) { return (kBackward ? tiles - 1 - i : i) * kTile; };
  for (int p = 0; p < kDepth - 1; ++p) {
    if (p < tiles) {
      load_tile(smem + p * kTileWords, src, F, T, b0, tile_start(p), lane);
    } else {
      __pipeline_commit();
    }
  }
  float v = 0.0f;
  for (long long i = 0; i < tiles; ++i) {
    __syncwarp();  // every lane is done with the slot the next copies overwrite
    const long long ahead = i + kDepth - 1;
    if (ahead < tiles) {
      load_tile(smem + (ahead % kDepth) * kTileWords, src, F, T, b0, tile_start(ahead), lane);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(kDepth - 1);  // this lane's copies of tile i have landed
    __syncwarp();                       // and every other lane's
    float* tile = smem + (i % kDepth) * kTileWords;
    float* row = tile + lane * kPad;  // a lane past F reads and writes a row no copy fills and no store reads
    const long long t0 = tile_start(i);
    float x[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) x[k] = row[k];
    if (i == 0 || t0 + kTile > T) {
      // the pass's first tile (its first frame starts the recurrence), or the partial last tile
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        const int k = kBackward ? kTile - 1 - kk : kk;
        if (t0 + k < T) x[k] = v = (t0 + k == first) ? x[k] : ema_step(v, x[k], a, b);  // [phase: chain]
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        const int k = kBackward ? kTile - 1 - kk : kk;
        x[k] = v = ema_step(v, x[k], a, b);  // [phase: chain]
      }
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) row[k] = x[k];
    __syncwarp();
    const long long t = t0 + lane;
    if (t < T) {
#pragma unroll 8
      for (int j = 0; j < kLanes; ++j) {  // [phase: stores]
        if (b0 + j < F) dst[(long long)(b0 + j) * T + t] = tile[j * kPad + lane];
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncwarp();
}

__global__ void __launch_bounds__(kLanes)
    mask_ema_kernel(const float* __restrict__ mask, float* out, int F, long long T, float a, float b) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  ema_pass<true>(mask, out, smem, F, T, b0, lane, a, b);
  __threadfence_block();
  ema_pass<false>(out, out, smem, F, T, b0, lane, a, b);
}

}  // namespace

extern "C" int mask_ema_launch(const void* mask, void* out, int F, long long T, float a, float b, void* stream) {
  if (F <= 0 || T <= 0) return (int)cudaGetLastError();
  const int blocks = (F + kLanes - 1) / kLanes;
  const size_t smem = (size_t)kDepth * kTileWords * sizeof(float);
  mask_ema_kernel<<<blocks, kLanes, smem, (cudaStream_t)stream>>>((const float*)mask, (float*)out, F, T, a, b);
  return (int)cudaGetLastError();
}
