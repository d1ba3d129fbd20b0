// Exclusive prefix sums within each 1024-column chunk of x [R, C] (float32).
//
// Replaces the TPU kernel ops/pallas_kernels.py of the JAX package:
// chunk_cumsum (body _chunk_cumsum_kernel), the inner stage of
// ops/cumsum.ChunkedCumsum written as a Pallas kernel over [8, 1024] tiles.
//
// What it computes: out[r, c] = sum of x[r, c0 .. c-1] where c0 is the first
// column of c's 1024-column chunk, with the TPU kernel's association: a
// Hillis-Steele ladder of 10 steps, step s (1, 2, 4, ..., 512) adding to
// every column c >= s of the chunk the running value at column c - s (and
// 0.0 below s), then subtracting x. The plain PyTorch version
// (ops/chunk_cumsum.py:chunk_cumsum_plain) runs the same ladder, and with
// round-to-nearest adds (--fmad=false, __fadd_rn) the two agree bit for bit.
//
// What bounds it on the card: bytes. It reads x once and writes out once
// (8 bytes per element); the ladder does 10 adds per element. Design: one
// warp per chunk, the whole chunk in registers, no shared memory and no
// barrier. Lane l holds columns c = l + 32 j in register j (j < 32), so each
// of the 32 loads and stores of a lane is one coalesced 128-byte access of
// the warp. A step s = 32 t >= 32 adds register j - t of the same lane: no
// data moves. A step s < 32 is one shuffle per register from lane (l - s)
// mod 32: the source lane m sends register j if m < 32 - s and register
// j - 1 otherwise (column m + 32 (j - 1) is c - s for the lanes l < s).
// Registers are updated from j = 31 down, so every add reads the previous
// step's values: each add keeps the ladder's operand pair acc[c] + acc[c - s],
// and columns c < s add 0.0, as in the plain version. The lines marked
// // [phase: ...] are cut by tools/chunk_cumsum_phases.py to split the time.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kWarp = 32;
constexpr int kPerLane = kChunk / kWarp;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    chunk_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out, long long chunks) {
  const long long chunk = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (chunk >= chunks) return;  // the whole warp: no block barrier follows
  const int lane = threadIdx.x % kWarp;
  // x is [R, C] contiguous with C % 1024 == 0: chunk i starts at 1024 i
  const float* xc = x + chunk * kChunk + lane;
  float* oc = out + chunk * kChunk + lane;

  float v[kPerLane], acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] = __ldg(xc + kWarp * j);
    acc[j] = v[j];
  }
  // steps 1, 2, 4, 8, 16: one shuffle per register
#pragma unroll
  for (int b = 0; b < 5; ++b) {  // [phase: shuffle steps]
    const int s = 1 << b;
#pragma unroll
    for (int j = kPerLane - 1; j >= 0; --j) {
      const float send = lane < kWarp - s ? acc[j] : acc[j > 0 ? j - 1 : 0];
      const float got = __shfl_sync(kFull, send, (lane - s) & (kWarp - 1));
      acc[j] = __fadd_rn(acc[j], (j == 0 && lane < s) ? 0.0f : got);
    }
  }
  // steps 32, 64, ..., 512: register j - t of the same lane, t = s / 32
#pragma unroll
  for (int b = 0; b < 5; ++b) {  // [phase: register steps]
    const int t = 1 << b;
#pragma unroll
    for (int j = kPerLane - 1; j >= 0; --j) acc[j] = __fadd_rn(acc[j], j >= t ? acc[j >= t ? j - t : 0] : 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) oc[kWarp * j] = __fsub_rn(acc[j], v[j]);
}

}  // namespace

extern "C" int chunk_cumsum_launch(const void* x, void* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  const long long chunks = (long long)R * (C / kChunk);
  const long long blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  chunk_cumsum_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, chunks);
  return (int)cudaGetLastError();
}
