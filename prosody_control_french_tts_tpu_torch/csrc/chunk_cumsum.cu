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
// block of 1024 threads per (row, chunk), one column per thread; each step
// goes through shared memory because its shift crosses warp boundaries for
// the lanes below it (a warp-local shuffle scan would be another
// association). The running values alternate between two shared buffers, so
// one barrier per step suffices.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kChunk) chunk_cumsum_kernel(const float* __restrict__ x,
                                                                float* __restrict__ out,
                                                                long long C) {
  __shared__ float buf[2][kChunk];
  const int c = threadIdx.x;
  const long long base = (long long)blockIdx.y * C + (long long)blockIdx.x * kChunk;
  const float v = x[base + c];
  float acc = v;
  int step = 0;
  for (int s = 1; s < kChunk; s <<= 1, ++step) {
    float* b = buf[step & 1];
    b[c] = acc;
    __syncthreads();
    acc = __fadd_rn(acc, c >= s ? b[c - s] : 0.0f);
  }
  out[base + c] = __fsub_rn(acc, v);
}

}  // namespace

extern "C" int chunk_cumsum_launch(const void* x, void* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  const dim3 grid(C / kChunk, R);
  chunk_cumsum_kernel<<<grid, kChunk, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                                  (long long)C);
  return (int)cudaGetLastError();
}
