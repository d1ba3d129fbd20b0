// Windowed frame gather: frames[b, f, j] = x[b, clip(starts[b, f] + j, 0, T-1)] * window[j].
//
// Replaces two TPU kernels of the JAX package's ops/pallas_kernels.py, which
// compute the same function: extract_frames (body _frames_kernel: one DMA of
// each frame's span into VMEM, one multiply by the window) and
// extract_frames_aligned (body _frames_kernel_aligned: 1024-aligned DMAs and
// bit-decomposed lane rotates, shapes Mosaic accepts). The alignment rules
// are Mosaic's and have no counterpart here, so one kernel serves both
// wrappers (ops/frames.py) and frames_op.
//
// Index rule: the reference gather's, clip(start + j, 0, T - 1). On the
// contract domain starts in [0, T - W] every index is in range and all
// three TPU entries agree with it.
//
// What bounds it on the card: bytes. Each output element is written once
// (B*F*W*4 bytes) and x is read about W/hop times over (frames overlap; the
// bound counts each input once). Design: a grid over (frame tile of 8, row
// b); the block stages the window in shared memory once, then for each
// frame of its tile its threads walk the frame's span with consecutive
// threads on consecutive samples (coalesced reads, L2 serves the overlap)
// and write one product each. One multiply, rounded to nearest: equal to
// the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerBlock = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) frames_kernel(const float* __restrict__ x,
                                                          const int* __restrict__ starts,
                                                          const float* __restrict__ window,
                                                          float* __restrict__ out, int T, int F,
                                                          int W) {
  extern __shared__ float win[];
  for (int j = threadIdx.x; j < W; j += kThreads) win[j] = window[j];
  __syncthreads();
  const int b = blockIdx.y;
  const float* xr = x + (long long)b * T;
  const int f0 = blockIdx.x * kFramesPerBlock;
  const int f1 = min(f0 + kFramesPerBlock, F);
  for (int f = f0; f < f1; ++f) {
    const long long start = starts[(long long)b * F + f];
    float* o = out + ((long long)b * F + f) * W;
    for (int j = threadIdx.x; j < W; j += kThreads) {
      long long i = start + j;
      i = i < 0 ? 0 : (i > T - 1 ? T - 1 : i);
      o[j] = __fmul_rn(xr[i], win[j]);
    }
  }
}

}  // namespace

extern "C" int frames_launch(const void* x, const void* starts, const void* window, void* out,
                             int B, int T, int F, int W, void* stream) {
  if (B <= 0 || F <= 0 || W <= 0) return (int)cudaGetLastError();
  const dim3 grid((F + kFramesPerBlock - 1) / kFramesPerBlock, B);
  frames_kernel<<<grid, kThreads, W * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)x, (const int*)starts, (const float*)window, (float*)out, T, F, W);
  return (int)cudaGetLastError();
}
