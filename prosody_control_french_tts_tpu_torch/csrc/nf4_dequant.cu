// NF4 dequantization of a frozen base kernel: packed codes [in/2, out]
// (uint8, rows 2i and 2i+1 in the low and high nibble of byte i) and block
// scales [in/64, out] (float32) -> the kernel [in, out] in bfloat16 or
// float32.
//
// Replaces no TPU kernel: the JAX package's models/quant.py:dequant_nf4 is
// XLA code. In the port it runs on every use of a quantized base kernel
// (models/lora.py: the forward, the remat recompute and the backward of each
// projection), so a QLoRA micro-step calls it three times a kernel.
//
// What it computes: out[2i + h, c] = level[code] * scale[(2i) / 64, c], code
// the low (h = 0) or high (h = 1) nibble of packed[i, c], level the 16 NF4
// levels (models/quant.py:NF4_TABLE, read from the card). The product is
// rounded once to float32 (__fmul_rn) and, for bfloat16, once more to
// nearest even: the plain PyTorch version (ops/nf4_dequant.py:
// nf4_dequant_plain, a float32 product then .to(bfloat16)) gives the same
// bits.
//
// What bounds it on the card: bytes. It reads half a byte of code and a
// sixteenth of a float32 scale a weight and writes 2 bytes (bfloat16):
// 2.5625 bytes a weight at 3.35 TB/s, a few operations a weight. Design: a
// streaming kernel. The 16 levels sit in shared memory (16 words in 16
// banks: a warp's lookups never conflict). A thread owns 16 bytes of output
// a row, 8 adjacent columns in bfloat16 (4 in float32), of one 64-row scale
// block, and `rows` (at most 4) of its 32 packed rows: it loads its scales
// into registers, then the codes of its rows (8 bytes a row; 4), all before
// any is converted, so that they are in flight together, then one 16-byte
// store per output row (rows 2i and 2i+1). Neighbouring threads take
// neighbouring columns, so each store of a warp writes 512 contiguous bytes
// (a thread owning 16 columns, two strided stores a row, reached half the
// byte rate on the card) and each load reads 256 (128). A block's 32 packed
// rows are split over 8 threads, 4 rows each, more where the grid would
// otherwise have fewer thread blocks than the card has SMs
// (ops/nf4_dequant.py:plan; on the card 4 rows a thread was within 2 % of
// the best split at every shape of stage B, 16 rows up to 6 % slower). A
// column count that is not a multiple of the thread's columns (or an input
// not 16-byte aligned) takes a scalar path with the ragged edge masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;               // rows of a scale block
constexpr int kPackedRows = kBlock / 2;  // packed rows of a scale block
constexpr int kThreads = 256;            // threads of a thread block
constexpr int kMaxRows = 4;              // packed rows of a thread at most: split >= 8

template <typename T>
struct Cols {
  static constexpr int n = 16 / sizeof(T);  // columns of a thread: 16 bytes of output a row
  static constexpr int words = n / 4;       // 32-bit words of codes a packed row
};

__device__ __forceinline__ float level_at(const float* levels, uint32_t byte_offset) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(levels) + byte_offset);
}

template <int kWords>
__device__ __forceinline__ void load_codes(const uint8_t* p, uint32_t (&w)[kWords]) {
  if constexpr (kWords == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  // round to nearest even, each value on its own; the lower column in the low half
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// One packed row of a thread's columns: the codes `w` (column 4q + k in byte
// k of word q) against the scales `sc`, one 16-byte store to output row
// `lo_row` (low nibbles) and one to `hi_row` (high nibbles).
template <typename T>
__device__ __forceinline__ void row_vec(const float* levels, const uint32_t (&w)[Cols<T>::words],
                                        const float (&sc)[Cols<T>::n], T* lo_row, T* hi_row) {
  constexpr int n = Cols<T>::n;
  float lo[n], hi[n];
#pragma unroll
  for (int q = 0; q < Cols<T>::words; ++q) {
    // each byte's low and high nibble as a byte offset into the levels
    const uint32_t lo_off = (w[q] & 0x0f0f0f0fu) << 2;
    const uint32_t hi_off = (w[q] >> 2) & 0x3c3c3c3cu;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * q + k;
      lo[c] = __fmul_rn(level_at(levels, (lo_off >> (8 * k)) & 0xffu), sc[c]);
      hi[c] = __fmul_rn(level_at(levels, (hi_off >> (8 * k)) & 0xffu), sc[c]);
    }
  }
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(lo_row) =
        make_uint4(bf16_pair(lo[0], lo[1]), bf16_pair(lo[2], lo[3]), bf16_pair(lo[4], lo[5]), bf16_pair(lo[6], lo[7]));
    *reinterpret_cast<uint4*>(hi_row) =
        make_uint4(bf16_pair(hi[0], hi[1]), bf16_pair(hi[2], hi[3]), bf16_pair(hi[4], hi[5]), bf16_pair(hi[6], hi[7]));
  } else {
    *reinterpret_cast<float4*>(lo_row) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<float4*>(hi_row) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Thread t takes column group g = t % groups, then share s = (t / groups) %
// split of scale block b = t / (groups * split): packed rows 32 b + s rows ..
// + rows - 1 (rows = 32 / split), columns n g .. n g + n - 1 (fewer at the
// ragged edge), n = Cols<T>::n. tests/test_torch_kernels.py:nf4_cover
// writes this mapping out for the CPU tests.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    nf4_dequant_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                       const float* __restrict__ table, T* __restrict__ out, int out_f, int groups, int split, int rows,
                       long long threads) {
  constexpr int n = Cols<T>::n;
  __shared__ float levels[16];
  if (threadIdx.x < 16) levels[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const int g = (int)(t % groups);
  const long long rest = t / groups;
  const int s = (int)(rest % split);
  const long long b = rest / split;
  const int c0 = g * n;
  const long long p0 = b * kPackedRows + (long long)s * rows;  // the thread's first packed row

  if (kVec) {
    float sc[n];
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + b * out_f + c0) + q);
      sc[4 * q] = v.x, sc[4 * q + 1] = v.y, sc[4 * q + 2] = v.z, sc[4 * q + 3] = v.w;
    }
    uint32_t codes[kMaxRows][Cols<T>::words];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < rows) load_codes(packed + (p0 + r) * out_f + c0, codes[r]);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const size_t lo = (size_t)(2 * (p0 + r)) * out_f + c0;
        row_vec<T>(levels, codes[r], sc, out + lo, out + lo + out_f);
      }
    }
  } else {
    const int ncols = min(n, out_f - c0);
    for (int j = 0; j < ncols; ++j) {
      const float sc = scale[b * out_f + c0 + j];
      for (int r = 0; r < rows; ++r) {
        const long long p = p0 + r;
        const uint32_t byte = packed[p * out_f + c0 + j];
        const size_t lo = (size_t)(2 * p) * out_f + c0 + j;
        store(out + lo, __fmul_rn(levels[byte & 0xfu], sc));
        store(out + lo + out_f, __fmul_rn(levels[byte >> 4], sc));
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* packed, const void* scale, const void* table, void* out, int in_f, int out_f, int split,
           cudaStream_t stream) {
  constexpr int n = Cols<T>::n;
  const int groups = (out_f + n - 1) / n;
  const long long threads = (long long)groups * (in_f / kBlock) * split;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto* p = (const uint8_t*)packed;
  const auto* s = (const float*)scale;
  const auto* tb = (const float*)table;
  const int rows = kPackedRows / split;
  if (out_f % n == 0 && aligned16(packed) && aligned16(scale) && aligned16(out))
    nf4_dequant_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(p, s, tb, (T*)out, out_f, groups, split,
                                                                          rows, threads);
  else
    nf4_dequant_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(p, s, tb, (T*)out, out_f, groups, split,
                                                                           rows, threads);
  return (int)cudaGetLastError();
}

}  // namespace

// packed [in/2, out] uint8, scale [in/64, out] float32, table [16] float32,
// out [in, out] (bfloat16 if bf16, else float32), all contiguous; split
// (threads a block's 32 packed rows) 8, 16 or 32. Returns cudaGetLastError().
extern "C" int nf4_dequant_launch(const void* packed, const void* scale, const void* table, void* out, int in_f,
                                  int out_f, int split, int bf16, void* stream) {
  if (in_f <= 0 || out_f <= 0) return (int)cudaGetLastError();
  if (in_f % kBlock || (split != 8 && split != 16 && split != 32)) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(packed, scale, table, out, in_f, out_f, split, (cudaStream_t)stream)
              : launch<float>(packed, scale, table, out, in_f, out_f, split, (cudaStream_t)stream);
}
