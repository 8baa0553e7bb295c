// Weight dequantisation for Hopper (sm_90a): codes times their group's
// scale, in one pass.
//
// Replaces no TPU kernel: the reference dequantises with jnp
// (src/repro/quant/quantize.py:126 `dequantize`), which XLA fuses into the
// operand read of the GEMM that consumes it.  Eager PyTorch ran the same
// function as a chain of elementwise ops (an int4 stack: 17 of them,
// about 29 bytes moved an element against the 4.5 that
// QuantizedTensor.nbytes_streamed charges).  This kernel is the one pass
// that the charge counts: codes and scales read once, the copy written
// once (the GEMM then reads it once).
//
// Function: int4 codes packed (R, N) uint8 -- row 2i of the output takes
// the low nibble of code row i, row 2i+1 the high nibble, and a nibble
// >= 8 takes 16 off -- or int8 codes (R, N), with per-group f32 scales
// (R * out_rows_per_code / group, N), to (R * out_rows_per_code, N) in
// bf16, f16 or f32.  Each element is code.to(T) * scale.to(T), rounded
// once in T: an integer of at most 8 bits times a scale already rounded
// to T is exact in f32, so rounding the f32 product once gives the bits
// of PyTorch's multiply in T.  The wrapper flattens leading dims into
// rows: a group never straddles two matrices of a stack, since K is a
// multiple of the group.
//
// What bounds it: bytes.  qwen2-moe-a2.7b's w_gate stack (60, 2048, 1408)
// int4 to bf16 reads 86.5 MB of codes and 5.4 MB of scales and writes
// 346 MB: 0.130 ms at 3.35 TB/s, of which the writes are 79%.  So the
// layout serves the stores: each thread owns the 16 / sizeof(T) columns
// (8 for bf16 and f16, 4 for f32) of one code row whose output fills
// one 16-byte vector, and writes each of its output rows (two for int4)
// with one 16-byte store.  Neighbouring threads take neighbouring
// columns, so one store instruction of a warp writes 512 contiguous
// bytes: whole 32-byte sectors.  (Owning 16 columns, a thread wrote each
// sector in two halves from two store instructions, and an H100 ran the
// stack at 0.16-0.23 ms as the compiler happened to schedule them; at
// 0.155 ms now.)
// Its codes are one 8- or 4-byte load, its scales one or two 16-byte
// loads.  No shared memory, no atomics.  scripts/dequantize_probe.py
// times it against variants of this source.  A width N that is not a
// multiple of the columns, or a pointer not 16-byte aligned, takes the
// same kernel's scalar variant (element loads, a masked ragged tail).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// columns a thread owns: those of one 16-byte vector of output
template <typename T>
__host__ __device__ constexpr int cols() { return 16 / sizeof(T); }

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  // round to nearest even, as Tensor.to does
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half(v));
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half(v);
  }
};

template <int BITS>
__device__ __forceinline__ int code_at(uint8_t c, int half) {
  if (BITS == 8) return static_cast<int>(static_cast<int8_t>(c));
  const int q = (c >> (4 * half)) & 0xF;
  return q >= 8 ? q - 16 : q;
}

// One thread: columns [c0, c0 + cols<T>()) of one code row.  VEC: N a
// multiple of the columns and every pointer 16-byte aligned.
template <typename T, int BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, T* __restrict__ out,
                  long long n_items, int n, int vecs, int code_rows_per_group) {
  constexpr int kCols = cols<T>();
  constexpr int kOut = BITS == 4 ? 2 : 1;   // output rows per code row
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_items) return;
  const int c0 = static_cast<int>(t % vecs) * kCols;
  const long long row = t / vecs;
  const int nc = VEC ? kCols : min(kCols, n - c0);

  const uint8_t* crow = codes + row * n + c0;
  const float* srow = scales + (row / code_rows_per_group) * n + c0;
  alignas(8) uint8_t c[kCols];
  alignas(16) float s[kCols];
  if (VEC) {
    if constexpr (kCols == 8)
      *reinterpret_cast<uint2*>(c) = *reinterpret_cast<const uint2*>(crow);
    else
      *reinterpret_cast<uint32_t*>(c) = *reinterpret_cast<const uint32_t*>(crow);
#pragma unroll
    for (int j = 0; j < kCols; j += 4)
      *reinterpret_cast<float4*>(s + j) = *reinterpret_cast<const float4*>(srow + j);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      c[j] = j < nc ? crow[j] : 0;
      s[j] = j < nc ? srow[j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) s[j] = Cvt<T>::round(s[j]);
#pragma unroll
  for (int h = 0; h < kOut; ++h) {
    alignas(16) T o[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[j] = Cvt<T>::store(static_cast<float>(code_at<BITS>(c[j], h)) * s[j]);
    T* orow = out + (row * kOut + h) * n + c0;
    if (VEC) {
      *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int j = 0; j < nc; ++j) orow[j] = o[j];
    }
  }
}

template <typename T, int BITS>
cudaError_t launch_typed(const void* codes, const void* scales, void* out,
                         long long code_rows, int n, int code_rows_per_group,
                         bool vec, cudaStream_t stream) {
  const int vecs = (n + cols<T>() - 1) / cols<T>();
  const long long n_items = code_rows * vecs;
  if (n_items == 0) return cudaSuccess;
  const long long blocks = (n_items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<T*>(out);
  if (vec)
    dequantize_kernel<T, BITS, true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        c, s, o, n_items, n, vecs, code_rows_per_group);
  else
    dequantize_kernel<T, BITS, false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        c, s, o, n_items, n, vecs, code_rows_per_group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bits(int bits, const void* codes, const void* scales, void* out,
                        long long code_rows, int n, int code_rows_per_group,
                        bool vec, cudaStream_t stream) {
  if (bits == 4)
    return launch_typed<T, 4>(codes, scales, out, code_rows, n, code_rows_per_group,
                              vec, stream);
  return launch_typed<T, 8>(codes, scales, out, code_rows, n, code_rows_per_group,
                            vec, stream);
}

}  // namespace

// codes: (code_rows, n) uint8 (int4 packed) or int8; scales: f32 (groups,
// n); out: (code_rows * (bits == 4 ? 2 : 1), n) in `dtype` (0 f32, 1 bf16,
// 2 f16).  `vec` selects vector accesses (N a multiple of 16 / sizeof(out)
// and 16-byte aligned pointers).  Returns the launch's
// cudaError_t.
extern "C" int dequantize_launch(const void* codes, const void* scales, void* out,
                                 long long code_rows, int n, int bits, int group,
                                 int dtype, int vec, void* stream) {
  if ((bits != 4 && bits != 8) || n <= 0 || group <= 0 || (bits == 4 && group % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int code_rows_per_group = bits == 4 ? group / 2 : group;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_bits<float>(bits, codes, scales, out, code_rows, n,
                               code_rows_per_group, vec != 0, st);
      break;
    case 1:
      err = launch_bits<__nv_bfloat16>(bits, codes, scales, out, code_rows, n,
                                       code_rows_per_group, vec != 0, st);
      break;
    case 2:
      err = launch_bits<__half>(bits, codes, scales, out, code_rows, n,
                                code_rows_per_group, vec != 0, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
