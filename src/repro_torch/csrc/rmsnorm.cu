// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py::
// rmsnorm_pallas (body `_kernel`).  Same function: x (R, D) bf16 or f32,
// y = x * rsqrt(mean(x^2) + eps) * w with the sum of squares and the
// products in f32, the result rounded once to x's dtype (round to
// nearest even).  w may be null: the non-parametric variant (OLMo).
//
// What bounds it: bytes.  Every element is read once and written once
// (a prefill of 2048 x 3584 bf16 moves 29.4 MB, 8.8 us at 3.35 TB/s); a
// decode row (R = 1, D = 2560 bf16 moves about 15 kB) is bound by the
// launch.  The TPU kernel keeps a (256, D) row block in VMEM; here one
// block owns one row, each thread reading 16 bytes at a time with
// neighbouring threads on neighbouring addresses, so a decode row is in
// flight after one load per thread.  The block reduces the sum of squares
// with warp shuffles and one shared-memory step, then makes a second pass
// over the row, which a row of at most 20 kB finds in L1.  Rows are
// addressed through a row stride, so a strided slice (x[:, -1:] of a
// batch) is read in place.  Widths, row strides and pointers must be
// 16-byte aligned: every configured width is a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;   // elements in one 16-byte load
template <>
struct Vec<float> { static constexpr int n = 4; };
template <>
struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as Tensor.to does
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(e + i, in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// One block: row blockIdx.x.  blockDim.x is a multiple of 32, at most 1024.
template <typename T, int V>
__global__ void rmsnorm_kernel(const T* __restrict__ x, long long x_stride,
                               const T* __restrict__ w, T* __restrict__ y,
                               int D, float eps) {
  __shared__ float warp_sums[32];
  __shared__ float inv_rms;
  const T* xr = x + (size_t)blockIdx.x * x_stride;
  T* yr = y + (size_t)blockIdx.x * D;
  const int nvec = D / V;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float ss = 0.f;
  for (int i = tid; i < nvec; i += blockDim.x) {
    float f[V];
    load<T, V>(xr + (size_t)i * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += f[j] * f[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)(blockDim.x / 32) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inv_rms = 1.f / sqrtf(s / (float)D + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int i = tid; i < nvec; i += blockDim.x) {
    float f[V], o[V];
    load<T, V>(xr + (size_t)i * V, f);
    if (w != nullptr) {
      float fw[V];
      load<T, V>(w + (size_t)i * V, fw);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = (f[j] * r) * fw[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = f[j] * r;
    }
    store<T, V>(yr + (size_t)i * V, o);
  }
}

template <typename T>
int launch(const void* x, long long x_stride, const void* w, void* y, int R,
           int D, float eps, cudaStream_t st) {
  constexpr int V = Vec<T>::n;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (D % V || x_stride % V || misaligned(x) || misaligned(y) ||
      (w != nullptr && misaligned(w)))
    return (int)cudaErrorInvalidValue;
  const int nvec = D / V;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T, V><<<R, threads, 0, st>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(w),
      static_cast<T*>(y), D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: R rows of D elements, row r at x + r * x_stride (elements); y: R x D
// contiguous; w: D elements or null.  D and x_stride must be multiples of
// 16 / sizeof(T) and x, w, y 16-byte aligned.  Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, long long x_stride,
                              const void* w, void* y, int R, int D,
                              float eps, int is_bf16, void* stream) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, x_stride, w, y, R, D, eps, st);
  return launch<float>(x, x_stride, w, y, R, D, eps, st);
}
