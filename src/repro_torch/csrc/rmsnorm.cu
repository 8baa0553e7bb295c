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
// launch and one memory round trip.  The TPU kernel keeps a (256, D) row
// block in VMEM.  Here a group of `warps_per_row` warps owns one row at a
// time and holds it in registers from its one read: each lane C 16-byte
// chunks, neighbouring lanes on neighbouring chunks, so y needs no second
// pass over x.  A group of one warp reduces the sum of squares by
// shuffles alone; a larger group adds its warps' sums in one
// shared-memory step at a barrier of its own (two slots by row parity, so
// one barrier a row): every warp reads them all at once and adds them by
// shuffles, in the same order.  Each lane loads its chunks of w once.  A
// block holds `rows_per_block` groups and walks rows `grid *
// rows_per_block` apart; a group issues its next row's loads before it
// reduces the current one.  The plan (warps per row, rows per block, C, grid) is the
// wrapper's (`norm_plan` in kernels/rmsnorm/ops.py) and is only checked
// here: decode rows (fewer rows than SMs) spread over enough warps that
// every chunk has a lane, a prompt's rows over a few warps each.  Rows
// are addressed through a row stride, so a strided slice (x[:, -1:] of a
// batch) is read in place.  Widths, row strides and pointers must be
// 16-byte aligned: every configured width is a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;   // 16-byte chunks of a row a lane holds

// Threads a block may have at C chunks a lane: each lane holds 3 x C
// 16-byte registers (this row, the next, w).  norm_plan keeps to it.
__host__ __device__ constexpr int max_threads(int C) {
  return C <= 2 ? 1024 : (C <= 4 ? 512 : 256);
}

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

__device__ __forceinline__ uint4 ld_row(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st_row(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) from_f(e + i, f[i]);
  return raw;
}

// Barrier `id` of the `threads` threads of one row group.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// blockDim.x = 32 * warps_per_row * rows_per_block; chunks C cover the
// row: C * 32 * warps_per_row >= D / V.
template <typename T, int C>
__global__ void __launch_bounds__(max_threads(C)) rmsnorm_kernel(
    const T* __restrict__ x, long long x_stride, const T* __restrict__ w,
    T* __restrict__ y, int R, int D, int warps_per_row, int rows_per_block,
    float eps) {
  constexpr int V = Vec<T>::n;
  __shared__ float part[2][32];   // the warps' sums of squares, by row parity
  const int nvec = D / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / warps_per_row;
  const int span = warps_per_row * 32;                 // lanes of a row
  const int lo = (warp % warps_per_row) * 32 + lane;   // the lane's first chunk
  const int step = gridDim.x * rows_per_block;
  int r = blockIdx.x * rows_per_block + group;

  uint4 xv[C], wv[C];
  if (r < R) {
    const T* xr = x + (size_t)r * x_stride;
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (lo + j * span < nvec) xv[j] = ld_row(xr + (size_t)(lo + j * span) * V);
  }
  if (w != nullptr) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (lo + j * span < nvec) wv[j] = ld_row(w + (size_t)(lo + j * span) * V);
  }
  int parity = 0;
  for (; r < R; r += step) {
    const T* xr = x + (size_t)r * x_stride;
    T* yr = y + (size_t)r * D;
    uint4 xn[C];   // the next row, in flight while this one is reduced
    if (r + step < R) {
      const T* xnr = x + (size_t)(r + step) * x_stride;
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (lo + j * span < nvec) xn[j] = ld_row(xnr + (size_t)(lo + j * span) * V);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lo + j * span < nvec) {
        float f[V];
        unpack<T>(xv[j], f);
#pragma unroll
        for (int k = 0; k < V; ++k) ss += f[k] * f[k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (warps_per_row > 1) {   // one shared-memory step between the row's warps
      if (lane == 0) part[parity][warp] = ss;
      group_sync(1 + group, span);
      ss = lane < warps_per_row ? part[parity][group * warps_per_row + lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      parity ^= 1;
    }
    // the row's sum of squares is in
    const float rr = 1.f / sqrtf(ss / (float)D + eps);
    // scale the row held in registers
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = lo + j * span;
      if (i < nvec) {
        float f[V], o[V];
        unpack<T>(xv[j], f);
        if (w != nullptr) {
          float fw[V];
          unpack<T>(wv[j], fw);
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = (f[k] * rr) * fw[k];
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = f[k] * rr;
        }
        st_row(yr + (size_t)i * V, pack<T>(o));
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) xv[j] = xn[j];
  }   // rows
}

template <typename T, int C>
int launch_c(const void* x, long long x_stride, const void* w, void* y, int R,
             int D, float eps, int warps_per_row, int rows_per_block,
             int grid, cudaStream_t st) {
  rmsnorm_kernel<T, C><<<grid, 32 * warps_per_row * rows_per_block, 0, st>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(w),
      static_cast<T*>(y), R, D, warps_per_row, rows_per_block, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, long long x_stride, const void* w, void* y, int R,
           int D, float eps, int warps_per_row, int rows_per_block,
           int chunks, int grid, cudaStream_t st) {
  constexpr int V = Vec<T>::n;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (D % V || x_stride % V || misaligned(x) || misaligned(y) ||
      (w != nullptr && misaligned(w)))
    return (int)cudaErrorInvalidValue;
  const long long threads = 32LL * warps_per_row * rows_per_block;
  if (chunks < 1 || chunks > kMaxChunks || warps_per_row < 1 ||
      rows_per_block < 1 || grid < 1 || threads > max_threads(chunks) ||
      (warps_per_row > 1 && rows_per_block > 15) ||   // barriers 1..15
      32LL * warps_per_row * chunks < D / V)
    return (int)cudaErrorInvalidValue;
#define NORM_LAUNCH(C)                                                   \
  case C:                                                                \
    return launch_c<T, C>(x, x_stride, w, y, R, D, eps, warps_per_row,   \
                          rows_per_block, grid, st)
  switch (chunks) {
    NORM_LAUNCH(1);
    NORM_LAUNCH(2);
    NORM_LAUNCH(3);
    NORM_LAUNCH(4);
    NORM_LAUNCH(5);
    NORM_LAUNCH(6);
    NORM_LAUNCH(7);
    NORM_LAUNCH(8);
  }
#undef NORM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: R rows of D elements, row r at x + r * x_stride (elements); y: R x D
// contiguous; w: D elements or null.  D and x_stride must be multiples of
// 16 / sizeof(T) and x, w, y 16-byte aligned.  The plan (norm_plan):
// warps_per_row warps own a row, rows_per_block rows a block, each lane
// `chunks` 16-byte chunks of its row, `grid` blocks.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, long long x_stride,
                              const void* w, void* y, int R, int D,
                              float eps, int is_bf16, int warps_per_row,
                              int rows_per_block, int chunks, int grid,
                              void* stream) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, x_stride, w, y, R, D, eps, warps_per_row,
                                 rows_per_block, chunks, grid, st);
  return launch<float>(x, x_stride, w, y, R, D, eps, warps_per_row,
                       rows_per_block, chunks, grid, st);
}

// ---------------------------------------------------------------- backward
//
// The gradient of the RMSNorm above (port-only: the TPU reference has no
// backward kernel, JAX differentiates its jnp RMSNorm).  For x (R, D),
// dy (R, D) and w (D,) or null, with the math in f32:
//
//   r  = rsqrt(mean(x^2) + eps)                     per row, from x
//   g  = dy * w  (dy when w is null)
//   dx = r g - x r^3 mean(g x)                      rounded once to T
//   dw = sum over rows of dy x r                    f32, then T
//
// What bounds it: bytes (x and dy read once, dx written once: 3 R D
// elements; dw and its partials are D-sized per block).  The rows are
// the forward's: a block of `warps` warps owns one row at a time and
// holds it in registers from its one read (each lane C 16-byte chunks of
// x, of dy and of w, neighbouring lanes on neighbouring chunks), reduces
// the row's two sums (x^2 and g x) by shuffles and one shared-memory step
// between the warps, and writes dx from the registers.  r is recomputed
// from x: no statistics are saved by the forward.  Block b walks rows b,
// b + grid, ... and keeps its part of dw in registers, in row order; it
// writes that part as row b of an f32 (grid, D) buffer.  A second kernel
// adds the grid parts of each column in a fixed order.  No atomics: two
// calls, and a graph replay, give the same bits.

namespace {

constexpr int kBwdMaxChunks = 4;   // 16-byte chunks of a row a lane holds
constexpr int kBwdMaxWarps = 16;   // warps of a row (512 threads)
constexpr int kReduceRows = 16;    // threadIdx.y of the dw reduction

template <typename T, int C>
__global__ void __launch_bounds__(32 * kBwdMaxWarps) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ w, T* __restrict__ dx, float* __restrict__ dw_part,
    int R, int D, float eps) {
  constexpr int V = Vec<T>::n;
  __shared__ float2 part[kBwdMaxWarps];   // the warps' (sum x^2, sum g x)
  const int nvec = D / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int span = blockDim.x;            // lanes of a row
  const int lo = threadIdx.x;             // the lane's first chunk

  uint4 wv[C];
  float acc[C][V];                        // this block's part of dw
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (w != nullptr && lo + j * span < nvec)
      wv[j] = ld_row(w + (size_t)(lo + j * span) * V);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
  }
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * D;
    const T* dyr = dy + (size_t)r * D;
    uint4 xv[C], dv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lo + j * span < nvec) {
        xv[j] = ld_row(xr + (size_t)(lo + j * span) * V);
        dv[j] = ld_row(dyr + (size_t)(lo + j * span) * V);
      }
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lo + j * span < nvec) {
        float f[V], d[V];
        unpack<T>(xv[j], f);
        unpack<T>(dv[j], d);
        if (w != nullptr) {
          float fw[V];
          unpack<T>(wv[j], fw);
#pragma unroll
          for (int k = 0; k < V; ++k) d[k] *= fw[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          ss += f[k] * f[k];
          sgx += d[k] * f[k];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if (warps > 1) {   // one shared-memory step between the row's warps
      if (lane == 0) part[warp] = make_float2(ss, sgx);
      __syncthreads();
      const float2 p = lane < warps ? part[lane] : make_float2(0.f, 0.f);
      ss = p.x;
      sgx = p.y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
      }
      __syncthreads();   // every warp has read part before the next row
    }
    const float rr = 1.f / sqrtf(ss / (float)D + eps);
    const float c = rr * rr * rr * (sgx / (float)D);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = lo + j * span;
      if (i < nvec) {
        float f[V], d[V], o[V];
        unpack<T>(xv[j], f);
        unpack<T>(dv[j], d);
        if (w != nullptr) {
          float fw[V];
          unpack<T>(wv[j], fw);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            o[k] = rr * (d[k] * fw[k]) - f[k] * c;
            acc[j][k] += d[k] * f[k] * rr;
          }
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = rr * d[k] - f[k] * c;
        }
        st_row(dx + (size_t)r * D + (size_t)i * V, pack<T>(o));
      }
    }
  }   // rows
  if (w != nullptr) {
    float* dst = dw_part + (size_t)blockIdx.x * D;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = lo + j * span;
      if (i < nvec) {
#pragma unroll
        for (int k = 0; k < V; k += 4)
          *reinterpret_cast<float4*>(dst + (size_t)i * V + k) =
              make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2], acc[j][k + 3]);
      }
    }
  }
}

// dw[j] = sum over p of part[p][j], p in a fixed order: thread (tx, ty)
// of a (32, kReduceRows) block adds p = ty, ty + kReduceRows, ... of
// column blockIdx.x * 32 + tx, then the kReduceRows sums are added in ty
// order.
template <typename T>
__global__ void __launch_bounds__(32 * kReduceRows) rmsnorm_dw_reduce(
    const float* __restrict__ part, int P, int D, T* __restrict__ dw) {
  __shared__ float sums[kReduceRows][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (j < D) {
#pragma unroll 4
    for (int p = ty; p < P; p += kReduceRows) s += part[(size_t)p * D + j];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < D) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kReduceRows; ++q) t += sums[q][tx];
    from_f(dw + j, t);
  }
}

template <typename T, int C>
int launch_bwd_c(const void* x, const void* dy, const void* w, void* dx,
                 void* dw, float* dw_part, int R, int D, float eps,
                 int warps, int grid, cudaStream_t st) {
  rmsnorm_bwd_kernel<T, C><<<grid, 32 * warps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(w), static_cast<T*>(dx), dw_part, R, D, eps);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || w == nullptr) return rc;
  rmsnorm_dw_reduce<T><<<(D + 31) / 32, dim3(32, kReduceRows), 0, st>>>(
      dw_part, grid, D, static_cast<T*>(dw));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* w, void* dx,
               void* dw, void* dw_part, int R, int D, float eps, int warps,
               int chunks, int grid, cudaStream_t st) {
  constexpr int V = Vec<T>::n;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (D % V || misaligned(x) || misaligned(dy) || misaligned(dx))
    return (int)cudaErrorInvalidValue;
  if (w != nullptr && (dw == nullptr || dw_part == nullptr || misaligned(w) ||
                       misaligned(dw_part)))
    return (int)cudaErrorInvalidValue;
  if (chunks < 1 || chunks > kBwdMaxChunks || warps < 1 ||
      warps > kBwdMaxWarps || grid < 1 || 32LL * warps * chunks < D / V)
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(dw_part);
#define NORM_BWD_LAUNCH(C)                                                   \
  case C:                                                                    \
    return launch_bwd_c<T, C>(x, dy, w, dx, dw, part, R, D, eps, warps, grid, \
                              st)
  switch (chunks) {
    NORM_BWD_LAUNCH(1);
    NORM_BWD_LAUNCH(2);
    NORM_BWD_LAUNCH(3);
    NORM_BWD_LAUNCH(4);
  }
#undef NORM_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: R x D contiguous; w, dw: D elements or both null; dw_part: an
// f32 (grid, D) scratch buffer when w is given (the blocks' parts of dw).
// D must be a multiple of 16 / sizeof(T) and every pointer 16-byte
// aligned.  The plan (bwd_plan in kernels/rmsnorm/ops.py): `warps` warps
// own a row, each lane `chunks` 16-byte chunks of it, `grid` blocks.
// Launches on `stream` (two kernels when w is given); returns the
// cudaError_t of the launches.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* w, void* dx, void* dw,
                                  void* dw_part, int R, int D, float eps,
                                  int is_bf16, int warps, int chunks,
                                  int grid, void* stream) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, w, dx, dw, dw_part, R, D, eps,
                                     warps, chunks, grid, st);
  return launch_bwd<float>(x, dy, w, dx, dw, dw_part, R, D, eps, warps,
                           chunks, grid, st);
}
