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
// What bounds it: bytes.  x and dy are read once and dx is written once:
// 3 R D elements, 25.2 MB at R = D = 2048 bf16 (7.5 us at 3.35 TB/s).
// With w the dw scratch adds 2 P D f32 (P = grid / cluster: 0.49 MB at
// that shape, 2%), and every group reads w, D elements, from L1 each
// row.  One launch, no atomic on a value.
//
// The plan is the wrapper's (`bwd_plan` / `card_bwd_plan` in
// kernels/rmsnorm/ops.py) and is only checked here.  Rows: a group of
// `warps` warps owns one row at a time, each lane C 16-byte chunks of x
// and of dy (neighbouring lanes on neighbouring chunks; 2 where 8 warps
// allow it, up to D 4096 bf16), a block of at most kBwdThreads threads
// holds `groups` groups and walks rows grid * groups apart, and a group
// issues its next row's loads before it reduces the current one: two
// rows of every group in flight (64 KB an SM at D 2048 bf16) and no block
// barrier between a row's loads and the next row's.  x and dy are read
// past L1 (each once), which keeps w there.  The two sums (x^2 and g x)
// reduce by shuffles and, with several warps, one shared-memory step at
// the group's own named barrier (two slots by row parity: one barrier a
// row).  dx is written from the registers; r is recomputed from x (the
// forward saves no statistics).  Each lane keeps its chunks' part of dw
// in f32 registers, adding its rows in order.
//
// dw: the blocks run in clusters of `cluster`, and block k of a cluster
// owns slice k of the columns.  Each group pushes every column of its
// part to the block that owns it (st.async into that block's shared
// memory, counted by its mbarrier: no barrier of the whole cluster and
// no fence behind the dx stores); the owner waits for the cluster's
// parts, adds them in (rank, group) order and writes the sum as row p
// (the cluster's index) of an f32 (P, D) scratch.  It then takes a
// ticket of slice k (an acq_rel atomic add after the block's barrier, the
// only atomic); the block that takes the last of slice k's P tickets adds
// the slice's P rows in a fixed order (thread sets over rows p = j mod
// sets, then the sets in j order), writes dw and puts the ticket back to
// 0, so each launch leaves the tickets as it found them.  Up to `cluster`
// blocks add the slices at once.  Repeated calls and graph replays give
// the same bits.  The tickets are the wrapper's, one set per device:
// calls on one device run in one stream order.  Widths: D up to 32 x 8
// lanes x 8 chunks of 16 bytes (16384 bf16, 8192 f32), a multiple of 16
// bytes.  scripts/ssd_rmsnorm_probe.py --only rmsnorm_bwd times it, its
// plans and ablations (PERF.md, row 5b).

namespace {

constexpr int kBwdThreads = 256;    // most threads of a backward block
constexpr int kBwdMaxChunks = 8;    // 16-byte chunks of a row a lane holds
constexpr int kBwdMaxCluster = 8;   // blocks of a cluster: the tickets
constexpr int kFinalBatch = 8;      // scratch rows a thread of a last block loads at once

// Blocks an SM the registers must allow at C chunks a lane: a lane
// holds 4 C 16-byte registers (this row's and the next row's x and dy)
// and C x V f32 of dw.
__host__ __device__ constexpr int bwd_min_blocks(int C) { return C <= 4 ? 2 : 1; }
// The most dynamic shared memory a launch asks for: the cluster's groups'
// parts of a block's slice, groups x (D / 4 + cluster) float4, with
// groups x D <= 32 x 8 warps x C x V.
template <typename T>
constexpr int bwd_max_smem(int C) {
  return (kBwdThreads * C * (int)Vec<T>::n + 4 * kBwdMaxCluster * kBwdThreads / 32) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "BWD_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra BWD_WAIT;\n\t}"
      ::"r"(smem_addr(bar)), "r"(phase) : "memory");
}
// v into the shared memory of block `rank` of this cluster at the place of
// `dst` there, counted by that block's mbarrier at the place of `bar`.
__device__ __forceinline__ void push4(float4* dst, unsigned long long* bar, unsigned rank,
                                      float4 v) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(d), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b) : "memory");
}
// x and dy are read once: past L1, where no line is allocated for them
__device__ __forceinline__ uint4 ld_once(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void st_dw(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st_dw(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);   // round to nearest even
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<unsigned*>(&a),
                                            *reinterpret_cast<unsigned*>(&b));
}

// blockDim.x = 32 * warps * groups; chunks C cover the row: C * 32 *
// warps >= D / V; gridDim.x a multiple of the cluster's blocks.  With w:
// dynamic shared memory of cluster * groups * ceil(D / 4 / cluster)
// float4, dw_part (P, D) f32 and tickets[cluster] int32, all 0.
template <typename T, int C>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks(C)) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
    T* __restrict__ dx, float* dw_part, int* tickets, T* __restrict__ dw, int R, int D,
    int warps, float eps) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float4 recv[];                // with w: (cluster, groups, per): the
                                                  // parts of this block's slice of dw
  __shared__ float2 part[2][kBwdThreads / 32];    // the warps' (sum x^2, sum g x), by row parity
  __shared__ float4 sets_s[kBwdThreads];          // the last block's thread sets
  __shared__ __align__(8) unsigned long long bar; // counts the parts pushed here
  __shared__ int last_s;
  const int nvec = D / V;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = blockDim.x / (32 * warps);
  const int group = warp / warps;
  const int span = warps * 32;                    // lanes of a row
  const int lo = (warp % warps) * 32 + lane;      // the lane's first chunk
  const int step = gridDim.x * groups;
  int r = blockIdx.x * groups + group;
  const int Q = D / 4;                            // float4 columns of a row
  const unsigned rank = cluster_rank(), ncl = cluster_blocks();
  const int per = (Q + (int)ncl - 1) / (int)ncl;  // columns of a slice
  const int q0 = min(Q, (int)rank * per), q1 = min(Q, q0 + per);

  float acc[C][V];                                // this lane's part of dw
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
  uint4 xv[C], dv[C];
  if (r < R) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lo + j * span < nvec) {
        xv[j] = ld_once(x + (size_t)r * D + (size_t)(lo + j * span) * V);
        dv[j] = ld_once(dy + (size_t)r * D + (size_t)(lo + j * span) * V);
      }
    }
  }
  if (w != nullptr) {   // this block's mbarrier, before any block pushes to it
    if (tid == 0) {
      mbar_init(&bar, 1);
      mbar_expect(&bar, (unsigned)(ncl * groups * (q1 - q0) * sizeof(float4)));
    }
    cluster_arrive_relaxed();
    cluster_wait();
  }
  int parity = 0;
  for (; r < R; r += step) {
    uint4 xn[C], dn[C];   // the next row, in flight while this one is reduced
    if (r + step < R) {
      const size_t next = (size_t)(r + step) * D;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (lo + j * span < nvec) {
          xn[j] = ld_once(x + next + (size_t)(lo + j * span) * V);
          dn[j] = ld_once(dy + next + (size_t)(lo + j * span) * V);
        }
      }
    }
    float ss = 0.f, sgx = 0.f;
    float g[C][V];     // dy * w, kept for dx
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = lo + j * span;
      if (i < nvec) {
        float f[V];
        unpack<T>(xv[j], f);
        unpack<T>(dv[j], g[j]);
        if (w != nullptr) {
          float fw[V];
          unpack<T>(ld_row(w + (size_t)i * V), fw);
#pragma unroll
          for (int k = 0; k < V; ++k) g[j][k] *= fw[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          ss += f[k] * f[k];
          sgx += g[j][k] * f[k];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if (warps > 1) {   // one shared-memory step between the row's warps
      if (lane == 0) part[parity][warp] = make_float2(ss, sgx);
      group_sync(1 + group, span);
      const float2 p = lane < warps ? part[parity][group * warps + lane]
                                    : make_float2(0.f, 0.f);
      ss = p.x;
      sgx = p.y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
      }
      parity ^= 1;
    }
    const float rr = 1.f / sqrtf(ss / (float)D + eps);
    const float c = rr * rr * rr * (sgx / (float)D);
    T* dxr = dx + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = lo + j * span;
      if (i < nvec) {
        float f[V], o[V];
        unpack<T>(xv[j], f);
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = rr * g[j][k] - f[k] * c;
        if (w != nullptr) {
          float d[V];
          unpack<T>(dv[j], d);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[j][k] += d[k] * f[k] * rr;
        }
        st_row(dxr + (size_t)i * V, pack<T>(o));
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      xv[j] = xn[j];
      dv[j] = dn[j];
    }
  }   // rows
  if (w == nullptr) return;

  // push each float4 column of this group's part to the block that owns it
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int i = lo + j * span;
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const int q = (i * V + e) / 4, owner = q / per;
        push4(recv + (rank * groups + group) * per + (q - owner * per), &bar, (unsigned)owner,
              make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]));
      }
    }
  }
  // slice `rank` of the cluster's part: its blocks' parts in rank order,
  // each block's groups in order
  mbar_wait(&bar, 0);
  const int P = gridDim.x / ncl, p = blockIdx.x / ncl;
  const int parts = (int)ncl * groups;
  float4* part4 = reinterpret_cast<float4*>(dw_part);
  for (int q = tid; q < q1 - q0; q += blockDim.x) {
    float4 s = recv[q];
    for (int b = 1; b < parts; ++b) s = add4(s, recv[b * per + q]);
    part4[(size_t)p * Q + q0 + q] = s;
  }
  __syncthreads();
  if (tid == 0) {     // release: the slice's row p; acquire: the other rows
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(tickets + rank) : "memory");
    last_s = prev == P - 1;
  }
  __syncthreads();
  if (!last_s) return;
  // slice `rank` of dw: its P rows in a fixed order
  for (int c0 = q0; c0 < q1; c0 += blockDim.x) {
    const int n = min((int)blockDim.x, q1 - c0), sets = blockDim.x / n;
    const int col = tid % n, set = tid / n;
    if (set < sets) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int pp = set; pp < P; pp += kFinalBatch * sets) {
        float4 v[kFinalBatch];   // a batch of rows in flight at once
#pragma unroll
        for (int b = 0; b < kFinalBatch; ++b)
          if (pp + b * sets < P) v[b] = __ldcg(part4 + (size_t)(pp + b * sets) * Q + c0 + col);
#pragma unroll
        for (int b = 0; b < kFinalBatch; ++b)
          if (pp + b * sets < P) s = add4(s, v[b]);
      }
      sets_s[set * n + col] = s;
    }
    __syncthreads();
    if (tid < n) {
      float4 s = sets_s[tid];
      for (int k = 1; k < sets; ++k) s = add4(s, sets_s[k * n + tid]);
      st_dw(dw + (size_t)(c0 + tid) * 4, s);
    }
    __syncthreads();
  }
  if (tid == 0) tickets[rank] = 0;
}

template <typename T, int C>
int launch_bwd_c(const void* x, const void* dy, const void* w, void* dx,
                 void* dw, void* dw_part, void* tickets, int R, int D,
                 float eps, int warps, int groups, int grid, int cluster,
                 cudaStream_t st) {
  const auto kernel = rmsnorm_bwd_kernel<T, C>;
  const int per = (D / 4 + cluster - 1) / cluster;
  const size_t smem = w != nullptr ? (size_t)cluster * groups * per * sizeof(float4) : 0;
  // once per instance: the most dynamic shared memory a launch asks of it
  static const int set = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_max_smem<T>(C));
  if (set != 0) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32 * warps * groups);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(w), static_cast<T*>(dx), static_cast<float*>(dw_part),
      static_cast<int*>(tickets), static_cast<T*>(dw), R, D, warps, eps);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* w, void* dx,
               void* dw, void* dw_part, void* tickets, int R, int D, float eps,
               int warps, int groups, int chunks, int grid, int cluster,
               cudaStream_t st) {
  constexpr int V = Vec<T>::n;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (D % V || misaligned(x) || misaligned(dy) || misaligned(dx))
    return (int)cudaErrorInvalidValue;
  if (w != nullptr && (dw == nullptr || dw_part == nullptr || tickets == nullptr ||
                       misaligned(w) || misaligned(dw) || misaligned(dw_part)))
    return (int)cudaErrorInvalidValue;
  if (chunks < 1 || chunks > kBwdMaxChunks || warps < 1 || groups < 1 ||
      32LL * warps * groups > kBwdThreads ||
      (warps > 1 && groups > 15) ||   // named barriers 1..15
      cluster < 1 || cluster > kBwdMaxCluster || grid < 1 || grid % cluster ||
      32LL * warps * chunks < D / V)
    return (int)cudaErrorInvalidValue;
#define NORM_BWD_LAUNCH(C)                                                   \
  case C:                                                                    \
    return launch_bwd_c<T, C>(x, dy, w, dx, dw, dw_part, tickets, R, D, eps, \
                              warps, groups, grid, cluster, st)
  switch (chunks) {
    NORM_BWD_LAUNCH(1);
    NORM_BWD_LAUNCH(2);
    NORM_BWD_LAUNCH(3);
    NORM_BWD_LAUNCH(4);
    NORM_BWD_LAUNCH(5);
    NORM_BWD_LAUNCH(6);
    NORM_BWD_LAUNCH(7);
    NORM_BWD_LAUNCH(8);
  }
#undef NORM_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T, int C>
int occupancy_c(int threads, int smem, int cluster, int* out) {
  const auto kernel = rmsnorm_bwd_kernel<T, C>;
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, kernel);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bwd_max_smem<T>(C));
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaOccupancyMaxActiveClusters(out + 1, kernel, &cfg);
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return rc;
}

template <typename T>
int occupancy(int chunks, int threads, int smem, int cluster, int* out) {
  switch (chunks) {
    case 1: return occupancy_c<T, 1>(threads, smem, cluster, out);
    case 2: return occupancy_c<T, 2>(threads, smem, cluster, out);
    case 3: return occupancy_c<T, 3>(threads, smem, cluster, out);
    case 4: return occupancy_c<T, 4>(threads, smem, cluster, out);
    case 5: return occupancy_c<T, 5>(threads, smem, cluster, out);
    case 6: return occupancy_c<T, 6>(threads, smem, cluster, out);
    case 7: return occupancy_c<T, 7>(threads, smem, cluster, out);
    case 8: return occupancy_c<T, 8>(threads, smem, cluster, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: R x D contiguous; w, dw: D elements or both null; with w,
// dw_part an f32 (grid / cluster, D) scratch (the clusters' parts of dw)
// and tickets int32[cluster], all 0 (each launch leaves them so).  D
// must be a multiple of 16 / sizeof(T) and every pointer 16-byte
// aligned.  The plan (bwd_plan in kernels/rmsnorm/ops.py): a block of
// `warps` warps owns a row, each lane `chunks` 16-byte chunks of it,
// `grid` blocks in clusters of `cluster`.  Launches one kernel on
// `stream`; returns the cudaError_t of the launch.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* w, void* dx, void* dw,
                                  void* dw_part, void* tickets, int R, int D,
                                  float eps, int is_bf16, int warps,
                                  int groups, int chunks, int grid,
                                  int cluster, void* stream) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, w, dx, dw, dw_part, tickets, R, D,
                                     eps, warps, groups, chunks, grid, cluster, st);
  return launch_bwd<float>(x, dy, w, dx, dw, dw_part, tickets, R, D, eps,
                           warps, groups, chunks, grid, cluster, st);
}

// What the card makes of one backward instance (the plan's and the
// probe's): out[0] blocks an SM at `threads` threads and `smem` dynamic
// shared bytes, out[1] clusters of `cluster` blocks resident at once,
// out[2] registers a thread, out[3] local (spill) bytes a thread.
extern "C" int rmsnorm_bwd_occupancy(int is_bf16, int chunks, int threads,
                                     int smem, int cluster, int* out) {
  if (is_bf16) return occupancy<__nv_bfloat16>(chunks, threads, smem, cluster, out);
  return occupancy<float>(chunks, threads, smem, cluster, out);
}
