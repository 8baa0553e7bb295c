// Mamba2 (SSD) decode-step state update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_update/ssd_update.py::
// ssd_update_pallas (body `_kernel`) together with the broadcasts of its
// wrapper (ops.py).  Same function, per (b, head), on the (P, N) f32
// state tile h:
//     xdt = f32(x[b, head, :]) * dt[b, head]          (P,)
//     h'  = exp(dt[b, head] * A[head]) * h + xdt (outer) B[b, g, :]
//     y   = h' . C[b, g, :]                           (P,)
// with g = head / (H / G): the B/C group of the head is read directly,
// no repeat is materialised.  h' and y are f32; x, B and C are bf16 or
// f32.  h' is computed as the reference does, two rounded products and a
// rounded sum (no fused multiply-add), so it matches the plain version
// bit for bit where exp does; y sums N products in another order.
//
// What bounds it: bytes.  The state is read once and written once: at
// mamba2-2.7b's batch-1 shape (H 80, P 64, N 128) 2 x 2.62 MB, 1.57 us
// at 3.35 TB/s; the vectors add about 30 kB.  The TPU grid is (B, H), one
// tile per step; at batch 1 that would be 80 blocks on 132 SMs.  Here the
// grid is (grid, H, B): a block owns rows of one head's tile, a row served
// by L = min(32, N / 4) lanes (N >= 16, so at least 4), each holding K
// (1 or 2) 16-byte chunks of it, and a thread updates RT rows (1, 2 or 4)
// with the same columns.  Every thread first issues its RT x K state
// loads, which depend on nothing, and only then reads dt, A, x and the
// chunks of B and C its columns need, straight into registers: no shared
// memory and no barrier stands before the state stream.  y of a row is a
// shuffle reduction over its lanes.  The plan (L, K, RT, warps a block,
// grid) is the wrapper's (`ssd_plan` in kernels/ssd_update/ops.py), sized
// from the SM count, and is only checked here.  Each element of h is read
// and then written by the same thread, so h' may be written over h (the
// decode step's in-place call).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxN = 256;   // 32 lanes x 2 chunks x 4 columns

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float upd(float decay, float h, float xdt,
                                     float b) {
  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(xdt, b));
}

// 16 bytes of the state
__device__ __forceinline__ float4 load_state(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store_state(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Four consecutive elements of B or C as f32: one load of 16 (f32) or 8
// (bf16) bytes where `vec` (the row is aligned to it), else four.
__device__ __forceinline__ void load4(const float* p, bool vec, float4& out) {
  out = vec ? *reinterpret_cast<const float4*>(p)
            : make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      float4& out) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    out = make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
  } else {
    out = make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
  }
}

// h, h_out: (B, H, P, N) f32 contiguous, may alias.  x: row (b, head) at
// x + b * x_bstride + head * P.  B/C: group g of batch b at
// + b * bc_bstride + g * N.  dt: (B, H); A: (H,); y: (B, H, P).
// Thread (warp, lane) of block bx updates rows
// p = (bx * RT + k) * rows + warp * (32 / L) + lane / L, k < RT, with
// rows = warps * 32 / L, at columns (lane % L + j * L) * 4, j < K.
template <typename T, int L, int K, int RT>
__global__ void __launch_bounds__(kMaxThreads) ssd_update_kernel(
    const float* h, const T* __restrict__ x, long long x_bstride,
    const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, long long b_bstride, const T* __restrict__ Cm,
    long long c_bstride, float* h_out, float* __restrict__ y, int H, int P,
    int N, int G) {
  constexpr int kRowsPerWarp = 32 / L;
  const int head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % L;
  const int rows = (blockDim.x / 32) * kRowsPerWarp;   // rows of one slot
  const int p0 = blockIdx.x * RT * rows + warp * kRowsPerWarp + lane / L;
  const size_t row0 = ((size_t)b * H + head) * P;      // (b, head)'s row 0

  // the state loads go out first: they depend on nothing
  float4 hv[RT][K];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int p = p0 + k * rows;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = (sub + j * L) * 4;
      if (p < P && c < N) hv[k][j] = load_state(h + (row0 + p) * N + c);
    }
  }
  // then the vectors, straight into registers
  const float dtv = dt[(size_t)b * H + head];
  const float decay = expf(__fmul_rn(dtv, A[head]));
  const int g = head / (H / G);
  const T* bv = Bm + (size_t)b * b_bstride + (size_t)g * N;
  const T* cv = Cm + (size_t)b * c_bstride + (size_t)g * N;
  const bool vec = (reinterpret_cast<uintptr_t>(bv) |
                    reinterpret_cast<uintptr_t>(cv)) % (4 * sizeof(T)) == 0;
  float4 bb[K], cc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (sub + j * L) * 4;
    if (c < N) {
      load4(bv + c, vec, bb[j]);
      load4(cv + c, vec, cc[j]);
    }
  }
  const T* xr = x + (size_t)b * x_bstride + (size_t)head * P;
  float xdt[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int p = p0 + k * rows;
    xdt[k] = p < P ? __fmul_rn(to_f(xr[p]), dtv) : 0.f;
  }

#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int p = p0 + k * rows;
    const size_t row = (row0 + p) * N;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = (sub + j * L) * 4;
      if (p < P && c < N) {
        float4 o;
        o.x = upd(decay, hv[k][j].x, xdt[k], bb[j].x);
        o.y = upd(decay, hv[k][j].y, xdt[k], bb[j].y);
        o.z = upd(decay, hv[k][j].z, xdt[k], bb[j].z);
        o.w = upd(decay, hv[k][j].w, xdt[k], bb[j].w);
        store_state(h_out + row + c, o);
        acc += o.x * cc[j].x + o.y * cc[j].y + o.z * cc[j].z + o.w * cc[j].w;
      }
    }
    // y of the row: a shuffle reduction over its lanes
    // (every lane of the warp takes part; rows past P add 0)
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (p < P && sub == 0) y[row0 + p] = acc;
  }   // rows
}

struct Args {
  const void *h, *x, *dt, *A, *Bm, *Cm;
  void *h_out, *y;
  long long x_bstride, b_bstride, c_bstride;
  int B, H, P, N, G, warps, grid;
  cudaStream_t st;
};

template <typename T, int L, int K, int RT>
int launch(const Args& a) {
  const dim3 grid(a.grid, a.H, a.B);
  ssd_update_kernel<T, L, K, RT><<<grid, 32 * a.warps, 0, a.st>>>(
      static_cast<const float*>(a.h), static_cast<const T*>(a.x), a.x_bstride,
      static_cast<const float*>(a.dt), static_cast<const float*>(a.A),
      static_cast<const T*>(a.Bm), a.b_bstride, static_cast<const T*>(a.Cm),
      a.c_bstride, static_cast<float*>(a.h_out), static_cast<float*>(a.y),
      a.H, a.P, a.N, a.G);
  return (int)cudaGetLastError();
}

template <typename T, int L, int K>
int by_rows(const Args& a, int rows_per_thread) {
  switch (rows_per_thread) {
    case 1: return launch<T, L, K, 1>(a);
    case 2: return launch<T, L, K, 2>(a);
    case 4: return launch<T, L, K, 4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int L>
int by_chunks(const Args& a, int chunks, int rows_per_thread) {
  if (chunks == 1) return by_rows<T, L, 1>(a, rows_per_thread);
  if (chunks == 2) return by_rows<T, L, 2>(a, rows_per_thread);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_lanes(const Args& a, int lanes, int chunks, int rows_per_thread) {
  switch (lanes) {
    case 4: return by_chunks<T, 4>(a, chunks, rows_per_thread);
    case 8: return by_chunks<T, 8>(a, chunks, rows_per_thread);
    case 16: return by_chunks<T, 16>(a, chunks, rows_per_thread);
    case 32: return by_chunks<T, 32>(a, chunks, rows_per_thread);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements.  N must be a multiple of 4 from 16 to kMaxN,
// G must divide H, h and h_out must be 16-byte aligned.  The plan
// (ssd_plan): `lanes` lanes a row, each `chunks` 16-byte chunks of it,
// `rows_per_thread` rows a thread, `warps` warps a block, grid (grid, H,
// B).  Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ssd_update_launch(const void* h, const void* x,
                                 long long x_bstride, const void* dt,
                                 const void* A, const void* Bm,
                                 long long b_bstride, const void* Cm,
                                 long long c_bstride, void* h_out, void* y,
                                 int B, int H, int P, int N, int G,
                                 int is_bf16, int lanes, int chunks,
                                 int rows_per_thread, int warps, int grid,
                                 void* stream) {
  if (B < 1 || H < 1 || P < 1 || N < 16 || N % 4 || N > kMaxN || G < 1 ||
      H % G || warps < 1 || 32 * warps > kMaxThreads || grid < 1 ||
      lanes < 4 || lanes * chunks * 4 < N ||
      (long long)grid * rows_per_thread * warps * (32 / lanes) < P)
    return (int)cudaErrorInvalidValue;
  const Args a{h, x, dt, A, Bm, Cm, h_out, y, x_bstride, b_bstride, c_bstride,
               B, H, P, N, G, warps, grid, static_cast<cudaStream_t>(stream)};
  if (is_bf16)
    return by_lanes<__nv_bfloat16>(a, lanes, chunks, rows_per_thread);
  return by_lanes<float>(a, lanes, chunks, rows_per_thread);
}
