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
// tile per step; at batch 1 that would be 80 blocks on 132 SMs, each
// walking 32 kB.  Here a block owns a few rows of one head's tile, grid
// (P / rows, H, B): 1280 blocks of 128 threads at mamba2's shape, all
// resident at once, so every byte of the state is requested in the first
// wave.  A row is served by LANES = min(32, N / 4) lanes (N >= 16, so at
// least 4), each holding 16-byte chunks of it; y of the row is a shuffle
// reduction within those lanes.  B and C of the head's group are staged in shared memory as f32.
// Each element of h is read and then written by the same thread, so h'
// may be written over h (the decode step's in-place call).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 256;   // state width staged in shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float upd(float decay, float h, float xdt,
                                     float b) {
  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(xdt, b));
}

// h, h_out: (B, H, P, N) f32 contiguous, may alias.  x: row (b, head) at
// x + b * x_bstride + head * P.  B/C: group g of batch b at
// + b * bc_bstride + g * N.  dt: (B, H); A: (H,); y: (B, H, P).
template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads) ssd_update_kernel(
    const float* h, const T* __restrict__ x, long long x_bstride,
    const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, long long b_bstride, const T* __restrict__ Cm,
    long long c_bstride, float* h_out, float* __restrict__ y, int H, int P,
    int N, int G) {
  constexpr int kRowsPerWarp = 32 / LANES;
  constexpr int kRows = kWarps * kRowsPerWarp;
  __shared__ __align__(16) float b_s[kMaxN];
  __shared__ __align__(16) float c_s[kMaxN];

  const int head = blockIdx.y, b = blockIdx.z;
  const int g = head / (H / G);
  const T* bv = Bm + (size_t)b * b_bstride + (size_t)g * N;
  const T* cv = Cm + (size_t)b * c_bstride + (size_t)g * N;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    b_s[i] = to_f(bv[i]);
    c_s[i] = to_f(cv[i]);
  }
  __syncthreads();

  const float dtv = dt[(size_t)b * H + head];
  const float decay = expf(__fmul_rn(dtv, A[head]));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * kRows + warp * kRowsPerWarp + lane / LANES;
  const int sub = lane % LANES;
  float acc = 0.f;
  if (p < P) {
    const float xdt =
        __fmul_rn(to_f(x[(size_t)b * x_bstride + (size_t)head * P + p]), dtv);
    const size_t base = (((size_t)b * H + head) * P + p) * N;
    for (int c = sub * 4; c < N; c += LANES * 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h + base + c);
      const float4 bb = *reinterpret_cast<const float4*>(b_s + c);
      const float4 cc = *reinterpret_cast<const float4*>(c_s + c);
      float4 o;
      o.x = upd(decay, hv.x, xdt, bb.x);
      o.y = upd(decay, hv.y, xdt, bb.y);
      o.z = upd(decay, hv.z, xdt, bb.z);
      o.w = upd(decay, hv.w, xdt, bb.w);
      *reinterpret_cast<float4*>(h_out + base + c) = o;
      acc += o.x * cc.x + o.y * cc.y + o.z * cc.z + o.w * cc.w;
    }
  }
  // every lane of the warp takes part (rows past P add 0)
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (p < P && sub == 0) y[((size_t)b * H + head) * P + p] = acc;
}

template <typename T, int LANES>
int launch(const void* h, const void* x, long long x_bstride, const void* dt,
           const void* A, const void* Bm, long long b_bstride, const void* Cm,
           long long c_bstride, void* h_out, void* y, int B, int H, int P,
           int N, int G, cudaStream_t st) {
  constexpr int kRows = kWarps * (32 / LANES);
  const dim3 grid((P + kRows - 1) / kRows, H, B);
  ssd_update_kernel<T, LANES><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const T*>(x), x_bstride,
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), b_bstride, static_cast<const T*>(Cm),
      c_bstride, static_cast<float*>(h_out), static_cast<float*>(y), H, P, N,
      G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_lanes(const void* h, const void* x, long long x_bstride,
                   const void* dt, const void* A, const void* Bm,
                   long long b_bstride, const void* Cm, long long c_bstride,
                   void* h_out, void* y, int B, int H, int P, int N, int G,
                   cudaStream_t st) {
  const int chunks = N / 4;   // 16-byte chunks per row
#define SSD_LAUNCH(L)                                                      \
  return launch<T, L>(h, x, x_bstride, dt, A, Bm, b_bstride, Cm, c_bstride, \
                      h_out, y, B, H, P, N, G, st)
  if (chunks >= 32) SSD_LAUNCH(32);
  if (chunks >= 16) SSD_LAUNCH(16);
  if (chunks >= 8) SSD_LAUNCH(8);
  SSD_LAUNCH(4);
#undef SSD_LAUNCH
}

}  // namespace

// Strides are in elements.  N must be a multiple of 4 from 16 to kMaxN,
// G must divide H, h and h_out must be 16-byte aligned.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int ssd_update_launch(const void* h, const void* x,
                                 long long x_bstride, const void* dt,
                                 const void* A, const void* Bm,
                                 long long b_bstride, const void* Cm,
                                 long long c_bstride, void* h_out, void* y,
                                 int B, int H, int P, int N, int G,
                                 int is_bf16, void* stream) {
  if (B < 1 || H < 1 || P < 1 || N < 16 || N % 4 || N > kMaxN || G < 1 ||
      H % G)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_lanes<__nv_bfloat16>(h, x, x_bstride, dt, A, Bm,
                                         b_bstride, Cm, c_bstride, h_out, y,
                                         B, H, P, N, G, st);
  return dispatch_lanes<float>(h, x, x_bstride, dt, A, Bm, b_bstride, Cm,
                               c_bstride, h_out, y, B, H, P, N, G, st);
}
