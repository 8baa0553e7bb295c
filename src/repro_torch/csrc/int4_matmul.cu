// Fused int4 dequant + matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul/int4_matmul.py::
// int4_matmul_pallas (body `_kernel`).  Same function: out (M, N) =
// x (M, K) @ W, where W is int4 packed two per byte along K as
// (K/2, N) uint8 (low nibble = even k, sign-extended from 4 bits) with f32
// scales per group of `group` rows along K, (K/group, N).  Each weight is
// code * scale in f32 and the sums are f32; out is in x's dtype.  The
// bf16 weight never exists in memory.
//
// What bounds it: at decode (M = 1, the main path) bytes: K*N/2 packed
// bytes plus K*N/group*4 scale bytes, 2 flops per weight, far below the
// ridge.  `int4_gemv` gives each lane 8 adjacent columns (one 8-byte
// load per pair of k rows, a warp reads 256 contiguous bytes) and keeps
// eight such loads in flight; the 8 warps of a block take consecutive
// slices of the block's K range for the same 256 columns and add their
// sums in shared memory.  K is also split over blockIdx.y so that
// N = 3584 still puts about two blocks on each of the 132 SMs: each split
// writes f32 partial sums (they stay in L2) that `int4_splitk_reduce`
// adds in a fixed order (deterministic, no atomics).  At prefill
// (M = prompt length) `int4_gemm_tiled` is a plain shared-memory tiled
// loop on the CUDA cores: 64x64 output tiles,
// the packed tile dequantised into shared memory once per k step.  It is
// bound by operations and slow next to a tensor-core GEMM; no wgmma yet.
// The TPU wrapper's M/N padding is dropped: edges are masked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvCols = 8;                      // columns per lane
constexpr int kGemvBlockCols = 32 * kGemvCols;    // columns per block
constexpr int kGemvMaxM = 4;                      // rows of x the GEMV serves
constexpr int kBM = 64, kBN = 64, kBK = 32, kTiledThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float nibble(int v) {  // 4-bit two's complement
  return (float)(v >= 8 ? v - 16 : v);
}
// The four low (lo4) or high nibbles of a packed word, each flipped to
// offset binary (v ^ 8, so the signed code is b - 8) and masked to its
// byte; column c as a float: the bits 0x4B000000 | b are 2^23 + b.
__device__ __forceinline__ float code(uint32_t nibbles, int c) {
  return __int_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7540u | c)) -
         8388616.f;  // 2^23 + 8
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// grid (ceil(N / 256), splits); split y covers k in [y*k_split, +k_split)
// and warp w the w-th eighth of it.  N % 8 == 0, k_split % 16 == 0,
// group % 2 == 0.
template <typename T>
__global__ void __launch_bounds__(kGemvThreads) int4_gemv(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ part,
    T* __restrict__ out, int M, int K, int N, int group, int k_split) {
  __shared__ float red[kGemvWarps][kGemvMaxM][kGemvBlockCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kGemvBlockCols + lane * kGemvCols;
  const int rows = k_split / kGemvWarps;
  const int kb = blockIdx.y * k_split + warp * rows;
  const int ke = min(K, kb + rows);
  float acc[kGemvMaxM][kGemvCols];
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int g0 = kb; g0 < ke;) {  // one scale group at a time
      const int grp = g0 / group;
      const int g1 = min(ke, (grp + 1) * group);
      const float4* sp =
          reinterpret_cast<const float4*>(scales + (size_t)grp * N + n0);
      const float4 s0 = sp[0], s1 = sp[1];
      const float sc[kGemvCols] = {s0.x, s0.y, s0.z, s0.w,
                                   s1.x, s1.y, s1.z, s1.w};
#pragma unroll 8
      for (int kk = g0; kk < g1; kk += 2) {
        const uint2 w =
            *reinterpret_cast<const uint2*>(packed + (size_t)(kk / 2) * N + n0);
        const uint32_t fx = w.x ^ 0x88888888u, fy = w.y ^ 0x88888888u;
        const uint32_t lo4[2] = {fx & 0x0F0F0F0Fu, fy & 0x0F0F0F0Fu};
        const uint32_t hi4[2] = {(fx >> 4) & 0x0F0F0F0Fu, (fy >> 4) & 0x0F0F0F0Fu};
        float lo[kGemvCols], hi[kGemvCols];
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c) {
          lo[c] = code(lo4[c / 4], c % 4) * sc[c];
          hi[c] = code(hi4[c / 4], c % 4) * sc[c];
        }
#pragma unroll
        for (int m = 0; m < kGemvMaxM; ++m) {
          if (m < M) {
            const float2 xv = load2(x + (size_t)m * K + kk);
#pragma unroll
            for (int c = 0; c < kGemvCols; ++c)
              acc[m][c] += xv.x * lo[c] + xv.y * hi[c];
          }
        }
      }
      g0 = g1;
    }
  }
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m)
    if (m < M)
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
        red[warp][m][lane * kGemvCols + c] = acc[m][c];
  __syncthreads();
  const int col = blockIdx.x * kGemvBlockCols + threadIdx.x;
  if (col >= N) return;
  for (int m = 0; m < M; ++m) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) a += red[w][m][threadIdx.x];
    if (gridDim.y == 1)
      store(out + (size_t)m * N + col, a);
    else
      part[((size_t)blockIdx.y * M + m) * N + col] = a;
  }
}

template <typename T>
__global__ void int4_splitk_reduce(const float* __restrict__ part,
                                   T* __restrict__ out, int splits,
                                   long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += part[(size_t)s * mn + i];
  store(out + i, a);
}

// grid (ceil(N / 64), ceil(M / 64)); each thread owns a 4x4 output tile.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads) int4_gemm_tiled(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, T* __restrict__ out, int M, int K,
    int N, int group) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN + 4];  // dequantised weight tile
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tm = (tid / 16) * 4, tn = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kTiledThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < (kBK / 2) * kBN; i += kTiledThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk2 = k0 / 2 + r, gn = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (gk2 < K / 2 && gn < N) {
        const int byte = packed[(size_t)gk2 * N + gn];
        const float s = scales[(size_t)(2 * gk2 / group) * N + gn];
        lo = nibble(byte & 0xF) * s;
        hi = nibble(byte >> 4) * s;
      }
      ws[2 * r][c] = lo;
      ws[2 * r + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][tm + i];
        b[i] = ws[kk][tn + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn + j;
      if (gn < N) store(out + (size_t)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* packed, const void* scales, void* part,
           void* out, int M, int K, int N, int group, int splits,
           int k_split, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  if (M <= kGemvMaxM) {
    const dim3 grid((N + kGemvBlockCols - 1) / kGemvBlockCols, splits);
    int4_gemv<T><<<grid, kGemvThreads, 0, stream>>>(
        xt, pk, sc, static_cast<float*>(part), o, M, K, N, group, k_split);
    if (splits > 1) {
      const long long mn = (long long)M * N;
      int4_splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(part), o, splits, mn);
    }
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    int4_gemm_tiled<T><<<grid, kTiledThreads, 0, stream>>>(xt, pk, sc, o, M,
                                                           K, N, group);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (is_bf16) or f32; packed (K/2, N) uint8; scales
// (K/group, N) f32; out (M, N) in x's dtype.  For M <= 4 the GEMV runs with
// `splits` K-slices of `k_split` rows and, when splits > 1, f32 scratch
// part (splits, M, N).  Launches on `stream`, never synchronises,
// allocates nothing; returns the cudaError_t of the launches.
extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scales, void* part, void* out,
                                  int M, int K, int N, int group, int splits,
                                  int k_split, int is_bf16, void* stream) {
  if (K % 2 || group % 2 || K % group) return (int)cudaErrorInvalidValue;
  if (M <= kGemvMaxM && (N % kGemvCols || k_split % (2 * kGemvWarps)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, packed, scales, part, out, M, K, N, group,
                                 splits, k_split, st);
  return launch<float>(x, packed, scales, part, out, M, K, N, group, splits,
                       k_split, st);
}
