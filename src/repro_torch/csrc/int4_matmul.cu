// Fused int4 dequant + matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul/int4_matmul.py::
// int4_matmul_pallas (body `_kernel`).  Same function: out (M, N) =
// x (M, K) @ W, where W is int4 packed two per byte along K as
// (K/2, N) uint8 (low nibble = even k, sign-extended from 4 bits) with f32
// scales per group of `group` rows along K, (K/group, N).  Each weight is
// code * scale and the sums are f32; out is in x's dtype.  The bf16
// weight never exists in device memory.  Three paths, one TPU kernel:
//
// M <= 4, `int4_gemv` (decode, the main path's step).  Bound by bytes:
// K*N/2 packed bytes plus K*N/group*4 scale bytes, 2 flops per weight,
// far below the ridge.  Each lane takes 8 adjacent columns (one 8-byte
// load per pair of k rows, a warp reads 256 contiguous bytes) and keeps
// eight such loads in flight; the 8 warps of a block take consecutive
// slices of the block's K range for the same 256 columns and add their
// sums in shared memory.  K is also split over blockIdx.y so that
// N = 3584 still puts about two blocks on each of the 132 SMs: each split
// writes f32 partial sums (they stay in L2) that `int4_splitk_reduce`
// adds in a fixed order (deterministic, no atomics).
//
// M > 4 with bf16 x, `int4_gemm_wgmma` (prefill).  Bound by operations:
// 2*M*K*N flops, 0.965 ms per qwen2.5-7b layer at M = 2048 (954.6 GFLOP
// at 989 TFLOP/s bf16), only on the tensor cores.  A block of two
// warpgroups owns a 128x128 output tile; each warpgroup issues
// wgmma.m64n128k16 (bf16 in, f32 out) with both operands in shared
// memory.  x arrives by TMA (one thread, an mbarrier per stage) in
// 128-byte-swizzled rows; copying it with cp.async from every thread
// left the tensor cores waiting on the copies.  The threads turn the
// packed bytes (cp.async) into bf16 codes (-8..7, exact in bf16) in a
// no-swizzle K-major code tile (8 rows x 16 bytes per core matrix).  The
// scale is applied after the product: each scale group's x @ codes is
// summed in a temporary f32 accumulator (scale-d = 0 on its first k16
// step) and then added as acc += tmp * scale[g, n], so no weight is
// rounded to bf16 and the result is the reference's f32 function up to
// summation order.  A 3-stage ring of 128-deep k-tiles: tile t's MMAs
// run while tile t + 2 is copied and tile t + 1 dequantised.  Left to
// later work: the packed bytes by TMA, a producer warp, two temporary
// accumulators so that the MMAs need not drain at every group, persistent
// tiles, and wk/wv (N = 512: 64 blocks on 132 SMs).
//
// M > 4 with f32 x, `int4_gemm_tiled`: a shared-memory tiled loop in f32
// on the CUDA cores (64x64 tiles), exact like the reference; only f32
// test models reach it.  The TPU wrapper's M/N padding is dropped: edges
// are masked here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvCols = 8;                      // columns per lane
constexpr int kGemvBlockCols = 32 * kGemvCols;    // columns per block
constexpr int kGemvMaxM = 4;                      // rows of x the GEMV serves
constexpr int kBM = 64, kBN = 64, kBK = 32, kTiledThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
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

// ---------------------------------------------------------------- wgmma path
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 128, kWgThreads = 256;
constexpr int kWgKG = kWgBK / 8;                 // 16-byte k chunks (core matrices) per row
constexpr int kWgScaleRows = kWgBK / 16;         // groups a k-tile touches (group >= 16)
constexpr int kWgSlab = 64;                      // k per TMA box: one 128-byte swizzled row
constexpr int kWgA = kWgBM * kWgBK * 2;          // x tile: BK/64 slabs of 128 rows x 128 B
constexpr int kWgP = kWgBK / 2 * kWgBN;          // packed tile, (BK/2, BN) bytes
constexpr int kWgS = kWgScaleRows * kWgBN * 4;   // scale rows, f32
constexpr int kWgBSbo = kWgKG * 128 + 16;       // code tile: step between 8-column groups
constexpr int kWgB = kWgBN / 8 * kWgBSbo;       // code tile, bf16 core matrices
constexpr int kWgStage = kWgA + kWgP + kWgS;     // a multiple of 1024
constexpr int kWgStages = 3;                     // ring depth
// the ring (1024-aligned for the swizzle), two code tiles, one mbarrier
// per stage, and room to align the base
constexpr int kWgSmem = kWgStages * kWgStage + 2 * kWgB + 8 * kWgStages + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// cp.async of 16 (or 4) bytes; an invalid chunk reads nothing and
// zero-fills (src-size 0).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Thread writes (st.shared and completed cp.async) become visible to
// wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulator registers
// across the asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Shared-memory matrix descriptor: start address, LBO = byte step
// between the two core matrices of a k16 slice (K direction), SBO = byte
// step between 8-row groups (M or N direction), each in 16-byte units,
// and the layout type (0: no swizzle, 1: 128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         layout << 62;
}
// mbarrier of a stage: one arrival (the thread that starts the copy) plus
// the bytes the tensor copies bring.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// TMA: the box at (c0, c1) of a 2-D tensor into shared memory, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// d (64x128 f32 fragment) = [d +] A (64x16 bf16) @ B (16x128 bf16), both
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One thread's share of the cp.async copies of a k-tile [k0, k0 + BK)
// into a stage: the packed bytes (BK/2 rows of 128 columns) after the x
// tile, then the scale rows of the groups the tile touches; k past K and
// columns past N read as 0.  N % 4 == 0; packed rows go in 16-byte chunks
// when N % 16 == 0, else 4-byte ones.  (The x tile comes by TMA.)
__device__ __forceinline__ void wg_load(uint8_t* stage,
                                        const uint8_t* __restrict__ packed,
                                        const float* __restrict__ scales,
                                        int K, int N, int group, int n0,
                                        int k0) {
  const int tid = threadIdx.x;
  uint8_t* pk = stage + kWgA;
  if (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kWgP / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads;  // BK/2 rows x 8 chunks
      const int p = c / 8, gn = n0 + 16 * (c % 8);
      const bool ok = k0 / 2 + p < K / 2 && gn < N;
      cp16(pk + c * 16, packed + (ok ? (size_t)(k0 / 2 + p) * N + gn : 0), ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWgP / 4 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads;
      const int p = c / 32, gn = n0 + 4 * (c % 32);
      const bool ok = k0 / 2 + p < K / 2 && gn < N;
      cp4(pk + c * 4, packed + (ok ? (size_t)(k0 / 2 + p) * N + gn : 0), ok);
    }
  }
  if (tid < kWgScaleRows * kWgBN / 4) {
    const int g = k0 / group + tid / 32, gn = n0 + 4 * (tid % 32);
    if (g <= (min(K, k0 + kWgBK) - 1) / group) {
      const bool ok = gn < N;
      cp16(pk + kWgP + tid * 16, scales + (ok ? (size_t)g * N + gn : 0), ok);
    }
  }
}

// The packed tile of a stage as bf16 codes in the K-major B tile: core
// matrix (n/8, k/8) at n/8 * kWgBSbo + k/8 * 128, row n % 8 of 16 bytes
// holding k..k+7.  A unit is 8 k (k chunk kg) of 4 adjacent columns: a
// warp takes one kg, lane l columns 4l..4l+3, with four 4-byte loads (one
// per pair of k) and four 16-byte stores (one per column).  The 16-byte
// pad in kWgBSbo puts the eight stores of a quarter warp on eight
// different bank groups.
__device__ __forceinline__ void wg_dequant(const uint8_t* stage, uint8_t* b) {
  const uint32_t* pk = reinterpret_cast<const uint32_t*>(stage + kWgA);
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int u = 0; u < kWgKG * 32 / kWgThreads; ++u) {
    const int kg = threadIdx.x / 32 + u * kWgThreads / 32, q = threadIdx.x % 32;
    uint32_t w[4][4];  // [column][pair]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // offset binary v = nibble ^ 8 of 4 columns at once; the bf16 bits
      // 0x4300 | v are 128 + v, so 128 + v - 136 is the signed code, exactly
      const uint32_t word = pk[(kg * 4 + j) * (kWgBN / 4) + q];
      const uint32_t lo = (word & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t bits =
            (__byte_perm(lo, hi, c | (c + 4) << 8) & 0x00FF00FFu) | 0x43004300u;
        const __nv_bfloat162 v =
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits), bias);
        w[c][j] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * q + c;
      *reinterpret_cast<uint4*>(b + (n / 8) * kWgBSbo + kg * 128 + (n % 8) * 16) =
          make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
    }
  }
}

// acc += tmp * scale[column]: register 4j + {0,1,2,3} of lane l holds
// columns 8j + 2(l % 4) + {0,1,0,1} (rows l/4 and l/4 + 8 of its warp).
__device__ __forceinline__ void wg_flush(float (&acc)[64], float (&tmp)[64],
                                         const float* srow) {
  const int c = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(srow + 8 * j + c);
    acc[4 * j] += tmp[4 * j] * s.x;
    acc[4 * j + 1] += tmp[4 * j + 1] * s.y;
    acc[4 * j + 2] += tmp[4 * j + 2] * s.x;
    acc[4 * j + 3] += tmp[4 * j + 3] * s.y;
  }
}

// grid (ceil(N / 128), ceil(M / 128)), 256 threads, kWgSmem bytes of
// dynamic shared memory; xmap is x (M, K) bf16 as a TMA tensor map with
// 64 x 128 boxes and 128-byte swizzle.  group % 16 == 0, K % group == 0,
// N % 4 == 0.  Per k-tile t: the MMAs of tile t are issued, and while
// they run the copies of tile t + kWgStages - 1 start and the threads
// dequantise tile t + 1 into the other code tile; then wait, scale,
// barrier.
__global__ void __launch_bounds__(kWgThreads, 1) int4_gemm_wgmma(
    const __grid_constant__ CUtensorMap xmap,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* btile = ring + kWgStages * kWgStage;  // two code tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(btile + 2 * kWgB);
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int tiles = (K + kWgBK - 1) / kWgBK;
  const bool whole = K % kWgBK == 0 && group % kWgBK == 0;
  // the x tile of k-tile t into its stage (one thread)
  auto load_x = [&](int t) {
    uint8_t* a = ring + (t % kWgStages) * kWgStage;
    uint64_t* bar = full + t % kWgStages;
    mbar_expect(bar, kWgA);
#pragma unroll
    for (int j = 0; j < kWgBK / kWgSlab; ++j)
      tma_load(a + j * kWgBM * 128, &xmap, bar, t * kWgBK + j * kWgSlab, m0);
  };
  float acc[64], tmp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tmp[i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kWgStages - 1; ++t) {
    if (t < tiles) {
      if (tid == 0) load_x(t);
      wg_load(ring + t * kWgStage, packed, scales, K, N, group, n0, t * kWgBK);
    }
    cp_commit();
  }
  cp_wait<kWgStages - 2>();
  __syncthreads();
  wg_dequant(ring, btile);
  fence_proxy_async();
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kWgBK, kend = min(K, k0 + kWgBK), g0 = k0 / group;
    const uint8_t* stage = ring + (t % kWgStages) * kWgStage;
    const float* srows = reinterpret_cast<const float*>(stage + kWgA + kWgP);
    // warpgroup wg multiplies rows [64 wg, 64 wg + 64) of the tile.  A k16
    // step adds 32 bytes: within a 128-byte swizzled row of x, and two
    // core matrices of the code tile.
    const uint8_t* a = stage + wg * 64 * 128;
    const uint64_t db = smem_desc(btile + (t & 1) * kWgB, 128, kWgBSbo, 0);
    auto da = [&](int s) {
      return smem_desc(a + s / 4 * kWgBM * 128 + s % 4 * 32, 16, 1024, 1);
    };
    mbar_wait(full + t % kWgStages, t / kWgStages & 1);
    fence_regs(tmp);
    wgmma_fence();
    // no group ends inside a whole tile: its k16 steps go back to back
    // (the checks of the general loop below break them apart)
    if (whole) {
#pragma unroll
      for (int s = 0; s < kWgBK / 16; ++s)
        wgmma_m64n128k16(tmp, da(s), db + 16 * s, s > 0 || k0 % group != 0);
    } else {
#pragma unroll
      for (int s = 0; s < kWgBK / 16; ++s) {
        const int k = k0 + 16 * s;
        if (k < kend) {
          wgmma_m64n128k16(tmp, da(s), db + 16 * s, k % group != 0);
          if ((k + 16) % group == 0 && k + 16 < kend) {  // group ends here
            wgmma_commit();
            wgmma_wait0();
            fence_regs(tmp);
            wg_flush(acc, tmp, srows + (k / group - g0) * kWgBN);
            fence_regs(tmp);
            wgmma_fence();
          }
        }
      }
    }
    wgmma_commit();
    if (t + 1 < tiles) {
      // stage (t - 1) % kWgStages and code tile (t + 1) & 1 were last read
      // by tile t - 1, finished before the previous iteration's barrier
      const int tn = t + kWgStages - 1;
      if (tn < tiles) {
        if (tid == 0) load_x(tn);
        wg_load(ring + (tn % kWgStages) * kWgStage, packed, scales, K, N,
                group, n0, tn * kWgBK);
      }
      cp_commit();
      cp_wait<kWgStages - 2>();  // tile t + 1's packed bytes have landed
      __syncthreads();
      wg_dequant(ring + ((t + 1) % kWgStages) * kWgStage,
                 btile + ((t + 1) & 1) * kWgB);
    }
    wgmma_wait0();
    fence_regs(tmp);
    if (kend % group == 0)
      wg_flush(acc, tmp, srows + ((kend - 1) / group - g0) * kWgBN);
    fence_proxy_async();
    __syncthreads();
  }

  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;  // N is even: col + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8 * h) * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// cuTensorMapEncodeTiled, a CUDA driver API entry point fetched through the
// runtime (the build links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// x (M, K) bf16 as a tensor map of 64 x 128 boxes (k, rows), 128-byte
// swizzle; rows past M and k past K read as 0.
cudaError_t x_tensor_map(CUtensorMap* map, const void* x, int M, int K) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kWgSlab, kWgBM}, unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM);
    CUtensorMap xmap;
    cudaError_t e = x_tensor_map(&xmap, x, M, K);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(int4_gemm_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWgSmem);
    if (e != cudaSuccess) return (int)e;
    int4_gemm_wgmma<<<grid, kWgThreads, kWgSmem, stream>>>(xmap, pk, sc, o, M,
                                                           K, N, group);
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
// part (splits, M, N); for M > 4 the wgmma GEMM (bf16, group % 16 == 0,
// N % 4 == 0) or the tiled loop (f32).  Launches on `stream`, never synchronises,
// allocates nothing; returns the cudaError_t of the launches.
extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scales, void* part, void* out,
                                  int M, int K, int N, int group, int splits,
                                  int k_split, int is_bf16, void* stream) {
  if (K % 2 || group % 2 || K % group) return (int)cudaErrorInvalidValue;
  if (M <= kGemvMaxM && (N % kGemvCols || k_split % (2 * kGemvWarps)))
    return (int)cudaErrorInvalidValue;
  if (M > kGemvMaxM && is_bf16 && (group % 16 || N % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, packed, scales, part, out, M, K, N, group,
                                 splits, k_split, st);
  return launch<float>(x, packed, scales, part, out, M, K, N, group, splits,
                       k_split, st);
}
