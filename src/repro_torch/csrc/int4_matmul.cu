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
// K*N/2 packed bytes plus K*N/group*4 scale bytes, 2*M flops per weight,
// far below the ridge; one launch per call.  What held the earlier
// CUDA-core GEMV (0.1972 ms per qwen2.5-7b layer at M=1 on an H100 80GB
// HBM3 at 700 W, 18.8% of the bound) was not the loads: with its weights already in L2 it ran no
// faster, and its instructions (~11 per packed byte: byte_perm, fsub,
// fmul, FFMA, addresses) kept too few bytes in flight.  So the decode
// goes to the tensor cores: per 16 columns and k16 step one
// mma.m16n8k16 (bf16 in, f32 out) whose A fragment is the packed bytes
// themselves, each byte made an exact bf16 code pair by byte_perm, one
// LOP3 and one bf16 subtract; x (M <= 4 rows, and for f32 x its bf16
// remainder) is the B operand, so M = 4 costs what M = 1 costs.  The
// codes of a scale group are summed in f32 and scaled once.  The K slices
// of a column tile are added by the block that takes the tile's last
// ticket, in split order (deterministic, and the tickets are left at 0).
// A band of packed rows is read nearly in address order, the next band's
// loads in flight while this one is multiplied; x and scale rows come by
// cp.async.  `ptxas -v`: 128 registers (two blocks per SM), no spills.
// Still short of the bound on that card: a 36 MB shape takes ~26 us of
// kernel time against ~16 us for a bare read of the same bytes in the
// same order (PERF.md).
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

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvTile = 128;                    // columns per block (8 x 16 per warp)
constexpr int kGemvMaxM = 4;                      // rows of x the GEMV serves
constexpr int kGemvSteps = 2;                     // k16 steps per warp per band
constexpr int kBM = 64, kBN = 64, kBK = 32, kTiledThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float nibble(int v) {  // 4-bit two's complement
  return (float)(v >= 8 ? v - 16 : v);
}
// 16 packed bytes, read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
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
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// x[k], x[k + 1] as a bf16 pair, and what f32 x loses to it (bf16 x: 0)
__device__ __forceinline__ void x_pair(const __nv_bfloat16* p, uint32_t& hi,
                                       uint32_t& lo) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0;
}
__device__ __forceinline__ void x_pair(const float* p, uint32_t& hi,
                                       uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  hi = bf16x2_bits(v.x, v.y);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = bf16x2_bits(v.x - h.x, v.y - h.y);
}
// Byte c of a 16-byte load (column c; even k in the low nibble, odd k in
// the high one) as the bf16 pair (code at even k, code at odd k), exact:
// byte_perm puts the byte in both halves (the high half shifted by 4),
// one LOP3 keeps each half's low nibble, flips it to offset binary
// b = v ^ 8 and sets the bits of 128 above it (magic = 0x43084308, kept
// in a register: LOP3 takes one immediate), and 128 + b - 136 is the
// code.
__device__ __forceinline__ uint32_t code_pair(const uint32_t (&w)[4],
                                              const uint32_t (&w4)[4], int c,
                                              uint32_t magic) {
  const int q = c / 4, j = c % 4;
  const uint32_t r = __byte_perm(w[q], w4[q], j | j << 4 | (4 + j) << 8 | (4 + j) << 12);
  uint32_t bits;  // (r & 0x000F000F) ^ magic in one LOP3: magic is a register
  asm("lop3.b32 %0, %1, 0x000F000F, %2, 0x6A;" : "=r"(bits) : "r"(r), "r"(magic));
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}
// c (16x8 f32) += a (16x16 bf16, row-major) @ b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a GEMV block (dynamic): its x rows as bf16 pairs (and
// the f32 remainders), then the scale rows of the groups it covers.
__host__ __device__ constexpr int gemv_x_words(int M, int rows) {
  return (2 * M * rows + 3) / 4 * 4;  // keeps the scale rows 16-byte aligned
}
__host__ __device__ constexpr int gemv_smem(int M, int rows, int group) {
  return gemv_x_words(M, rows) * 4 + 2 * rows / group * kGemvTile * 4;
}

// grid (ceil(N / 128), splits), 256 threads, gemv_smem(M, rows of the
// largest split, group) bytes of dynamic shared memory; group % 16 == 0,
// N % 16 == 0.  Split y owns scale groups [y G / splits, (y + 1) G /
// splits) of the G = K / group, so splits differ by at most one group;
// block (t, y) owns columns [128 t, +128) of them.
//
// On the tensor cores: out^T (128 x M) = W^T (128 x K) @ x^T, one
// mma.m16n8k16 per 16 columns and k16 step.  Lane (g = lane / 4, t = lane
// % 4) of a warp reads columns 16 g..16 g + 15 of packed rows r + t and
// r + t + 4 of a step of 8 (two 16-byte loads; the warp reads 4 rows x 128
// contiguous bytes per load), and byte c of them is exactly its A
// fragment's pair for A-row g (c even) or g + 8 (c odd) of the c/2-th
// MMA: the K order inside a step is permuted alike in A and in B, so the
// packed bytes need no shuffle.  B holds x^T: column m < M the bf16 x row
// m, column 4 + m what f32 x loses to bf16 (0 for bf16 x), so f32 x costs
// no second MMA.  Each scale group's sums stay in c (f32) and are added
// as acc += c * scale when the group ends.
//
// The block reads its packed rows in bands: warp w takes rows [8 S w,
// 8 S w + 8 S) of each band of 64 S (S = kGemvSteps), and the next band's
// loads are issued before this one is used, so the card reads each band
// nearly in address order.  (A run of rows per thread, far apart, lost
// half the rate.)  The block's x and scale rows are staged once in shared
// memory while its first band is on its way.  The warps' sums are added
// in a fixed order in shared memory.  With splits > 1 each block writes
// its f32 partial tile to part (splits, M, N); the block that takes the
// last ticket of its column tile adds the partials in split order, writes
// out and puts the ticket back to 0, so a call leaves the tickets as it
// found them (a replayed CUDA graph too).
template <typename T, int M>
__global__ void __launch_bounds__(kGemvThreads, 2) int4_gemv(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ part,
    int* __restrict__ tickets, T* __restrict__ out, int K, int N, int group) {
  constexpr int S = kGemvSteps;
  constexpr bool split_x = std::is_same_v<T, float>;
  extern __shared__ float4 gemv_smem_raw[];
  __shared__ float red[kGemvWarps][M][kGemvTile];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grows = group / 2, G = K / group, splits = gridDim.y;
  const int pb = (int)((long long)blockIdx.y * G / splits) * grows;
  const int pe = (int)((long long)(blockIdx.y + 1) * G / splits) * grows;
  const int nrows = pe - pb, band = kGemvWarps * 8 * S;
  const int t0 = blockIdx.x * kGemvTile, n = t0 + 16 * g;
  const bool live = n < N;  // N % 16 == 0: a lane's columns are all in or out
  const int first = pb + warp * 8 * S;
  uint32_t* xhi = reinterpret_cast<uint32_t*>(gemv_smem_raw);  // [M][nrows]
  uint32_t* xlo = xhi + M * nrows;                             // [M][nrows]
  float* ssh = reinterpret_cast<float*>(xhi + gemv_x_words(M, nrows));  // [groups][128]
  const uint8_t* src = packed + (size_t)t * N + n;

  uint4 wa[S][2], wb[S][2];
  auto fetch = [&](uint4 (&w)[S][2], int p) {  // steps at rows p + 8 s
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[s][h] = live && p + 8 * s < pe
                      ? ld_stream(src + (size_t)(p + 8 * s + 4 * h) * N)
                      : make_uint4(0u, 0u, 0u, 0u);
  };
  fetch(wa, first);
  // bf16 x rows and the scale rows by cp.async, every copy issued before
  // any is waited for (a loop of plain loads waited once per row); f32 x
  // is split into bf16 and remainder on the way
  for (int i = tid; i < M * nrows; i += kGemvThreads) {
    const int m = i / nrows, r = i % nrows;
    const T* xp = x + (size_t)m * K + 2 * (pb + r);
    if constexpr (split_x) {
      uint32_t hi, lo;
      x_pair(xp, hi, lo);
      xhi[i] = hi;
      xlo[i] = lo;
    } else {
      cp4(xhi + i, xp, true);
    }
  }
  const int g_lo = pb / grows, n_groups = nrows / grows;
  for (int i = tid; i < n_groups * kGemvTile / 4; i += kGemvThreads) {
    const int gi = i / (kGemvTile / 4), c = 4 * (i % (kGemvTile / 4));
    const bool ok = t0 + c < N;
    cp16(ssh + 4 * i, ok ? scales + (size_t)(g_lo + gi) * N + t0 + c : scales, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // B column g: x row g (g < M) or its f32 remainder (split_x, g - 4 < M)
  const int bm = g < 4 ? g : g - 4;
  const uint32_t* xb = bm < M && (g < 4 || split_x)
                           ? (g < 4 ? xhi : xlo) + bm * nrows - pb + t
                           : nullptr;
  uint32_t magic;
  asm("mov.b32 %0, 0x43084308;" : "=r"(magic));
  float c[8][4], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = acc[i][e] = 0.f;
  auto flush = [&](int grp) {  // acc += (sums of the group) * scale
    const float4* sp = reinterpret_cast<const float4*>(
        ssh + (grp - g_lo) * kGemvTile + 16 * g);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 s4 = sp[q];
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int i = 2 * q + i2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(c[i][e], sc[2 * i2 + e / 2], acc[i][e]);
          c[i][e] = 0.f;
        }
      }
    }
  };
  int grp = first / grows, gnext = (grp + 1) * grows;
  auto use = [&](const uint4 (&w)[S][2], int p) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = p + 8 * s;
      if (r < pe) {  // the same for the whole warp
        if (r >= gnext) {  // a new scale group
          flush(grp);
          grp = r / grows;
          gnext = (grp + 1) * grows;
        }
        const uint32_t b0 = xb ? xb[r] : 0u, b1 = xb ? xb[r + 4] : 0u;
        const uint32_t w0[4] = {w[s][0].x, w[s][0].y, w[s][0].z, w[s][0].w};
        const uint32_t w1[4] = {w[s][1].x, w[s][1].y, w[s][1].z, w[s][1].w};
        const uint32_t w04[4] = {w0[0] >> 4, w0[1] >> 4, w0[2] >> 4, w0[3] >> 4};
        const uint32_t w14[4] = {w1[0] >> 4, w1[1] >> 4, w1[2] >> 4, w1[3] >> 4};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t a[4] = {code_pair(w0, w04, 2 * i, magic), code_pair(w0, w04, 2 * i + 1, magic),
                                 code_pair(w1, w14, 2 * i, magic), code_pair(w1, w14, 2 * i + 1, magic)};
          mma_bf16(c[i], a, b0, b1);
        }
      }
    }
  };
  for (int p = first; p < pe; p += 2 * band) {
    fetch(wb, p + band);
    use(wa, p);
    fetch(wa, p + 2 * band);
    use(wb, p + band);
  }
  if (first < pe) flush(grp);

  // acc[i][2 h + e] is (x row 2 t + e, column 16 g + 2 i + h); lanes t and
  // t + 2 hold the bf16 part and the remainder of the same sums
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 2);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = 2 * t + e;
    if (t < 2 && m < M)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(&red[warp][m][16 * g + 2 * i]) =
            make_float2(acc[i][e], acc[i][2 + e]);
  }
  __syncthreads();
  for (int o = tid; o < M * kGemvTile; o += kGemvThreads) {
    const int m = o / kGemvTile, col = o % kGemvTile;
    if (t0 + col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kGemvWarps; ++k) v += red[k][m][col];
    if (splits == 1)
      store(out + (size_t)m * N + t0 + col, v);
    else
      part[((size_t)blockIdx.y * M + m) * N + t0 + col] = v;
  }
  if (splits == 1) return;
  // the ticket: release this block's partials, learn whether it is last
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the last block: thread (column quad q, lane j) adds splits j, j + 8,
  // ... in order, then the 8 lanes are added in order
  const int q = tid % (kGemvTile / 4), jl = tid / (kGemvTile / 4);
  if (t0 + 4 * q < N)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* pp = part + (size_t)m * N + t0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = jl; s < splits; s += kGemvWarps) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(pp + (size_t)s * M * N));
        v.x += a.x, v.y += a.y, v.z += a.z, v.w += a.w;
      }
      reinterpret_cast<float4*>(&red[jl][m][4 * q])[0] = v;
    }
  __syncthreads();
  for (int o = tid; o < M * kGemvTile; o += kGemvThreads) {
    const int m = o / kGemvTile, col = o % kGemvTile;
    if (t0 + col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kGemvWarps; ++k) v += red[k][m][col];
    store(out + (size_t)m * N + t0 + col, v);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
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

template <typename T, int M>
cudaError_t gemv_launch(const T* x, const uint8_t* pk, const float* sc,
                        float* part, int* tickets, T* o, int K, int N,
                        int group, int splits, cudaStream_t stream) {
  const int G = K / group;
  const int smem = gemv_smem(M, (G + splits - 1) / splits * (group / 2), group);
  static int allowed = 48 * 1024 - (int)sizeof(float) * kGemvWarps * M * kGemvTile;
  if (smem > allowed) {  // opt in to more shared memory, once per size
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const dim3 grid((N + kGemvTile - 1) / kGemvTile, splits);
  int4_gemv<T, M><<<grid, kGemvThreads, smem, stream>>>(x, pk, sc, part,
                                                        tickets, o, K, N, group);
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* packed, const void* scales, void* part,
           void* tickets, void* out, int M, int K, int N, int group,
           int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  if (M <= kGemvMaxM) {
    float* pt = static_cast<float*>(part);
    int* tk = static_cast<int*>(tickets);
    cudaError_t e = cudaErrorInvalidValue;
    switch (M) {
      case 1: e = gemv_launch<T, 1>(xt, pk, sc, pt, tk, o, K, N, group, splits, stream); break;
      case 2: e = gemv_launch<T, 2>(xt, pk, sc, pt, tk, o, K, N, group, splits, stream); break;
      case 3: e = gemv_launch<T, 3>(xt, pk, sc, pt, tk, o, K, N, group, splits, stream); break;
      case 4: e = gemv_launch<T, 4>(xt, pk, sc, pt, tk, o, K, N, group, splits, stream); break;
    }
    if (e != cudaSuccess) return (int)e;
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
// (K/group, N) f32; out (M, N) in x's dtype.  For M <= 4 the GEMV, one
// launch: K in `splits` slices of whole scale groups (1 <= splits <=
// K / group; N % 16 == 0, group % 16 == 0); with splits > 1 it takes f32 scratch part
// (splits, M, N) and ceil(N / 128) int32 tickets, all 0, which it leaves
// at 0.  For M > 4 the wgmma GEMM (bf16, group % 16 == 0, N % 4 == 0) or
// the tiled loop (f32).  Launches on `stream`, never synchronises,
// allocates nothing; returns the cudaError_t of the launch.
extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scales, void* part,
                                  void* tickets, void* out, int M, int K,
                                  int N, int group, int splits, int is_bf16,
                                  void* stream) {
  if (K % 2 || group % 2 || K % group) return (int)cudaErrorInvalidValue;
  if (M <= kGemvMaxM &&
      (N % 16 || group % 16 || splits < 1 || splits > K / group ||
       (splits > 1 && (part == nullptr || tickets == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (M > kGemvMaxM && is_bf16 && (group % 16 || N % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, packed, scales, part, tickets, out, M, K,
                                 N, group, splits, st);
  return launch<float>(x, packed, scales, part, tickets, out, M, K, N, group,
                       splits, st);
}
