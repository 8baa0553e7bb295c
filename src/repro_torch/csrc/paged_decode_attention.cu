// GQA one-token decode attention over a paged KV cache, for Hopper
// (sm_90a): bf16 q over bf16 or int8 pools on the tensor cores
// (`paged_attention_mma`, the serving path), and f32 q over f32 or int8
// pools on the CUDA cores (`paged_partial` + `paged_merge`).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention/
// paged_decode_attention.py::paged_decode_attention_pallas (bodies
// `_kernel` and `_kernel_quant`).  Same function: q (B, Hq, hd) against
// each slot's pages, read in place through block_table[b, i] from pools
// (n_pages, page, Hkv, hd); slot b attends over its virtual positions
// 0..lengths[b]-1.  Online softmax in f32, output acc / max(l, 1e-30) in
// q's dtype, so a slot with lengths[b] == 0 gives zeros.  The int8
// variant reads int8 codes plus one f32 scale per (token, KV head) for K
// and for V, from scale pools (n_pages, page, Hkv) that follow the same
// block table: K and V are codes * scale, and no dequantised copy of the
// pool is ever written.
//
// What bounds it: bytes.  A decode step reads each live token's K and V
// once at stored width (qwen2.5-7b, 4 slots of ~2100 tokens, bf16: 17.2
// MB per layer, 5.1 us at 3.35 TB/s; int8 8.9 MB, 2.7 us) and does
// 4 * Hq * hd flops per token on them, far below the tensor-core ridge.
// The TPU grid (B, Hkv, max_blocks) walks one slot's pages in order per
// grid cell; here each (slot, KV head) pair's live tokens are split over
// blocks too, since a few slots times 4 KV heads are a handful of blocks
// on 132 SMs.
//
// The mma path, one launch per call.  Grid (n_split, Hkv, B), 4 warps.
// The host fixes n_split from B * Hkv and the SM count (one block per
// SM over bf16 pools, two over int8: 8 and 16 splits at the serving
// shape) and never reads lengths, so a call captures into a CUDA graph.
// Each block reads lengths[b] and takes its share of the slot's live
// 16-token units (`split_range`), in 64-token tiles, 16 tokens per warp.
// Serial latency, not arithmetic, sets this kernel's time, so each step
// starts as early as it can: q's copy and an L1 prefetch of the slot's
// block-table row go out while lengths[b] is read; then every
// block-table entry the block's first three tiles need is loaded at
// once, and those tiles are copied into a 3-slot cp.async ring at stored
// width, each token row in 16-byte pieces (at the serving shape a block
// has 4-5 tiles over bf16 pools, 2-3 over int8).  A
// token at or past lengths[b] (or past the split) is zero-filled and
// never read, nor is its block-table entry, so the garbage pages past a
// slot's length are never touched.  Q.K^T and P.V run as mma.m16n8k16
// (bf16 in, f32 accumulate): the G <= 16 query heads of the KV head are
// A's rows (zero past G), the K tile is B by ldmatrix, the V tile B by
// ldmatrix.trans; the online softmax runs in f32 on the accumulator
// fragments and P is rounded to bf16 as A.  Each warp widens its own
// rows of int8 codes to bf16 exactly (|code| <= 127) in shared memory;
// k_scale[t] multiplies score column t, v_scale[t] multiplies p_t before
// it is rounded.  The four warps' (m, l, acc) are combined through
// shared memory; with n_split > 1 each block writes its partial (m, l,
// acc; zeros for a split with no live token), and the block that takes
// its pair's last ticket (an acq_rel atomic add after the block's
// barrier) copies every partial into shared memory in one batch, adds
// them in split order, so repeat calls are bit-equal, and puts the
// ticket back to 0.  This replaces PR 12's path for bf16 q, which ran
// 32-token tiles of f32-staged K/V through CUDA-core dot products and a
// second merge launch.  scripts/paged_attention_probe.py times where it
// spends its time.
//
// The CUDA-core path (f32 q) is that PR 12 design: grid (n_split, Hkv,
// B) over the virtual span, one 32-token tile per block, K and V widened
// to f32 in shared memory; a second kernel, one block per (b, query
// head), merges the live splits' partial (m, l, acc) with log-sum-exp
// weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGMax = 16;        // most query heads per KV head

// ---------------------------------------------------------------- CUDA-core path (f32 q)
constexpr int kThreads = 128;    // threads per block (4 warps)
constexpr int kTile = 32;        // tokens per shared-memory tile
constexpr int kMaxSplit = 1024;  // most partials the merge takes

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// One block: KV head h of slot b, virtual tokens [split*chunk, +chunk)
// clipped to the slot's live length.  T is q's type, KV the pools' (T,
// or int8_t with kQuant).
template <typename T, typename KV, bool kQuant, int HD>
__global__ void __launch_bounds__(kThreads) paged_partial(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int max_blocks,
    int page, int Hkv, int G, int chunk, float scale) {
  constexpr int kVec = 16 / sizeof(KV);   // pool elements per 16-byte load
  constexpr int kQVec = 16 / sizeof(T);   // q elements per 16-byte load
  constexpr int kRow = HD + 4;            // padded K row: conflict-free float4 reads
  constexpr int kAcc = kGMax * HD / kThreads;
  __shared__ __align__(16) float q_s[kGMax * HD];
  __shared__ __align__(16) float k_s[kTile * kRow];
  __shared__ float v_s[kTile * HD];
  __shared__ float p_s[kGMax * kTile];
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  __shared__ long long row_s[kTile];      // pool row of each tile token
  __shared__ float ks_s[kTile], vs_s[kTile];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, min(lengths[b], max_blocks * page));
  if (s0 >= s1) return;   // no live token here: nothing read, nothing written
  const int Hq = Hkv * G;

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD / kQVec; i += kThreads) {
    float f[kQVec];
    load16(qb + i * kQVec, f);
#pragma unroll
    for (int j = 0; j < kQVec; ++j) q_s[i * kQVec + j] = f[j];
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int* bt = block_table + (size_t)b * max_blocks;

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int nt = min(kTile, s1 - t0);
    // block-table lookups (and scales) for live tokens only
    if (tid < kTile) {
      long long row = -1;
      if (tid < nt) {
        const int t = t0 + tid;
        row = ((long long)bt[t / page] * page + t % page) * Hkv + h;
        if (kQuant) {
          ks_s[tid] = k_scale[row];
          vs_s[tid] = v_scale[row];
        }
      }
      row_s[tid] = row;
    }
    __syncthreads();

    // K and V tiles, dequantised in registers on the int8 variant
    for (int i = tid; i < kTile * HD / kVec; i += kThreads) {
      const int t = i / (HD / kVec), c = (i % (HD / kVec)) * kVec;
      const long long row = row_s[t];
      float fk[kVec], fv[kVec];
      if (row >= 0) {
        load16(k + row * HD + c, fk);
        load16(v + row * HD + c, fv);
        if (kQuant) {
          const float sk = ks_s[t], sv = vs_s[t];
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            fk[j] *= sk;
            fv[j] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) fk[j] = fv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[t * kRow + c + j] = fk[j];
        v_s[t * HD + c + j] = fv[j];
      }
    }
    __syncthreads();

    // scores: one (head, token) pair per thread and step
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      float s = kNegInf;
      if (t < nt) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * HD);
        const float4* kv = reinterpret_cast<const float4*>(k_s + t * kRow);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD / 4; ++d) {
          const float4 qd = qv[d], kd = kv[d];
          dot += qd.x * kd.x + qd.y * kd.y + qd.z * kd.z + qd.w * kd.w;
        }
        s = dot * scale;
      }
      p_s[g * kTile + t] = s;
    }
    __syncthreads();

    // online-softmax update: one warp per query head, one lane per token
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V: each thread owns fixed (head, dim) outputs
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = tid + i * kThreads;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        float a = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) a += p_s[g * kTile + t] * v_s[t * HD + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const size_t part = ((size_t)b * Hkv + h) * gridDim.x + split;
  if (tid < G) {
    m_part[part * G + tid] = m_s[tid];
    l_part[part * G + tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * HD) acc_part[part * G * HD + o] = acc[i];
  }
}

__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < (int)blockDim.x / 32; ++i)
    v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// One block per (b, query head): log-sum-exp merge of the splits that
// hold a live token of slot b (the first ceil(len / chunk)).  Thread t
// reads dims [4*(t % (HD/4)), +4) of every kGroups-th partial, and the
// kGroups sums per dim are added in shared memory.  No live split (a
// length-0 slot) leaves l = 0 and acc = 0: the output is zeros.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_merge(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const int* __restrict__ lengths,
    T* __restrict__ out, int n_split, int chunk, int S, int Hkv, int G) {
  constexpr int kCols = HD / 4, kGroups = kThreads / kCols;
  __shared__ float w_s[kMaxSplit];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(16) float sums[kGroups * HD];
  const int bh = blockIdx.x / G, g = blockIdx.x % G;   // bh = b * Hkv + h
  const int len = min(max(lengths[bh / Hkv], 0), S);
  const int n_live = (len + chunk - 1) / chunk;
  const size_t base = (size_t)bh * n_split;   // partial index of split 0
  float m = kNegInf;
  for (int s = threadIdx.x; s < n_live; s += kThreads)
    m = fmaxf(m, m_part[(base + s) * G + g]);
  m = block_reduce(m, true, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < n_live; s += kThreads) {
    const float w = expf(m_part[(base + s) * G + g] - m);
    w_s[s] = w;
    l += l_part[(base + s) * G + g] * w;
  }
  l = block_reduce(l, false, red);   // its barriers also publish w_s
  const int col = threadIdx.x % kCols, grp = threadIdx.x / kCols;
  const float4* a = reinterpret_cast<const float4*>(acc_part + (base * G + g) * HD) + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < n_live; s += kGroups) {
    const float4 v = a[(size_t)s * G * kCols];
    const float w = w_s[s];
    acc.x += v.x * w; acc.y += v.y * w; acc.z += v.z * w; acc.w += v.w * w;
  }
  reinterpret_cast<float4*>(sums)[grp * kCols + col] = acc;
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) total += sums[i * HD + d];
    store(out + ((size_t)bh * G + g) * HD + d, total / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------- mma path (bf16 q)
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaTile = 64;       // tokens per ring tile, 16 per warp
constexpr int kUnit = 16;          // tokens per split unit: one warp's share of a tile
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kMmaMaxSplit = 128;  // most splits per (slot, KV head)
constexpr int kMaxPairs = 4096;    // most (slot, KV head) pairs: tickets
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Tokens [s0, s1) of a slot with `len` live tokens that split `split` of
// n_split takes: a contiguous run of whole 16-token units (the runs
// differ by at most one unit), clipped to len.  s0 >= s1: nothing.
__device__ __forceinline__ void split_range(int len, int split, int n_split,
                                            int& s0, int& s1) {
  const long long units = (len + kUnit - 1) / kUnit;
  s0 = (int)(units * split / n_split) * kUnit;
  s1 = min((int)(units * (split + 1) / n_split) * kUnit, len);
}

// Shared memory of a block (dynamic), by phase: the ring of K/V tiles
// at stored width (rows padded by 16 bytes, so ldmatrix and the 16-byte
// copies are free of bank conflicts) with, for int8, the tile's scales
// and one bf16 copy of the current K and V tiles, and the q rows; then
// the four warps' (m, l, acc) to combine; then the merge's per-split
// weights.
template <bool kQuant, int HD>
struct MmaSmem {
  static constexpr int kRow = HD * (kQuant ? 1 : 2) + 16;   // ring row bytes
  static constexpr int kRowB = 2 * HD + 16;                 // bf16 row bytes
  static constexpr int kTileBytes = kMmaTile * kRow;
  static constexpr int kScales = kQuant ? 2 * kMmaTile * 4 : 0;
  static constexpr int kStage = 2 * kTileBytes + kScales;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kWide = kQuant ? 2 * kMmaTile * kRowB : 0;
  static constexpr int kQ = 16 * kRowB;                     // q rows, zero past G
  static constexpr int kAccRow = HD + 4;                    // floats
  static constexpr int kCombine = (4 * 16 * kAccRow + 3 * 4 * 16) * 4;
  static constexpr int kMerge = 2 * kMmaMaxSplit * kGMax * 4;
  static constexpr int kBytes = cmax(kRing + kWide + kQ, cmax(kCombine, kMerge));
};

// Four int8 codes (one 32-bit word) as two bf16 pairs, exact: each code
// c + 128 is placed as the low byte of 2^23's f32 mantissa, 2^23 + 128
// is subtracted (exact: c is an integer), and an integer of at most 8
// significant bits is its f32's high half as bf16.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}
// A warp's 16 rows of int8 codes (rows of HD + 16 bytes) to bf16 rows
// (2 HD + 16 bytes), 16 codes per lane and step.
template <int HD>
__device__ __forceinline__ void widen_unit(const unsigned char* src, unsigned char* dst,
                                           int lane) {
  constexpr int kPieces = HD / 16;
#pragma unroll
  for (int i = lane; i < kUnit * kPieces; i += 32) {
    const int r = i / kPieces, c = i % kPieces;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * (HD + 16) + 16 * c);
    uint4 lo, hi;
    codes_bf16(w.x, lo.x, lo.y);
    codes_bf16(w.y, lo.z, lo.w);
    codes_bf16(w.z, hi.x, hi.y);
    codes_bf16(w.w, hi.z, hi.w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * (2 * HD + 16) + 32 * c);
    d[0] = lo;
    d[1] = hi;
  }
}

// One block: KV head h of slot b, the tokens split_range gives `split`.
// part_acc (pairs, n_split, G, HD) and part_ml (pairs, n_split, 2, G)
// hold every split's partial when n_split > 1 (zeros, m -1e30, for a
// split with no live token).
template <bool kQuant, int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) paged_attention_mma(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out, int max_blocks, int page_shift, int Hkv, int G,
    float scale_log2) {
  using L = MmaSmem<kQuant, HD>;
  using KV = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  constexpr int kElems = 16 / sizeof(KV);            // pool elements per piece
  constexpr int kPieces = HD / kElems;               // pieces per token row
  constexpr int kRowsPer = kMmaThreads / kPieces;    // rows per copy pass
  constexpr int kRowB = L::kRowB;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float M_s[kGMax], L_s[kGMax];
  __shared__ int last_s;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;   // fragment row group, lane in quad
  const int pair = b * Hkv + h;
  // q rows into shared memory first (rows past G zero-filled): their
  // latency overlaps that of lengths[b]
  unsigned char* q_s = smem + L::kRing + L::kWide;
  const __nv_bfloat16* qb = q + ((size_t)pair * G) * HD;
  for (int i = tid; i < 16 * (HD / 8); i += kMmaThreads) {
    const int row = i / (HD / 8), c = i % (HD / 8);
    cp16(q_s + row * kRowB + 16 * c, qb + (row < G ? row : 0) * HD + 8 * c, row < G);
  }
  cp_commit();
  // and the slot's block-table row towards L1 (at most 128 lines)
  const int* bt = block_table + (size_t)b * max_blocks;
  if (tid < min((max_blocks * 4 + 127) / 128, 128))
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(bt + 32 * tid));
  const int len = min(max(lengths[b], 0), max_blocks << page_shift);
  int s0, s1;
  split_range(len, split, n_split, s0, s1);
  const bool live = s0 < s1;

  {  // a split with no live token skips the tiles and writes a zero partial
    // o[n]: rows gr (c 0, 1) and gr + 8 (c 2, 3), dims 8 n + 2 tq + (c & 1)
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    if (live) {
      uint32_t qa[HD / 16][4];   // q as A fragments: rows = the KV head's query heads
      const int n_tiles = (s1 - s0 + kMmaTile - 1) / kMmaTile;
      const KV* kp = static_cast<const KV*>(k_pool);
      const KV* vp = static_cast<const KV*>(v_pool);
      // tiles [first, first + count) into their ring slots, one cp.async
      // group each: every block-table entry they need is loaded first, so
      // those loads are in flight together, then the copies start
      auto issue = [&](int first, int count) {
        const int piece = tid % kPieces;
        int rows[kStages][kMmaTile / kRowsPer];   // pool row of each token row, -1: none
#pragma unroll
        for (int k = 0; k < kStages; ++k)
#pragma unroll
          for (int i = 0; i < kMmaTile / kRowsPer; ++i) {
            const int t = s0 + (first + k) * kMmaTile + tid / kPieces + i * kRowsPer;
            rows[k][i] = -1;
            if (k < count && first + k < n_tiles && t < s1)   // the guard comes before any read
              rows[k][i] = ((__ldg(bt + (t >> page_shift)) << page_shift) +
                            (t & ((1 << page_shift) - 1))) * Hkv + h;
          }
#pragma unroll
        for (int k = 0; k < kStages; ++k) {
          if (k >= count) break;
          unsigned char* st = smem + ((first + k) % kStages) * L::kStage;
#pragma unroll
          for (int i = 0; i < kMmaTile / kRowsPer; ++i) {
            if (first + k >= n_tiles) break;   // no tile: an empty group
            const int r = tid / kPieces + i * kRowsPer;
            const bool ok = rows[k][i] >= 0;
            const long long row = ok ? rows[k][i] : 0;
            cp16(st + r * L::kRow + 16 * piece, kp + row * HD + piece * kElems, ok);
            cp16(st + L::kTileBytes + r * L::kRow + 16 * piece,
                 vp + row * HD + piece * kElems, ok);
            if (kQuant && piece == 0) {
              float* sc = reinterpret_cast<float*>(st + 2 * L::kTileBytes);
              cp4(sc + r, k_scale + row, ok);
              cp4(sc + kMmaTile + r, v_scale + row, ok);
            }
          }
          cp_commit();
        }
      };
      // the first kStages tiles are in flight from the start; a slot is
      // refilled once its tile is used
      issue(0, kStages);
      for (int tile = 0; tile < n_tiles; ++tile) {
        cp_wait<kStages - 1>();
        __syncthreads();   // the tile (and q) has arrived
        if (tile == 0)
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks)
            ldsm_x4(qa[ks], q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRowB +
                                2 * (16 * ks + (lane >> 4) * 8));
        const unsigned char* st = smem + (tile % kStages) * L::kStage;
        const unsigned char* kt = st;
        const unsigned char* vt = st + L::kTileBytes;
        const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
        const int wr = kUnit * warp;       // the warp's first row of the tile
        const int u0 = tile * kMmaTile + wr;   // and of its unit in the split
        if (s0 + u0 < s1) {
          if (kQuant) {   // the warp widens its own rows of K and V
            unsigned char* wide = smem + L::kRing;
            __syncwarp();   // its reads of the tile before are done
            widen_unit<HD>(kt + wr * L::kRow, wide + wr * kRowB, lane);
            widen_unit<HD>(vt + wr * L::kRow, wide + (kMmaTile + wr) * kRowB, lane);
            __syncwarp();
            kt = wide;
            vt = wide + kMmaTile * kRowB;
          }
          // S = Q K^T over the unit's 16 tokens: two n8 tiles
          float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const unsigned char* kw = kt + wr * kRowB;
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks) {
            uint32_t bk[4];
            ldsm_x4(bk, kw + ((lane & 7) + (lane >> 4 << 3)) * kRowB +
                            2 * (16 * ks + ((lane >> 3) & 1) * 8));
            mma_bf16(sc[0], qa[ks], bk[0], bk[1]);
            mma_bf16(sc[1], qa[ks], bk[2], bk[3]);
          }
          // online softmax on the fragments (rows gr and gr + 8)
          const int tb = s0 + u0 + 2 * tq;   // token of sc[0][0]
          float pv[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int dt = 8 * j + (c & 1);
              float s = sc[j][c] * scale_log2;
              if (kQuant) s *= ksc[wr + 2 * tq + dt];
              sc[j][c] = tb + dt < s1 ? s : kNegInf;
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                             fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_r[r], mx);
            const float alpha = exp2f(m_r[r] - m_new);
            m_r[r] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float p = exp2f(sc[j][2 * r + e] - m_new);
                sum += p;
                pv[j][2 * r + e] =
                    kQuant ? p * ksc[kMmaTile + wr + 2 * tq + 8 * j + e] : p;
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
              o[n][2 * r] *= alpha;
              o[n][2 * r + 1] *= alpha;
            }
          }
          // O += P V: P (bf16) is the A fragment as the scores lie
          const uint32_t pa[4] = {bf16x2_bits(pv[0][0], pv[0][1]), bf16x2_bits(pv[0][2], pv[0][3]),
                                  bf16x2_bits(pv[1][0], pv[1][1]), bf16x2_bits(pv[1][2], pv[1][3])};
          const unsigned char* vw = vt + wr * kRowB;
#pragma unroll
          for (int n = 0; n < HD / 8; n += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vw + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRowB +
                                  2 * (8 * n + (lane >> 4 << 3)));
            mma_bf16(o[n], pa, bv[0], bv[1]);
            mma_bf16(o[n + 1], pa, bv[2], bv[3]);
          }
        }
        if (tile + kStages < n_tiles) __syncthreads();   // the slot is used
        issue(tile + kStages, 1);
      }
    }
    cp_wait<0>();
    __syncthreads();   // the ring is free: the four warps' (m, l, acc) go there
    float* acc_w = reinterpret_cast<float*>(smem);
    float* m_w = acc_w + 4 * 16 * L::kAccRow;
    float* l_w = m_w + 4 * 16;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float* r0 = acc_w + (warp * 16 + gr) * L::kAccRow + 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(r0) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(r0 + 8 * L::kAccRow) = make_float2(o[n][2], o[n][3]);
    }
    if (tq == 0) {
      m_w[warp * 16 + gr] = m_r[0];
      m_w[warp * 16 + gr + 8] = m_r[1];
      l_w[warp * 16 + gr] = l_r[0];
      l_w[warp * 16 + gr + 8] = l_r[1];
    }
    __syncthreads();
    // each head's weight per warp once (e_w), its max and l; then the
    // block's (m, l, acc) as float4 columns
    float* e_w = l_w + 4 * 16;
    if (tid < 16) {
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) M = fmaxf(M, m_w[w * 16 + tid]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float e = exp2f(m_w[w * 16 + tid] - M);
        e_w[w * 16 + tid] = e;
        l += e * l_w[w * 16 + tid];
      }
      M_s[tid] = M;
      L_s[tid] = l;
    }
    __syncthreads();
    const size_t part = (size_t)pair * n_split + split;
    for (int i = tid; i < G * HD / 4; i += kMmaThreads) {
      const int g = i / (HD / 4), d = 4 * (i % (HD / 4));
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float e = e_w[w * 16 + g];
        const float4 v = *reinterpret_cast<const float4*>(acc_w + (w * 16 + g) * L::kAccRow + d);
        a.x += e * v.x; a.y += e * v.y; a.z += e * v.z; a.w += e * v.w;
      }
      if (n_split == 1) {
        const float l = fmaxf(L_s[g], 1e-30f);
        reinterpret_cast<uint2*>(out + (size_t)pair * G * HD)[i] =
            make_uint2(bf16x2_bits(a.x / l, a.y / l), bf16x2_bits(a.z / l, a.w / l));
      } else {
        reinterpret_cast<float4*>(part_acc + part * G * HD)[i] = a;
      }
    }
    if (n_split > 1 && tid < G) {
      part_ml[part * 2 * G + tid] = M_s[tid];
      part_ml[part * 2 * G + G + tid] = L_s[tid];
    }
    if (n_split == 1) return;
  }

  // the ticket: release this block's partial, learn whether it is last
  __syncthreads();
  if (tid == 0) {   // release: the block's partial; acquire: the others'
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(tickets + pair) : "memory");
    last_s = prev == n_split - 1;
  }
  __syncthreads();
  if (!last_s) return;
  // the last block: every split's (m, l) and as many acc partials as
  // fit come into shared memory in one batch of copies, then the sums
  // run in split order there (a dead split's m is -1e30, its weight 0)
  const int n_out = G * HD / 4;   // float4 of one split's acc partial
  float* w_s = reinterpret_cast<float*>(smem);   // (n_split, G)
  float* l_s = w_s + kMmaMaxSplit * kGMax;
  float4* buf = reinterpret_cast<float4*>(l_s + kMmaMaxSplit * kGMax);
  const int chunk = min(n_split, (L::kBytes - L::kMerge) / (n_out * 16));
  const float* ml = part_ml + (size_t)pair * n_split * 2 * G;
  const float4* pa = reinterpret_cast<const float4*>(part_acc + (size_t)pair * n_split * G * HD);
  for (int i = tid; i < n_split * G; i += kMmaThreads) {
    const int s = i / G, g = i % G;
    cp4(w_s + i, ml + s * 2 * G + g, true);
    cp4(l_s + i, ml + s * 2 * G + G + g, true);
  }
  auto fetch = [&](int s0) {
    const int n = min(chunk, n_split - s0) * n_out;
    for (int i = tid; i < n; i += kMmaThreads) cp16(buf + i, pa + (size_t)s0 * n_out + i, true);
    cp_commit();
  };
  cp_commit();   // the (m, l) first: the weights are found while the acc partials land
  fetch(0);
  cp_wait<1>();
  __syncthreads();
  // head g's max and l over the splits: 8 lanes a head, each taking
  // splits j, j + 8, ..., then a fixed shuffle tree (same order each call)
  const int hg = tid / 8, hj = tid % 8;
  float M = kNegInf;
  if (hg < G)
    for (int s = hj; s < n_split; s += 8) M = fmaxf(M, w_s[s * G + hg]);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float l = 0.f;
  if (hg < G)
    for (int s = hj; s < n_split; s += 8) {
      const float e = exp2f(w_s[s * G + hg] - M);
      l += e * l_s[s * G + hg];
      w_s[s * G + hg] = e;   // each weight is read and written by this lane alone
    }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (hg < G && hj == 0) L_s[hg] = l;
  cp_wait<0>();
  __syncthreads();   // the weights and the partials
  constexpr int kOut = kGMax * HD / 4 / kMmaThreads;   // float4 outputs per thread
  float4 acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_split; s0 += chunk) {
    if (s0 > 0) {
      __syncthreads();   // the chunk before is summed
      fetch(s0);
      cp_wait<0>();
      __syncthreads();
    }
    const int n = min(chunk, n_split - s0);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o4 = tid + j * kMmaThreads;
      if (o4 < n_out) {
        const float* w = w_s + s0 * G + o4 / (HD / 4);
#pragma unroll 8
        for (int s = 0; s < n; ++s) {
          const float4 v = buf[s * n_out + o4];
          const float ws = w[s * G];
          acc[j].x += ws * v.x; acc[j].y += ws * v.y;
          acc[j].z += ws * v.z; acc[j].w += ws * v.w;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int o4 = tid + j * kMmaThreads;
    if (o4 < n_out) {
      const float l = fmaxf(L_s[o4 / (HD / 4)], 1e-30f);
      const uint2 v = make_uint2(bf16x2_bits(acc[j].x / l, acc[j].y / l),
                                 bf16x2_bits(acc[j].z / l, acc[j].w / l));
      reinterpret_cast<uint2*>(out + (size_t)pair * G * HD)[o4] = v;
    }
  }
  if (tid == 0) tickets[pair] = 0;
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *block_table, *lengths;
  void *m_part, *l_part, *acc_part, *out;
  int B, max_blocks, page, Hkv, G, n_split, chunk;
  float scale;
};

template <typename KV, bool kQuant, int HD>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_split, a.Hkv, a.B);
  paged_partial<float, KV, kQuant, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.block_table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.m_part),
      static_cast<float*>(a.l_part), static_cast<float*>(a.acc_part),
      a.max_blocks, a.page, a.Hkv, a.G, a.chunk, a.scale);
  paged_merge<float, HD><<<a.B * a.Hkv * a.G, kThreads, 0, stream>>>(
      static_cast<const float*>(a.m_part), static_cast<const float*>(a.l_part),
      static_cast<const float*>(a.acc_part),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.out), a.n_split,
      a.chunk, a.max_blocks * a.page, a.Hkv, a.G);
}

template <typename KV, bool kQuant>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: launch<KV, kQuant, 32>(a, stream); break;
    case 64: launch<KV, kQuant, 64>(a, stream); break;
    case 128: launch<KV, kQuant, 128>(a, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Once per instance: the dynamic shared memory above 48 KB, and the
// carveout that lets two blocks share an SM.
template <bool kQuant, int HD>
cudaError_t prepare_mma() {
  static const cudaError_t err = [] {
    const auto kernel = paged_attention_mma<kQuant, HD>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaSmem<kQuant, HD>::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <bool kQuant, int HD>
int blocks_per_sm() {
  int n = -1;
  if (prepare_mma<kQuant, HD>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_attention_mma<kQuant, HD>,
                                                    kMmaThreads, MmaSmem<kQuant, HD>::kBytes) !=
          cudaSuccess)
    return -1;
  return n;
}

template <bool kQuant, int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* block_table, const void* lengths,
               void* part_acc, void* part_ml, void* tickets, void* out, int B,
               int max_blocks, int page, int Hkv, int G, int n_split,
               cudaStream_t stream) {
  constexpr int kBytes = MmaSmem<kQuant, HD>::kBytes;
  const cudaError_t attr = prepare_mma<kQuant, HD>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(n_split, Hkv, B);
  paged_attention_mma<kQuant, HD><<<grid, kMmaThreads, kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(tickets),
      static_cast<__nv_bfloat16*>(out), max_blocks, __builtin_ctz(page), Hkv, G,
      (float)(kLog2e / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <bool kQuant>
int dispatch_mma(int hd, const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const void* bt, const void* lens,
                 void* pacc, void* pml, void* tickets, void* out, int B,
                 int max_blocks, int page, int Hkv, int G, int n_split,
                 cudaStream_t st) {
  switch (hd) {
    case 32: return launch_mma<kQuant, 32>(q, k, v, ks, vs, bt, lens, pacc, pml, tickets,
                                           out, B, max_blocks, page, Hkv, G, n_split, st);
    case 64: return launch_mma<kQuant, 64>(q, k, v, ks, vs, bt, lens, pacc, pml, tickets,
                                           out, B, max_blocks, page, Hkv, G, n_split, st);
    case 128: return launch_mma<kQuant, 128>(q, k, v, ks, vs, bt, lens, pacc, pml, tickets,
                                             out, B, max_blocks, page, Hkv, G, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The CUDA-core path: q (B, Hq, hd) and out (B, Hq, hd) f32.  Pools k/v
// (n_pages, page, Hkv, hd) f32, or int8 codes when quant, with f32 scale
// pools k_scale/v_scale (n_pages, page, Hkv) (ignored otherwise).
// block_table (B, max_blocks) and lengths (B,) int32.  Scratch:
// m_part/l_part (B, Hkv, n_split, G) and acc_part (B, Hkv, n_split, G,
// hd) f32, where n_split * chunk covers max_blocks * page.  Launches on
// `stream`, never synchronises, allocates nothing; returns the
// cudaError_t of the launches.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_table, const void* lengths,
    void* m_part, void* l_part, void* acc_part, void* out, int B,
    int max_blocks, int page, int Hkv, int G, int hd, int n_split, int chunk,
    float scale, int quant, void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMaxSplit || page < 1 ||
      (long long)n_split * chunk < (long long)max_blocks * page)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, block_table, lengths, m_part,
               l_part, acc_part, out, B, max_blocks, page, Hkv, G, n_split,
               chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quant ? dispatch_hd<int8_t, true>(hd, a, st)
               : dispatch_hd<float, false>(hd, a, st);
}

// The mma path: q and out (B, Hq, hd) bf16; pools bf16, or int8 codes
// with f32 scale pools when quant; block_table and lengths as above.
// Scratch (n_split > 1): part_acc (B, Hkv, n_split, G, hd) and part_ml
// (B, Hkv, n_split, 2, G) f32, and tickets: B * Hkv int32, all 0, which
// the launch leaves at 0.  Launches one kernel on `stream`, never
// synchronises, allocates nothing; returns its cudaError_t.
extern "C" int paged_decode_attention_mma_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_table, const void* lengths,
    void* part_acc, void* part_ml, void* tickets, void* out, int B,
    int max_blocks, int page, int Hkv, int G, int hd, int n_split, int quant,
    void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMmaMaxSplit || page < 1 ||
      (page & (page - 1)) || max_blocks < 1 || B * Hkv > kMaxPairs ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quant ? dispatch_mma<true>(hd, q, k, v, k_scale, v_scale, block_table, lengths,
                                    part_acc, part_ml, tickets, out, B, max_blocks, page,
                                    Hkv, G, n_split, st)
               : dispatch_mma<false>(hd, q, k, v, k_scale, v_scale, block_table, lengths,
                                     part_acc, part_ml, tickets, out, B, max_blocks, page,
                                     Hkv, G, n_split, st);
}

// Blocks of the mma path's kernel one SM holds at once (for hd and
// quant), or -1 on an error: what the split plan assumes.
extern "C" int paged_decode_attention_mma_blocks_per_sm(int hd, int quant) {
  switch (hd) {
    case 32: return quant ? blocks_per_sm<true, 32>() : blocks_per_sm<false, 32>();
    case 64: return quant ? blocks_per_sm<true, 64>() : blocks_per_sm<false, 64>();
    case 128: return quant ? blocks_per_sm<true, 128>() : blocks_per_sm<false, 128>();
    default: return -1;
  }
}
