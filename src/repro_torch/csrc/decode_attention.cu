// GQA one-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a): bf16 q on the tensor cores (`decode_attention_mma`, one
// launch per call), f32 q on the CUDA cores (`decode_attention_partial`
// + `decode_attention_merge`).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::decode_attention_pallas (body `_kernel`).  Same
// function: q (B, Hq, hd) against k/v (B, S, Hkv, hd) under an arbitrary
// int8/bool validity mask, shared (S,) or per sequence (B, S).  Online
// softmax in f32, masked scores set to -1e30 and masked probabilities to
// 0, output acc / max(l, 1e-30) in q's dtype, so a row with no valid
// slot gives zeros.  Every one of the G = Hq / Hkv query heads of a KV
// head is served from one read of K/V.
//
// What bounds it: bytes.  At batch 1 the kernel streams the layer's K and
// V once (qwen2.5-7b at ctx 2048: 4.2 MB, 1.26 us at 3.35 TB/s) and does
// 4 * Hq * S * hd flops on them, far below the tensor-core ridge.  The
// TPU kernel walks S in order inside one grid cell per (b, kv head); at
// batch 1 that would be 4 blocks on 4 of the 132 SMs.  Here S is split
// over blocks as well, grid (n_split, Hkv, B).
//
// The mma path, one launch per call, 4 warps a block.  The host fixes
// n_split from B * Hkv and the SM count alone (33 splits of 64 tokens at
// qwen2.5-7b's batch-1 shape, 4 of ~520 at zamba2-1.2b's shared block),
// so a call captures into a CUDA graph.  Each block takes its share of
// S's 16-token units (`split_range`, runs differing by at most one
// unit); ragged S is masked in the kernel, never padded or read past.
// Serial latency, not arithmetic, sets this kernel's time, so the block
// first sends q's copy, then reads its range's mask bytes (one byte a
// token, coalesced) into bit words by warp ballots; every warp derives
// from them which of its 64-token tiles hold a valid slot.  A tile with
// none is skipped without a copy; the live tiles are copied at stored
// width into a 3-slot cp.async ring (rows padded by 16 bytes: ldmatrix
// and the copies are free of bank conflicts).  A masked slot's K/V row
// is zero-filled and never read, so whatever the cache holds there
// (garbage, NaN) cannot reach the output.  Q.K^T and P.V run as
// mma.m16n8k16 (bf16 in, f32 accumulate): the G <= 16 query heads of
// the KV head are A's rows (zero past G), the K tile is B by ldmatrix,
// the V tile B by ldmatrix.trans; the online softmax runs in f32 on the
// accumulator fragments, a masked column's p is set to 0 explicitly (a
// fully masked unit would otherwise give exp(s - m) = 1), and P is
// rounded to bf16 as A.  Each warp takes 16 tokens of a tile (and skips
// a unit with no valid slot); the four warps' (m, l, acc) are combined
// through shared memory.  With n_split > 1 each block writes its partial
// (m and l in f32, acc rounded to bf16 as P already is: it halves the
// bytes the merge reads; -1e30, 0, 0 for a split with no valid slot) and
// the block that takes its (b, KV head) pair's last ticket (an acq_rel
// atomic add after the block's barrier) copies every partial into shared
// memory in one batch, adds them in split order in f32, so repeat calls
// are bit-equal, and puts the ticket back to 0.  That block's read of
// the partials from L2 is the largest phase at qwen2.5-7b's shape.  A
// block holds the mask bits of at most kWindow tokens; a longer range
// runs as successive windows.  This is PR 18's kernel-2 design
// (paged_decode_attention.cu) on a contiguous cache with a mask in place
// of lengths; scripts/decode_attention_probe.py times where it spends
// its time.
//
// The CUDA-core path (f32 q) is the PR 11 design: one 32-slot tile per
// block with K/V widened to f32 in shared memory and scalar dot products,
// each block writing a partial (m, l, acc); a second kernel, one block
// per (b, query head), merges the partials with the log-sum-exp combine
// of `_split_kv_decode` (src/repro/models/attention.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGMax = 16;      // most query heads per KV head

// ---------------------------------------------------------------- CUDA-core path (f32 q)
constexpr int kThreads = 128;  // threads per block (4 warps)
constexpr int kTile = 32;      // tokens per shared-memory tile (one per lane)
constexpr int kMaxSplit = 1024;  // most partials the merge takes

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// One block: KV head h of sequence b, slots [split*chunk, +chunk).
template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_partial(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask,
    long long mask_bstride, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int S, int Hkv,
    int G, int chunk, float scale) {
  constexpr int kVec = 4;                // elements per 16-byte load
  constexpr int kRow = HD + 4;           // padded K row: conflict-free float4 reads
  constexpr int kAcc = kGMax * HD / kThreads;
  __shared__ __align__(16) float q_s[kGMax * HD];
  __shared__ __align__(16) float k_s[kTile * kRow];
  __shared__ float v_s[kTile * HD];
  __shared__ float p_s[kGMax * kTile];
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  __shared__ uint8_t valid_s[kTile];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  const int Hq = Hkv * G;

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD / kVec; i += kThreads) load16(qb + i * kVec, q_s + i * kVec);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const uint8_t* mrow = mask + (size_t)b * mask_bstride;

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int nt = min(kTile, s1 - t0);
    if (tid < kTile) valid_s[tid] = tid < nt && mrow[t0 + tid] != 0;
    __syncthreads();

    // K and V tiles; consecutive slots are Hkv*HD elements apart
    for (int i = tid; i < kTile * HD / kVec; i += kThreads) {
      const int t = i / (HD / kVec), c = (i % (HD / kVec)) * kVec;
      float fk[kVec], fv[kVec];
      if (valid_s[t]) {
        const size_t off = (((size_t)b * S + t0 + t) * Hkv + h) * HD + c;
        load16(k + off, fk);
        load16(v + off, fv);
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

    // scores: one (head, slot) pair per thread and step
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      float s = kNegInf;
      if (valid_s[t]) {
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

    // online-softmax update: one warp per query head, one lane per slot
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = valid_s[lane] ? expf(s - m_new) : 0.f;
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

// One block per (b, query head): log-sum-exp merge of the n_split
// partials.  Thread t reads dims [4*(t % (HD/4)), +4) of every kGroups-th
// partial (float4 loads, kGroups sums in flight per dim), and the
// kGroups sums per dim are added in shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_merge(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, float* __restrict__ out, int n_split,
    int G) {
  constexpr int kCols = HD / 4, kGroups = kThreads / kCols;
  __shared__ float w_s[kMaxSplit];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(16) float sums[kGroups * HD];
  const int bh = blockIdx.x / G, g = blockIdx.x % G;
  const size_t base = (size_t)bh * n_split;   // partial index of split 0
  float m = kNegInf;
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    m = fmaxf(m, m_part[(base + s) * G + g]);
  m = block_reduce(m, true, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < n_split; s += kThreads) {
    const float w = expf(m_part[(base + s) * G + g] - m);
    w_s[s] = w;
    l += l_part[(base + s) * G + g] * w;
  }
  l = block_reduce(l, false, red);   // its barriers also publish w_s
  const int col = threadIdx.x % kCols, grp = threadIdx.x / kCols;
  const float4* a = reinterpret_cast<const float4*>(acc_part + (base * G + g) * HD) + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < n_split; s += kGroups) {
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
    out[((size_t)bh * G + g) * HD + d] = total / fmaxf(l, 1e-30f);
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, const void* mask,
            long long mask_bstride, void* m_part, void* l_part,
            void* acc_part, void* out, int B, int S, int Hkv, int G,
            int n_split, int chunk, float scale, cudaStream_t stream) {
  const dim3 grid(n_split, Hkv, B);
  decode_attention_partial<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      mask_bstride, static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), S, Hkv, G, chunk, scale);
  decode_attention_merge<HD><<<B * Hkv * G, kThreads, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<float*>(out), n_split, G);
}

// ---------------------------------------------------------------- mma path (bf16 q)
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaTile = 64;       // tokens per ring tile, 16 per warp
constexpr int kUnit = 16;          // tokens per split unit: one warp's share of a tile
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kWindow = 4096;      // tokens whose mask bits a block holds at once
constexpr int kMmaMaxSplit = 128;  // most splits per (b, KV head)
constexpr int kMaxPairs = 4096;    // most (b, KV head) pairs: tickets
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Slots [s0, s1) of S that split `split` of n_split takes: a contiguous
// run of whole 16-token units (the runs differ by at most one unit),
// clipped to S.
__device__ __forceinline__ void split_range(int S, int split, int n_split, int& s0,
                                            int& s1) {
  const long long units = (S + kUnit - 1) / kUnit;
  s0 = (int)(units * split / n_split) * kUnit;
  s1 = min((int)(units * (split + 1) / n_split) * kUnit, S);
}

// Shared memory of a block (dynamic), by phase: the ring of K/V tiles
// (bf16 rows padded by 16 bytes) and the q rows; then the four warps'
// (m, l, acc) to combine; then the merge's per-split weights and as many
// partials as fit.
template <int HD>
struct MmaSmem {
  static constexpr int kRow = 2 * HD + 16;                  // row bytes
  static constexpr int kTileBytes = kMmaTile * kRow;
  static constexpr int kStage = 2 * kTileBytes;             // K tile, V tile
  static constexpr int kRing = kStages * kStage;
  static constexpr int kQ = 16 * kRow;                      // q rows, zero past G
  static constexpr int kAccRow = HD + 4;                    // floats
  static constexpr int kCombine = (4 * 16 * kAccRow + 3 * 4 * 16) * 4;
  static constexpr int kMerge = 2 * kMmaMaxSplit * kGMax * 4;
  static constexpr int kBytes = cmax(kRing + kQ, cmax(kCombine, kMerge));
};

// One block: KV head h of sequence b, the slots split_range gives
// `split`.  part_acc (pairs, n_split, G, HD) bf16 and part_ml (pairs,
// n_split, 2, G) f32 hold every split's partial when n_split > 1.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) decode_attention_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    long long mask_bstride, __nv_bfloat16* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ tickets, __nv_bfloat16* __restrict__ out,
    int S, int Hkv, int G, float scale_log2) {
  using L = MmaSmem<HD>;
  constexpr int kPieces = HD / 8;                    // 16-byte pieces per token row
  constexpr int kRowsPer = kMmaThreads / kPieces;    // rows per copy pass
  constexpr int kRowB = L::kRow;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t bits_s[kWindow / 32];          // mask bits of the window
  __shared__ float M_s[kGMax], L_s[kGMax];
  __shared__ int last_s;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;   // fragment row group, lane in quad
  const int pair = b * Hkv + h;
  // q rows into shared memory first (rows past G zero-filled): their
  // latency overlaps that of the mask bytes
  unsigned char* q_s = smem + L::kRing;
  const __nv_bfloat16* qb = q + ((size_t)pair * G) * HD;
  for (int i = tid; i < 16 * kPieces; i += kMmaThreads) {
    const int row = i / kPieces, c = i % kPieces;
    cp16(q_s + row * kRowB + 16 * c, qb + (row < G ? row : 0) * HD + 8 * c, row < G);
  }
  cp_commit();
  int s0, s1;
  split_range(S, split, n_split, s0, s1);
  const uint8_t* mrow = mask + (size_t)b * mask_bstride;
  // token t's K/V row starts at element (kv0 + t * Hkv) * HD
  const size_t kv0 = (size_t)b * S * Hkv + h;

  {  // o[n]: rows gr (c 0, 1) and gr + 8 (c 2, 3), dims 8 n + 2 tq + (c & 1)
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    uint32_t qa[HD / 16][4];   // q as A fragments: rows = the KV head's query heads
    bool have_q = false;
    for (int w0 = s0; w0 < s1; w0 += kWindow) {
      const int n_tok = min(kWindow, s1 - w0);
      const int n_tiles = (n_tok + kMmaTile - 1) / kMmaTile;
      if (w0 > s0) __syncthreads();   // the window before is done with bits_s and the ring
      // the window's mask bits: one ballot per 32 slots, zero up to the tile edge
      for (int i = tid; i < n_tiles * kMmaTile; i += kMmaThreads) {
        const uint32_t bits = __ballot_sync(0xffffffffu, i < n_tok && __ldg(mrow + w0 + i) != 0);
        if (lane == 0) bits_s[i / 32] = bits;
      }
      __syncthreads();
      // tiles with a valid slot, as a 64-bit set (every warp finds it)
      const auto any = [&](int t) {
        return t < n_tiles && (bits_s[2 * t] | bits_s[2 * t + 1]) != 0u;
      };
      const uint64_t live = __ballot_sync(0xffffffffu, any(lane)) |
                            (uint64_t)__ballot_sync(0xffffffffu, any(lane + 32)) << 32;
      const int n_live = __popcll(live);
      uint64_t to_issue = live, to_run = live;
      // the next live tile into ring slot `slot`, one cp.async group
      // (empty when none is left); masked rows are zero-filled, not read
      auto issue = [&](int slot) {
        if (to_issue) {
          const int tile = __ffsll((long long)to_issue) - 1;
          to_issue &= to_issue - 1;
          unsigned char* st = smem + slot * L::kStage;
          const int piece = tid % kPieces;
#pragma unroll
          for (int i = 0; i < kMmaTile / kRowsPer; ++i) {
            const int r = tid / kPieces + i * kRowsPer;
            const int t = tile * kMmaTile + r;   // in the window
            const bool ok = (bits_s[t / 32] >> (t % 32)) & 1u;
            const size_t off = ((kv0 + (size_t)(ok ? w0 + t : 0) * Hkv) * HD) + 8 * piece;
            cp16(st + r * L::kRow + 16 * piece, k + off, ok);
            cp16(st + L::kTileBytes + r * L::kRow + 16 * piece, v + off, ok);
          }
        }
        cp_commit();
      };
#pragma unroll
      for (int j = 0; j < kStages; ++j) issue(j);
      for (int j = 0; j < n_live; ++j) {
        const int tile = __ffsll((long long)to_run) - 1;
        to_run &= to_run - 1;
        cp_wait<kStages - 1>();
        __syncthreads();   // the tile (and q) has arrived
        if (!have_q) {
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks)
            ldsm_x4(qa[ks], q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRowB +
                                2 * (16 * ks + (lane >> 4) * 8));
          have_q = true;
        }
        const unsigned char* kt = smem + (j % kStages) * L::kStage;
        const unsigned char* vt = kt + L::kTileBytes;
        const int wr = kUnit * warp;              // the warp's first row of the tile
        const int u = tile * kMmaTile + wr;       // and its slot in the window
        const uint32_t ubits = (bits_s[u / 32] >> (u % 32)) & 0xffffu;
        if (ubits) {
          // S = Q K^T over the unit's 16 slots: two n8 tiles
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
          // online softmax on the fragments (rows gr and gr + 8); column
          // 8 j + 2 tq + (c & 1) of the unit is valid when its bit is set
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const bool ok = (ubits >> (8 * j2 + 2 * tq + (c & 1))) & 1u;
              sc[j2][c] = ok ? sc[j2][c] * scale_log2 : kNegInf;
            }
          float pv[2][4];
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
            for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const bool ok = (ubits >> (8 * j2 + 2 * tq + e)) & 1u;
                const float p = ok ? exp2f(sc[j2][2 * r + e] - m_new) : 0.f;
                sum += p;
                pv[j2][2 * r + e] = p;
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
        if (j + kStages < n_live) __syncthreads();   // the slot is used
        issue(j % kStages);
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
        const float4 x = *reinterpret_cast<const float4*>(acc_w + (w * 16 + g) * L::kAccRow + d);
        a.x += e * x.x; a.y += e * x.y; a.z += e * x.z; a.w += e * x.w;
      }
      if (n_split == 1) {
        const float l = fmaxf(L_s[g], 1e-30f);
        reinterpret_cast<uint2*>(out + (size_t)pair * G * HD)[i] =
            make_uint2(bf16x2_bits(a.x / l, a.y / l), bf16x2_bits(a.z / l, a.w / l));
      } else {
        reinterpret_cast<uint2*>(part_acc + part * G * HD)[i] =
            make_uint2(bf16x2_bits(a.x, a.y), bf16x2_bits(a.z, a.w));
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
  // run in split order there (an empty split's m is -1e30, its weight 0)
  const int n_out = G * HD / 4;    // 4-element groups of one split's acc partial
  const int n_piece = G * HD / 8;  // its 16-byte pieces
  float* w_s = reinterpret_cast<float*>(smem);   // (n_split, G)
  float* l_s = w_s + kMmaMaxSplit * kGMax;
  uint2* buf = reinterpret_cast<uint2*>(l_s + kMmaMaxSplit * kGMax);
  const int chunk = min(n_split, (L::kBytes - L::kMerge) / (n_piece * 16));
  const float* ml = part_ml + (size_t)pair * n_split * 2 * G;
  const uint4* pacc = reinterpret_cast<const uint4*>(part_acc + (size_t)pair * n_split * G * HD);
  for (int i = tid; i < n_split * G; i += kMmaThreads) {
    const int s = i / G, g = i % G;
    cp4(w_s + i, ml + s * 2 * G + g, true);
    cp4(l_s + i, ml + s * 2 * G + G + g, true);
  }
  auto fetch = [&](int c0) {
    const int n = min(chunk, n_split - c0) * n_piece;
    for (int i = tid; i < n; i += kMmaThreads)
      cp16(buf + 2 * i, pacc + (size_t)c0 * n_piece + i, true);
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
  for (int c0 = 0; c0 < n_split; c0 += chunk) {
    if (c0 > 0) {
      __syncthreads();   // the chunk before is summed
      fetch(c0);
      cp_wait<0>();
      __syncthreads();
    }
    const int n = min(chunk, n_split - c0);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o4 = tid + j * kMmaThreads;
      if (o4 < n_out) {
        const float* w = w_s + c0 * G + o4 / (HD / 4);
#pragma unroll 8
        for (int s = 0; s < n; ++s) {
          const uint2 x = buf[s * n_out + o4];
          const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
          const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
          const float ws = w[s * G];
          acc[j].x += ws * x0.x; acc[j].y += ws * x0.y;
          acc[j].z += ws * x1.x; acc[j].w += ws * x1.y;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int o4 = tid + j * kMmaThreads;
    if (o4 < n_out) {
      const float l = fmaxf(L_s[o4 / (HD / 4)], 1e-30f);
      const uint2 x = make_uint2(bf16x2_bits(acc[j].x / l, acc[j].y / l),
                                 bf16x2_bits(acc[j].z / l, acc[j].w / l));
      reinterpret_cast<uint2*>(out + (size_t)pair * G * HD)[o4] = x;
    }
  }
  if (tid == 0) tickets[pair] = 0;
}

// Once per instance: the dynamic shared memory above 48 KB, and the
// carveout that lets two blocks share an SM.
template <int HD>
cudaError_t prepare_mma() {
  static const cudaError_t err = [] {
    const auto kernel = decode_attention_mma<HD>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaSmem<HD>::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <int HD>
int blocks_per_sm() {
  int n = -1;
  if (prepare_mma<HD>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_attention_mma<HD>, kMmaThreads,
                                                    MmaSmem<HD>::kBytes) != cudaSuccess)
    return -1;
  return n;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* mask,
               long long mask_bstride, void* part_acc, void* part_ml, void* tickets,
               void* out, int B, int S, int Hkv, int G, int n_split, cudaStream_t stream) {
  const cudaError_t attr = prepare_mma<HD>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(n_split, Hkv, B);
  decode_attention_mma<HD><<<grid, kMmaThreads, MmaSmem<HD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask), mask_bstride,
      static_cast<__nv_bfloat16*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(tickets),
      static_cast<__nv_bfloat16*>(out), S, Hkv, G, (float)(kLog2e / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core path: q (B, Hq, hd), k/v (B, S, Hkv, hd) and out (B, Hq,
// hd) f32, mask bytes at mask + b * mask_bstride + s (mask_bstride 0 for
// a shared (S,) mask).  Scratch: m_part/l_part (B, Hkv, n_split, G) and
// acc_part (B, Hkv, n_split, G, hd) f32.  Launches on `stream`, never
// synchronises, allocates nothing; returns the cudaError_t of the
// launches.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* mask,
    long long mask_bstride, void* m_part, void* l_part, void* acc_part,
    void* out, int B, int S, int Hkv, int G, int hd, int n_split, int chunk,
    float scale, void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: launch<32>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part, out, B, S,
                        Hkv, G, n_split, chunk, scale, st); break;
    case 64: launch<64>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part, out, B, S,
                        Hkv, G, n_split, chunk, scale, st); break;
    case 128: launch<128>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part, out, B, S,
                          Hkv, G, n_split, chunk, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The mma path: q, k/v and out bf16 with the shapes and mask above.
// Scratch (n_split > 1): part_acc (B, Hkv, n_split, G, hd) bf16 and
// part_ml (B, Hkv, n_split, 2, G) f32, and tickets: B * Hkv int32, all 0, which
// the launch leaves at 0.  Launches one kernel on `stream`, never
// synchronises, allocates nothing; returns its cudaError_t.
extern "C" int decode_attention_mma_launch(
    const void* q, const void* k, const void* v, const void* mask, long long mask_bstride,
    void* part_acc, void* part_ml, void* tickets, void* out, int B, int S, int Hkv, int G,
    int hd, int n_split, void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMmaMaxSplit || S < 1 ||
      B * Hkv > kMaxPairs ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_mma<32>(q, k, v, mask, mask_bstride, part_acc, part_ml, tickets,
                                   out, B, S, Hkv, G, n_split, st);
    case 64: return launch_mma<64>(q, k, v, mask, mask_bstride, part_acc, part_ml, tickets,
                                   out, B, S, Hkv, G, n_split, st);
    case 128: return launch_mma<128>(q, k, v, mask, mask_bstride, part_acc, part_ml, tickets,
                                     out, B, S, Hkv, G, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the mma path's kernel one SM holds at once (for hd), or -1
// on an error.
extern "C" int decode_attention_mma_blocks_per_sm(int hd) {
  switch (hd) {
    case 32: return blocks_per_sm<32>();
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    default: return -1;
  }
}
