// GQA one-token decode attention over a paged KV cache, for Hopper
// (sm_90a), in an fp variant (bf16 or f32 pools) and an int8-KV variant.
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
// block table, and dequantises codes * scale in registers: no
// dequantised copy of the pool is ever written.
//
// What bounds it: bytes.  A decode step reads each live token's K and V
// once at stored width (qwen2.5-7b, 4 slots of ~2100 tokens, bf16: 17.2
// MB per layer, 5.1 us at 3.35 TB/s) and does 4 * Hq * hd flops per
// token on them, far below the tensor-core ridge.  The TPU grid
// (B, Hkv, max_blocks) walks one slot's pages in order per grid cell; at
// qwen2.5-7b's 4 KV heads and a few slots that is a handful of blocks on
// 132 SMs.  Here each slot's virtual span is split over blocks as well,
// grid (n_split, Hkv, B), 32 tokens per block at the serving shape, as
// in csrc/decode_attention.cu.  Each block reads its own block-table
// entries and stages one 32-token tile of K and V in shared memory;
// tokens at or past lengths[b] are never loaded, and neither is their
// block-table entry, so a page with i * page >= lengths[b] (a free lane's
// or a short slot's garbage-sentinel entries) is never read: the skip
// comes before the load, not as a mask after it.  A split with no live
// token exits at once and writes nothing.  A second kernel, one block per
// (b, query head), merges the live splits' partial (m, l, acc) with the
// log-sum-exp weights; it derives from lengths[b] how many splits are
// live, so a dead split is never read either.  No wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;    // threads per block (4 warps)
constexpr int kTile = 32;        // tokens per shared-memory tile
constexpr int kGMax = 16;        // most query heads per KV head
constexpr int kMaxSplit = 1024;  // most partials the merge takes

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *block_table, *lengths;
  void *m_part, *l_part, *acc_part, *out;
  int B, max_blocks, page, Hkv, G, n_split, chunk;
  float scale;
};

template <typename T, typename KV, bool kQuant, int HD>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_split, a.Hkv, a.B);
  paged_partial<T, KV, kQuant, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.block_table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.m_part),
      static_cast<float*>(a.l_part), static_cast<float*>(a.acc_part),
      a.max_blocks, a.page, a.Hkv, a.G, a.chunk, a.scale);
  paged_merge<T, HD><<<a.B * a.Hkv * a.G, kThreads, 0, stream>>>(
      static_cast<const float*>(a.m_part), static_cast<const float*>(a.l_part),
      static_cast<const float*>(a.acc_part),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.n_split,
      a.chunk, a.max_blocks * a.page, a.Hkv, a.G);
}

template <typename T, typename KV, bool kQuant>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: launch<T, KV, kQuant, 32>(a, stream); break;
    case 64: launch<T, KV, kQuant, 64>(a, stream); break;
    case 128: launch<T, KV, kQuant, 128>(a, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, hd) and out (B, Hq, hd) in bf16 if is_bf16 else f32.  Pools
// k/v (n_pages, page, Hkv, hd) in q's type, or int8 codes when quant,
// with f32 scale pools k_scale/v_scale (n_pages, page, Hkv) (ignored
// otherwise).  block_table (B, max_blocks) and lengths (B,) int32.
// Scratch: m_part/l_part (B, Hkv, n_split, G) and acc_part
// (B, Hkv, n_split, G, hd) f32, where n_split * chunk covers
// max_blocks * page.  Launches on `stream`, never synchronises,
// allocates nothing; returns the cudaError_t of the launches.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_table, const void* lengths,
    void* m_part, void* l_part, void* acc_part, void* out, int B,
    int max_blocks, int page, int Hkv, int G, int hd, int n_split, int chunk,
    float scale, int is_bf16, int quant, void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMaxSplit || page < 1 ||
      (long long)n_split * chunk < (long long)max_blocks * page)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, block_table, lengths, m_part,
               l_part, acc_part, out, B, max_blocks, page, Hkv, G, n_split,
               chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return quant ? dispatch_hd<__nv_bfloat16, int8_t, true>(hd, a, st)
                 : dispatch_hd<__nv_bfloat16, __nv_bfloat16, false>(hd, a, st);
  return quant ? dispatch_hd<float, int8_t, true>(hd, a, st)
               : dispatch_hd<float, float, false>(hd, a, st);
}
