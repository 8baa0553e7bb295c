// GQA one-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::decode_attention_pallas (body `_kernel`).  Same
// function: q (B, Hq, hd) against k/v (B, S, Hkv, hd) under an arbitrary
// int8/bool validity mask, shared (S,) or per sequence (B, S).  Online
// softmax in f32, masked scores set to -1e30, output acc / max(l, 1e-30)
// in q's dtype, so a row with no valid slot gives zeros.  Every one of the
// G = Hq / Hkv query heads of a KV head is served from one read of K/V.
//
// What bounds it: bytes.  At batch 1 the kernel streams the layer's K and
// V once (qwen2.5-7b at ctx 2048: 4.19 MB, 1.25 us at 3.35 TB/s) and does
// 4 * Hq * S * hd flops on them, far below the tensor-core ridge.  The
// TPU kernel walks S in order inside one grid cell per (b, kv head); at
// batch 1 that would be 4 blocks on 4 of the 132 SMs.  Here S is split
// over blocks as well, grid (n_split, Hkv, B), with chunks small enough
// (the wrapper picks one 32-slot tile per block at qwen2.5-7b's batch-1
// shape) that every block's K/V loads are in flight at once: the whole
// layer's KV is requested in the first microsecond.  Each block runs the
// online softmax over its chunk in tiles staged in shared memory and
// writes a partial (m, l, acc) per query head to scratch, which stays in
// the 50 MB L2; a second kernel, one block per (b, query head), merges
// the partials with the log-sum-exp combine of `_split_kv_decode`
// (src/repro/models/attention.py).  A chunk with no valid slot carries
// (m=-1e30, l=0, acc=0) and merges as no contribution.  K/V rows of
// masked slots are not read.  Ragged S is masked in the kernel: nothing
// is padded.  No wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // threads per block (4 warps)
constexpr int kTile = 32;      // tokens per shared-memory tile (one per lane)
constexpr int kGMax = 16;      // most query heads per KV head
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One block: KV head h of sequence b, slots [split*chunk, +chunk).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, long long mask_bstride,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int S, int Hkv, int G, int chunk,
    float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
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

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD / kVec; i += kThreads) {
    float f[kVec];
    load16(qb + i * kVec, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) q_s[i * kVec + j] = f[j];
  }
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_merge(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out, int n_split,
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
    store(out + ((size_t)bh * G + g) * HD + d, total / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* mask,
            long long mask_bstride, void* m_part, void* l_part,
            void* acc_part, void* out, int B, int S, int Hkv, int G,
            int n_split, int chunk, float scale, cudaStream_t stream) {
  const dim3 grid(n_split, Hkv, B);
  decode_attention_partial<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      mask_bstride, static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), S, Hkv, G, chunk, scale);
  decode_attention_merge<T, HD><<<B * Hkv * G, kThreads, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), n_split, G);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* mask, long long mask_bstride, void* m_part,
                void* l_part, void* acc_part, void* out, int B, int S,
                int Hkv, int G, int n_split, int chunk, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part,
                    out, B, S, Hkv, G, n_split, chunk, scale, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part,
                    out, B, S, Hkv, G, n_split, chunk, scale, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, mask, mask_bstride, m_part, l_part, acc_part,
                     out, B, S, Hkv, G, n_split, chunk, scale, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, hd), k/v (B, S, Hkv, hd) in one dtype (bf16 if is_bf16 else
// f32), mask bytes at mask + b * mask_bstride + s (mask_bstride 0 for a
// shared (S,) mask).  Scratch: m_part/l_part (B, Hkv, n_split, G) and
// acc_part (B, Hkv, n_split, G, hd) f32.  out (B, Hq, hd) in q's dtype.
// Launches on `stream`, never synchronises, allocates nothing; returns
// the cudaError_t of the launches.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* mask,
    long long mask_bstride, void* m_part, void* l_part, void* acc_part,
    void* out, int B, int S, int Hkv, int G, int hd, int n_split, int chunk,
    float scale, int is_bf16, void* stream) {
  if (G < 1 || G > kGMax || n_split < 1 || n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, mask_bstride,
                                      m_part, l_part, acc_part, out, B, S,
                                      Hkv, G, n_split, chunk, scale, st);
  return dispatch_hd<float>(hd, q, k, v, mask, mask_bstride, m_part, l_part,
                            acc_part, out, B, S, Hkv, G, n_split, chunk,
                            scale, st);
}
