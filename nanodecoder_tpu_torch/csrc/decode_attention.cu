// One-token attention over a (B, T, D) decode cache (kernels K4a, K4b).
//
// Replaces: nanodecoder_tpu/ops/attention.py `_decode_attn_kernel` (the
// Pallas body of `decode_attention`, K4a: one query row per cache row)
// and `_decode_attn_grouped_kernel` (`decode_attention_grouped`, K4b: the
// G beams of a chunk against the chunk's one cache row, read once).  One
// kernel serves both: K4a is the group-1 case.  MHA only: the cache holds
// all H heads, D = H * Dh.
//
// Math, per query row and head (the Pallas kernel's rounding points): the
// query in the cache dtype (int8 caches: f32 query times the per-lane K
// scale); scores accumulated in f32, then * scale; positions t >= valid
// set to -1e9 by a select; p = exp(s - max) / sum in f32 (IEEE division,
// no fast-math); the attention position is the lowest t whose head sum
// of p (heads added in order) reaches the maximum; p rounded to the V
// dtype (f32 for int8), P.V accumulated in f32, times the per-lane V
// scale for int8, rounded to the query dtype.
//
// What bounds it on the H100: bytes.  At B 640, T 256, D 256 it reads
// 168 MB of bf16 K/V (0.050 ms at 3.35 TB/s; f32 0.100 ms, int8 0.025
// ms) and does 0.17 GFLOP.  K4b reads each chunk's cache once for its G
// beams, so its bytes fall by G against K4a on tiled caches.  Rows at
// t >= valid are masked to probability exactly 0 and are not read (a
// length-0 padding row attends uniformly and reads all T).
//
// Design (simple first): one block of 256 threads per cache row.  A
// thread owns 8 lanes of a row (16 bytes of bf16), so D / 8 threads cover
// a row and the block walks 256 / (D / 8) rows per pass; the Dh / 8
// threads of a head reduce their partial dot products with warp shuffles.
// The G x H x T f32 scores live in dynamic shared memory (40 KB at G 5,
// H 8, T 256), where one warp per (beam, head) takes the softmax and one
// warp per beam the head-summed argmax.  P.V accumulates per thread in
// registers (G x 8 lanes) over its rows, and the row groups' partial sums
// meet in shared memory.  No cp.async/TMA pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kVec = 8;         // cache lanes per thread and row
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A probability as the P.V product sees it: rounded to the V dtype; the
// int8 path multiplies f32 probabilities with the upcast values.
template <typename T> __device__ __forceinline__ float p_as(float p) { return p; }
template <> __device__ __forceinline__ float p_as<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Eight consecutive cache lanes to f32 (one or two 16-byte loads).
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_floats(int group, int t, int d, int heads) {
  const int rows = kThreads / (d / kVec);
  return (size_t)group * d + (size_t)group * heads * t + (size_t)rows * group * d;
}

template <typename TQ, typename TKV, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const int* __restrict__ lens,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   TQ* __restrict__ out, int* __restrict__ amax, int group,
                   int t_len, int d, int heads, float scale) {
  extern __shared__ float smem[];
  const int gh = group * heads;
  float* qs = smem;                              // [G][D] f32 queries
  float* ss = qs + group * d;                    // [G * H][T] scores, then probs
  float* red = ss + (size_t)gh * t_len;          // [R][G][D] partial P.V sums

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int chunks = d / kVec;                   // threads per cache row
  const int rows = kThreads / chunks;            // cache rows per pass
  const int c = tid % chunks, r = tid / chunks;
  const int lanes = d / heads / kVec;            // threads per head
  const int h = c / lanes;
  const int n = lens[b];
  const int n_eff = n > 0 ? min(n, t_len) : t_len;
  const size_t base = (size_t)b * t_len * d;

  for (int i = tid; i < group * d; i += kThreads) {
    float x = to_f32(q[(size_t)b * group * d + i]);
    if (ks != nullptr) x *= ks[(size_t)b * d + i % d];
    qs[i] = x;
  }
  const int tail = t_len - n_eff;
  for (int i = tid; i < gh * tail; i += kThreads)
    ss[(size_t)(i / tail) * t_len + n_eff + i % tail] = kNegInf;
  __syncthreads();

  // Scores.  The trip count is uniform over the block, so every lane
  // takes part in the shuffles; rows past n_eff load zeros and store
  // nothing.
  for (int t0 = 0; t0 < n_eff; t0 += rows) {
    const int t = t0 + r;
    const bool live = t < n_eff;
    float kf[kVec];
    if (live) {
      load8(k + base + (size_t)t * d + c * kVec, kf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        const float* qg = qs + g * d + c * kVec;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(kf[e], qg[e], part);
        for (int o = lanes / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (live && c % lanes == 0)
          ss[(size_t)(g * heads + h) * t_len + t] = t < n ? part * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // Softmax: one warp per (beam, head) row of scores.
  const int warp = tid / 32, lane = tid % 32;
  for (int j = warp; j < gh; j += kThreads / 32) {
    float* row = ss + (size_t)j * t_len;
    float m = -INFINITY;
    for (int t = lane; t < t_len; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float z = 0.f;
    for (int t = lane; t < t_len; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      z += e;
    }
    z = warp_sum(z);
    for (int t = lane; t < t_len; t += 32) row[t] = __fdiv_rn(row[t], z);
  }
  __syncthreads();

  // Attention position: one warp per beam; lowest t on ties.
  for (int g = warp; g < group; g += kThreads / 32) {
    const float* pg = ss + (size_t)g * heads * t_len;
    float best = -INFINITY;
    int best_t = t_len;
    for (int t = lane; t < t_len; t += 32) {
      float s = pg[t];
      for (int hh = 1; hh < heads; ++hh) s += pg[(size_t)hh * t_len + t];
      if (s > best) {
        best = s;
        best_t = t;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int ot = __shfl_xor_sync(0xffffffffu, best_t, o);
      if (ob > best || (ob == best && ot < best_t)) {
        best = ob;
        best_t = ot;
      }
    }
    if (lane == 0) amax[(size_t)b * group + g] = best_t;
  }

  // P.V over the rows this thread owns, then the row groups' sums.
  float acc[MAXG][kVec];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  for (int t = r; t < n_eff; t += rows) {
    float vf[kVec];
    load8(v + base + (size_t)t * d + c * kVec, vf);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        const float p = p_as<TKV>(ss[(size_t)(g * heads + h) * t_len + t]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      float* dst = red + ((size_t)r * group + g) * d + c * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < group * d; i += kThreads) {
    float s = red[i];
    for (int rr = 1; rr < rows; ++rr) s += red[(size_t)rr * group * d + i];
    if (vs != nullptr) s *= vs[(size_t)b * d + i % d];
    out[(size_t)b * group * d + i] = from_f32<TQ>(s);
  }
}

template <typename TQ, typename TKV, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens,
                   const float* ks, const float* vs, void* out, int* amax, int b,
                   int group, int t, int d, int heads, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(group, t, d, heads);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<TQ, TKV, MAXG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<TQ, TKV, MAXG><<<b, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lens, ks, vs, static_cast<TQ*>(out), amax, group, t, d, heads, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_group(const void* q, const void* k, const void* v, const int* lens,
                           const float* ks, const float* vs, void* out, int* amax,
                           int b, int group, int t, int d, int heads, float scale,
                           cudaStream_t st) {
  if (group == 1)
    return launch<TQ, TKV, 1>(q, k, v, lens, ks, vs, out, amax, b, group, t, d, heads,
                              scale, st);
  return launch<TQ, TKV, kMaxGroup>(q, k, v, lens, ks, vs, out, amax, b, group, t, d,
                                    heads, scale, st);
}

}  // namespace

extern "C" int nd_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lens, const void* k_scale,
                                   const void* v_scale, void* out, void* amax, int b,
                                   int group, int t, int d, int heads, int is_bf16,
                                   int is_int8, float scale, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0 || heads <= 0 || group < 1 || group > kMaxGroup ||
      d % heads || d % kVec || kThreads % (d / kVec))
    return (int)cudaErrorInvalidValue;
  const int lanes = d / heads / kVec;
  if (lanes <= 0 || (lanes & (lanes - 1)) ||
      sizeof(float) * smem_floats(group, t, d, heads) > 227u * 1024u)
    return (int)cudaErrorInvalidValue;
  if (is_int8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  const float* ks = is_int8 ? static_cast<const float*>(k_scale) : nullptr;
  const float* vs = is_int8 ? static_cast<const float*>(v_scale) : nullptr;
  int* am = static_cast<int*>(amax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return (int)(is_bf16 ? dispatch_group<__nv_bfloat16, int8_t>(
                               q, k, v, ln, ks, vs, out, am, b, group, t, d, heads, scale, st)
                         : dispatch_group<float, int8_t>(
                               q, k, v, ln, ks, vs, out, am, b, group, t, d, heads, scale, st));
  return (int)(is_bf16 ? dispatch_group<__nv_bfloat16, __nv_bfloat16>(
                             q, k, v, ln, ks, vs, out, am, b, group, t, d, heads, scale, st)
                       : dispatch_group<float, float>(
                             q, k, v, ln, ks, vs, out, am, b, group, t, d, heads, scale, st));
}
