// Beam-search advance (kernel K3) and top-n extraction (kernel K7).
//
// Replaces: nanodecoder_tpu/ops/beam_step.py `_beam_advance_kernel` (the
// Pallas body of `beam_advance`) and `_beam_topk_kernel` (the body of
// `beam_topk`).  Both score the candidates of one chunk row,
// flat = alive[k] + log_probs[k, v] over K * V, and extract the best ones
// one at a time: m = max(flat), the lowest index i with flat[i] >= m, then
// flat[i] = -1e9.  A picked slot is overwritten, not removed, so the same
// index comes back once everything left is at or below -1e9; the kernels
// keep that rule (the JAX package's `_extract_top`).  K3 then picks the
// new alive set (best K of the 2K picks that are not EOS) and the merged
// finished set (best K of the old finished scores and the EOS picks
// divided by the step's length penalty, an IEEE f32 division).
//
// What bounds it on the H100: at the flagship's beam step (B 256 rows,
// K 5, V 344) the kernel reads 1.8 MB and writes 46 KB, about 0.5 us at
// 3.35 TB/s, and its compares are a few million: a launch costs more than
// either, so it is launch-bound.
//
// Design: one block per batch row keeps the row's K * V candidates in
// shared memory (6.9 KB at the flagship) and runs the rounds of a
// block-wide argmax under the order (value desc, index asc): each thread
// scans a strided slice, warps reduce by shuffles, warp 0 reduces the
// warps' results and overwrites the pick.  The order is total, so the
// result does not depend on the reduction's shape.  Warp 0 then runs the
// two small picks (over 2K and 3K candidates) with the same argmax.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1.0e9f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

struct Pick {
  float v;
  int i;
};

__device__ __forceinline__ Pick better(Pick a, Pick b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Pick warp_best(Pick p) {
  for (int off = 16; off > 0; off >>= 1) {
    Pick o{__shfl_xor_sync(0xffffffffu, p.v, off), __shfl_xor_sync(0xffffffffu, p.i, off)};
    p = better(p, o);
  }
  return p;  // every lane holds the warp's best
}

__device__ __forceinline__ Pick scan(const float* s, int len, int first, int step) {
  Pick p{-INFINITY, INT_MAX};
  for (int i = first; i < len; i += step) p = better(p, Pick{s[i], i});
  return p;
}

// The whole block extracts the top n of s[0, len) into out_v / out_i.
__device__ void extract_top_block(float* s, int len, int n, float* out_v, int* out_i) {
  __shared__ Pick red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    Pick p = warp_best(scan(s, len, threadIdx.x, kThreads));
    if (lane == 0) red[warp] = p;
    __syncthreads();
    if (warp == 0) {
      Pick q = warp_best(lane < kWarps ? red[lane] : Pick{-INFINITY, INT_MAX});
      if (lane == 0) {
        out_v[j] = q.v;
        out_i[j] = q.i;
        s[q.i] = kNegInf;
      }
    }
    __syncthreads();
  }
}

// One warp extracts the top n of s[0, len) into out_v / out_i.
__device__ void extract_top_warp(float* s, int len, int n, float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    Pick p = warp_best(scan(s, len, lane, 32));
    if (lane == 0) {
      out_v[j] = p.v;
      out_i[j] = p.i;
      s[p.i] = kNegInf;
    }
    __syncwarp();
  }
}

// flat[i] = alive[i / v] + lp[i] for one row, into shared memory.
__device__ void load_candidates(const float* __restrict__ alive, const float* __restrict__ lp,
                                int v, int n, float* flat) {
  for (int i = threadIdx.x; i < n; i += kThreads) flat[i] = alive[i / v] + lp[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
beam_advance_kernel(const float* __restrict__ alive, const float* __restrict__ lp,
                    const float* __restrict__ fin, float pen, int k, int v, int eos,
                    int* __restrict__ top_ids, float* __restrict__ alive_s,
                    int* __restrict__ alive_sel, float* __restrict__ fin_s,
                    int* __restrict__ fin_sel) {
  extern __shared__ float smem[];
  const int n = k * v, row = blockIdx.x;
  float* flat = smem;                                  // n
  float* tops = flat + n;                              // 2k
  int* topi = reinterpret_cast<int*>(tops + 2 * k);    // 2k
  float* cand = reinterpret_cast<float*>(topi + 2 * k);  // 3k
  load_candidates(alive + (long long)row * k, lp + (long long)row * n, v, n, flat);
  extract_top_block(flat, n, 2 * k, tops, topi);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int j = lane; j < 2 * k; j += 32) {
    top_ids[(long long)row * 2 * k + j] = topi[j];
    const bool is_eos = topi[j] - (topi[j] / v) * v == eos;
    cand[j] = is_eos ? kNegInf : tops[j];
  }
  __syncwarp();
  extract_top_warp(cand, 2 * k, k, alive_s + (long long)row * k, alive_sel + (long long)row * k);
  for (int j = lane; j < 3 * k; j += 32) {
    if (j < k) {
      cand[j] = fin[(long long)row * k + j];
    } else {
      const int c = j - k;
      const bool is_eos = topi[c] - (topi[c] / v) * v == eos;
      cand[j] = is_eos ? __fdiv_rn(tops[c], pen) : kNegInf;
    }
  }
  __syncwarp();
  extract_top_warp(cand, 3 * k, k, fin_s + (long long)row * k, fin_sel + (long long)row * k);
}

__global__ void __launch_bounds__(kThreads)
beam_topk_kernel(const float* __restrict__ alive, const float* __restrict__ lp, int k, int v,
                 int n_out, float* __restrict__ scores, int* __restrict__ ids) {
  extern __shared__ float smem[];
  const int n = k * v, row = blockIdx.x;
  load_candidates(alive + (long long)row * k, lp + (long long)row * n, v, n, smem);
  extract_top_block(smem, n, n_out, scores + (long long)row * n_out,
                    ids + (long long)row * n_out);
}

// Opt in to more than 48 KB of dynamic shared memory where a row needs it.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, long long bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int nd_beam_advance(const void* alive, const void* lp, const void* fin, float pen,
                               int b, int k, int v, int eos, void* top_ids, void* alive_s,
                               void* alive_sel, void* fin_s, void* fin_sel, void* stream) {
  if (b <= 0 || k <= 0 || v <= 0 || eos < 0 || eos >= v || (long long)k * v > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const long long smem = ((long long)k * v + 7LL * k) * 4;
  cudaError_t err = reserve_smem(beam_advance_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  beam_advance_kernel<<<b, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alive), static_cast<const float*>(lp),
      static_cast<const float*>(fin), pen, k, v, eos, static_cast<int*>(top_ids),
      static_cast<float*>(alive_s), static_cast<int*>(alive_sel), static_cast<float*>(fin_s),
      static_cast<int*>(fin_sel));
  return (int)cudaGetLastError();
}

extern "C" int nd_beam_topk(const void* alive, const void* lp, int b, int k, int v, int n_out,
                            void* scores, void* ids, void* stream) {
  if (b <= 0 || k <= 0 || v <= 0 || n_out <= 0 || (long long)k * v > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)k * v * 4;
  cudaError_t err = reserve_smem(beam_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  beam_topk_kernel<<<b, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alive), static_cast<const float*>(lp), k, v, n_out,
      static_cast<float*>(scores), static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
