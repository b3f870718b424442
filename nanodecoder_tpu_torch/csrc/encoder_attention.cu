// Encoder self-attention (kernels K1, K5, K6).
//
// Replaces: nanodecoder_tpu/ops/encoder_attention.py `_enc_attn_kernel_qkv`
// (the Pallas body of `flash_encoder_attention_qkv`, K1: Q, K and V as
// column slices of the fused (B, S, 3D) QKV slab), `_enc_attn_kernel_flat`
// (`flash_encoder_attention_nld`, K5: separate (B, S, D) q, k and v) and
// `_enc_attn_kernel` (`flash_encoder_attention`, K6: the (B, S, H, Dh)
// layout, which is K5's on the contiguous (B, S, H * Dh) view).  Each
// Pallas kernel keeps one batch row's (S, S) score tile in VMEM so the
// probabilities never reach device memory.  One CUDA kernel serves all
// three: it takes a q, a k and a v pointer and the row stride between
// consecutive positions (3D for the slab, D otherwise).
//
// Math, per (batch row b, head h): logits = q.k^T * scale accumulated in
// f32; keys at positions >= lengths[b] are set to -1e9 (select, not add,
// so a length-0 padding row comes out uniform, never NaN); f32 softmax;
// probabilities rounded to the input dtype; P.V accumulated in f32 and
// rounded to the output dtype.  Heads are concatenated in the (B, S, D)
// output.
//
// What bounds it on the H100: at the flagship shape (B 640, S 256, D 256,
// 2 heads of 128) one call does 42.9 GFLOP against 335 MB (bf16) or
// 671 MB (f32) of traffic.  In f32 the exact-f32 requirement keeps it off
// the tensor cores, so it is bound by the 67 TFLOP/s CUDA-core f32 rate
// (~0.64 ms); in bf16 the data sheet says memory (~0.10 ms) would bound a
// tensor-core kernel.  K5 and K6 read the same bytes from three tensors.
//
// Design (simple and exact first): one block of 256 threads per (query
// tile of 32 rows, head, batch row).  Q's tile is converted to f32 in
// shared memory; K and then V stream through a 64-row shared tile; the
// block's (32, S) f32 score strip stays in shared memory for the softmax
// and the value product, so scores never reach device memory either.
// Both products run as f32 FMAs on the CUDA cores (register tiles of 2x4
// scores and 4 rows x Dh/32 outputs per thread).  Tensor-core MMA, TMA and
// a pipelined K/V ring are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 32;         // query rows per block
constexpr int kTK = 64;         // key/value rows per shared tile
constexpr int kThreads = 256;   // 8 warps
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

size_t smem_bytes(int dh, int s) {
  return sizeof(float) * ((size_t)(kTQ + kTK) * (dh + 1) + (size_t)kTQ * s);
}

// Load rows [r0, r0 + rows) of one head's column slice (offset `col`) of
// an operand with row stride `ld` into an f32 tile with row stride DH + 1 (the +1 keeps the
// column-wise reads of the score loop free of bank conflicts).  Rows past
// the sequence end are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ base,
                                          int r0, int rows, int s, int ld, int col) {
  for (int i = threadIdx.x; i < rows * DH; i += kThreads) {
    const int r = i / DH, c = i % DH, row = r0 + r;
    tile[r * (DH + 1) + c] = row < s ? to_f32(base[(size_t)row * ld + col + c]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
enc_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ lengths,
                T* __restrict__ out, int s, int heads, int ld, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kTQ][DH + 1]
  float* kv = qs + kTQ * (DH + 1);         // [kTK][DH + 1]
  float* ss = kv + kTK * (DH + 1);         // [kTQ][s] scores, then probs

  const int q0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = heads * DH;
  const int n = lengths[b];
  const size_t row0 = (size_t)b * s * ld;
  const int tid = threadIdx.x;

  load_tile<T, DH>(qs, q + row0, q0, kTQ, s, ld, h * DH);

  // Scores: thread (rg, cg) owns rows 2rg, 2rg+1 and columns cg + 16j.
  const int rg = tid / 16, cg = tid % 16;
  for (int k0 = 0; k0 < s; k0 += kTK) {
    __syncthreads();  // Q tile ready; previous K tile consumed
    load_tile<T, DH>(kv, k + row0, k0, kTK, s, ld, h * DH);
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      const float qa = qs[(2 * rg) * (DH + 1) + c];
      const float qb = qs[(2 * rg + 1) * (DH + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = kv[(cg + 16 * j) * (DH + 1) + c];
        acc[0][j] = fmaf(qa, kk, acc[0][j]);
        acc[1][j] = fmaf(qb, kk, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        if (col < s) ss[(2 * rg + i) * s + col] = col < n ? acc[i][j] * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // Softmax: each warp owns rows warp, warp + 8, ...
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kTQ; r += kThreads / 32) {
    float* row = ss + r * s;
    float m = -INFINITY;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < s; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < s; c += 32) row[c] = to_f32(from_f32<T>(row[c] / sum));
  }

  // Value product: warp owns rows 4*warp .. +4, lane owns columns lane + 32c.
  constexpr int kCols = DH / 32;
  const int r0 = warp * 4;
  float o[4][kCols] = {};
  for (int k0 = 0; k0 < s; k0 += kTK) {
    __syncthreads();  // probs complete; previous V tile consumed
    load_tile<T, DH>(kv, v + row0, k0, kTK, s, ld, h * DH);
    __syncthreads();
    const int kmax = min(kTK, s - k0);
    for (int j = 0; j < kmax; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = kv[j * (DH + 1) + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(r0 + i) * s + k0 + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p, vj[c], o[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + r0 + i;
    if (q >= s) continue;
    T* dst = out + ((size_t)b * s + q) * d + h * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[lane + 32 * c] = from_f32<T>(o[i][c]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int b, int s, int heads, int ld, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(DH, s);
  cudaError_t err = cudaFuncSetAttribute(enc_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kTQ - 1) / kTQ, heads, b);
  enc_attn_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), s, heads, ld, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const int* lengths,
                        void* out, int b, int s, int heads, int dh, int ld, float scale,
                        cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, b, s, heads, ld, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, b, s, heads, ld, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, b, s, heads, ld, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: the first element of position 0 of batch row 0 of each
// operand; position p of batch row b starts at (b * s + p) * ld elements
// after it.  out: (B, S, heads * dh), contiguous.
extern "C" int nd_encoder_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int b, int s,
                                    int heads, int dh, int ld, int is_bf16, float scale,
                                    void* stream) {
  if (b <= 0 || s <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      ld < heads * dh || smem_bytes(dh, s) > 227u * 1024u)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? dispatch_dh<__nv_bfloat16>(q, k, v, len, out, b, s, heads, dh, ld,
                                                scale, st)
                   : dispatch_dh<float>(q, k, v, len, out, b, s, heads, dh, ld, scale, st));
}
