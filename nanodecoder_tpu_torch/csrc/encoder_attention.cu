// Encoder self-attention (kernels K1, K5, K6).
//
// Replaces: nanodecoder_tpu/ops/encoder_attention.py `_enc_attn_kernel_qkv`
// (the Pallas body of `flash_encoder_attention_qkv`, K1: Q, K and V as
// column slices of the fused (B, S, 3D) QKV slab), `_enc_attn_kernel_flat`
// (`flash_encoder_attention_nld`, K5: separate (B, S, D) q, k and v) and
// `_enc_attn_kernel` (`flash_encoder_attention`, K6: the (B, S, H, Dh)
// layout, which is K5's on the contiguous (B, S, H * Dh) view).  Each
// Pallas kernel keeps one batch row's (S, S) score tile in VMEM so the
// probabilities never reach device memory.  One kernel family serves all
// three: it takes a q, a k and a v pointer and the row stride between
// consecutive positions (3D for the slab, D otherwise).
//
// Math, per (batch row b, head h): logits = q.k^T accumulated in f32, then
// * scale; keys at positions >= lengths[b] are set to -1e9 (a select, so
// a length-0 padding row comes out uniform, never NaN); f32 softmax with
// max subtraction, accurate expf and an IEEE division by the row sum;
// probabilities rounded to the input dtype BEFORE the value product (no
// online rescaling of the output, which would move that rounding point);
// P.V accumulated in f32 and rounded to the output dtype.
//
// What bounds it on the H100: at the flagship shape (B 640, S 256, D 256,
// 2 heads of 128) one call moves 335 MB in bf16 (0.100 ms at 3.35 TB/s)
// and does at most 42.9 GFLOP (0.043 ms on the bf16 tensor cores), so the
// bf16 kernel is bytes-bound.  In f32 the exact-f32 requirement keeps it
// off the tensor cores (no TF32): 67 TFLOP/s on the CUDA cores, so the
// f32 kernel is operations-bound (0.32 ms for the keys its rows need).
//
// Both paths skip the K/V tiles that lie wholly at or past a row's length
// n (n > 0): those keys get probability exactly 0 (expf(-1e9 - max)
// underflows), so skipping them changes no result.  A length-0 row still
// goes over all S keys.
//
// bf16 path (`enc_attn_bf16`): tensor cores through mma.sync m16n8k16
// (bf16 in, f32 accumulate) fed by ldmatrix.  One block of 4 warps per
// (64 query rows, head, batch row); each warp owns 16 query rows, whose Q
// fragments stay in registers.  K and V tiles of 64 rows stream through a
// double-buffered cp.async ring of 4 slots (16 bytes a thread, rows padded
// by 16 bytes so ldmatrix is free of bank conflicts).  Two passes over K:
// the first takes each row's max and its sum of exp(s - max) (the sum
// rescaled when the max grows), the second recomputes the scores, forms
// the normalised probabilities, rounds them to bf16 and feeds them from
// registers as the A operand of the P.V mma, so they never touch shared
// memory.  Any S works.  The kernel is bound by latency, not by its work:
// a one-pass variant that kept the (16, S <= 256) scores in registers did
// 2/3 of the tensor work and read K once, but needed so many registers
// that one block fewer fit on an SM, and it was slower on the H100; so
// was a deeper ring (three K tiles in flight in pass 1).
//
// f32 path (`enc_attn_f32`): exact f32 FMAs on the CUDA cores.  One block
// of 256 threads per (32 query rows, head, batch row); the block's (32, S)
// score strip stays in shared memory, so one pass over K and one over V.
// Register tiles fed by float4 shared loads: for the scores the two
// halves of the block each take half of the head's channels with 4 x 4
// tiles (16 FMAs per K load), then add; for P.V a thread keeps 2 rows x 8
// columns at Dh 128.  Where the strip does not fit in shared memory (S
// over 1408 at Dh 128), `enc_attn_f32_2p` takes two passes over K instead,
// as the bf16 kernel does.
//
// Head dims: the kernels are instantiated for Dh 32, 64, 128 and 256; the
// wrapper pads other head dims up to 256 with zero lanes up to the next of
// them (zeros add nothing to a score or to P.V; the scale stays
// 1/sqrt(Dh) of the true Dh).  Head dims over 256 and operands that are
// not 16-byte aligned run `enc_attn_any`, a scalar kernel of the same
// math (below).  Every kernel loops over grid y and z, so any B and any
// number of heads run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxSmem = 227 * 1024;

// ---- shared helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + rows) of one head's DH-wide column slice (offset
// `col`) of an operand with row stride `ld` into shared memory with row
// stride `srow` elements.  Rows at or past `s` are zero-filled.
template <typename T, int DH, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int srow, const T* __restrict__ base,
                                          int r0, int rows, int s, int ld, int col) {
  constexpr int kChunks = DH * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks, row = r0 + r;
    const bool live = row < s;
    const T* src = live ? base + (size_t)row * ld + col + c * kPer : base;
    cp_async16(dst + r * srow + c * kPer, src, live ? 16 : 0);
  }
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

// p = e / l with IEEE rounding.  A zero numerator (a masked key) gives 0
// without the division, whose fast path does not take zeros: the result
// is the same, the slow path is skipped.
__device__ __forceinline__ float div_prob(float e, float l) {
  return e > 0.f ? __fdiv_rn(e, l) : 0.f;
}

// Keys each row of batch row b needs: all S for a length-0 row.
__device__ __forceinline__ int keys_needed(int n, int s) { return n > 0 ? min(n, s) : s; }

// Set the dynamic shared-memory limit of `kernel` once per device.
template <typename K>
cudaError_t allow_smem(K* kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kBQ = 64;          // query rows per block (16 per warp)
constexpr int kBK = 64;          // key/value rows per tile
constexpr int kThreads16 = 128;  // 4 warps
constexpr int kSlots = 4;        // K/V tiles in shared memory: two K/V pairs

template <int DH> __host__ __device__ constexpr int srow16() { return DH + 8; }  // +16 bytes
template <int DH> __host__ __device__ constexpr size_t smem16() {
  return kSlots * (size_t)kBK * srow16<DH>() * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The warp's 16 x 64 score tile against the K tile `ks`: sc[j] holds the
// mma C fragment of keys 8j .. 8j + 7 (rows g and g + 8, columns 2t and
// 2t + 1 of the lane), already scaled and masked.  Columns at or past `s`
// get -inf (no key there), columns at or past n get -1e9.
template <int DH>
__device__ __forceinline__ void score_tile(float (&sc)[8][4], const uint32_t (&qf)[DH / 16][4],
                                           const __nv_bfloat16* ks, int k0, int n, int s,
                                           float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      uint32_t b[4];
      ldsm_x4(b, ks + (nb * 8 + lane % 8 + 8 * (lane / 16)) * srow16<DH>() + kk * 16 +
                     8 * ((lane / 8) % 2));
      mma16816(sc[nb], qf[kk], b[0], b[1]);
      mma16816(sc[nb + 1], qf[kk], b[2], b[3]);
    }
  }
  if (k0 + kBK <= min(n, s)) {  // every key of the tile is live
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
      sc[j][e] = col >= s ? -INFINITY : (col < n ? sc[j][e] * scale : kNegInf);
    }
}

// Two passes over K per block, so any S works and the (16, S) scores are
// never held.  Stage i < nk is K tile i (pass 1), stage nk + t is K tile t
// and V tile t (pass 2); stage i goes to slots 2 (i % 2) and 2 (i % 2) + 1,
// one stage in flight while the other is used.
template <int DH>
__device__ __forceinline__ void enc_attn_bf16_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int s, int heads, int ld, float scale, int h, int b) {
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int SROW = srow16<DH>();
  auto slot = [&](int j) { return slots + j * kBK * SROW; };

  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * s * ld;
  const int col = h * DH;

  // Prologue: Q into slot 2 and K tile 0 (every row needs it) into slot
  // 0, started before the row's length is known; Q fragments to registers.
  load_rows<__nv_bfloat16, DH, kThreads16>(slot(2), SROW, q + row0, q0, kBQ, s, ld, col);
  load_rows<__nv_bfloat16, DH, kThreads16>(slot(0), SROW, k + row0, 0, kBK, s, ld, col);
  cp_async_commit();
  const int n = lengths[b];
  const int nk = (keys_needed(n, s) + kBK - 1) / kBK;  // K/V tiles this row needs
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qf[kk], slot(2) + (warp * 16 + lane % 16) * SROW + kk * 16 + 8 * (lane / 16));
  __syncthreads();

  auto load_stage = [&](int i) {
    const int t = i < nk ? i : i - nk;
    __nv_bfloat16* dst = slot(2 * (i % 2));
    load_rows<__nv_bfloat16, DH, kThreads16>(dst, SROW, k + row0, t * kBK, kBK, s, ld, col);
    if (i >= nk)
      load_rows<__nv_bfloat16, DH, kThreads16>(dst + kBK * SROW, SROW, v + row0, t * kBK,
                                               kBK, s, ld, col);
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int step = 0; step < 2 * nk; ++step) {
    if (step + 1 < 2 * nk) load_stage(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = slot(2 * (step % 2));
    float sc[8][4];
    if (step < nk) {
      // Pass 1: the row max and the sum of exp(s - max).
      score_tile<DH>(sc, qf, ks, step * kBK, n, s, scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        float sum = l[r] * expf(m[r] - mt);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += expf(sc[j][2 * r] - mt) + expf(sc[j][2 * r + 1] - mt);
        l[r] = sum;
        m[r] = mt;
      }
    } else {
      if (step == nk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
      }
      // Pass 2: normalised probabilities, rounded to bf16 and packed as
      // the A fragments of the P.V mma (keys 16kk .. 16kk + 15 are
      // pa[kk]: columns 2t, 2t + 1 of C fragments 2kk and 2kk + 1).
      score_tile<DH>(sc, qf, ks, (step - nk) * kBK, n, s, scale);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* c = sc[2 * kk + half];
          pa[kk][2 * half] = pack_bf16(div_prob(expf(c[0] - m[0]), l[0]),
                                       div_prob(expf(c[1] - m[0]), l[0]));
          pa[kk][2 * half + 1] = pack_bf16(div_prob(expf(c[2] - m[1]), l[1]),
                                           div_prob(expf(c[3] - m[1]), l[1]));
        }
      // o += P times the V tile (read transposed by ldmatrix).
      const __nv_bfloat16* vs = ks + kBK * SROW;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nb = 0; nb < DH / 8; nb += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * SROW + nb * 8 +
                            8 * (lane / 16));
          mma16816(o[nb], pa[kk], bv[0], bv[1]);
          mma16816(o[nb + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

  const int d = heads * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= s) continue;
    __nv_bfloat16* dst = out + ((size_t)b * s + qi) * d + col + 2 * (lane % 4);
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dst + nb * 8) =
          __floats2bfloat162_rn(o[nb][2 * r], o[nb][2 * r + 1]);
  }
}

// Block (x, y, z) takes query tile x of heads y, y + gridDim.y, ... of
// batch rows z, z + gridDim.z, ...: grid y and z stop at 65535, B and H
// do not.  The same loop wraps every kernel below.
template <int DH>
__global__ void __launch_bounds__(kThreads16)
enc_attn_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, int nb, int s, int heads, int ld,
              float scale) {
  for (int b = blockIdx.z; b < nb; b += gridDim.z)
    for (int h = blockIdx.y; h < heads; h += gridDim.y) {
      enc_attn_bf16_tile<DH>(q, k, v, lengths, out, s, heads, ld, scale, h, b);
      __syncthreads();  // the next (head, batch row) reuses shared memory
    }
}

// ---- f32: register-tiled CUDA cores ----------------------------------------

constexpr int kTQ = 32;          // query rows per block
constexpr int kTK = 64;          // key/value rows per tile
constexpr int kThreads32 = 256;  // 8 warps
constexpr int kTP = kTK + 4;     // row pitch of the two-pass kernel's score tile

template <int DH> __host__ __device__ constexpr int srow32() { return DH + 4; }  // keeps float4 rows aligned
__host__ __device__ inline int strip_stride(int s) { return (s + 31) / 32 * 32 + 8; }
size_t smem32(int dh, int s) {
  return sizeof(float) *
         ((size_t)(kTQ + kTK) * (dh + 4) + (size_t)kTQ * strip_stride(s));
}
size_t smem32_2p(int dh) {
  return sizeof(float) * ((size_t)(kTQ + kTK) * (dh + 4) + (size_t)kTQ * kTP);
}

// The value product's register tile: thread (ry, cx) owns RT rows and NV
// float4 column groups at 4cx + u * DH / 2.
template <int DH> struct PvTile {
  static constexpr int NV = DH >= 128 ? 2 : 1;
  static constexpr int TX = DH / (4 * NV);
  static constexpr int TY = kThreads32 / TX;
  static constexpr int RT = kTQ / TY;
};

// Scores of the block's kTQ query rows (qs) against the K tile in kv,
// keys k0 .. k0 + kTK - 1, into ss (row pitch sp) at column key - col0
// for keys < s: the two halves of the block take the two halves of the
// head's channels; thread (ty, tx) of a half owns rows 4ty .. 4ty + 3 and
// keys tx + 16j, a 4 x 4 register tile.  The first half leaves its
// partial sums in ss; the second adds its own, scales and masks (keys at
// or past n get -1e9).  Ends with the block synchronised.
template <int DH>
__device__ __forceinline__ void score_tile32(const float* qs, const float* kv, float* ss,
                                             int sp, int k0, int col0, int n, int s,
                                             float scale) {
  constexpr int SROW = srow32<DH>();
  const int tid = threadIdx.x;
  const int half = tid / 128, ty = (tid % 128) / 16, tx = tid % 16;
  float acc[4][4] = {};
#pragma unroll 4
  for (int c = half * (DH / 2); c < (half + 1) * (DH / 2); c += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * SROW + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(kv + (tx + 16 * j) * SROW + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(a[i].x, kk.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, kk.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, kk.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, kk.w, acc[i][j]);
      }
    }
  }
  if (half == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key < s) ss[(4 * ty + i) * sp + key - col0] = acc[i][j];
      }
  }
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float* cell = ss + (4 * ty + i) * sp + key - col0;
        if (key < s) *cell = key < n ? (*cell + acc[i][j]) * scale : kNegInf;
      }
  }
  __syncthreads();
}

// o += P (columns 0 .. jmax - 1 of p, row pitch sp, jmax a multiple of 4)
// times the V tile in kv.
template <int DH>
__device__ __forceinline__ void pv_tile32(const float* p, int sp, const float* kv, int jmax,
                                          float4 (&o)[PvTile<DH>::RT][PvTile<DH>::NV]) {
  using PT = PvTile<DH>;
  constexpr int SROW = srow32<DH>();
  const int ry = threadIdx.x / PT::TX, cx = threadIdx.x % PT::TX;
  for (int j = 0; j < jmax; j += 4) {
    float4 pr4[PT::RT];
#pragma unroll
    for (int r = 0; r < PT::RT; ++r)
      pr4[r] = *reinterpret_cast<const float4*>(p + (PT::RT * ry + r) * sp + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int u = 0; u < PT::NV; ++u) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kv + (j + jj) * SROW + 4 * cx + u * (DH / 2));
#pragma unroll
        for (int r = 0; r < PT::RT; ++r) {
          const float pr = jj == 0 ? pr4[r].x : jj == 1 ? pr4[r].y : jj == 2 ? pr4[r].z
                                                                             : pr4[r].w;
          o[r][u].x = fmaf(pr, vv.x, o[r][u].x);
          o[r][u].y = fmaf(pr, vv.y, o[r][u].y);
          o[r][u].z = fmaf(pr, vv.z, o[r][u].z);
          o[r][u].w = fmaf(pr, vv.w, o[r][u].w);
        }
      }
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_rows32(float* out, const float4 (&o)[PvTile<DH>::RT][PvTile<DH>::NV],
                                             int b, int q0, int s, int heads, int col) {
  using PT = PvTile<DH>;
  const int ry = threadIdx.x / PT::TX, cx = threadIdx.x % PT::TX;
  const int d = heads * DH;
#pragma unroll
  for (int r = 0; r < PT::RT; ++r) {
    const int qi = q0 + PT::RT * ry + r;
    if (qi >= s) continue;
    float* dst = out + ((size_t)b * s + qi) * d + col + 4 * cx;
#pragma unroll
    for (int u = 0; u < PT::NV; ++u) *reinterpret_cast<float4*>(dst + u * (DH / 2)) = o[r][u];
  }
}

// One pass over K and one over V: the block's (32, S) score strip stays
// in shared memory (S up to about 1400 at Dh 128, 1000 at Dh 256).
template <int DH>
__device__ __forceinline__ void enc_attn_f32_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ out, int s, int heads, int ld,
    float scale, int h, int b) {
  extern __shared__ float4 smem_f4[];
  constexpr int SROW = srow32<DH>();
  using PT = PvTile<DH>;
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kTQ][SROW]
  float* kv = qs + kTQ * SROW;                     // [kTK][SROW]
  float* ss = kv + kTK * SROW;                     // [kTQ][sp] scores, then probs
  const int sp = strip_stride(s);

  const int q0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * s * ld;
  const int col = h * DH;

  // Q and K tile 0 (every row needs it), started before the row's length
  // is known.
  load_rows<float, DH, kThreads32>(qs, SROW, q + row0, q0, kTQ, s, ld, col);
  load_rows<float, DH, kThreads32>(kv, SROW, k + row0, 0, kTK, s, ld, col);
  cp_async_commit();
  const int n = lengths[b];
  const int nk = (keys_needed(n, s) + kTK - 1) / kTK;
  const int kend = min(s, nk * kTK);  // keys past kend have probability 0

  for (int kt = 0; kt < nk; ++kt) {
    if (kt > 0) {
      load_rows<float, DH, kThreads32>(kv, SROW, k + row0, kt * kTK, kTK, s, ld, col);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    score_tile32<DH>(qs, kv, ss, sp, kt * kTK, 0, n, s, scale);
  }

  // Softmax over keys [0, kend); keys [kend, kend rounded up to 4) get 0
  // so the float4 reads of the value product see finite zeros.
  const int warp = tid / 32, lane = tid % 32;
  const int kend4 = (kend + 3) / 4 * 4;
  for (int r = warp; r < kTQ; r += kThreads32 / 32) {
    float* row = ss + r * sp;
    float mx = -INFINITY;
    for (int c = lane; c < kend; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < kend; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < kend4; c += 32) row[c] = c < kend ? div_prob(row[c], sum) : 0.f;
  }

  float4 o[PT::RT][PT::NV];
#pragma unroll
  for (int r = 0; r < PT::RT; ++r)
#pragma unroll
    for (int u = 0; u < PT::NV; ++u) o[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // probabilities complete; previous V tile consumed
    load_rows<float, DH, kThreads32>(kv, SROW, v + row0, kt * kTK, kTK, s, ld, col);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    pv_tile32<DH>(ss + kt * kTK, sp, kv, min(kTK, kend4 - kt * kTK), o);
  }
  store_rows32<DH>(out, o, b, q0, s, heads, col);
}

template <int DH>
__global__ void __launch_bounds__(kThreads32, 2)
enc_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ out, int nb, int s, int heads, int ld, float scale) {
  for (int b = blockIdx.z; b < nb; b += gridDim.z)
    for (int h = blockIdx.y; h < heads; h += gridDim.y) {
      enc_attn_f32_tile<DH>(q, k, v, lengths, out, s, heads, ld, scale, h, b);
      __syncthreads();
    }
}

// For an S whose strip does not fit: two passes over K, as the bf16
// kernel takes them.  Pass 1 keeps each row's max and its sum of
// exp(s - max), the sum rescaled when the max grows; pass 2 recomputes the
// scores tile by tile into a (32, 64) tile, forms the probabilities with
// the same max and sum, and takes the value product of the tile.
template <int DH>
__device__ __forceinline__ void enc_attn_f32_2p_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ out, int s, int heads, int ld,
    float scale, int h, int b) {
  extern __shared__ float4 smem_f4[];
  constexpr int SROW = srow32<DH>();
  constexpr int kRowsPerWarp = kTQ / (kThreads32 / 32);
  using PT = PvTile<DH>;
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kTQ][SROW]
  float* kv = qs + kTQ * SROW;                     // [kTK][SROW] a K tile, then a V tile
  float* st = kv + kTK * SROW;                     // [kTQ][kTP] one tile's scores

  const int q0 = blockIdx.x * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * s * ld;
  const int col = h * DH;

  load_rows<float, DH, kThreads32>(qs, SROW, q + row0, q0, kTQ, s, ld, col);
  load_rows<float, DH, kThreads32>(kv, SROW, k + row0, 0, kTK, s, ld, col);
  cp_async_commit();
  const int n = lengths[b];
  const int nk = (keys_needed(n, s) + kTK - 1) / kTK;
  const int kend = min(s, nk * kTK);

  // Pass 1: warp w keeps rows w + 8i, its lanes holding the same max and sum.
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt > 0) {
      load_rows<float, DH, kThreads32>(kv, SROW, k + row0, kt * kTK, kTK, s, ld, col);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    score_tile32<DH>(qs, kv, st, kTP, kt * kTK, kt * kTK, n, s, scale);
    const int cols = min(kTK, kend - kt * kTK);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float* row = st + (warp + 8 * i) * kTP;
      float mt = m[i];
      for (int c = lane; c < cols; c += 32) mt = fmaxf(mt, row[c]);
      mt = warp_max(mt);
      float sum = 0.f;
      for (int c = lane; c < cols; c += 32) sum += expf(row[c] - mt);
      l[i] = l[i] * expf(m[i] - mt) + warp_sum(sum);
      m[i] = mt;
    }
    __syncthreads();  // the tile's scores are consumed
  }

  // Pass 2.
  float4 o[PT::RT][PT::NV];
#pragma unroll
  for (int r = 0; r < PT::RT; ++r)
#pragma unroll
    for (int u = 0; u < PT::NV; ++u) o[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < nk; ++kt) {
    load_rows<float, DH, kThreads32>(kv, SROW, k + row0, kt * kTK, kTK, s, ld, col);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    score_tile32<DH>(qs, kv, st, kTP, kt * kTK, kt * kTK, n, s, scale);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* row = st + (warp + 8 * i) * kTP;
      for (int c = lane; c < kTK; c += 32)
        row[c] = kt * kTK + c < kend ? div_prob(expf(row[c] - m[i]), l[i]) : 0.f;
    }
    __syncthreads();  // probabilities complete; the K tile is consumed
    load_rows<float, DH, kThreads32>(kv, SROW, v + row0, kt * kTK, kTK, s, ld, col);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    pv_tile32<DH>(st, kTP, kv, min(kTK, (kend - kt * kTK + 3) / 4 * 4), o);
    __syncthreads();  // the V tile and the probabilities are consumed
  }
  store_rows32<DH>(out, o, b, q0, s, heads, col);
}

template <int DH>
__global__ void __launch_bounds__(kThreads32, 2)
enc_attn_f32_2p(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ lengths,
                float* __restrict__ out, int nb, int s, int heads, int ld, float scale) {
  for (int b = blockIdx.z; b < nb; b += gridDim.z)
    for (int h = blockIdx.y; h < heads; h += gridDim.y) {
      enc_attn_f32_2p_tile<DH>(q, k, v, lengths, out, s, heads, ld, scale, h, b);
      __syncthreads();
    }
}

// ---- any head dim, any alignment: the scalar kernel ---------------------------

// For head dims without an instantiation above 256 and for operands that
// are not 16-byte aligned in base or row stride (such as a view at an odd
// element offset), both dtypes: plain loads of one element, any Dh in
// slices.  One block of 256 threads per (kAnyRows query rows, head, batch
// row); warp r owns query row r.  Two passes over K, as the bf16 kernel
// takes them: pass 1 keeps each row's max and its sum of exp(s - max)
// (the sum rescaled when the max grows); pass 2 recomputes the scores,
// forms the probabilities, rounds them to the input dtype and adds P.V
// into f32 accumulators in shared memory.  Scores of a 64-key tile
// accumulate over Dh in slices of 32 channels, each slice of the K tile
// staged in shared memory with coalesced loads (a lane a key, two keys a
// lane).  Shared memory: the rows' f32 queries and accumulators (2 x rows
// x Dh floats), one K slice, one tile of probabilities: 45 KB at Dh 512
// and 8 rows; fewer rows a block at larger Dh.
constexpr int kAnyRows = 8;    // query rows per block, one a warp
constexpr int kAnyKeys = 64;   // keys per tile, two a lane
constexpr int kAnySlice = 32;  // channels per staged K slice

__device__ __forceinline__ float elt_f32(float x) { return x; }
__device__ __forceinline__ float elt_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_elt(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// A probability as the value product sees it: rounded to the input dtype.
__device__ __forceinline__ float prob_as(float p, float) { return p; }
__device__ __forceinline__ float prob_as(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

size_t any_smem(int rows, int dh) {
  return sizeof(float) * (2 * (size_t)rows * dh + (size_t)kAnyKeys * (kAnySlice + 1) +
                          (size_t)rows * kAnyKeys);
}

// Query rows per block: up to 8 whose queries and accumulators fit; 0 if
// not even one row's do (Dh over about 29,000).
int any_rows(int dh) {
  int rows = kAnyRows;
  while (rows > 0 && any_smem(rows, dh) > (size_t)kMaxSmem) --rows;
  return rows;
}

// The (rows, 64) scores of query rows q0.. against keys k0 .. k0 + 63 for
// warp `warp`'s row, into sc0 (key k0 + lane) and sc1 (key k0 + 32 +
// lane): scaled, -1e9 at or past n, -inf at or past s.  Every thread of
// the block takes part (the K slices are staged together).
template <typename T>
__device__ __forceinline__ void any_scores(const float* qs, float* kt, const T* __restrict__ k,
                                           size_t row0, int ld, int col, int dh, int k0,
                                           int n, int s, int rows, float scale, float& sc0,
                                           float& sc1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a0 = 0.f, a1 = 0.f;
  for (int c0 = 0; c0 < dh; c0 += kAnySlice) {
    const int w = min(kAnySlice, dh - c0);
    __syncthreads();  // the previous slice (or tile's use of kt) is consumed
    for (int i = threadIdx.x; i < kAnyKeys * kAnySlice; i += blockDim.x) {
      const int r = i / kAnySlice, c = i % kAnySlice, key = k0 + r;
      kt[r * (kAnySlice + 1) + c] =
          key < s && c < w ? elt_f32(k[row0 + (size_t)key * ld + col + c0 + c]) : 0.f;
    }
    __syncthreads();
    if (warp < rows) {
      const float* qr = qs + (size_t)warp * dh + c0;
      for (int c = 0; c < w; ++c) {
        a0 = fmaf(qr[c], kt[lane * (kAnySlice + 1) + c], a0);
        a1 = fmaf(qr[c], kt[(lane + 32) * (kAnySlice + 1) + c], a1);
      }
    }
  }
  const int key0 = k0 + lane, key1 = k0 + 32 + lane;
  sc0 = key0 >= s ? -INFINITY : (key0 < n ? a0 * scale : kNegInf);
  sc1 = key1 >= s ? -INFINITY : (key1 < n ? a1 * scale : kNegInf);
}

template <typename T>
__device__ __forceinline__ void enc_attn_any_tile(const T* __restrict__ q,
                                                  const T* __restrict__ k,
                                                  const T* __restrict__ v,
                                                  const int* __restrict__ lengths,
                                                  T* __restrict__ out, int s, int heads,
                                                  int dh, int ld, int rows, float scale,
                                                  int h, int b) {
  extern __shared__ float smem_any[];
  float* qs = smem_any;                           // [rows][Dh] f32 queries
  float* acc = qs + (size_t)rows * dh;            // [rows][Dh] P.V sums
  float* kt = acc + (size_t)rows * dh;            // [64][33] a K slice
  float* ps = kt + kAnyKeys * (kAnySlice + 1);    // [rows][64] probabilities
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * s * ld;
  const int col = h * dh;

  for (int i = threadIdx.x; i < rows * dh; i += blockDim.x) {
    const int r = i / dh, qi = q0 + r;
    qs[i] = qi < s ? elt_f32(q[row0 + (size_t)qi * ld + col + i % dh]) : 0.f;
    acc[i] = 0.f;
  }
  const int n = lengths[b];
  const int nk = (keys_needed(n, s) + kAnyKeys - 1) / kAnyKeys;
  const int kend = min(s, nk * kAnyKeys);  // keys past kend have probability 0

  // Pass 1 (any_scores synchronises before it first reads qs).
  float m = -INFINITY, l = 0.f;
  for (int kt_i = 0; kt_i < nk; ++kt_i) {
    float sc0, sc1;
    any_scores(qs, kt, k, row0, ld, col, dh, kt_i * kAnyKeys, n, s, rows, scale, sc0, sc1);
    const float mt = warp_max(fmaxf(m, fmaxf(sc0, sc1)));
    const float sum = warp_sum(expf(sc0 - mt) + expf(sc1 - mt));
    l = l * expf(m - mt) + sum;
    m = mt;
  }

  // Pass 2.
  for (int kt_i = 0; kt_i < nk; ++kt_i) {
    const int k0 = kt_i * kAnyKeys;
    float sc0, sc1;
    any_scores(qs, kt, k, row0, ld, col, dh, k0, n, s, rows, scale, sc0, sc1);
    if (warp < rows) {
      ps[warp * kAnyKeys + lane] =
          k0 + lane < kend ? prob_as(div_prob(expf(sc0 - m), l), T()) : 0.f;
      ps[warp * kAnyKeys + 32 + lane] =
          k0 + 32 + lane < kend ? prob_as(div_prob(expf(sc1 - m), l), T()) : 0.f;
    }
    __syncthreads();
    const int keys = min(kAnyKeys, kend - k0);
    for (int i = threadIdx.x; i < rows * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      const float* pr = ps + r * kAnyKeys;
      const T* vc = v + row0 + (size_t)k0 * ld + col + c;
      float a = acc[i];
      for (int j = 0; j < keys; ++j) a = fmaf(pr[j], elt_f32(vc[(size_t)j * ld]), a);
      acc[i] = a;
    }
  }
  __syncthreads();
  const int d = heads * dh;
  for (int i = threadIdx.x; i < rows * dh; i += blockDim.x) {
    const int qi = q0 + i / dh;
    if (qi < s) store_elt(out + ((size_t)b * s + qi) * d + col + i % dh, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
enc_attn_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ lengths, T* __restrict__ out, int nb, int s, int heads,
             int dh, int ld, int rows, float scale) {
  for (int b = blockIdx.z; b < nb; b += gridDim.z)
    for (int h = blockIdx.y; h < heads; h += gridDim.y) {
      enc_attn_any_tile<T>(q, k, v, lengths, out, s, heads, dh, ld, rows, scale, h, b);
      __syncthreads();
    }
}

// ---- launch ------------------------------------------------------------------

// Grid y and z, capped at 65535; the kernels loop over the rest.
dim3 grid_of(int tiles, int heads, int b) {
  return dim3(tiles, heads < 65535 ? heads : 65535, b < 65535 ? b : 65535);
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* lengths,
                        void* out, int b, int s, int heads, int ld, float scale,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(enc_attn_bf16<DH>, done);
  if (err != cudaSuccess) return err;
  enc_attn_bf16<DH><<<grid_of((s + kBQ - 1) / kBQ, heads, b), kThreads16, smem16<DH>(),
                      stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), b, s,
      heads, ld, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* lengths,
                       void* out, int b, int s, int heads, int ld, float scale,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> done{0}, done_2p{0};
  const dim3 grid = grid_of((s + kTQ - 1) / kTQ, heads, b);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  cudaError_t err;
  if (smem32(DH, s) <= (size_t)kMaxSmem) {
    err = allow_smem(enc_attn_f32<DH>, done);
    if (err != cudaSuccess) return err;
    enc_attn_f32<DH><<<grid, kThreads32, smem32(DH, s), stream>>>(
        qf, kf, vf, lengths, static_cast<float*>(out), b, s, heads, ld, scale);
  } else {
    err = allow_smem(enc_attn_f32_2p<DH>, done_2p);
    if (err != cudaSuccess) return err;
    enc_attn_f32_2p<DH><<<grid, kThreads32, smem32_2p(DH), stream>>>(
        qf, kf, vf, lengths, static_cast<float*>(out), b, s, heads, ld, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* q, const void* k, const void* v, const int* lengths,
                       void* out, int b, int s, int heads, int dh, int ld, float scale,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const int rows = any_rows(dh);
  if (rows == 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(enc_attn_any<T>, done);
  if (err != cudaSuccess) return err;
  enc_attn_any<T><<<grid_of((s + rows - 1) / rows, heads, b), 256, any_smem(rows, dh),
                    stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), lengths, static_cast<T*>(out), b, s,
                              heads, dh, ld, rows, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: the first element of position 0 of batch row 0 of each
// operand; position p of batch row b starts at (b * s + p) * ld elements
// after it.  out: (B, S, heads * dh), contiguous.  Head dims 32, 64, 128
// and 256 with all three operands and out 16-byte aligned and ld a
// multiple of 16 bytes run the fast kernels; everything else runs the
// scalar kernel.  *launched reports which: 0 fast, 1 scalar.
extern "C" int nd_encoder_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int b, int s,
                                    int heads, int dh, int ld, int is_bf16, float scale,
                                    void* stream, int* launched) {
  const int elt = is_bf16 ? 2 : 4;
  if (b <= 0 || s <= 0 || heads <= 0 || dh <= 0 || ld < heads * dh)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0 &&
      ((long long)ld * elt) % 16 == 0;
  const bool fast = aligned && (dh == 32 || dh == 64 || dh == 128 || dh == 256);
  *launched = fast ? 0 : 1;
  if (!fast)
    return (int)(is_bf16 ? launch_any<__nv_bfloat16>(q, k, v, len, out, b, s, heads, dh, ld,
                                                     scale, st)
                         : launch_any<float>(q, k, v, len, out, b, s, heads, dh, ld, scale,
                                             st));
  if (is_bf16) {
    switch (dh) {
      case 32: return (int)launch_bf16<32>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 64: return (int)launch_bf16<64>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 128: return (int)launch_bf16<128>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 256: return (int)launch_bf16<256>(q, k, v, len, out, b, s, heads, ld, scale, st);
    }
  } else {
    switch (dh) {
      case 32: return (int)launch_f32<32>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 64: return (int)launch_f32<64>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 128: return (int)launch_f32<128>(q, k, v, len, out, b, s, heads, ld, scale, st);
      case 256: return (int)launch_f32<256>(q, k, v, len, out, b, s, heads, ld, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
