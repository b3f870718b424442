// One-token attention over a (B, T, Dk) decode cache (kernels K4a, K4b).
//
// Replaces: nanodecoder_tpu/ops/attention.py `_decode_attn_kernel` (the
// Pallas body of `decode_attention`, K4a: one query row per cache row)
// and `_decode_attn_grouped_kernel` (`decode_attention_grouped`, K4b: the
// G beams of a chunk against the chunk's one cache row, read once), one
// kernel each.  The cache holds n_kv heads of Dh lanes, Dk = n_kv * Dh:
// MHA (n_kv = H, D = Dk) or GQA/MQA (n_kv dividing H, query head h
// reading KV head h // (H / n_kv)) in exact dtypes, as the JAX kernels
// take them; int8 caches are MHA only, as JAX asserts.
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
// What bounds it on the H100: bytes.  At B 640, T 256, D 256 K4a reads
// 168 MB of bf16 K/V (0.050 ms at 3.35 TB/s; f32 0.100 ms, int8 0.025
// ms) and does 0.17 GFLOP.  K4b reads each chunk's cache once for its G
// beams, so its bytes fall by G against K4a on tiled caches (B 256 x G 5:
// 0.020 ms in bf16).  Rows at t >= valid are masked to probability
// exactly 0 and are not read; a length-0 padding row reads no K (every
// score is -1e9 whatever K holds) and all T rows of V (it attends
// uniformly).
//
// K4a (`decode_attn_row_kernel`): one block of 256 threads per cache row,
// built to keep bytes in flight in every dtype.  A thread owns 16 bytes of
// a cache row (4 f32, 8 bf16 or 16 int8 lanes), so Dk * elt / 16 threads
// cover a row and the block walks 256 / that many rows per pass.  Each
// thread keeps loads for 4 rows in flight, and issues the next batch's
// loads before it uses the current one, so a block has 16 to 32 KB in
// flight; K and V are one stream, so V's first batch loads while the
// softmax runs.  The Dh / lanes threads of a head reduce their dot
// products with shuffles; the H x T f32 scores live in shared memory,
// where one warp per head takes the softmax; P.V accumulates per thread in
// registers and the row groups' partial sums meet in shared memory.
// int8 lanes convert through f32 bit tricks, not I2F (whose quarter rate
// would sit near the bytes bound).  GQA: a thread's lanes belong to one KV
// head, and it computes the scores and P.V sums of all H / n_kv query
// heads that read it (instantiated for up to 1, 2, 4 or 8 of them).
//
// Shapes: K4a's row kernel takes the shapes whose Dh is a power-of-two
// number of 16-byte loads, at most 32, with at most 8 query heads per KV
// head and a cache row of at most 256 loads (a thread takes 16 bytes of
// it; threads past the last whole row of a pass idle, so D 384 in bf16
// runs on 240 of 256).  K4b's grouped kernel takes MHA caches with Dh a
// multiple of 16 and D <= 1024, any group: a block runs up to 8 beams
// and a group over 8 is split into equal sub-groups, one block each, that
// read the chunk's cache each.  Every other shape (any Dh, any width, any
// number of query heads per KV head, GQA in K4b, unaligned widths, and
// caches whose base is not 16-byte aligned, such as a view at an odd
// offset) runs `decode_attn_any_kernel`, a plain scalar kernel: one block
// per cache row and sub-group of up to 8 query rows; a thread per
// (position, row, head) takes a score, a warp per (row, head) its
// softmax, a thread per output channel its P.V sums.  Its scores sit in
// shared memory, or, where one query row's H x T f32 scores do not fit
// there (H * T over about 57,000, e.g. 32 heads at T 1800), in a
// (rows, H, T) f32 workspace in device memory that the wrapper allocates
// (`nd_decode_attention_workspace` says when).  It keeps the JAX
// kernels' contract, 10 to 150 times under the fast kernels' bound
// shares (PERF.md section 6).  Of the repository's models only the tiny
// test config (Dh 8) runs it, in K4b on its beam path.  The launcher
// reports which kernel it launched, so the wrappers count the scalar
// kernel's launches apart.
//
// K4b (`decode_attn_grouped_kernel`, group 2 to 8 a block): at G 5 a row design
// is latency-bound (G dot products per loaded row, each ending in
// shuffle rounds), so K4b has its own kernel.  One block of 256 threads per
// chunk streams the chunk's K rows, then its V rows, through a 4-stage
// ring of cp.async tiles of about 16 KB (32 rows of bf16 or int8, 16 of
// f32 at D 256; 16 bytes a thread; three stages in flight while one is
// used, so a block keeps about 50 KB in flight; rows padded by 16 bytes
// so the column reads below are free of bank conflicts), and the stages
// of V are already in flight while the softmax runs.  Scores: one warp
// per head; a lane takes one cache row of the stage (in f32 two lanes
// share a row and one shuffle adds their halves) and computes all G dot
// products from it, the G queries read from shared memory as broadcasts.
// The G x H x T scores stay in shared memory for the per-(beam, head)
// softmax and the head-summed argmax, as before.  P.V: a thread owns one
// output channel (up to four at D > 256) and keeps G accumulators,
// reading four probabilities per float4.  Instantiated for each G, so
// registers match it.  At G 5, H 8, T 256 a block takes 111 KB of shared
// memory in bf16 (79 KB in int8): two blocks per SM, so the 256 blocks of
// a beam batch of 256 chunks are all resident at once; the ring's depth,
// not a third block, supplies the bytes in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kVec = 8;         // K4b: cache lanes per load8
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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

// ---- K4a: one query row per cache row ----------------------------------------

constexpr int kRowsAhead = 4;    // cache rows a thread has 16-byte loads in flight for
constexpr int kMaxSmem = 227 * 1024;

// 16 bytes of cache lanes to f32: 4 f32, 8 bf16 or 16 int8 lanes.  bf16
// is the high half of an f32; an int8 byte x goes through the f32
// 2^23 + (x + 128) and one subtraction, exact and cheaper than I2F.
__device__ __forceinline__ void unpack16(const uint4& u, float* o, float) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o, int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + j)) - 8388736.f;
  }
}

// Score rows padded to 1 mod 32 floats, so that the heads' entries of one
// position fall in distinct banks.
__host__ __device__ inline int row_score_stride(int t) { return (t + 31) / 32 * 32 + 1; }

// Floats before the partial sums: the query and the scores, rounded up
// to 16 bytes for the float4 stores.
__host__ __device__ inline int row_red_offset(int d, int heads, int ts) {
  return (d + heads * ts + 3) / 4 * 4;
}

size_t row_smem(int t, int d, int dk, int heads, int elt) {
  const int rows = kThreads / (dk * elt / 16);
  return sizeof(float) * ((size_t)row_red_offset(d, heads, row_score_stride(t)) +
                          (size_t)rows * d);
}

// GRP: query heads per KV head that a thread keeps registers for (1 for
// MHA; for GQA the smallest of 2, 4, 8 that holds H / n_kv).
template <typename TQ, typename TKV, int GRP>
__global__ void __launch_bounds__(kThreads, GRP == 1 ? 3 : 1)
decode_attn_row_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const int* __restrict__ lens,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       TQ* __restrict__ out, int* __restrict__ amax, int t_len, int d,
                       int dk, int heads, int grp, float scale) {
  constexpr int kLanes = 16 / (int)sizeof(TKV);  // cache lanes per 16-byte load
  extern __shared__ float smem[];
  const int ts = row_score_stride(t_len);
  const int dh = d / heads;
  const int chunks = dk / kLanes;                // threads per cache row
  const int rows = kThreads / chunks;            // cache rows per pass
  const int lph = dh / kLanes;                   // threads per head of a row
  float* qs = smem;                              // [D] f32 queries
  float* ss = qs + d;                            // [H][ts] scores, then probabilities
  float* red = smem + row_red_offset(d, heads, ts);  // [rows][D] partial P.V sums

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = tid % chunks, r = tid / chunks;
  const bool active = r < rows;                  // threads past the last whole row idle
  const int kv = c / lph, cl = c % lph;          // this thread's KV head, slot in it
  const int n = lens[b];
  const int nk = n > 0 ? min(n, t_len) : 0;      // K rows scored (length 0: all masked)
  const int nv = n > 0 ? nk : t_len;             // V rows read (length 0: uniform)
  const int step = rows * kRowsAhead;
  const int nbk = (nk + step - 1) / step, nb = nbk + (nv + step - 1) / step;
  const size_t base = (size_t)b * t_len * dk;

  // Batch i < nbk: K rows [i step, +step); batch nbk + j: V rows of batch
  // j.  A thread takes rows r + u * rows of a batch, 16 bytes of each.
  uint4 nxt[kRowsAhead];
  auto load = [&](int i) {
    const bool is_k = i < nbk;
    const uint4* src = reinterpret_cast<const uint4*>((is_k ? k : v) + base) + c;
    const int t0 = (is_k ? i : i - nbk) * step + r, lim = is_k ? nk : nv;
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const int t = t0 + u * rows;
      nxt[u] = active && t < lim ? __ldg(src + (size_t)t * chunks)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);

  for (int i = tid; i < d; i += kThreads) {
    float x = to_f32(q[(size_t)b * d + i]);
    if (ks != nullptr) x *= ks[(size_t)b * d + i];
    qs[i] = x;
  }
  const int tail = t_len - nk;
  for (int i = tid; i < heads * tail; i += kThreads)
    ss[(size_t)(i / tail) * ts + nk + i % tail] = kNegInf;
  __syncthreads();

  // The queries of this thread's lanes: in registers for MHA, read from
  // shared memory per row for GQA (up to GRP heads).
  float qr[GRP == 1 ? kLanes : 1];
  if constexpr (GRP == 1) {
#pragma unroll
    for (int e = 0; e < kLanes; ++e) qr[e] = qs[kv * dh + cl * kLanes + e];
  }

  // Scores.  Trip counts are uniform over the block, so every lane takes
  // part in the shuffles; rows past nk hold zeros and store nothing.
  for (int i = 0; i < nbk; ++i) {
    uint4 cur[kRowsAhead];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) cur[u] = nxt[u];
    if (i + 1 < nb) load(i + 1);  // the last K batch starts V's first
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const int t = i * step + u * rows + r;
      float kf[kLanes];
      unpack16(cur[u], kf, TKV());
#pragma unroll
      for (int j = 0; j < GRP; ++j) {
        if (j < grp) {
          float part = 0.f;
          if constexpr (GRP == 1) {
#pragma unroll
            for (int e = 0; e < kLanes; ++e) part = fmaf(kf[e], qr[e], part);
          } else {
            const float* qh = qs + (kv * grp + j) * dh + cl * kLanes;
#pragma unroll
            for (int e = 0; e < kLanes; ++e) part = fmaf(kf[e], qh[e], part);
          }
          for (int o = lph / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          if (active && t < nk && cl == 0) ss[(size_t)(kv * grp + j) * ts + t] = part * scale;
        }
      }
    }
  }
  __syncthreads();

  // Softmax: one warp per head.  A masked position's 0 skips the IEEE
  // division (whose fast path does not take zeros); the quotient is 0.
  for (int h = warp; h < heads; h += kThreads / 32) {
    float* row = ss + (size_t)h * ts;
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
    for (int t = lane; t < t_len; t += 32) {
      const float e = row[t];
      row[t] = e > 0.f ? __fdiv_rn(e, z) : 0.f;
    }
  }
  __syncthreads();

  // Attention position (warp 0): lowest t with the largest head sum.
  if (warp == 0) {
    float best = -INFINITY;
    int best_t = t_len;
    for (int t = lane; t < t_len; t += 32) {
      float s = ss[t];
      for (int hh = 1; hh < heads; ++hh) s += ss[(size_t)hh * ts + t];
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
    if (lane == 0) amax[b] = best_t;
  }

  // P.V over this thread's rows, p rounded to the V dtype; then the row
  // groups' partial sums meet in shared memory.
  float acc[GRP][kLanes];
#pragma unroll
  for (int j = 0; j < GRP; ++j)
#pragma unroll
    for (int e = 0; e < kLanes; ++e) acc[j][e] = 0.f;
  for (int i = nbk; i < nb; ++i) {
    uint4 cur[kRowsAhead];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) cur[u] = nxt[u];
    if (i + 1 < nb) load(i + 1);
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const int t = (i - nbk) * step + u * rows + r;
      if (active && t < nv) {
        float vf[kLanes];
        unpack16(cur[u], vf, TKV());
#pragma unroll
        for (int j = 0; j < GRP; ++j) {
          if (j < grp) {
            const float p = p_as<TKV>(ss[(size_t)(kv * grp + j) * ts + t]);
#pragma unroll
            for (int e = 0; e < kLanes; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < GRP; ++j) {
    if (active && j < grp) {
      float4* dst = reinterpret_cast<float4*>(red + (size_t)r * d + (kv * grp + j) * dh +
                                              cl * kLanes);
#pragma unroll
      for (int e = 0; e < kLanes; e += 4)
        dst[e / 4] = make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < d; i += kThreads) {
    float s = red[i];
    for (int rr = 1; rr < rows; ++rr) s += red[(size_t)rr * d + i];
    if (vs != nullptr) s *= vs[(size_t)b * d + i];
    out[(size_t)b * d + i] = from_f32<TQ>(s);
  }
}

// Raise a kernel's dynamic shared-memory limit to the most a block may
// have, once per kernel and device (not once per launch).
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename TQ, typename TKV, int GRP>
cudaError_t launch_row(const void* q, const void* k, const void* v, const int* lens,
                       const float* ks, const float* vs, void* out, int* amax, int b, int t,
                       int d, int dk, int heads, float scale, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_max_smem(decode_attn_row_kernel<TQ, TKV, GRP>, done);
  if (err != cudaSuccess) return err;
  const size_t smem = row_smem(t, d, dk, heads, (int)sizeof(TKV));
  decode_attn_row_kernel<TQ, TKV, GRP><<<b, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lens, ks, vs, static_cast<TQ*>(out), amax, t, d, dk, heads, heads / (dk / (d / heads)),
      scale);
  return cudaGetLastError();
}

// ---- K4b: the grouped kernel -------------------------------------------------

constexpr int kStages = 4;       // ring depth: three stages in flight while one is used
constexpr int kMaxD = 1024;      // P.V: each thread owns D / 256 <= 4 channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// Cache rows per ring stage: 32 (one per lane) for bf16 and int8, 16 for
// f32 (two lanes per row), so a bf16 or f32 stage holds about 16 KB at
// D 256.  Ring rows are padded by 16 bytes, so the rows that lanes read
// at one column fall in distinct banks.
__host__ __device__ constexpr int ring_rows(int elt) { return elt == 4 ? 16 : 32; }
__host__ __device__ inline int ring_row_bytes(int d, int elt) { return d * elt + 16; }
__host__ __device__ inline int score_stride(int t, int rows) {
  return (t + rows - 1) / rows * rows;
}

size_t grouped_smem(int group, int t, int d, int heads, int elt) {
  const int rows = ring_rows(elt);
  return sizeof(float) * ((size_t)group * d + (size_t)group * heads * score_stride(t, rows)) +
         (size_t)kStages * rows * ring_row_bytes(d, elt);
}

template <typename TQ, typename TKV, int G, int KC>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_grouped_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                           const TKV* __restrict__ v, const int* __restrict__ lens,
                           const float* __restrict__ ks, const float* __restrict__ vs,
                           TQ* __restrict__ out, int* __restrict__ amax, int t_len, int d,
                           int heads, int group, float scale) {
  extern __shared__ float4 smem_f4[];
  constexpr int kRows = ring_rows((int)sizeof(TKV));
  constexpr int kLanesPerRow = 32 / kRows;
  const int ts = score_stride(t_len, kRows);
  const int dh = d / heads;
  const int rb = ring_row_bytes(d, (int)sizeof(TKV));
  float* qs = reinterpret_cast<float*>(smem_f4);              // [G][D] f32 queries
  float* ss = qs + G * d;                                      // [G * H][ts] scores, probs
  char* ring = reinterpret_cast<char*>(ss + (size_t)G * heads * ts);  // [kStages][kRows][rb]

  // Block (b, y) takes the beams g0 .. g0 + gn - 1 of chunk b; the rest of
  // its G query slots hold zeros and store nothing.
  const int b = blockIdx.x, g0 = blockIdx.y * G, gn = min(G, group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = lens[b];
  const int n_eff = n > 0 ? min(n, t_len) : t_len;
  const int nk = (n_eff + kRows - 1) / kRows;
  const size_t base = (size_t)b * t_len * d;

  // Stage i < nk: K rows [kRows i, +kRows); stage nk + j: V rows of tile
  // j.  Rows at or past n_eff are zero-filled, never read.
  auto load_stage = [&](int i) {
    const TKV* src = i < nk ? k : v;
    const int t0 = (i < nk ? i : i - nk) * kRows;
    char* dst = ring + (size_t)(i % kStages) * kRows * rb;
    const int chunks = d * (int)sizeof(TKV) / 16;
    for (int c = tid; c < kRows * chunks; c += kThreads) {
      const int r = c / chunks, off = (c % chunks) * 16;
      const bool live = t0 + r < n_eff;
      const char* g = reinterpret_cast<const char*>(src + base + (size_t)(t0 + r) * d) + off;
      cp_async16(dst + r * rb + off, live ? g : reinterpret_cast<const char*>(src), live ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < 2 * nk) load_stage(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int i = tid; i < G * d; i += kThreads) {
    float x = 0.f;
    if (i < gn * d) {
      x = to_f32(q[((size_t)b * group + g0) * d + i]);
      if (ks != nullptr) x *= ks[(size_t)b * d + i % d];
    }
    qs[i] = x;
  }
  for (int i = tid; i < G * heads * (t_len - n_eff); i += kThreads) {
    const int tail = t_len - n_eff;
    ss[(size_t)(i / tail) * ts + n_eff + i % tail] = kNegInf;
  }

  // Registers for the P.V product: thread owns channels tid + 256 c,
  // c < KC (KC 1 for D <= 256, else 4).
  float acc[G][KC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[g][c] = 0.f;

  const int part_of_row = lane / kRows, r = lane % kRows;
  for (int i = 0; i < 2 * nk; ++i) {
    if (i + kStages - 1 < 2 * nk) load_stage(i + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    const char* stage = ring + (size_t)(i % kStages) * kRows * rb;

    if (i < nk) {
      // Scores: warp per head; lane r % kRows takes row r of the stage and
      // (for f32, split over two lanes) the head's channels for all G
      // queries; for f32 one shuffle adds the two halves.
      const int t = i * kRows + r;
      const bool live = t < n_eff;
      const TKV* krow = reinterpret_cast<const TKV*>(stage + r * rb);
      for (int h = warp; h < heads; h += kThreads / 32) {
        const int c0 = h * dh + part_of_row * (dh / kLanesPerRow);
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
        for (int c = c0; c < c0 + dh / kLanesPerRow; c += kVec) {
          float kf[kVec];
          load8(krow + c, kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qa = *reinterpret_cast<const float4*>(qs + g * d + c);
            const float4 qb = *reinterpret_cast<const float4*>(qs + g * d + c + 4);
            part[g] = fmaf(kf[0], qa.x, part[g]);
            part[g] = fmaf(kf[1], qa.y, part[g]);
            part[g] = fmaf(kf[2], qa.z, part[g]);
            part[g] = fmaf(kf[3], qa.w, part[g]);
            part[g] = fmaf(kf[4], qb.x, part[g]);
            part[g] = fmaf(kf[5], qb.y, part[g]);
            part[g] = fmaf(kf[6], qb.z, part[g]);
            part[g] = fmaf(kf[7], qb.w, part[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = part[g];
          if (kLanesPerRow == 2) s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (live && part_of_row == 0)
            ss[(size_t)(g * heads + h) * ts + t] = t < n ? s * scale : kNegInf;
        }
      }
    } else {
      if (i == nk) {
        // Softmax: one warp per (beam, head) row of scores.
        for (int j = warp; j < G * heads; j += kThreads / 32) {
          float* row = ss + (size_t)j * ts;
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
          // A masked position's 0 skips the division (whose fast path does
          // not take zeros); the quotient would be the same 0.
          for (int t = lane; t < t_len; t += 32) {
            const float e = row[t];
            row[t] = e > 0.f ? __fdiv_rn(e, z) : 0.f;
          }
        }
        __syncthreads();
        // Attention position: one warp per beam; lowest t on ties.
        for (int g = warp; g < gn; g += kThreads / 32) {
          const float* pg = ss + (size_t)g * heads * ts;
          float best = -INFINITY;
          int best_t = t_len;
          for (int t = lane; t < t_len; t += 32) {
            float s = pg[t];
            for (int hh = 1; hh < heads; ++hh) s += pg[(size_t)hh * ts + t];
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
          if (lane == 0) amax[(size_t)b * group + g0 + g] = best_t;
        }
        __syncthreads();
        // Probabilities as P.V sees them: rounded to the V dtype; 0 past T.
        for (int j = tid; j < G * heads * ts; j += kThreads) {
          const int t = j % ts;
          ss[j] = t < t_len ? p_as<TKV>(ss[j]) : 0.f;
        }
        __syncthreads();
      }
      // P.V over the stage's rows (rows past n_eff hold zeros and p 0).
      const int t0 = (i - nk) * kRows;
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        const int c = tid + cc * kThreads;
        if (c < d) {
          const float* prow = ss + (size_t)(c / dh) * ts + t0;
#pragma unroll
          for (int rr = 0; rr < kRows; rr += 4) {
            float vv[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              vv[jj] = to_f32(reinterpret_cast<const TKV*>(stage + (rr + jj) * rb)[c]);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 p = *reinterpret_cast<const float4*>(prow + (size_t)g * heads * ts + rr);
              acc[g][cc] = fmaf(p.x, vv[0], acc[g][cc]);
              acc[g][cc] = fmaf(p.y, vv[1], acc[g][cc]);
              acc[g][cc] = fmaf(p.z, vv[2], acc[g][cc]);
              acc[g][cc] = fmaf(p.w, vv[3], acc[g][cc]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int cc = 0; cc < KC; ++cc) {
    const int c = tid + cc * kThreads;
    if (c < d) {
      const float sc = vs != nullptr ? vs[(size_t)b * d + c] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < gn) {
          float s = acc[g][cc];
          if (vs != nullptr) s *= sc;
          out[((size_t)b * group + g0 + g) * d + c] = from_f32<TQ>(s);
        }
      }
    }
  }
}

template <typename TQ, typename TKV, int G, int KC>
cudaError_t launch_grouped(const void* q, const void* k, const void* v, const int* lens,
                           const float* ks, const float* vs, void* out, int* amax, int b,
                           int group, int t, int d, int heads, float scale, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_max_smem(decode_attn_grouped_kernel<TQ, TKV, G, KC>, done);
  if (err != cudaSuccess) return err;
  const size_t smem = grouped_smem(G, t, d, heads, (int)sizeof(TKV));
  const dim3 grid(b, (group + G - 1) / G);
  decode_attn_grouped_kernel<TQ, TKV, G, KC><<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lens, ks, vs, static_cast<TQ*>(out), amax, t, d, heads, group, scale);
  return cudaGetLastError();
}

// ---- any shape: the scalar kernel --------------------------------------------

constexpr int kAnyMaxSub = 8;    // query rows of a chunk per block

size_t any_smem(int sub, int t, int d, int heads) {
  return sizeof(float) * ((size_t)sub * d + (size_t)sub * heads * row_score_stride(t));
}

// Query rows per block: up to 8, fewer where their scores would not fit
// in shared memory; 0 if not even one row's do.
int any_sub(int group, int t, int d, int heads) {
  int sub = group < kAnyMaxSub ? group : kAnyMaxSub;
  while (sub > 0 && any_smem(sub, t, d, heads) > (size_t)kMaxSmem) --sub;
  return sub;
}

// Query rows per block when the scores go to the global workspace: up to
// 8 whose f32 queries fit in shared memory.
int any_sub_ws(int group, int d) {
  int sub = group < kAnyMaxSub ? group : kAnyMaxSub;
  while (sub > 0 && sizeof(float) * (size_t)sub * d > (size_t)kMaxSmem) --sub;
  return sub;
}

// Block (b, y): query rows b * group + y * sub .. + gn - 1 against cache
// row b.  Same math and rounding points as the kernels above.  The H x T
// scores of a query row live in shared memory, or, where not even one
// row's fit there (H * T over about 57,000), in the (rows, H, T) f32
// workspace `ws` in device memory: the same arithmetic in the same order,
// at device-memory latency.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attn_any_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const int* __restrict__ lens,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       TQ* __restrict__ out, int* __restrict__ amax, float* __restrict__ ws,
                       int t_len, int d, int dk, int heads, int group, int sub, float scale) {
  extern __shared__ float smem[];
  const int ts = ws != nullptr ? t_len : row_score_stride(t_len);
  const int dh = d / heads, grp = heads / (dk / dh);
  const int b = blockIdx.x, g0 = blockIdx.y * sub, gn = min(sub, group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)b * group + g0;
  float* qs = smem;                                // [sub][D] f32 queries
  // [sub * H][ts] scores, then probabilities
  float* ss = ws != nullptr ? ws + row0 * heads * t_len : qs + (size_t)sub * d;
  const int n = lens[b];
  const int nk = n > 0 ? min(n, t_len) : 0;        // K rows scored (length 0: all masked)
  const int nv = n > 0 ? nk : t_len;               // V rows read (length 0: uniform)
  const TKV* kb = k + (size_t)b * t_len * dk;
  const TKV* vb = v + (size_t)b * t_len * dk;

  for (int i = tid; i < gn * d; i += kThreads) {
    float x = to_f32(q[row0 * d + i]);
    if (ks != nullptr) x *= ks[(size_t)b * d + i % d];
    qs[i] = x;
  }
  const int rows = gn * heads, tail = t_len - nk;
  for (int i = tid; i < rows * tail; i += kThreads)
    ss[(size_t)(i / tail) * ts + nk + i % tail] = kNegInf;
  __syncthreads();

  // Scores: neighbouring threads take the heads of one position, so they
  // read one cache row.
  for (int i = tid; i < nk * rows; i += kThreads) {
    const int t = i / rows, j = i % rows, h = j % heads;
    const TKV* kr = kb + (size_t)t * dk + (h / grp) * dh;
    const float* qr = qs + (j / heads) * d + h * dh;
    float s = 0.f;
    for (int e = 0; e < dh; ++e) s = fmaf(to_f32(kr[e]), qr[e], s);
    ss[(size_t)j * ts + t] = s * scale;
  }
  __syncthreads();

  for (int j = warp; j < rows; j += kThreads / 32) {
    float* row = ss + (size_t)j * ts;
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
    for (int t = lane; t < t_len; t += 32) {
      const float e = row[t];
      row[t] = e > 0.f ? __fdiv_rn(e, z) : 0.f;
    }
  }
  __syncthreads();

  for (int g = warp; g < gn; g += kThreads / 32) {
    const float* pg = ss + (size_t)g * heads * ts;
    float best = -INFINITY;
    int best_t = t_len;
    for (int t = lane; t < t_len; t += 32) {
      float s = pg[t];
      for (int hh = 1; hh < heads; ++hh) s += pg[(size_t)hh * ts + t];
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
    if (lane == 0) amax[row0 + g] = best_t;
  }

  // P.V: a thread per output channel, an accumulator per query row.
  for (int c = tid; c < d; c += kThreads) {
    const int h = c / dh, col = (h / grp) * dh + c % dh;
    float acc[kAnyMaxSub];
#pragma unroll
    for (int g = 0; g < kAnyMaxSub; ++g) acc[g] = 0.f;
    for (int t = 0; t < nv; ++t) {
      const float x = to_f32(vb[(size_t)t * dk + col]);
#pragma unroll
      for (int g = 0; g < kAnyMaxSub; ++g)
        if (g < gn) acc[g] = fmaf(p_as<TKV>(ss[(size_t)(g * heads + h) * ts + t]), x, acc[g]);
    }
    const float sc = vs != nullptr ? vs[(size_t)b * d + c] : 1.f;
#pragma unroll
    for (int g = 0; g < kAnyMaxSub; ++g)
      if (g < gn) out[(row0 + g) * d + c] = from_f32<TQ>(vs != nullptr ? acc[g] * sc : acc[g]);
  }
}

// ws: the (B * group, H, T) f32 score workspace, used (and then required)
// only where one query row's scores do not fit in shared memory.
template <typename TQ, typename TKV>
cudaError_t launch_any(const void* q, const void* k, const void* v, const int* lens,
                       const float* ks, const float* vs, void* out, int* amax, float* ws,
                       int b, int group, int t, int d, int dk, int heads, float scale,
                       cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_max_smem(decode_attn_any_kernel<TQ, TKV>, done);
  if (err != cudaSuccess) return err;
  int sub = any_sub(group, t, d, heads);
  size_t smem = any_smem(sub, t, d, heads);
  if (sub > 0) {
    ws = nullptr;
  } else {
    sub = any_sub_ws(group, d);
    smem = sizeof(float) * (size_t)sub * d;
    if (ws == nullptr || sub == 0) return cudaErrorInvalidValue;
  }
  const dim3 grid(b, (group + sub - 1) / sub);
  decode_attn_any_kernel<TQ, TKV><<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lens, ks, vs, static_cast<TQ*>(out), amax, ws, t, d, dk, heads, group, sub, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the fast kernels take this shape (the scalar kernel takes the rest).
bool row_fits(const void* k, const void* v, int t, int d, int dk, int heads, int elt) {
  const int lanes = 16 / elt;               // cache lanes per thread and row
  const int dh = d / heads, lph = dh / lanes;  // threads per head of a row
  const int chunks = dk / lanes;            // threads per cache row
  return aligned16(k) && aligned16(v) && dh % lanes == 0 && lph <= 32 &&
         (lph & (lph - 1)) == 0 && chunks <= kThreads && heads / (dk / dh) <= kMaxGroup &&
         row_smem(t, d, dk, heads, elt) <= (size_t)kMaxSmem;
}

// Beams a block of the grouped kernel takes: the group, or a group over 8
// split into equal sub-groups of at most 8.
int grouped_sub(int group) {
  const int nsub = (group + kMaxGroup - 1) / kMaxGroup;
  return (group + nsub - 1) / nsub;
}

bool grouped_fits(const void* k, const void* v, int group, int t, int d, int dk, int heads,
                  int elt) {
  return aligned16(k) && aligned16(v) && dk == d && (d / heads) % 16 == 0 && d <= kMaxD &&
         (d * elt) % 16 == 0 &&
         grouped_smem(grouped_sub(group), t, d, heads, elt) <= (size_t)kMaxSmem;
}

// The kernel nd_decode_attention launched, as it reports it.
enum Launched { kRowKernel = 0, kGroupedKernel = 1, kScalarKernel = 2 };

template <typename TQ, typename TKV>
cudaError_t dispatch_group(const void* q, const void* k, const void* v, const int* lens,
                           const float* ks, const float* vs, void* out, int* amax, float* ws,
                           int b, int group, int t, int d, int dk, int heads, float scale,
                           cudaStream_t st, int* launched) {
  constexpr int elt = (int)sizeof(TKV);
  if (group == 1 && row_fits(k, v, t, d, dk, heads, elt)) {
    *launched = kRowKernel;
    const int grp = heads / (dk / (d / heads));  // query heads per KV head
#define ND_ROW(GRP) \
  launch_row<TQ, TKV, GRP>(q, k, v, lens, ks, vs, out, amax, b, t, d, dk, heads, scale, st)
    if (grp == 1) return ND_ROW(1);
    if constexpr (!std::is_same<TKV, int8_t>::value) {  // int8 caches are MHA only
      if (grp <= 2) return ND_ROW(2);
      if (grp <= 4) return ND_ROW(4);
      return ND_ROW(8);
    }
#undef ND_ROW
    return cudaErrorInvalidValue;
  }
  if (group > 1 && grouped_fits(k, v, group, t, d, dk, heads, elt)) {
    *launched = kGroupedKernel;
#define ND_GROUPED(G)                                                                    \
  case G:                                                                                \
    return d <= kThreads ? launch_grouped<TQ, TKV, G, 1>(q, k, v, lens, ks, vs, out, amax, \
                                                         b, group, t, d, heads, scale, st) \
                         : launch_grouped<TQ, TKV, G, kMaxD / kThreads>(                  \
                               q, k, v, lens, ks, vs, out, amax, b, group, t, d, heads,   \
                               scale, st);
    switch (grouped_sub(group)) {
      ND_GROUPED(2)
      ND_GROUPED(3)
      ND_GROUPED(4)
      ND_GROUPED(5)
      ND_GROUPED(6)
      ND_GROUPED(7)
      ND_GROUPED(8)
      default: return cudaErrorInvalidValue;
    }
#undef ND_GROUPED
  }
  *launched = kScalarKernel;
  return launch_any<TQ, TKV>(q, k, v, lens, ks, vs, out, amax, ws, b, group, t, d, dk,
                             heads, scale, st);
}

}  // namespace

// Floats of score workspace each query row needs (H * T), or 0 where the
// scores fit in a block's shared memory and the launch takes no workspace.
extern "C" long long nd_decode_attention_workspace(int group, int t, int d, int heads) {
  if (group < 1 || t <= 0 || d <= 0 || heads <= 0) return 0;
  return any_sub(group, t, d, heads) > 0 ? 0 : (long long)heads * t;
}

// workspace: a (B * group, H, T) f32 buffer where
// nd_decode_attention_workspace asks for one, else null.
extern "C" int nd_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lens, const void* k_scale,
                                   const void* v_scale, void* out, void* amax,
                                   void* workspace, int b, int group, int t, int d, int dk,
                                   int heads, int is_bf16, int is_int8, float scale,
                                   void* stream, int* launched) {
  if (b <= 0 || t <= 0 || d <= 0 || dk <= 0 || heads <= 0 || group < 1 || d % heads)
    return (int)cudaErrorInvalidValue;
  const int dh = d / heads;
  const int n_kv = dk / dh;
  if (dk % dh || n_kv < 1 || heads % n_kv || (is_int8 && dk != d))
    return (int)cudaErrorInvalidValue;
  if (is_int8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  const float* ks = is_int8 ? static_cast<const float*>(k_scale) : nullptr;
  const float* vs = is_int8 ? static_cast<const float*>(v_scale) : nullptr;
  int* am = static_cast<int*>(amax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ND_DISPATCH(TQ, TKV)                                                               \
  dispatch_group<TQ, TKV>(q, k, v, ln, ks, vs, out, am, static_cast<float*>(workspace), b, \
                          group, t, d, dk, heads, scale, st, launched)
  if (is_int8)
    return (int)(is_bf16 ? ND_DISPATCH(__nv_bfloat16, int8_t) : ND_DISPATCH(float, int8_t));
  return (int)(is_bf16 ? ND_DISPATCH(__nv_bfloat16, __nv_bfloat16) : ND_DISPATCH(float, float));
#undef ND_DISPATCH
}
