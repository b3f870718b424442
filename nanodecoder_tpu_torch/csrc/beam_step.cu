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
// either, so it is launch- and latency-bound, and the design cuts the
// dependent steps between the loads and the stores.
//
// K3 (`beam_advance_warp_kernel`, K <= 10, V >= 4, K * V <= 2048): one
// warp per batch row, two rows per block.  The warp copies its row into
// shared memory with cp.async (16 bytes a copy, all in flight at once) and
// adds alive[slot / V] in place; lane l owns slots 4 (l + 32 g) + e.  No
// round runs over the whole row:
//   1. each lane finds its best slot under the order (value desc, index
//      asc); the lanes rank their bests (31 shuffles) and the lane best of
//      rank 2K - 1 is a threshold: at least 2K slots are at or above it,
//      so the top 2K are among the slots at or above it;
//   2. those slots (typically 2K to 4K of them; more than 128 only on
//      inputs built for it) are listed, each counts the ones better than
//      it, and rank r < 2K lands in place r: the top 2K in order, with no
//      sequential rounds;
//   3. the overwrite rule in closed form.  Let A be the slots above -1e9.
//      The first min(2K, |A|) picks are A in order.  After them every slot
//      of A holds -1e9, so every further pick is the lowest index among
//      the slots at or equal to -1e9 at the start (A and the exact ties),
//      and it repeats.  If A is empty the first pick is the best slot
//      overall; if it lies below -1e9 (no slot equals -1e9), it then holds
//      -1e9, exceeds every other slot, and comes back with value -1e9.
//      This is the first step's case too: -1e9 + lp rounds to -1e9, and
//      the empty finished set returns slot 0 K times.
// The two small picks (over 2K and 3K candidates, one a lane) rank by
// shuffles and close the same way.  Should step 1 leave more than 128
// slots, the warp extracts by the rule itself (2K rounds of a warp argmax
// over the row, each pick overwritten with -1e9).  Larger K or K * V run
// the block kernel below.
//
// Why shared memory and rolled loops: each SM runs about one block of this
// kernel per launch, so its code runs once per warp and every instruction
// is fetched cold.  A version holding the row in registers (64 slots a
// lane, every pass unrolled: 5,400 instructions) spent about 10 cycles on
// each, instruction fetch and not loads or arithmetic setting its pace;
// short loops are fetched once and run from the instruction cache.
//
// K7 (`beam_topk_warp_kernel`, n_out <= 20, K <= 32, V >= 4, K * V <=
// 2048) runs the same warp extraction (steps 1 to 3, n_out picks) and
// writes the picks; two rows a block (one, two and four rows a block
// timed alike on the H100, PERF.md section 6).
//
// K7 beyond those sizes (`beam_topk_kernel`) and K3 beyond its warp
// kernel's: one block per batch row keeps the row's K * V candidates in
// shared memory and runs the rounds of a block-wide argmax under the same
// order: each thread scans a strided slice, warps reduce by shuffles,
// warp 0 reduces the warps' results and overwrites the pick.  The order
// is total, so the result does not depend on the reduction's shape.  Warp
// 0 then runs K3's two small picks with the same argmax.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// ---- K3: one warp per batch row ----------------------------------------------

constexpr int kAdvRows = 2;                  // batch rows (warps) per block
constexpr int kAdvGroups = 16;               // float4 groups of slots a lane holds
constexpr int kAdvMaxN = 32 * 4 * kAdvGroups;  // K * V <= 2048
constexpr int kAdvMaxK = 10;                 // 3K <= 32: a small pick's candidates, one a lane
constexpr int kAdvCap = 128;                 // slots ranked in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTopkWarpMaxOut = 2 * kAdvMaxK;  // K7 on the warp path: n_out <= 20
constexpr int kTopkRows = 2;                 // K7 warp path: rows (warps) per block

__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);   // (value desc, index asc)
}

struct AdvScratch {
  float sv[kAdvCap];                         // ranked slots: values, indices
  int si[kAdvCap];
  float lv[32];                              // the sorted best of a pick
  int li[32];
  float flat[kAdvMaxN];                      // the row (alive added in place)
  float tops[2 * kAdvMaxK];
  int topi[2 * kAdvMaxK];
};

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Pick `lane` (< n) of the iterated extraction, given the best nl entries
// of the set in order (lv, li) and, where a pick needs it, min_at() (warp-
// uniform), the lowest index whose value is >= -1e9 (the closed form of
// the header note).
template <typename MinAt>
__device__ __forceinline__ void closed_form(const float* lv, const int* li, int nl, int n,
                                            MinAt min_at_of, float& v, int& i) {
  const int lane = threadIdx.x & 31;
  const unsigned low = __ballot_sync(kFull, lane < nl && lv[lane] <= kNegInf);
  const int a = low ? __ffs(low) - 1 : nl;   // entries above -1e9
  const int min_at = a < n ? min_at_of() : INT_MAX;
  v = kNegInf;
  i = 0;
  if (lane < n) {
    if (lane < a) {
      v = lv[lane];
      i = li[lane];
    } else if (a > 0) {
      i = min_at;
    } else {
      v = lane == 0 ? lv[0] : kNegInf;
      i = li[0];
    }
  }
}

// The iterated extraction of n picks from len <= 32 candidates, lane j
// holding candidate j: ranks by shuffles, then the closed form.  Lane j < n
// writes pick j.
__device__ void extract_small(float c, int len, int n, AdvScratch& w, float* out_v,
                              int* out_i) {
  const int lane = threadIdx.x & 31;
  int r = 0;
#pragma unroll 4
  for (int j = 0; j < len; ++j) r += ahead(__shfl_sync(kFull, c, j), j, c, lane);
  const bool mine = lane < len;
  if (mine && r < n) {
    w.lv[r] = c;
    w.li[r] = lane;
  }
  __syncwarp();
  float v;
  int i;
  closed_form(w.lv, w.li, min(n, len), n,
              [&] { return warp_min_int(mine && c >= kNegInf ? lane : INT_MAX); }, v, i);
  if (lane < n) {
    out_v[lane] = v;
    out_i[lane] = i;
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The warp's part of one row: copies alive + log_probs of the row into
// w.flat, and lane j < n_pick (n_pick <= 2 * kAdvMaxK) ends with pick j of
// the iterated extraction in (pv, pi).  al: alive[lane] for lane < k.
__device__ void warp_top_row(const float* __restrict__ src, float al, int k, int v,
                             int n_pick, AdvScratch& w, float& pv, int& pi) {
  const int lane = threadIdx.x & 31;
  float* flat = w.flat;
  const int n = k * v;

  // The row into shared memory by cp.async, every copy in flight at once;
  // slots past n (up to the group of 4) read as -inf.
  const int groups = (n + 127) / 128;        // float4 groups a lane takes
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int g = 0; g < groups; ++g) {
      const int i0 = 4 * (lane + 32 * g);
      if (i0 < n)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(flat + i0)),
                     "l"(src + i0));
    }
  } else {
    for (int i = lane; i < n; i += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(flat + i)),
                   "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = n + lane; i < 128 * groups; i += 32) flat[i] = -INFINITY;
  const float inv_v = 1.f / (float)v;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();

  // flat = alive[slot / V] + lp, in place; a group's 4 slots span at most
  // two beams (V >= 4), the first one's from an f32 estimate, corrected.
  // Then this lane's best slot, slots visited in index order; a lane
  // without slots (or with only -inf ones) keeps a sentinel whose index,
  // unique per lane, ranks it behind every slot.
  float bv = -INFINITY;
  int bi = INT_MAX - 31 + lane;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    const int i0 = 4 * (lane + 32 * g);
    int beam = (int)((float)i0 * inv_v);
    beam -= beam * v > i0;
    beam += (beam + 1) * v <= i0;
    const int next = (beam + 1) * v;        // the next beam's first slot
    const float a0 = __shfl_sync(kFull, al, min(beam, k - 1));
    const float a1 = __shfl_sync(kFull, al, min(beam + 1, k - 1));
    float4 f = *reinterpret_cast<float4*>(flat + i0);
    f.x += i0 < next ? a0 : a1;
    f.y += i0 + 1 < next ? a0 : a1;
    f.z += i0 + 2 < next ? a0 : a1;
    f.w += i0 + 3 < next ? a0 : a1;
    *reinterpret_cast<float4*>(flat + i0) = f;
    const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < n && e[j] > bv) {
        bv = e[j];
        bi = i0 + j;
      }
    }
  }

  // 1. The lanes' bests ranked; the one of rank n_pick - 1 is the threshold.
  int rank = 0;
#pragma unroll 4
  for (int o = 1; o < 32; ++o) {
    const float ov = __shfl_sync(kFull, bv, (lane + o) & 31);
    const int oi = __shfl_sync(kFull, bi, (lane + o) & 31);
    rank += ahead(ov, oi, bv, bi);
  }
  const int th_lane = __ffs(__ballot_sync(kFull, rank == n_pick - 1)) - 1;
  const float tv = __shfl_sync(kFull, bv, th_lane);
  const int ti = __shfl_sync(kFull, bi, th_lane);

  // 2. The slots at or above the threshold (bit 4 g + e of keep), counted
  // and placed.
  uint64_t keep = 0;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    const int i0 = 4 * (lane + 32 * g);
    const float4 f = *reinterpret_cast<const float4*>(flat + i0);
    const unsigned bits = (unsigned)(i0 < n && !ahead(tv, ti, f.x, i0)) |
                          (unsigned)(i0 + 1 < n && !ahead(tv, ti, f.y, i0 + 1)) << 1 |
                          (unsigned)(i0 + 2 < n && !ahead(tv, ti, f.z, i0 + 2)) << 2 |
                          (unsigned)(i0 + 3 < n && !ahead(tv, ti, f.w, i0 + 3)) << 3;
    keep |= (uint64_t)bits << (4 * g);
  }
  const int cnt = __popcll(keep);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  const int total = __shfl_sync(kFull, incl, 31);

  if (total <= kAdvCap) {
    int off = incl - cnt;
    for (uint64_t m = keep; m != 0; m &= m - 1) {
      const int bit = __ffsll((long long)m) - 1;
      const int i = 4 * (lane + 32 * (bit >> 2)) + (bit & 3);
      w.sv[off] = flat[i];
      w.si[off] = i;
      ++off;
    }
    __syncwarp();
    for (int s = lane; s < total; s += 32) {
      const float xv = w.sv[s];
      const int xi = w.si[s];
      int r = 0;
#pragma unroll 8
      for (int j = 0; j < total; ++j) r += ahead(w.sv[j], w.si[j], xv, xi);
      if (r < n_pick) {
        w.lv[r] = xv;
        w.li[r] = xi;
      }
    }
    __syncwarp();
    // 3. The closed form.
    closed_form(w.lv, w.li, min(n_pick, total), n_pick, [&] {
      int first = INT_MAX;
      for (int i = lane; i < n; i += 32)
        if (flat[i] >= kNegInf) {
          first = i;
          break;
        }
      return warp_min_int(first);
    }, pv, pi);
  } else {
    // The rule itself (inputs built for it): n_pick rounds of a warp
    // argmax over the row, picks overwritten.
    extract_top_warp(flat, n, n_pick, w.tops, w.topi);
    pv = lane < n_pick ? w.tops[lane] : kNegInf;
    pi = lane < n_pick ? w.topi[lane] : 0;
  }
}

__global__ void __launch_bounds__(32 * kAdvRows)
beam_advance_warp_kernel(const float* __restrict__ alive, const float* __restrict__ lp,
                         const float* __restrict__ fin, float pen, int b, int k, int v,
                         int eos, int* __restrict__ top_ids, float* __restrict__ alive_s,
                         int* __restrict__ alive_sel, float* __restrict__ fin_s,
                         int* __restrict__ fin_sel) {
  __shared__ __align__(16) AdvScratch scratch[kAdvRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kAdvRows + warp;
  if (row >= b) return;                      // the whole warp leaves
  AdvScratch& w = scratch[warp];
  const int n2 = 2 * k;
  const float al = lane < k ? alive[(size_t)row * k + lane] : 0.f;
  const float fo = lane < k ? fin[(size_t)row * k + lane] : 0.f;
  float pv;                                  // lane j < 2K: pick j
  int pi;
  warp_top_row(lp + (size_t)row * k * v, al, k, v, n2, w, pv, pi);

  // The alive set: best K of the 2K picks that are not EOS (lane j holds
  // candidate j).
  const bool pick_eos = pi - (pi / v) * v == eos;
  if (lane < n2) top_ids[(size_t)row * n2 + lane] = pi;
  extract_small(pick_eos ? kNegInf : pv, n2, k, w, alive_s + (size_t)row * k,
                alive_sel + (size_t)row * k);
  // The finished set: best K of the old finished scores and the EOS picks
  // over the length penalty (lane j < K: old slot j; lane j >= K: pick
  // j - K).
  const float cv = __shfl_sync(kFull, pv, (lane + 32 - k) & 31);
  const bool cand_eos = __shfl_sync(kFull, pick_eos, (lane + 32 - k) & 31);
  extract_small(lane < k ? fo : cand_eos ? __fdiv_rn(cv, pen) : kNegInf, 3 * k, k, w,
                fin_s + (size_t)row * k, fin_sel + (size_t)row * k);
}

// K7 on the warp path: one warp per row, kTopkRows rows a block.
__global__ void __launch_bounds__(32 * kTopkRows)
beam_topk_warp_kernel(const float* __restrict__ alive, const float* __restrict__ lp, int b,
                      int k, int v, int n_out, float* __restrict__ scores,
                      int* __restrict__ ids) {
  __shared__ __align__(16) AdvScratch scratch[kTopkRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kTopkRows + warp;
  if (row >= b) return;
  const float al = lane < k ? alive[(size_t)row * k + lane] : 0.f;
  float pv;
  int pi;
  warp_top_row(lp + (size_t)row * k * v, al, k, v, n_out, scratch[warp], pv, pi);
  if (lane < n_out) {
    scores[(size_t)row * n_out + lane] = pv;
    ids[(size_t)row * n_out + lane] = pi;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kAdvMaxK && k * v <= kAdvMaxN && v >= 4) {
    beam_advance_warp_kernel<<<(b + kAdvRows - 1) / kAdvRows, 32 * kAdvRows, 0, st>>>(
        static_cast<const float*>(alive), static_cast<const float*>(lp),
        static_cast<const float*>(fin), pen, b, k, v, eos, static_cast<int*>(top_ids),
        static_cast<float*>(alive_s), static_cast<int*>(alive_sel),
        static_cast<float*>(fin_s), static_cast<int*>(fin_sel));
    return (int)cudaGetLastError();
  }
  const long long smem = ((long long)k * v + 7LL * k) * 4;
  cudaError_t err = reserve_smem(beam_advance_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  beam_advance_kernel<<<b, kThreads, (size_t)smem, st>>>(
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
  if (k <= 32 && k * v <= kAdvMaxN && v >= 4 && n_out <= kTopkWarpMaxOut) {
    beam_topk_warp_kernel<<<(b + kTopkRows - 1) / kTopkRows, 32 * kTopkRows, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(alive), static_cast<const float*>(lp), b, k, v, n_out,
        static_cast<float*>(scores), static_cast<int*>(ids));
    return (int)cudaGetLastError();
  }
  const long long smem = (long long)k * v * 4;
  cudaError_t err = reserve_smem(beam_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  beam_topk_kernel<<<b, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alive), static_cast<const float*>(lp), k, v, n_out,
      static_cast<float*>(scores), static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
