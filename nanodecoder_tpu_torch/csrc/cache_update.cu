// In-place write of one aligned 8-row block into the decode cache (kernel K2).
//
// Replaces: nanodecoder_tpu/ops/cache_update.py `_write_block_kernel` (the
// Pallas body of `write_cache_block`), one async DMA of the staged
// (B, 8, C) slab into the aliased (B, T, C) cache at rows
// [8 * (step / 8), +8).  Its contract is `dynamic_update_slice` with
// T % 8 == 0, and this kernel keeps it; like the Pallas kernel it updates
// the cache in place.
//
// What bounds it on the H100: it moves B*8*C elements in and out, 10.5 MB
// in f32 (about 3 us at 3.35 TB/s) or 5.2 MB in bf16 at the flagship's
// B 640, C 256: at that size launch latency is as large as the copy, and
// the copy is one wave of loads, so the time to the first load and the
// tail of the last store count as much as bandwidth.
//
// Design: for each batch row the slab block and its destination are both
// one contiguous run of 8*C elements.  Block (j, g) copies element
// 256 j + tid of the runs of rows 4 g .. 4 g + 3, in the widest unit every
// offset allows (16, 4 or 1 bytes): a thread computes its addresses with
// no division, issues its four loads, then its four stores.  At the
// flagship's C 256 bf16 that is 160 blocks of 256 threads, one wave.
// Beyond 65535 row groups (B > 262140) a block goes on to the row groups
// gridDim.y further on.  Runs and indices are 64-bit, so a batch row's
// block may exceed 2^31 copy units (2 GiB of a cache whose rows are not
// 4-byte aligned, copied a byte a thread).  Six other
// designs were timed against this one on an "NVIDIA H100 80GB HBM3,
// 700.00 W" (the earlier grid-stride loop, one element a thread, TMA bulk
// copies, a block a row with 8 loads a thread first, row groups of 2 and
// 8): at C 256 bf16 all seven took 0.0036 to 0.0039 ms cold, a launch and
// a DRAM latency above the copy itself (PERF.md section 6).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlock = 8;  // rows per staged block
constexpr int kThreads = 256;
constexpr int kRows = 4;   // batch rows a block copies

template <typename V>
__global__ void __launch_bounds__(kThreads)
write_block_kernel(V* __restrict__ cache, const V* __restrict__ slab, int b, long long run,
                   long long row_stride, long long offset) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= run) return;
  for (int r0 = blockIdx.y * kRows; r0 < b; r0 += gridDim.y * kRows) {
    V x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (r0 + u < b) x[u] = slab[(size_t)(r0 + u) * run + i];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (r0 + u < b) cache[(size_t)(r0 + u) * row_stride + offset + i] = x[u];
  }
}

template <typename V>
cudaError_t launch(void* cache, const void* slab, int b, long long run_bytes,
                   long long stride_bytes, long long offset_bytes, cudaStream_t stream) {
  const long long run = run_bytes / (long long)sizeof(V);
  const long long blocks = (run + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // grid x: 2^39 units
  const int groups = (b + kRows - 1) / kRows;
  const dim3 grid((unsigned)blocks, groups < 65535 ? groups : 65535);
  write_block_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(cache), static_cast<const V*>(slab), b, run,
      stride_bytes / (long long)sizeof(V), offset_bytes / (long long)sizeof(V));
  return cudaGetLastError();
}

bool aligned(const void* p, long long n, long long a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0 && n % a == 0;
}

}  // namespace

extern "C" int nd_write_cache_block(void* cache, const void* slab, int b, int t, int c,
                                    int elem_bytes, int step, void* stream) {
  if (b <= 0 || c <= 0 || elem_bytes <= 0 || t % kBlock != 0 || step < 0 || step >= t)
    return (int)cudaErrorInvalidValue;
  const long long row = (long long)c * elem_bytes;     // bytes of one cache row
  const long long run = kBlock * row;                 // bytes of one batch row's block
  const long long stride = (long long)t * row;         // bytes between batch rows
  const long long offset = (long long)(step / kBlock) * kBlock * row;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long all = run | stride | offset;
  if (aligned(cache, all, 16) && aligned(slab, run, 16))
    return (int)launch<uint4>(cache, slab, b, run, stride, offset, st);
  if (aligned(cache, all, 4) && aligned(slab, run, 4))
    return (int)launch<uint32_t>(cache, slab, b, run, stride, offset, st);
  return (int)launch<uint8_t>(cache, slab, b, run, stride, offset, st);
}
