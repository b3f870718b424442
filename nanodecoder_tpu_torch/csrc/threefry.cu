// Threefry2x32 random draws (kernel R1): raw bits, uniform floats or a
// Bernoulli mask for a key, a count and a 64-bit counter offset.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the XLA op
// behind jax.random (jax._src.prng threefry2x32_p), which the JAX package
// runs for every draw: the dropout masks of training, the Gumbel noise of
// sample mode.  Element i (i = offset + 0 .. n-1) hashes the counter pair
// (i >> 32, i & 0xFFFFFFFF) under the key and takes the XOR of the two
// output words (jax/_src/prng.py, the partitionable mode); "uniform" and
// "bernoulli" then compute what jax/_src/random.py computes from them.
//
// What bounds it on the H100: the hash is 20 rounds of add, rotate and
// xor plus five key injections against 4 bytes (bits, uniform) or 1 byte
// (a mask) written.  Built, it is about 60 instructions an element on the
// SM's integer ALU (funnel shifts, three-input xors and adds) and 19 adds
// that nvcc issues as IMAD on the FMA pipe: at 64 ALU lanes per SM it is
// bound by the ALU, not by bytes (chip_smoke.py's r1_bound counts the
// built kernel's SASS).
//
// Design: one thread per counter pair, no shared memory, the key and the
// offset passed by value, one instance per output kind; rotations are
// funnel shifts (one instruction each).  A second launcher,
// nd_threefry_table, reads the two key words from device memory (a row
// of a key table) instead: the same hash and output, for draws captured
// in a CUDA graph whose keys change from one replay to the next (the
// train step's dropout), the table written before each replay.  The multiply-add of "uniform" is
// one fused multiply-add (__fmaf_rn): XLA compiles JAX's
// `floats * (hi - lo) + lo` into an FMA on the CPU, and the two roundings
// of __fmul_rn / __fadd_rn differ from it in about half the values at
// glorot's scales.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  unsigned long long i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    const int r0 = round % 2 ? 17 : 13, r1 = round % 2 ? 29 : 15;
    const int r2 = round % 2 ? 16 : 26, r3 = round % 2 ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(round + 1) % 3];
    x1 += ks[(round + 2) % 3] + static_cast<uint32_t>(round + 1);
  }
  return x0 ^ x1;
}

// kKind 0: bits (uint32 words); 1: uniform float32 on [lo, lo + span);
// 2: bernoulli (bool bytes, uniform on [0, 1) below p).  One instance per
// kind keeps each one's code straight-line.
template <int kKind>
__device__ __forceinline__ void draw(void* __restrict__ out, long long j, uint32_t k0,
                                     uint32_t k1, unsigned long long offset, float lo,
                                     float span, float p) {
  const uint32_t word = threefry_bits(k0, k1, offset + static_cast<unsigned long long>(j));
  if constexpr (kKind == 0) {
    static_cast<uint32_t*>(out)[j] = word;
  } else {
    const float f = __uint_as_float((word >> 9) | 0x3F800000u) - 1.0f;
    if constexpr (kKind == 1)
      static_cast<float*>(out)[j] = fmaxf(lo, __fmaf_rn(f, span, lo));
    else
      static_cast<uint8_t*>(out)[j] = f < p;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(void* __restrict__ out, long long n, uint32_t k0, uint32_t k1,
                unsigned long long offset, float lo, float span, float p) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  draw<kKind>(out, j, k0, k1, offset, lo, span, p);
}

// The key words at `key` (two uint32, k0 then k1), read by every thread.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
threefry_table_kernel(void* __restrict__ out, long long n, const uint32_t* __restrict__ key,
                      unsigned long long offset, float lo, float span, float p) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  draw<kKind>(out, j, __ldg(key), __ldg(key + 1), offset, lo, span, p);
}

}  // namespace

extern "C" int nd_threefry(void* out, long long n, unsigned int k0, unsigned int k1,
                           unsigned long long offset, int kind, float lo, float span,
                           float p, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto launch = kind == 0 ? threefry_kernel<0>
                      : kind == 1 ? threefry_kernel<1> : threefry_kernel<2>;
  launch<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, k0, k1, offset, lo, span, p);
  return (int)cudaGetLastError();
}

extern "C" int nd_threefry_table(void* out, long long n, const void* key,
                                 unsigned long long offset, int kind, float lo, float span,
                                 float p, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto launch = kind == 0 ? threefry_table_kernel<0>
                      : kind == 1 ? threefry_table_kernel<1> : threefry_table_kernel<2>;
  launch<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, static_cast<const uint32_t*>(key), offset, lo, span, p);
  return (int)cudaGetLastError();
}
