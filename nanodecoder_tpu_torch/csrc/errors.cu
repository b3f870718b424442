// Text of a CUDA error code, for the Python wrappers' exceptions, and an
// empty kernel: its device-only time is the launch floor that
// chip_smoke.py prints beside the short kernels' times.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* nd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int nd_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
