// One-shot toolchain probe for Hopper (sm_90a): o = x + 1 on n floats.
//
// Replaces the Pallas TPU probe `_probe_kernel` of
// src/repro/core/backend_pallas.py (`mosaic_supported`), which compiles and
// runs a trivial kernel once per process to learn whether compiled kernels
// work on the host.  Here the probe goes through the very toolchain the
// contraction kernel uses (nvcc -> plain-C shared library -> ctypes), so a
// missing or broken nvcc, a wrong architecture or a refused launch shows up
// once, before the first statement runs.
//
// Bound: launch latency (8 floats); the kernel's work is nothing.
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* x, float* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" int probe_launch(const void* x, void* o, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return (int)cudaGetLastError();
}
