// Launch counting for the hand-written kernels of this package.
//
// A kernel calls count_launch() once at its start: its first thread adds one
// to a counter in device memory.  The count is taken where the kernel runs,
// so a launch captured in a CUDA graph counts at every replay and not at the
// capture.  Each library exports <name>_launch_count, which calls
// read_launch_count; utils/cuda_build.py:LaunchCount reads it from Python.
#pragma once
#include <cuda_runtime.h>

namespace {

__device__ unsigned long long g_launch_count;

__device__ __forceinline__ void count_launch() {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(&g_launch_count, 1ULL);
}

// Waits for `device`, then sets *count to its launches of this library's
// kernels since the last reset, and zeroes them when reset != 0.  Returns 0,
// else the CUDA error code.
inline int read_launch_count(int device, int reset, unsigned long long* count) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(count, g_launch_count, sizeof(*count));
  const unsigned long long zero = 0;
  if (err == cudaSuccess && reset)
    err = cudaMemcpyToSymbol(g_launch_count, &zero, sizeof(zero));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace
