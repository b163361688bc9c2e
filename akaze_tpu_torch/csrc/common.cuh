// Shared helpers of the port's CUDA sources.  Every C entry point takes raw
// device pointers and a cudaStream_t (as void*), launches on that stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AKAZE_RETURN_IF_ERROR()                 \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

extern "C" const char* akaze_strerror(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
