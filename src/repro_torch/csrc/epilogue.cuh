// Shared by every kernel source of this directory: the fused epilogue's
// activation and the error-string export the ctypes loader binds.
//
// The `act` codes are those of `ACT_CODES` in kernels/epilogue.py.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) {  // gelu, tanh approximation (as jax.nn.gelu(approximate=True))
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// Each source is its own shared library, so each defines this once.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
