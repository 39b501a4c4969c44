// Shared by every kernel source of this directory: the fused epilogue's
// activation, the int8 kernels' dequant epilogue, the bias and store helpers
// of the bf16 GEMM and conv kernels, and the error-string export
// the ctypes loader binds.
//
// The `act` codes are those of `ACT_CODES` in kernels/epilogue.py.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// A bias entry, fp32 or bf16 (then widened), for the fp32 epilogue.
__device__ __forceinline__ float bias_at(const void* bias, int bias_bf16, int col) {
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                   : static_cast<const float*>(bias)[col];
}

// Store the fp32 epilogue's value: as it is, or rounded once to bf16 (round to
// nearest even: the reference's `.astype(bfloat16)` of its fp32 result).
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) {  // gelu, tanh approximation (as jax.nn.gelu(approximate=True))
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// The int8 kernels' epilogue, in the order of `dequant_epilogue` in
// kernels/epilogue.py: int32 -> fp32 (round to nearest), + bias / scale when
// there is a bias, * scale, then the activation. Each step is an explicitly
// rounded intrinsic, so nvcc can neither contract it into an FMA nor
// replace the divide by a reciprocal multiply: the result is bitwise that
// of the plain version for act none and relu.
__device__ __forceinline__ float dequant_epilogue(int acc, float scale,
                                                  const float* bias, int col,
                                                  int act) {
  float y = __int2float_rn(acc);
  if (bias != nullptr) y = __fadd_rn(y, __fdiv_rn(bias[col], scale));
  y = __fmul_rn(y, scale);
  return apply_act(y, act);
}

// Each source is its own shared library, so each defines this once.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
