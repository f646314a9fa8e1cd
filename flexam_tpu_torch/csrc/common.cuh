// Helpers shared by the port's CUDA kernels (plain C interface, no PyTorch
// headers, so that one `nvcc -shared` call builds every kernel in seconds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flexam {

typedef __nv_bfloat16 bf16;

// Round a float to bf16 and back: the value an op computed in bf16 holds.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum over the whole block (blockDim.x a multiple of 32, at most 1024).
// Every thread gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? scratch[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace flexam
