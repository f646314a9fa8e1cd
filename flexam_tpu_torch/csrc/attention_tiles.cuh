// Small helpers of the port's attention kernels, left from their first
// mma.sync tile code (all four kernels now run on hopper_attention.cuh):
// the masked-key logit, bf16 packing, and the reductions over the 4 lanes
// (a quad) that hold one row of an mma.sync or wgmma accumulator fragment.
// hopper_attention.cuh imports them.
#pragma once

#include "common.cuh"

namespace flexam {
namespace attn {

constexpr float kNeg = -1e30f;      // logit of a masked key

using flexam::pack_bf16;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace attn
}  // namespace flexam
