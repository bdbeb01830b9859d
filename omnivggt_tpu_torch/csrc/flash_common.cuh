// Constants and bf16 packing shared by the Hopper attention kernels
// (attend_sm90.cuh and the sources that run it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // finite "minus infinity", as on the TPU
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClampLog2 = 80.0f * kLog2e;  // the bounded clamp, in log2 units

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace flash
