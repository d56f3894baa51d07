// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace spmv {

// The (8, 128) tile of the JAX package's formats: 8 sublanes x 128 lanes.
constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kTile = kSub * kLanes;  // 1024 slots = one 1024-column window

// bf16 is carried as its 16 raw bits; widening to f32 is exact.
__device__ __forceinline__ float bf16_bits_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// acc + a * b rounded once, in the accumulator's own type.
__device__ __forceinline__ float fma_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double fma_acc(double a, double b, double acc) {
  return fma(a, b, acc);
}

}  // namespace spmv
