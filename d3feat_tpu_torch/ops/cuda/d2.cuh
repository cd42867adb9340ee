// Squared distance shared by K1 (select.cu), K2 (band_conv.cu) and K3
// (head.cu). K2 and K3 recover each query's neighbor list from K1's
// threshold by comparing this value bit for bit, so all three must compute
// it identically: per axis d = s - q, then fma(dz, dz, fma(dx, dx, dy * dy))
// — the order in which the reference's expression evaluates on the JAX CPU
// backend. Every rounding is spelled out; the sources are built with
// -fmad=false so the compiler contracts nothing else.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float exact_d2(float4 s, float qx, float qy, float qz) {
  const float dx = __fsub_rn(s.x, qx), dy = __fsub_rn(s.y, qy), dz = __fsub_rn(s.z, qz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}
