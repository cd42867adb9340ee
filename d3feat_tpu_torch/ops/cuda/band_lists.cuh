// Per-query selected-row lists and kernel-point influence weights, shared
// by the list stage (band_lists.cu), K2 (band_conv.cu) and K4
// (band_conv_bwd.cu): the lists are built once per search and both
// kernels weigh the listed rows bit for bit alike.
#pragma once
#include <cuda_runtime.h>

#include "d2.cuh"

#define LCAP 64  // selected rows per query: threshold selection reproduces
                 // a K-list of at most K <= 64 rows (K1's cap)

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// Linear influence of kernel point k (|k|^2 = kk) on the pair (q, s) with
// exact squared distance d2, by the reference's expansion
//     w = max(1 - sqrt(max(d2 + a + b, 0)) / extent, 0),
//     a = -2 s.k,  b = 2 q.k + |k|^2.
__device__ __forceinline__ float kp_weight(float d2, float4 sr, float4 qq, float kx, float ky,
                                           float kz, float kk, float inv_extent) {
  const float a = __fmul_rn(-2.f, dot3(sr.x, sr.y, sr.z, kx, ky, kz));
  const float b = __fadd_rn(__fmul_rn(2.f, dot3(qq.x, qq.y, qq.z, kx, ky, kz)), kk);
  const float d2kp = fmaxf(__fadd_rn(__fadd_rn(d2, a), b), 0.f);
  return fmaxf(__fsub_rn(1.f, __fmul_rn(__fsqrt_rn(d2kp), inv_extent)), 0.f);
}

// One warp appends query qq's selected rows among n staged window rows
// (rows[0, n) stand for positions base + [0, n)): the rows with q's cloud
// id and (d2 < thr or d2 == thr and position <= ptie), in ascending
// position, into lpos/ld2 from entry cnt on (at most LCAP entries are
// kept). Returns the new count, uncapped (all lanes).
__device__ __forceinline__ int select_rows(const float4* rows, int base, int n, float4 qq,
                                           float th, float pt, int* lpos, float* ld2,
                                           int cnt) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool sel = false;
    float d2 = 0.f;
    if (j < n) {
      const float4 sr = rows[j];
      d2 = exact_d2(sr, qq.x, qq.y, qq.z);
      sel = (sr.w == qq.w) && (d2 < th || (d2 == th && (float)(base + j) <= pt));
    }
    const unsigned m = __ballot_sync(0xffffffffu, sel);
    if (sel) {
      const int idx = cnt + __popc(m & ((1u << lane) - 1u));
      if (idx < LCAP) {
        lpos[idx] = base + j;
        ld2[idx] = d2;
      }
    }
    cnt += __popc(m);
  }
  return cnt;
}
