// K5: backward of the detector-head band sums, for Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/head.py::_band_head_bwd_kernel
// (pallas_call in _band_head_bwd_call). K3 sums, per sorted query q, the
// feature rows its threshold selects from its tile's window; the
// transposed sum carries the cotangent g back to the support rows:
//     dx[r] = sum of g[q] over the queries q whose selection holds r.
// The TPU kernel runs its grid in order, so its read-modify-write of the
// dx rows of overlapping windows is race-free. Here the pass is
// support-major instead, and deterministic: one warp per support row r
// walks the tiles whose window [start, wend) holds r (a range the wrapper
// gives per row), in ascending order, and their queries 32 at a time in
// ascending order, redoing K3's selection test with the same exact d2
// (d2.cuh). Lane c holds channels c, c+32, ... (C <= 128). Per tile the
// selected g rows are summed in query order, then the tile's sum is added
// to the row's total: the twin's order, so kernel and twin agree bit for
// bit. Bound: the selection tests, ~8 FP32 operations per (row, query of a
// covering tile), and the L2 reads of the query rows they need.

#include <cuda_runtime.h>

#include "d2.cuh"

#define RPB 8  // support rows per CTA, one warp each
#define CMAX 128

__global__ void __launch_bounds__(RPB * 32)
band_head_bwd_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
                     const float* __restrict__ ptie, const float4* __restrict__ s,
                     const float* __restrict__ g, const int* __restrict__ starts,
                     const int* __restrict__ wends, const int* __restrict__ first,
                     const int* __restrict__ end, int ns, int tile, int C,
                     float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  const float4 sr = s[r];
  const float rf = (float)r;
  float acc[CMAX / 32];
#pragma unroll
  for (int i = 0; i < CMAX / 32; ++i) acc[i] = 0.f;
  const int t_end = end[r];
  for (int t = first[r]; t < t_end; ++t) {
    if (r < starts[t] || r >= wends[t]) continue;
    float part[CMAX / 32];
#pragma unroll
    for (int i = 0; i < CMAX / 32; ++i) part[i] = 0.f;
    for (int base = t * tile; base < (t + 1) * tile; base += 32) {
      const int qi = base + lane;
      const float4 qq = q[qi];
      const float d2 = exact_d2(sr, qq.x, qq.y, qq.z);
      const float th = thr[qi];
      const bool sel = (sr.w == qq.w) && (d2 < th || (d2 == th && rf <= ptie[qi]));
      unsigned m = __ballot_sync(0xffffffffu, sel);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1u;
        const float* gr = g + (size_t)(base + b) * C;
#pragma unroll
        for (int i = 0; i < CMAX / 32; ++i) {
          const int c = lane + 32 * i;
          if (c < C) part[i] = __fadd_rn(part[i], gr[c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CMAX / 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
#pragma unroll
  for (int i = 0; i < CMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) dx[(size_t)r * C + c] = acc[i];
  }
}

extern "C" int band_head_bwd_launch(const void* q, const void* thr, const void* ptie,
                                    const void* s, const void* g, const void* starts,
                                    const void* wends, const void* first, const void* end,
                                    int ns, int tile, int C, void* dx, void* stream) {
  if (tile % 32 || C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  if (ns == 0) return 0;
  band_head_bwd_kernel<<<(ns + RPB - 1) / RPB, RPB * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s,
      (const float*)g, (const int*)starts, (const int*)wends, (const int*)first,
      (const int*)end, ns, tile, C, (float*)dx);
  return (int)cudaGetLastError();
}
