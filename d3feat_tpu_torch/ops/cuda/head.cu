// K3: detector-head neighbourhood sums over the level-0 sorted band, for
// Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/head.py::_band_head_kernel (pallas_call
// in band_head), forward. For each sorted query q, the rows of its tile's
// window [start, wend) are selected by the same threshold rule as K2
// (exact K1 d2 against thr[q], ties by position against ptie[q]), then
//     fsum[q] = sum of the selected feature rows   (f32, ascending position)
//     cnt[q]  = number of selected rows whose row-sum is != 0.
// One warp per query: it scans the window 32 rows at a time, and for each
// selected row (in position order) the lanes add the row's channels
// (lane c holds channels c, c+32, ...; C <= 128). Bound: the window scan,
// ~16 B per window row per query read from L2.

#include <cuda_runtime.h>

#include "d2.cuh"

#define QPB 8  // queries per CTA, one warp each
#define CMAX 128

__global__ void __launch_bounds__(QPB * 32)
band_head_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
                 const float* __restrict__ ptie, const float4* __restrict__ s,
                 const float* __restrict__ x, const int* __restrict__ starts,
                 const int* __restrict__ wends, int tile, int C,
                 float* __restrict__ fsum, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int qg = blockIdx.x * QPB + (threadIdx.x >> 5);
  const float4 qq = q[qg];
  const float th = thr[qg], pt = ptie[qg];
  const int t = qg / tile;
  const int ws = starts[t], we = wends[t];
  float acc[CMAX / 32];
#pragma unroll
  for (int i = 0; i < CMAX / 32; ++i) acc[i] = 0.f;
  int count = 0;
  for (int base = ws; base < we; base += 32) {
    const int r = base + lane;
    bool sel = false;
    if (r < we) {
      const float4 sr = s[r];
      const float d2 = exact_d2(sr, qq.x, qq.y, qq.z);
      sel = (sr.w == qq.w) && (d2 < th || (d2 == th && (float)r <= pt));
    }
    unsigned m = __ballot_sync(0xffffffffu, sel);
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1u;
      const float* xr = x + (size_t)(base + b) * C;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CMAX / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < C) {
          const float v = xr[c];
          acc[i] = __fadd_rn(acc[i], v);
          part = __fadd_rn(part, v);
        }
      }
      for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      count += part != 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < CMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) fsum[(size_t)qg * C + c] = acc[i];
  }
  if (lane == 0) cnt[qg] = (float)count;
}

extern "C" int band_head_launch(const void* q, const void* thr, const void* ptie,
                                const void* s, const void* x, const void* starts,
                                const void* wends, int nq, int tile, int C,
                                void* fsum, void* cnt, void* stream) {
  if (nq % QPB || tile % QPB || C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  band_head_kernel<<<nq / QPB, QPB * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s,
      (const float*)x, (const int*)starts, (const int*)wends, tile, C,
      (float*)fsum, (float*)cnt);
  return (int)cudaGetLastError();
}
