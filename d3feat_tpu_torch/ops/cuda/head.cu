// K3: detector-head neighbourhood sums over the level-0 lists, for Hopper
// (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/head.py::_band_head_kernel (pallas_call
// in band_head), forward. The TPU kernel selects each query's rows from
// its tile's window by the K1 threshold; here the selection is conv0's
// list stage (band_lists.cu), which the level-0 convs already built for the
// same search: for each sorted query q with listed rows lpos[q][0, lcnt[q])
// (lw entries a query, band_lists.cuh)
// (ascending position),
//     fsum[q] = sum of the listed feature rows   (f32, in list order)
//     cnt[q]  = number of listed rows whose row-sum is != 0.
// The window route summed the selected rows in ascending position too, so
// the sums are the same bit for bit.
//
// Design: a pre-pass flags each support row once (one warp per row: the
// lanes' strided partials reduced by an xor butterfly, the window route's
// routine for a row's sum, != 0), so the count of a query is a ballot over
// the flags of its listed rows, not a butterfly per listed row. Then one
// warp per query; lane c holds channels c, c + 32, ... (C <= 128). The warp
// reads its list 32 entries at a time (coalesced, issued beside the
// count's load) with their flags, then gathers AHEAD listed rows into
// registers before adding them in order, so AHEAD row loads are in flight
// where one row's add would wait on one load.
// Bound: the gathered rows (L2-resident x, read about 18 times over at
// level 0) and the lists; at the card's memory rate, x once, the lists up
// to their counts and the outputs (bytes).

#include <cuda_runtime.h>

#include "band_lists.cuh"

#define QPB 8  // queries (or flagged rows) per CTA, one warp each
#define CMAX 128
#define AHEAD 16  // listed rows loaded before their adds; divides 32
#define FULL 0xffffffffu

// NI = ceil(C / 32) channels per lane
template <int NI>
__global__ void __launch_bounds__(QPB * 32)
row_flags_kernel(const float* __restrict__ x, int ns, int C, unsigned char* __restrict__ flag) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * QPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = lane + 32 * i;
    if (c < C) part = __fadd_rn(part, x[(size_t)r * C + c]);
  }
  for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(FULL, part, o));
  if (lane == 0) flag[r] = part != 0.f;
}

template <int NI>
__global__ void __launch_bounds__(QPB * 32)
band_head_kernel(const int* __restrict__ lpos, const int* __restrict__ lcnt, int lw,
                 const float* __restrict__ x, const unsigned char* __restrict__ flag, int C,
                 float* __restrict__ fsum, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int qg = blockIdx.x * QPB + (threadIdx.x >> 5);
  const int* lp = lpos + (size_t)qg * lw;
  const int n = lcnt[qg];
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int m = min(32, n - j0);
    // entries past the count hold -1: row 0 stands in, never loaded
    const int mine = max(lp[j0 + lane], 0);
    count += __popc(__ballot_sync(FULL, lane < m && flag[mine]));
    for (int u0 = 0; u0 < m; u0 += AHEAD) {
      float v[AHEAD][NI];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const float* xr = x + (size_t)__shfl_sync(FULL, mine, u0 + u) * C;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int c = lane + 32 * i;
          v[u][i] = u0 + u < m && c < C ? __ldg(xr + c) : 0.f;
        }
      }
      // rows past the count add 0: acc starts at +0 and a sum is -0 only
      // when both terms are, so adding +0 leaves every acc as it is
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[i] = __fadd_rn(acc[i], v[u][i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = lane + 32 * i;
    if (c < C) fsum[(size_t)qg * C + c] = acc[i];
  }
  if (lane == 0) cnt[qg] = (float)count;
}

template <int NI>
static int launch(int nq, int ns, const void* lpos, const void* lcnt, int lw, const void* x,
                  int C, void* flag, void* fsum, void* cnt, cudaStream_t st) {
  row_flags_kernel<NI><<<(ns + QPB - 1) / QPB, QPB * 32, 0, st>>>((const float*)x, ns, C,
                                                                  (unsigned char*)flag);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  band_head_kernel<NI><<<nq / QPB, QPB * 32, 0, st>>>(
      (const int*)lpos, (const int*)lcnt, lw, (const float*)x, (const unsigned char*)flag, C,
      (float*)fsum, (float*)cnt);
  return (int)cudaGetLastError();
}

// flag: [ns] bytes of scratch
extern "C" int band_head_launch(const void* lpos, const void* lcnt, int lw, const void* x,
                                int nq, int ns, int C, void* flag, void* fsum, void* cnt,
                                void* stream) {
  if (nq % QPB || ns < 1 || C < 1 || C > CMAX || !list_width_ok(lw))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((C + 31) / 32) {
    case 1: return launch<1>(nq, ns, lpos, lcnt, lw, x, C, flag, fsum, cnt, st);
    case 2: return launch<2>(nq, ns, lpos, lcnt, lw, x, C, flag, fsum, cnt, st);
    case 3: return launch<3>(nq, ns, lpos, lcnt, lw, x, C, flag, fsum, cnt, st);
    default: return launch<4>(nq, ns, lpos, lcnt, lw, x, C, flag, fsum, cnt, st);
  }
}
