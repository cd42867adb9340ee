// K5: backward of the detector-head band sums, for Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/head.py::_band_head_bwd_kernel
// (pallas_call in _band_head_bwd_call). K3 sums, per sorted query q, the
// feature rows of q's conv0 list; the transposed sum carries the cotangent
// g back to the support rows:
//     dx[r] = sum of g[q] over the queries q whose list holds r.
// The queries that list r are read from the transpose of conv0's lists
// (band_lists.cu), which K4's conv0 backward shares: the entries of row r
// are pairs[row_ptr[r], row_ptr[r + 1]), each e = q * lw + j, ascending
// in q. No d2, threshold or window is read.
//
// Order: the twin (and the TPU kernel, whose grid walks the tiles in
// order) sums each row per tile, over the tile's queries in ascending
// order from +0, then adds the tiles' partials in ascending tile order
// into a total that starts from +0. Walking r's entries in order does the
// same: a running tile partial, added into the total where the tile
// changes (__fadd_rn, -fmad=false). A partial is never -0, so the +0s the
// twin adds for unlisted queries and tiles change nothing: bit for bit.
//
// Design: a segmented gather-sum, about 18 entries a row at level 0,
// bound by the latency and traffic of its L2 gathers. 8 lanes own a row
// (a warp 4 rows); lane s of a row holds the float4 of channels 4 s + 32 i
// (C <= 128). A row's lanes read 32 entries at a time (4 each, 8 lanes
// side by side) and pass them round with 8-wide shuffles; the g rows of
// AHEAD entries are loaded before their adds, so AHEAD row loads are in
// flight per lane. At C <= 32 the kernel is held to 64 registers, 4 CTAs
// an SM: there more warps in flight beat more loads in flight per lane
// (wider rows lose by it). Rows without entries (padding, the shadow row)
// write zeros.
// Bound: bytes (row_ptr, the entries, g once, dx); about C adds an entry.
// Each entry reads a whole g row, so g (L2-resident) is read about 18
// times over at level 0.

#include <cuda_runtime.h>

#include "band_lists.cuh"

#define RPW 4    // rows per warp, 8 lanes each
#define WPB 8    // warps per CTA
#define AHEAD 8  // entries whose g rows are loaded before their adds
#define CMAX 128
#define FULL 0xffffffffu

// four channels c .. c + 3 of a row: one float4 when C % 4 == 0 (V), else
// scalars, each past C read as 0
template <bool V>
__device__ __forceinline__ float4 load4(const float* row, int c, int C) {
  if (V)
    return c < C ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0, 0, 0, 0);
  float4 v;
  v.x = c < C ? __ldg(row + c) : 0.f;
  v.y = c + 1 < C ? __ldg(row + c + 1) : 0.f;
  v.z = c + 2 < C ? __ldg(row + c + 2) : 0.f;
  v.w = c + 3 < C ? __ldg(row + c + 3) : 0.f;
  return v;
}

template <bool V>
__device__ __forceinline__ void store4(float* row, int c, int C, float4 v) {
  if (V) {
    if (c < C) *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  if (c < C) row[c] = v.x;
  if (c + 1 < C) row[c + 1] = v.y;
  if (c + 2 < C) row[c + 2] = v.z;
  if (c + 3 < C) row[c + 3] = v.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// NI = ceil(C / 32) float4s per lane
template <int NI, bool V>
__global__ void __launch_bounds__(WPB * 32, NI == 1 ? 4 : 1)
band_head_bwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ pairs,
                     const float* __restrict__ g, int ns, int tile, int C, int lsh,
                     float* __restrict__ dx) {
  const int sub = threadIdx.x & 7;
  const int r = (blockIdx.x * WPB + (threadIdx.x >> 5)) * RPW + ((threadIdx.x >> 3) & 3);
  const int b = r < ns ? row_ptr[r] : 0;
  const int n = r < ns ? row_ptr[r + 1] - b : 0;
  int nmax = max(n, __shfl_xor_sync(FULL, n, 8));  // the warp's longest row
  nmax = max(nmax, __shfl_xor_sync(FULL, nmax, 16));
  float4 acc[NI], part[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = part[i] = make_float4(0, 0, 0, 0);
  int cur = -1;  // tile of the running partial
  for (int j0 = 0; j0 < nmax; j0 += 32) {
    int ent[4];  // entry j0 + sub + 8 k of the row, -1 past its end
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + sub + 8 * k;
      ent[k] = j < n ? pairs[b + j] : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j0 + 8 * k >= nmax) break;  // warp-uniform
      int q[AHEAD];
      float4 v[AHEAD][NI];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int e = __shfl_sync(FULL, ent[k], u, 8);  // entry j0 + 8 k + u
        q[u] = e >= 0 ? e >> lsh : -1;  // -1 past the row's end (lsh: list_shift)
        const float* gr = g + (size_t)max(q[u], 0) * C;
#pragma unroll
        for (int i = 0; i < NI; ++i)
          v[u][i] = e >= 0 ? load4<V>(gr, 4 * sub + 32 * i, C) : make_float4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (q[u] < 0) continue;
        const int t = q[u] / tile;
        if (t != cur) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            acc[i] = add4(acc[i], part[i]);
            part[i] = make_float4(0, 0, 0, 0);
          }
          cur = t;
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) part[i] = add4(part[i], v[u][i]);
      }
    }
  }
  if (r >= ns) return;
#pragma unroll
  for (int i = 0; i < NI; ++i) store4<V>(dx + (size_t)r * C, 4 * sub + 32 * i, C,
                                         add4(acc[i], part[i]));
}

template <int NI>
static int launch(const void* row_ptr, const void* pairs, const void* g, int ns, int tile, int C,
                  int lsh, void* dx, cudaStream_t st) {
  const unsigned blocks = (unsigned)((ns + WPB * RPW - 1) / (WPB * RPW));
  if (C % 4 == 0)
    band_head_bwd_kernel<NI, true><<<blocks, WPB * 32, 0, st>>>(
        (const int*)row_ptr, (const int*)pairs, (const float*)g, ns, tile, C, lsh, (float*)dx);
  else
    band_head_bwd_kernel<NI, false><<<blocks, WPB * 32, 0, st>>>(
        (const int*)row_ptr, (const int*)pairs, (const float*)g, ns, tile, C, lsh, (float*)dx);
  return (int)cudaGetLastError();
}

// row_ptr [ns + 1] and pairs: the transpose of the lists (lw entries a
// query) of the queries whose cotangents g [nq, C] are; dx [ns, C]
extern "C" int band_head_bwd_launch(const void* row_ptr, const void* pairs, const void* g,
                                    int ns, int tile, int C, int lw, void* dx, void* stream) {
  if (tile < 1 || C < 1 || C > CMAX || !list_width_ok(lw)) return (int)cudaErrorInvalidValue;
  if (ns == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int lsh = 31 - __builtin_clz((unsigned)lw);
  switch ((C + 31) / 32) {
    case 1: return launch<1>(row_ptr, pairs, g, ns, tile, C, lsh, dx, st);
    case 2: return launch<2>(row_ptr, pairs, g, ns, tile, C, lsh, dx, st);
    case 3: return launch<3>(row_ptr, pairs, g, ns, tile, C, lsh, dx, st);
    default: return launch<4>(row_ptr, pairs, g, ns, tile, C, lsh, dx, st);
  }
}
