// K2: rigid KPConv over sorted support bands, threshold selection, for
// Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/band_conv.py::_band_conv_kernel
// (pallas_call in band_conv), forward, threshold mode. For each sorted
// query q of a tile, the support rows of the tile's window [start, wend)
// are selected by
//     same cloud id  and  (d2 < thr[q]  or  (d2 == thr[q] and pos <= ptie[q]))
// with d2 computed exactly as K1 computes it, which reproduces q's K-list.
// Then, per kernel point kp,
//     w   = max(1 - sqrt(max(d2 + a + b, 0)) / extent, 0)
//           (a = -2 s.k, b = 2 q.k + |k|^2, the reference's expansion)
//     y  += (w^T x_band) W[kp]            (f32, FP32 FMA, no tensor cores)
// and den = max(#selected rows with row-sum > 0, 1); out = y / den.
//
// The TPU kernel multiplies dense [T x band] panels because its matrix
// unit wants them; on this card the selection is sparse (<= K of ~1-2k
// window rows), so each query keeps its selected rows as a list:
//   phase 1: one warp per query scans the window 32 rows at a time,
//            compacts the selected rows (ballot) into a shared-memory list
//            in ascending position, and counts the active ones;
//   phase 2: per kernel point, the influence weights of the listed rows,
//            weighted[q][c] = sum_j w[q][j] x[pos_j][c] into shared memory,
//            then acc[q][co] += sum_c weighted[q][c] W[kp][c][co], each
//            thread holding 8 queries x 1 output column in registers.
// A CTA owns 32 queries x 64 output columns. Bound: the FP32 FMAs of the
// second product (Nq x KP x Cin x Cout) at the deep levels, the window scan
// at level 0.
//
// The selection and the weights are band_lists.cuh's, shared with K4.

#include <cuda_runtime.h>

#include "band_lists.cuh"

#define QT 32        // queries per CTA
#define COLS 64      // output columns per CTA
#define NTHREADS 256

__global__ void __launch_bounds__(NTHREADS)
band_conv_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
                 const float* __restrict__ ptie, const float4* __restrict__ s,
                 const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ kp, const int* __restrict__ starts,
                 const int* __restrict__ wends, int tile, int C, int Cout, int KP,
                 float inv_extent, float* __restrict__ out, float* __restrict__ den_out) {
  extern __shared__ float smem[];
  float* weighted = smem;                  // [QT][C]
  float* wbuf = weighted + QT * C;         // [QT][LCAP]
  float* ld2 = wbuf + QT * LCAP;           // [QT][LCAP]
  int* lpos = (int*)(ld2 + QT * LCAP);     // [QT][LCAP]
  __shared__ int lcnt[QT];
  __shared__ float lden[QT];
  __shared__ float4 qs[QT];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT;

  // phase 1: per-query selected-row lists
  for (int qi = warp; qi < QT; qi += NTHREADS / 32) {
    const int qg = q0 + qi;
    const float4 qq = q[qg];
    const float th = thr[qg], pt = ptie[qg];
    const int t = qg / tile;
    const int cnt = select_rows(s, qq, th, pt, starts[t], wends[t], lpos + qi * LCAP,
                                ld2 + qi * LCAP);
    int active = 0;
    for (int j = 0; j < cnt; ++j) {
      const float* xr = x + (size_t)lpos[qi * LCAP + j] * C;
      float part = 0.f;
      for (int c = lane; c < C; c += 32) part = __fadd_rn(part, xr[c]);
      for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      active += part > 0.f;
    }
    if (lane == 0) {
      lcnt[qi] = cnt;
      lden[qi] = fmaxf((float)active, 1.f);
      qs[qi] = qq;
    }
  }
  __syncthreads();

  // phase 2: kernel-point products
  const int col = threadIdx.x % COLS;
  const int qgrp = threadIdx.x / COLS;    // 4 groups of 8 queries
  const int co = blockIdx.y * COLS + col;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  for (int k = 0; k < KP; ++k) {
    const float kx = kp[3 * k], ky = kp[3 * k + 1], kz = kp[3 * k + 2];
    const float kk = dot3(kx, ky, kz, kx, ky, kz);
    for (int e = threadIdx.x; e < QT * LCAP; e += NTHREADS) {
      const int qi = e / LCAP, j = e % LCAP;
      if (j < lcnt[qi]) {
        wbuf[e] = kp_weight(ld2[e], s[lpos[e]], qs[qi], kx, ky, kz, kk, inv_extent);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < QT * C; e += NTHREADS) {
      const int qi = e / C, c = e % C;
      const int n = lcnt[qi];
      const float* wr = wbuf + qi * LCAP;
      const int* pr = lpos + qi * LCAP;
      float v = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) v = __fmaf_rn(wr[j], x[(size_t)pr[j] * C + c], v);
      weighted[e] = v;
    }
    __syncthreads();
    if (co < Cout) {
      const float* wk = W + (size_t)k * C * Cout + co;
      const float* wq = weighted + qgrp * 8 * C;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float wv = wk[(size_t)c * Cout];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fmaf_rn(wq[i * C + c], wv, acc[i]);
      }
    }
    __syncthreads();
  }
  if (co < Cout) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = qgrp * 8 + i;
      out[(size_t)(q0 + qi) * Cout + co] = __fdiv_rn(acc[i], lden[qi]);
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < QT) den_out[q0 + threadIdx.x] = lden[threadIdx.x];
}

extern "C" int band_conv_launch(const void* q, const void* thr, const void* ptie,
                                const void* s, const void* x, const void* W,
                                const void* kp, const void* starts, const void* wends,
                                int nq, int tile, int C, int Cout, int KP,
                                float inv_extent, void* out, void* den, void* stream) {
  if (nq % QT || tile % QT || C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const size_t smem = ((size_t)QT * C + 3 * QT * LCAP) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nq / QT, (Cout + COLS - 1) / COLS);
  band_conv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s,
      (const float*)x, (const float*)W, (const float*)kp, (const int*)starts,
      (const int*)wends, tile, C, Cout, KP, inv_extent, (float*)out, (float*)den);
  return (int)cudaGetLastError();
}
