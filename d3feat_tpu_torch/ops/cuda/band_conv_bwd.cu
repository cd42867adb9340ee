// K4: backward of the band KPConv (threshold selection), for Hopper
// (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/band_conv.py::_band_conv_bwd_kernel
// (pallas_call in _bwd_call), threshold mode. With gs = g / den (the
// density-scaled cotangent, formed by the caller as the TPU path forms it
// outside its kernel) and w_kp(q, r) the influence weights of K2's
// selection (band_lists.cuh, bit for bit K2's):
//     dW[kp] = sum_q weighted_kp[q]^T gs[q],
//              weighted_kp[q] = sum_{r in sel(q)} w_kp(q, r) x[r]
//     dx[r]  = sum_{q : r in sel(q)} sum_kp w_kp(q, r) gW[q, kp],
//              gW[q, kp] = W[kp] gs[q]
// The TPU kernel walks its grid in order, carrying dW in one accumulator
// and reading-modifying-writing the dx rows of overlapping windows. Here
// CTAs run concurrently, so every sum has one owner and a fixed order
// (the result is the same from run to run):
//   1. weighted: query-major, 32 queries x 64 channels per CTA, K2's list
//      building, then per kernel point the weighted rows (FP32 FMA over the
//      list in ascending position) into wtd [Nq, KP * Cin];
//   2. dW = wtd^T gs: a tiled FP32 product (64 x 64 outputs per CTA, each
//      thread 4 x 4, FMA in ascending query order), the query range split
//      into a few slices whose partial sums are then added in slice order;
//   3. gW = gs W^T: the same product kernel, [Nq, Cout] x [Cout, KP * Cin];
//   4. dx: support-major, one warp per support row r: over the tiles whose
//      window holds r (ascending; a per-row range from the wrapper) and
//      their queries (ascending, 32 at a time), K2's selection test with
//      the exact d2; for each selected query the lanes k < KP compute
//      w_k(q, r), and each lane adds sum_k w_k gW[q, k, c] into its
//      channels c = lane + 32 i (FMA, k ascending).
// No tensor cores and no library product: FP32 FMA only, as the TPU
// kernel's f32 panels at HIGHEST. Bound: the FP32 FMAs of the two dense
// products (2 x Nq x KP x Cin x Cout each) at the deep levels, the window
// scans and the gW rows read per selected pair at level 0.

#include <cuda_runtime.h>

#include "band_lists.cuh"

#define QT 32        // queries per CTA of the weighted pass
#define CB 64        // channels per CTA of the weighted pass
#define NTHREADS 256
#define RPB 8        // support rows per CTA of the dx pass, one warp each
#define BM 64        // product tile: rows
#define BN 64        //               columns
#define BK 16        //               reduction step

__global__ void __launch_bounds__(NTHREADS)
bwd_weighted_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
                    const float* __restrict__ ptie, const float4* __restrict__ s,
                    const float* __restrict__ x, const float* __restrict__ kp,
                    const int* __restrict__ starts, const int* __restrict__ wends, int tile,
                    int C, int KP, float inv_extent, float* __restrict__ wtd) {
  __shared__ float wbuf[QT * LCAP];
  __shared__ float ld2[QT * LCAP];
  __shared__ int lpos[QT * LCAP];
  __shared__ int lcnt[QT];
  __shared__ float4 qs[QT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT;

  for (int qi = warp; qi < QT; qi += NTHREADS / 32) {
    const int qg = q0 + qi;
    const float4 qq = q[qg];
    const int t = qg / tile;
    const int cnt = select_rows(s, qq, thr[qg], ptie[qg], starts[t], wends[t],
                                lpos + qi * LCAP, ld2 + qi * LCAP);
    if (lane == 0) {
      lcnt[qi] = cnt;
      qs[qi] = qq;
    }
  }
  __syncthreads();

  const size_t row = (size_t)KP * C;
  const int c0 = blockIdx.y * CB, cb = min(CB, C - c0);
  for (int k = 0; k < KP; ++k) {
    const float kx = kp[3 * k], ky = kp[3 * k + 1], kz = kp[3 * k + 2];
    const float kk = dot3(kx, ky, kz, kx, ky, kz);
    for (int e = threadIdx.x; e < QT * LCAP; e += NTHREADS) {
      const int qi = e / LCAP, j = e % LCAP;
      if (j < lcnt[qi]) wbuf[e] = kp_weight(ld2[e], s[lpos[e]], qs[qi], kx, ky, kz, kk, inv_extent);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < QT * cb; e += NTHREADS) {
      const int qi = e / cb, c = c0 + e % cb;
      const int n = lcnt[qi];
      const float* wr = wbuf + qi * LCAP;
      const int* pr = lpos + qi * LCAP;
      float v = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) v = __fmaf_rn(wr[j], x[(size_t)pr[j] * C + c], v);
      wtd[(size_t)(q0 + qi) * row + (size_t)k * C + c] = v;
    }
    __syncthreads();
  }
}

// out[z][m][n] = sum over k in slice z of A(m, k) B(k, n), with
// A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn].
// Slice z covers reduction indices [z * kc, min((z + 1) * kc, K)).
__global__ void __launch_bounds__(256)
product_kernel(const float* __restrict__ A, long long sam, long long sak,
               const float* __restrict__ B, long long sbk, long long sbn,
               float* __restrict__ out, int M, int N, int K, int kc) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4, tn = (tid % 16) * 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const bool a_k_inner = (sak == 1), b_n_inner = (sbn == 1);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // neighbouring threads read neighbouring addresses of each operand
    for (int i = tid; i < BM * BK; i += 256) {
      const int mm = a_k_inner ? i / BK : i % BM, kk = a_k_inner ? i % BK : i / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kend) ? A[gm * sam + gk * sak] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += 256) {
      const int nn = b_n_inner ? i % BN : i / BK, kk = b_n_inner ? i / BN : i % BK;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < kend) ? B[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tm + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tn + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn + j;
      if (gn < N) o[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in slice order
__global__ void sum_slices_kernel(const float* __restrict__ part, int splits, size_t n,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int z = 1; z < splits; ++z) v = __fadd_rn(v, part[(size_t)z * n + i]);
  out[i] = v;
}

template <int NC>  // channel slots per lane: C <= 32 * NC
__global__ void __launch_bounds__(RPB * 32)
bwd_dx_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
              const float* __restrict__ ptie, const float4* __restrict__ s,
              const float* __restrict__ gw, const float* __restrict__ kp,
              const int* __restrict__ starts, const int* __restrict__ wends,
              const int* __restrict__ first, const int* __restrict__ end, int ns, int tile,
              int C, int KP, float inv_extent, float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  const float4 sr = s[r];
  const float rf = (float)r;
  float kx = 0.f, ky = 0.f, kz = 0.f, kk = 0.f;  // lane k < KP: kernel point k
  if (lane < KP) {
    kx = kp[3 * lane];
    ky = kp[3 * lane + 1];
    kz = kp[3 * lane + 2];
    kk = dot3(kx, ky, kz, kx, ky, kz);
  }
  const size_t row = (size_t)KP * C;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  const int t_end = end[r];
  for (int t = first[r]; t < t_end; ++t) {
    if (r < starts[t] || r >= wends[t]) continue;
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
        float4 qb;
        qb.x = __shfl_sync(0xffffffffu, qq.x, b);
        qb.y = __shfl_sync(0xffffffffu, qq.y, b);
        qb.z = __shfl_sync(0xffffffffu, qq.z, b);
        qb.w = 0.f;
        const float d2b = __shfl_sync(0xffffffffu, d2, b);
        const float w = lane < KP ? kp_weight(d2b, sr, qb, kx, ky, kz, kk, inv_extent) : 0.f;
        const float* gr = gw + (size_t)(base + b) * row;
        for (int k = 0; k < KP; ++k) {
          const float wk = __shfl_sync(0xffffffffu, w, k);
          const float* gk = gr + (size_t)k * C;
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int c = lane + 32 * i;
            if (c < C) acc[i] = __fmaf_rn(wk, gk[c], acc[i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < C) dx[(size_t)r * C + c] = acc[i];
  }
}

static cudaError_t product(const float* A, long long sam, long long sak, const float* B,
                           long long sbk, long long sbn, float* out, int M, int N, int K,
                           int splits, int kc, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  product_kernel<<<grid, 256, 0, st>>>(A, sam, sak, B, sbk, sbn, out, M, N, K, kc);
  return cudaGetLastError();
}

extern "C" int band_conv_bwd_launch(const void* q, const void* thr, const void* ptie,
                                    const void* s, const void* x, const void* W,
                                    const void* kp, const void* gs, const void* starts,
                                    const void* wends, int nq, int ns, int tile, int C,
                                    int Cout, int KP, float inv_extent, int splits, int kc,
                                    void* wtd, void* part, void* dW, const void* first,
                                    const void* end, void* gw, void* dx, void* stream) {
  if (nq % QT || tile % QT || C < 1 || Cout < 1 || KP < 1 || KP > 32 || splits < 1 ||
      kc < 1 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  const int KC = KP * C;
  if (nq > 0) {
    bwd_weighted_kernel<<<dim3(nq / QT, (C + CB - 1) / CB), NTHREADS, 0, st>>>(
        (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s,
        (const float*)x, (const float*)kp, (const int*)starts, (const int*)wends, tile, C, KP,
        inv_extent, (float*)wtd);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  // dW [KP * C, Cout] = wtd^T gs, reduced over the nq queries
  float* dst = splits > 1 ? (float*)part : (float*)dW;
  if ((e = product((const float*)wtd, 1, KC, (const float*)gs, Cout, 1, dst, KC, Cout, nq,
                   splits, kc, st)) != cudaSuccess)
    return (int)e;
  if (splits > 1) {
    const size_t n = (size_t)KC * Cout;
    sum_slices_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)part, splits,
                                                                   n, (float*)dW);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (!dx) return 0;
  if (C > 512) return (int)cudaErrorInvalidValue;
  // gW [nq, KP * C] = gs W^T (W viewed as [KP * C, Cout])
  if ((e = product((const float*)gs, Cout, 1, (const float*)W, 1, Cout, (float*)gw, nq, KC,
                   Cout, 1, Cout, st)) != cudaSuccess)
    return (int)e;
  if (ns == 0) return 0;
  const dim3 grid((ns + RPB - 1) / RPB), block(RPB * 32);
#define DX_ARGS                                                                              \
  (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s, (const float*)gw, \
      (const float*)kp, (const int*)starts, (const int*)wends, (const int*)first,              \
      (const int*)end, ns, tile, C, KP, inv_extent, (float*)dx
  if (C <= 32) bwd_dx_kernel<1><<<grid, block, 0, st>>>(DX_ARGS);
  else if (C <= 64) bwd_dx_kernel<2><<<grid, block, 0, st>>>(DX_ARGS);
  else if (C <= 128) bwd_dx_kernel<4><<<grid, block, 0, st>>>(DX_ARGS);
  else if (C <= 256) bwd_dx_kernel<8><<<grid, block, 0, st>>>(DX_ARGS);
  else bwd_dx_kernel<16><<<grid, block, 0, st>>>(DX_ARGS);
#undef DX_ARGS
  return (int)cudaGetLastError();
}
