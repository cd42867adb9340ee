// K6: the deformable KPConv's neighbour sums, forward, float32, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the deformable KPConv in
// XLA (d3feat_tpu/models/kpconv.py::kpconv, its deformable branch), and the
// port's gather route (ops/deform_conv.py::deform_sums_plain) materialises
// the [Q, nn, Cin] gathered features and the [Q, nn, KP, 3] differences of
// every such conv, twice: once for the offset KPConv, once for the moved
// kernel points. Here, for each query q with neighbour list inds[q][0, nn)
// (index ns is the shadow, a point at 1e6 with a zero feature row) and
// kernel points kp (shared [KP, 3], or one set a query [Q, KP, 3]) centred
// on q:
//     d2[n][k]  = |(s[n] - q) - kp[k]|^2           ((dx dx + dy dy) + dz dz)
//     kept[n]   = !drop || some d2[n][k] < r2
//     w[n][k]   = kept[n] ? max(1 - sqrt(d2[n][k]) / extent, 0) : 0
//     weighted[q][k][c] = sum over kept n of w[n][k] x[n][c]     (list order)
//     density[q] = max(1, number of kept n < ns whose row of x sums > 0)
//     min_d2[q][k] = min over every n, the shadow included, of d2[n][k]
//                    (per-query kernel points only: the regulariser's input)
// The product with the weights and the modulations stay outside (a matmul).
//
// Design: a pre-pass flags each support row once (one warp a row, the
// lanes' strided partials reduced by an xor butterfly, > 0). Then one CTA of
// TPB threads a query. A pass weighs CHUNK listed neighbours, one a thread:
// its d2 to every kernel point (in shared memory), the range test, the
// influences, the running minima and the density count in registers. The
// neighbours with a non-zero weight (the others add only zeros) are
// compacted by a ballot into shared memory: their rows and a 16-float
// weight row each, read back as four float4 broadcasts. Then thread t
// holds channels t, t + TPB, ... (CPT of them) and KP accumulators each,
// gathers UNROLL compacted rows into registers before their fused
// multiply-adds, and writes its column of weighted[q] once at the end.
// Bound: each pair's 2 KP Cin operations of the weighted sum (the rows are
// read from L2: a level's features are reused by every query listing
// them), against the card's float32 rate outside the tensor cores; the
// influences are KP per pair, against KP Cin multiply-adds.

#include <cuda_runtime.h>

#define TPB 128      // threads a CTA, one query a CTA
#define CHUNK 128    // listed neighbours weighed a pass, one a thread
#define KP 15        // kernel points (KPConv's and D3Feat's disposition)
#define NKP 16       // weight slots a neighbour: four float4s
#define UNROLL 4     // compacted rows loaded before their multiply-adds
#define FLAG_ROWS 8  // rows flagged a CTA, one warp each
#define CMAX (TPB * 4)
#define FULL 0xffffffffu
#define SHADOW 1.0e6f

__global__ void __launch_bounds__(FLAG_ROWS * 32)
positive_rows_kernel(const float* __restrict__ x, int ns, int C, unsigned char* __restrict__ flag) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * FLAG_ROWS + (threadIdx.x >> 5);
  if (r >= ns) return;
  float part = 0.f;
  for (int c = lane; c < C; c += 32) part = __fadd_rn(part, x[(size_t)r * C + c]);
  for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(FULL, part, o));
  if (lane == 0) flag[r] = part > 0.f;
}

// CPT channels a thread; PERQ: one set of kernel points a query
template <int CPT, bool PERQ>
__global__ void __launch_bounds__(TPB)
deform_sums_kernel(const float* __restrict__ qp, const float* __restrict__ sp,
                   const int* __restrict__ inds, int nn, const float* __restrict__ x, int ns,
                   int C, const float* __restrict__ kp, float extent, float r2,
                   int drop, const unsigned char* __restrict__ flag,
                   float* __restrict__ weighted, float* __restrict__ density,
                   float* __restrict__ min_d2) {
  __shared__ __align__(16) float sw[CHUNK + UNROLL][NKP];
  __shared__ int srow[CHUNK + UNROLL];
  __shared__ float skp[NKP * 3];
  __shared__ int swarp[TPB / 32];
  __shared__ int scount[TPB / 32];
  __shared__ float smin[TPB / 32][NKP];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t q = blockIdx.x;
  if (t < KP * 3) skp[t] = kp[(PERQ ? q * KP * 3 : 0) + t];
  const float qx = qp[q * 3], qy = qp[q * 3 + 1], qz = qp[q * 3 + 2];
  __syncthreads();

  float acc[CPT][KP];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[i][k] = 0.f;
  float dmin[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) dmin[k] = __int_as_float(0x7f800000);  // +inf
  int count = 0;
  const int* row_inds = inds + q * nn;

  for (int j0 = 0; j0 < nn; j0 += CHUNK) {
    const int j = j0 + t;
    const bool listed = j < nn;
    const int idx = listed ? row_inds[j] : ns;
    const bool real = listed && idx < ns;
    const float px = real ? sp[(size_t)idx * 3] : SHADOW;
    const float py = real ? sp[(size_t)idx * 3 + 1] : SHADOW;
    const float pz = real ? sp[(size_t)idx * 3 + 2] : SHADOW;
    const float nx = __fsub_rn(px, qx), ny = __fsub_rn(py, qy), nz = __fsub_rn(pz, qz);
    float w[KP];
    bool in_range = false, weighs = false;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const float dx = __fsub_rn(nx, skp[3 * k]);
      const float dy = __fsub_rn(ny, skp[3 * k + 1]);
      const float dz = __fsub_rn(nz, skp[3 * k + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (PERQ && listed) dmin[k] = fminf(dmin[k], d2);
      in_range |= d2 < r2;
      const float d = d2 > 0.f ? __fsqrt_rn(d2) : 0.f;
      w[k] = fmaxf(__fsub_rn(1.f, __fdiv_rn(d, extent)), 0.f);
      weighs |= w[k] != 0.f;
    }
    const bool kept = real && (in_range || !drop);
    count += kept && flag[idx];
    const bool take = kept && weighs;
    const unsigned ballot = __ballot_sync(FULL, take);
    if (lane == 0) swarp[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int i = 0; i < TPB / 32; ++i) {
      base += i < warp ? swarp[i] : 0;
      total += swarp[i];
    }
    if (take) {
      const int pos = base + __popc(ballot & ((1u << lane) - 1u));
      srow[pos] = idx;
#pragma unroll
      for (int k = 0; k < KP; ++k) sw[pos][k] = w[k];
      sw[pos][KP] = 0.f;
    }
    // the last group of UNROLL padded with row 0 at weight 0: acc starts at
    // +0 and a sum is -0 only when both terms are, so adding 0 x leaves it
    if (t < UNROLL) {
      srow[total + t] = 0;
#pragma unroll
      for (int k = 0; k < NKP; ++k) sw[total + t][k] = 0.f;
    }
    __syncthreads();

    for (int u0 = 0; u0 < total; u0 += UNROLL) {
      float v[UNROLL][CPT];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float* xr = x + (size_t)srow[u0 + u] * C;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const int c = t + TPB * i;
          v[u][i] = c < C ? __ldg(xr + c) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float wk[NKP];
        const float4* w4 = reinterpret_cast<const float4*>(sw[u0 + u]);
#pragma unroll
        for (int h = 0; h < NKP / 4; ++h) {
          const float4 f = w4[h];
          wk[4 * h] = f.x;
          wk[4 * h + 1] = f.y;
          wk[4 * h + 2] = f.z;
          wk[4 * h + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < CPT; ++i)
#pragma unroll
          for (int k = 0; k < KP; ++k) acc[i][k] = __fmaf_rn(wk[k], v[u][i], acc[i][k]);
      }
    }
    __syncthreads();  // the next pass rewrites the compacted rows
  }

#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = t + TPB * i;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < KP; ++k) weighted[(q * KP + k) * C + c] = acc[i][k];
    }
  }
  for (int o = 16; o; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
  if (lane == 0) scount[warp] = count;
  if (PERQ) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float m = dmin[k];
      for (int o = 16; o; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, o));
      if (lane == 0) smin[warp][k] = m;
    }
  }
  __syncthreads();
  if (t == 0) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < TPB / 32; ++i) n += scount[i];
    density[q] = (float)max(n, 1);
  }
  if (PERQ && t < KP) {
    float m = smin[0][t];
#pragma unroll
    for (int i = 1; i < TPB / 32; ++i) m = fminf(m, smin[i][t]);
    min_d2[q * KP + t] = m;
  }
}

template <int CPT>
static int launch_sums(int nq, const void* qp, const void* sp, const void* inds, int nn,
                       const void* x, int ns, int C, const void* kp, int per_query,
                       float extent, float r2, int drop, const void* flag, void* weighted,
                       void* density, void* min_d2, cudaStream_t st) {
  if (per_query)
    deform_sums_kernel<CPT, true><<<nq, TPB, 0, st>>>(
        (const float*)qp, (const float*)sp, (const int*)inds, nn, (const float*)x, ns, C,
        (const float*)kp, extent, r2, drop, (const unsigned char*)flag, (float*)weighted,
        (float*)density, (float*)min_d2);
  else
    deform_sums_kernel<CPT, false><<<nq, TPB, 0, st>>>(
        (const float*)qp, (const float*)sp, (const int*)inds, nn, (const float*)x, ns, C,
        (const float*)kp, extent, r2, drop, (const unsigned char*)flag, (float*)weighted,
        (float*)density, (float*)min_d2);
  return (int)cudaGetLastError();
}

// q_pts [nq, 3], s_pts [ns, 3], inds [nq, nn] int32 (ns: the shadow), x [ns, C],
// kp [KP, 3] or (per_query) [nq, KP, 3], all float32 unless stated;
// flag: [ns] bytes of scratch; weighted [nq, KP, C], density [nq],
// min_d2 [nq, KP] (per_query only; may be null otherwise)
extern "C" int deform_sums_launch(const void* q_pts, const void* s_pts, const void* inds,
                                  const void* x, const void* kp, int nq, int ns, int nn, int C,
                                  int per_query, float extent, float r2, int drop, void* flag,
                                  void* weighted, void* density, void* min_d2, void* stream) {
  if (nq < 0 || ns < 0 || nn < 1 || C < 1 || C > CMAX || (per_query && !min_d2))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ns > 0) {
    positive_rows_kernel<<<(ns + FLAG_ROWS - 1) / FLAG_ROWS, FLAG_ROWS * 32, 0, st>>>(
        (const float*)x, ns, C, (unsigned char*)flag);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int cpt = (C + TPB - 1) / TPB;
#define DEFORM_ARGS nq, q_pts, s_pts, inds, nn, x, ns, C, kp, per_query, extent, r2, drop, flag, \
                    weighted, density, min_d2, st
  if (cpt == 1) return launch_sums<1>(DEFORM_ARGS);
  if (cpt == 2) return launch_sums<2>(DEFORM_ARGS);
  return launch_sums<4>(DEFORM_ARGS);
#undef DEFORM_ARGS
}
