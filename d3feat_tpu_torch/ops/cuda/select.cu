// K1: band radius select for Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/select.py::_select_kernel (pallas_call in
// band_select). For each query of a tile of sorted queries, the K
// candidates (same cloud id, d2 <= r2) of smallest squared distance among
// the tile's window of sorted support rows [start, wend), ascending, ties
// by ascending position. Empty slots: position Ns_pad - 1, d2 = 3e38.
// d2 is float32 in one fixed op order (d2.cuh, shared with the kernels
// that recover these lists from their threshold bit for bit).
//
// Order without tie rules: a candidate at position p with squared distance
// d2 >= 0 is the 64-bit key (bits(d2) << 32) | p, every other row the key
// NONE. For non-negative floats the unsigned order of the keys is exactly
// "ascending d2, ties by ascending position", and positions are distinct,
// so no two candidate keys are equal.
//
// Design: a CTA owns QB consecutive queries of one tile (QB set by the
// wrapper from the search's size, so the small deep-level searches still
// spread over the card) and stages the tile's window once through shared
// memory (window_stage.cuh). A warp serves QPW of them: it reads 32 window
// rows at a time (one per lane, once for all its queries) and, per query,
// keeps the K smallest keys sorted across the lanes, S per lane (slots
// S lane .. S lane + S - 1; S = 2 up to K = 64, 4 up to 128, 8 up to 256,
// the wider lists of deformable convs' doubled radii). A ballot of key <
// the current K-th key skips a 32-row step that holds no candidate for the
// query (most steps, once its list is full); otherwise each new key, in
// lane order, is inserted into the distributed list: every slot takes its
// predecessor, the new key or itself, from one shuffle of the neighbouring
// lane's upper slot. 32 S slots are kept whatever K is, so keys that land
// past K are harmless. K = 1 (the upsample searches) keeps one running
// minimum per lane and reduces it over the warp at the end.
//
// Bound: the d2 tests, query x window row pairs (operations); the bytes
// (window rows re-read from L2 by the tile / QB CTAs of a tile, the K
// outputs) are small.

#include <cuda_runtime.h>

#include "d2.cuh"
#include "window_stage.cuh"

#define KMAX 256  // eight slots per lane
#define EMPTY_D2 3.0e38f
#define NONE 0xffffffffffffffffull
#define FULL 0xffffffffu

typedef unsigned long long u64;

template <int QPW, int S, bool TOP1>
__global__ void __launch_bounds__(256)
select_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
              const int* __restrict__ starts, const int* __restrict__ wends, int tile, int K,
              float r2, int empty, int* __restrict__ out_pos, float* __restrict__ out_d2) {
  __shared__ __align__(16) float4 rows[2][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * (blockDim.x >> 5) * QPW;
  const int t = q0 / tile;
  const int ws = starts[t], we = wends[t];
  const int qw = q0 + warp * QPW;  // this warp's first query
  const int kl = (K - 1) / S, ks = (K - 1) % S;  // lane and slot of the K-th key

  float4 qq[QPW];
  u64 v[QPW][S], kth[QPW];  // slots S lane + h; K-th key
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    qq[i] = q[qw + i];
    kth[i] = NONE;
#pragma unroll
    for (int h = 0; h < S; ++h) v[i][h] = NONE;
  }

  const int nch = window_chunks(ws, we);
  if (nch > 0) stage_chunk(rows[0], s, ws, we);
  for (int c = 0; c < nch; ++c) {
    const bool more = c + 1 < nch;
    if (more) stage_chunk(rows[(c + 1) & 1], s, ws + (c + 1) * CHUNK, we);
    wait_chunk(more);
    const int base = ws + c * CHUNK, n = min(CHUNK, we - base);
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < n;
      float4 sr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) sr = rows[c & 1][j];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float d2 = exact_d2(sr, qq[i].x, qq[i].y, qq[i].z);
        const u64 key = (in && sr.w == qq[i].w && d2 <= r2)
                            ? ((u64)__float_as_uint(d2) << 32) | (unsigned)(base + j)
                            : NONE;
        if (TOP1) {
          v[i][0] = key < v[i][0] ? key : v[i][0];
          continue;
        }
        unsigned m = __ballot_sync(FULL, key < kth[i]);
        if (!m) continue;
        do {
          const int b = __ffs(m) - 1;
          m &= m - 1u;
          const u64 x = __shfl_sync(FULL, key, b);
          u64 prev = __shfl_up_sync(FULL, v[i][S - 1], 1);
          if (lane == 0) prev = 0;  // slot 0 has no predecessor
#pragma unroll
          for (int h = S - 1; h > 0; --h)  // from the top: v[i][h - 1] still the old key
            v[i][h] = x < v[i][h - 1] ? v[i][h - 1] : (x < v[i][h] ? x : v[i][h]);
          v[i][0] = x < prev ? prev : (x < v[i][0] ? x : v[i][0]);
        } while (m);
        u64 mine = v[i][0];
#pragma unroll
        for (int h = 1; h < S; ++h) mine = h == ks ? v[i][h] : mine;
        kth[i] = __shfl_sync(FULL, mine, kl);
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }

#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const size_t o = (size_t)(qw + i) * K;
    if (TOP1) {
      u64 mn = v[i][0];
      for (int off = 16; off; off >>= 1) {
        const u64 w = __shfl_xor_sync(FULL, mn, off);
        mn = w < mn ? w : mn;
      }
      v[i][0] = mn;
    }
#pragma unroll
    for (int h = 0; h < S; ++h) {
      const int k = S * lane + h;
      const u64 key = v[i][h];
      if (k < K) {
        out_pos[o + k] = key == NONE ? empty : (int)(unsigned)key;
        out_d2[o + k] = key == NONE ? EMPTY_D2 : __uint_as_float((unsigned)(key >> 32));
      }
    }
  }
}

template <int QPW, int S, bool TOP1>
static int launch(int blocks, int threads, const void* q, const void* s, const void* starts,
                  const void* wends, int tile, int K, float r2, int empty, void* out_pos,
                  void* out_d2, cudaStream_t st) {
  select_kernel<QPW, S, TOP1><<<blocks, threads, 0, st>>>(
      (const float4*)q, (const float4*)s, (const int*)starts, (const int*)wends, tile, K, r2,
      empty, (int*)out_pos, (float*)out_d2);
  return (int)cudaGetLastError();
}

// qb queries per CTA, one of 1, 2, 4, 8, 16, 32, dividing the tile:
// min(qb, 8) warps of qb / warps queries each; K above 64 (S > 2) only at
// one query a warp (qb <= 8), which bounds the list's registers
extern "C" int select_launch(const void* q, const void* s, const void* starts,
                             const void* wends, int nq, int tile, int qb, int K, float r2,
                             int empty, void* out_pos, void* out_d2, void* stream) {
  if (K < 1 || K > KMAX || tile < 1 || nq % tile || qb < 1 || qb > 32 || (qb & (qb - 1)) ||
      tile % qb || (K > 64 && qb > 8))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int warps = qb < 8 ? qb : 8, qpw = qb / warps, blocks = nq / qb, threads = warps * 32;
#define SELECT_LAUNCH(QPW, S)                                                                 \
  return K == 1 ? launch<QPW, S, true>(blocks, threads, q, s, starts, wends, tile, K, r2,     \
                                       empty, out_pos, out_d2, st)                            \
                : launch<QPW, S, false>(blocks, threads, q, s, starts, wends, tile, K, r2,    \
                                        empty, out_pos, out_d2, st)
  if (K > 128) SELECT_LAUNCH(1, 8);
  if (K > 64) SELECT_LAUNCH(1, 4);
  if (qpw == 1) SELECT_LAUNCH(1, 2);
  if (qpw == 2) SELECT_LAUNCH(2, 2);
  SELECT_LAUNCH(4, 2);
#undef SELECT_LAUNCH
}
