// K1: band radius select for Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/select.py::_select_kernel (pallas_call in
// band_select). For each query of a tile of T sorted queries, walk the
// tile's window of sorted support rows [start, wend) and keep the K
// candidates (same cloud id, d2 <= r2) of smallest squared distance,
// ascending, ties by ascending position. Empty slots: position Ns_pad - 1,
// d2 = 3e38.
//
// d2 is float32 in one fixed op order (d2.cuh, shared with K2 and K3,
// which compare against the threshold derived from it bit for bit).
//
// Bound: neither bytes (each support row is 16 B, each output 8 B per
// slot) nor FLOPs are large; the work is T x window compares per tile.
// Design: one CTA per query tile, one thread per query, the window streamed
// through shared memory in 256-row chunks (every thread reads the same row:
// a broadcast), and a per-thread sorted top-K kept in registers by an
// unrolled shift-insert network (the TPU kernel's insertion, per query).

#include <cuda_runtime.h>

#include "d2.cuh"

#define CHUNK 256
#define KMAX 64
#define EMPTY_D2 3.0e38f

// KT >= K entries are kept in registers (the list is unrolled at compile
// time); keeping more than K smallest leaves the first K unchanged.
template <int KT>
__global__ void select_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                              const int* __restrict__ starts, const int* __restrict__ wends,
                              int K, float r2, int empty,
                              int* __restrict__ out_pos, float* __restrict__ out_d2) {
  __shared__ float4 rows[CHUNK];
  const int tile = blockIdx.x;
  const int qi = tile * blockDim.x + threadIdx.x;
  const float4 qq = q[qi];
  const int start = starts[tile];
  const int wend = wends[tile];

  float dk[KT];
  int pk[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) { dk[k] = EMPTY_D2; pk[k] = empty; }

  for (int base = start; base < wend; base += CHUNK) {
    const int n = min(CHUNK, wend - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) rows[i] = s[base + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 sr = rows[j];
      const float d2 = exact_d2(sr, qq.x, qq.y, qq.z);
      if (sr.w == qq.w && d2 <= r2 && d2 < dk[KT - 1]) {
        // shift-insert: d2 lands after every kept entry <= d2 (ties keep
        // arrival order, and rows arrive in ascending position)
        const int pos = base + j;
#pragma unroll
        for (int k = KT - 1; k > 0; --k) {
          const bool shift = d2 < dk[k - 1];
          const bool here = !shift && d2 < dk[k];
          dk[k] = shift ? dk[k - 1] : (here ? d2 : dk[k]);
          pk[k] = shift ? pk[k - 1] : (here ? pos : pk[k]);
        }
        if (d2 < dk[0]) { dk[0] = d2; pk[0] = pos; }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k < K) {
      out_pos[(size_t)qi * K + k] = pk[k];
      out_d2[(size_t)qi * K + k] = dk[k];
    }
  }
}

template <int KT>
static int launch(const void* q, const void* s, const void* starts, const void* wends,
                  int n_tiles, int tile, int K, float r2, int empty, void* out_pos,
                  void* out_d2, cudaStream_t stream) {
  select_kernel<KT><<<n_tiles, tile, 0, stream>>>(
      (const float4*)q, (const float4*)s, (const int*)starts, (const int*)wends,
      K, r2, empty, (int*)out_pos, (float*)out_d2);
  return (int)cudaGetLastError();
}

extern "C" int select_launch(const void* q, const void* s, const void* starts,
                             const void* wends, int n_tiles, int tile, int K,
                             float r2, int empty, void* out_pos, void* out_d2,
                             void* stream) {
  if (K < 1 || K > KMAX || tile < 1 || tile > 1024) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 1) return launch<1>(q, s, starts, wends, n_tiles, tile, K, r2, empty, out_pos, out_d2, st);
  if (K <= 16) return launch<16>(q, s, starts, wends, n_tiles, tile, K, r2, empty, out_pos, out_d2, st);
  if (K <= 32) return launch<32>(q, s, starts, wends, n_tiles, tile, K, r2, empty, out_pos, out_d2, st);
  if (K <= 48) return launch<48>(q, s, starts, wends, n_tiles, tile, K, r2, empty, out_pos, out_d2, st);
  return launch<64>(q, s, starts, wends, n_tiles, tile, K, r2, empty, out_pos, out_d2, st);
}
