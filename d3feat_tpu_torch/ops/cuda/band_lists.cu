// List stage of K2 and K4: each query's selected support rows, built once
// per search and shared by every band conv that uses the search (and by
// their backward), for Hopper (sm_90a).
//
// Replaces the selection phase of d3feat_tpu/ops/pallas/band_conv.py::
// _band_conv_kernel and _band_conv_bwd_kernel (threshold mode), which the
// TPU kernels redo in every conv as a dense [T x band] mask. For each
// padded query q of a tile, the rows of the tile's window [start, wend)
// with q's cloud id and
//     d2 < thr[q]  or  (d2 == thr[q] and position <= ptie[q])
// (d2 exactly as K1 computes it, d2.cuh), which reproduces q's K1 list,
// go to lpos[q] / ld2[q] in ascending position; lcnt[q] is their count
// (at most LCAP); unused entries hold position -1 and d2 0.
//
// Design: a CTA owns QB consecutive queries of one tile and streams the
// tile's window through shared memory in CHUNK-row stages (cp.async,
// double-buffered), so the window is read once per CTA rather than once
// per query. Each warp then tests its queries against the staged rows,
// 32 at a time, and appends the selected ones by ballot compaction.
// Bound: the d2 tests, QB x window rows per CTA (operations); the bytes
// are the window rows (L2-resident, re-read by the tile / QB CTAs of a
// tile) and the lists.
//
// The transpose (band_lists_transpose_launch) turns a search's lists into
// K4's dx gather order: for each support row r, the entries e = q * LCAP
// + j with lpos[e] == r, ascending (ascending query order). A counting
// sort: per-row counts (atomic), their exclusive scan (one CTA), a fill
// in arrival order, then each row's short segment sorted (by rank), so
// the result does not depend on the order the atomics ran in.

#include <climits>
#include <cuda_runtime.h>

#include "band_lists.cuh"

#define QB 32        // queries per CTA (a slice of one tile)
#define CHUNK 256    // window rows per shared-memory stage
#define NTHREADS 256

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__global__ void __launch_bounds__(NTHREADS)
band_lists_kernel(const float4* __restrict__ q, const float* __restrict__ thr,
                  const float* __restrict__ ptie, const float4* __restrict__ s,
                  const int* __restrict__ starts, const int* __restrict__ wends, int tile,
                  int* __restrict__ lpos, float* __restrict__ ld2, int* __restrict__ lcnt) {
  __shared__ __align__(16) float4 rows[2][CHUNK];
  __shared__ float4 qs[QB];
  __shared__ float ths[QB], pts[QB];
  __shared__ int cnts[QB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QB;
  const int t = q0 / tile;
  const int ws = starts[t], we = wends[t];
  if (threadIdx.x < QB) {
    qs[threadIdx.x] = q[q0 + threadIdx.x];
    ths[threadIdx.x] = thr[q0 + threadIdx.x];
    pts[threadIdx.x] = ptie[q0 + threadIdx.x];
    cnts[threadIdx.x] = 0;
  }
  const int nch = we > ws ? (we - ws + CHUNK - 1) / CHUNK : 0;
  auto stage = [&](int c) {
    const int r = ws + c * CHUNK + threadIdx.x;
    if (r < we) cp_async16(&rows[c & 1][threadIdx.x], s + r);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (nch > 0) stage(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int base = ws + c * CHUNK, n = min(CHUNK, we - base);
    for (int qi = warp; qi < QB; qi += NTHREADS / 32) {
      const size_t o = (size_t)(q0 + qi) * LCAP;
      const int cnt = select_rows(rows[c & 1], base, n, qs[qi], ths[qi], pts[qi], lpos + o,
                                  ld2 + o, cnts[qi]);
      __syncwarp();
      if (lane == 0) cnts[qi] = cnt;
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }
  __syncthreads();
  for (int qi = warp; qi < QB; qi += NTHREADS / 32) {
    const int n = min(cnts[qi], LCAP);
    const size_t o = (size_t)(q0 + qi) * LCAP;
    for (int j = n + lane; j < LCAP; j += 32) {
      lpos[o + j] = -1;
      ld2[o + j] = 0.f;
    }
    if (lane == 0) lcnt[q0 + qi] = n;
  }
}

__global__ void count_rows_kernel(const int* __restrict__ lpos, const int* __restrict__ lcnt,
                                  int nq, int* __restrict__ cnt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nq * LCAP || e % LCAP >= lcnt[e / LCAP]) return;
  atomicAdd(cnt + lpos[e], 1);
}

#define SCAN_THREADS 1024

// row_ptr[0..ns] = exclusive scan of cnt, by one CTA: each thread sums a
// contiguous segment, the segment sums are scanned in shared memory
__global__ void __launch_bounds__(SCAN_THREADS)
scan_rows_kernel(const int* __restrict__ cnt, int ns, int* __restrict__ row_ptr) {
  __shared__ int tot[SCAN_THREADS];
  const int tid = threadIdx.x;
  const int seg = (ns + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b = min(tid * seg, ns), e = min(b + seg, ns);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += cnt[i];
  tot[tid] = sum;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int v = tid >= off ? tot[tid - off] : 0;
    __syncthreads();
    tot[tid] += v;
    __syncthreads();
  }
  int run = tid ? tot[tid - 1] : 0;
  for (int i = b; i < e; ++i) {
    row_ptr[i] = run;
    run += cnt[i];
  }
  if (tid == SCAN_THREADS - 1) row_ptr[ns] = tot[tid];
}

__global__ void fill_rows_kernel(const int* __restrict__ lpos, const int* __restrict__ lcnt,
                                 int nq, const int* __restrict__ row_ptr, int* __restrict__ fill,
                                 int* __restrict__ pairs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nq * LCAP || e % LCAP >= lcnt[e / LCAP]) return;
  const int r = lpos[e];
  pairs[row_ptr[r] + atomicAdd(fill + r, 1)] = e;
}

// each row's entries ascending, one warp per row: an entry's place is the
// number of the row's entries below it (the entries are distinct)
__global__ void __launch_bounds__(256)
sort_rows_kernel(const int* __restrict__ row_ptr, int ns, const int* __restrict__ filled,
                 int* __restrict__ pairs) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= ns) return;
  const int b = row_ptr[r], n = row_ptr[r + 1] - b;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int v = i0 + lane < n ? filled[b + i0 + lane] : INT_MAX;
    int rank = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int u = j0 + lane < n ? filled[b + j0 + lane] : INT_MAX;
      for (int k = 0; k < 32; ++k) rank += __shfl_sync(0xffffffffu, u, k) < v;
    }
    if (i0 + lane < n) pairs[b + rank] = v;
  }
}

// cnt and fill: [ns] zeroed scratch; row_ptr [ns + 1]; filled (scratch) and
// pairs [nq * LCAP]
extern "C" int band_lists_transpose_launch(const void* lpos, const void* lcnt, int nq, int ns,
                                           void* cnt, void* fill, void* row_ptr, void* filled,
                                           void* pairs, void* stream) {
  if (nq < 0 || ns < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(((size_t)nq * LCAP + 255) / 256);
  cudaError_t e;
  if (nq > 0) {
    count_rows_kernel<<<blocks, 256, 0, st>>>((const int*)lpos, (const int*)lcnt, nq, (int*)cnt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  scan_rows_kernel<<<1, SCAN_THREADS, 0, st>>>((const int*)cnt, ns, (int*)row_ptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (nq == 0) return 0;
  fill_rows_kernel<<<blocks, 256, 0, st>>>((const int*)lpos, (const int*)lcnt, nq,
                                           (const int*)row_ptr, (int*)fill, (int*)filled);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sort_rows_kernel<<<(unsigned)((ns + 7) / 8), 256, 0, st>>>((const int*)row_ptr, ns,
                                                             (const int*)filled, (int*)pairs);
  return (int)cudaGetLastError();
}

extern "C" int band_lists_launch(const void* q, const void* thr, const void* ptie,
                                 const void* s, const void* starts, const void* wends, int nq,
                                 int tile, void* lpos, void* ld2, void* lcnt, void* stream) {
  if (nq % QB || tile % QB || tile < QB) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  band_lists_kernel<<<nq / QB, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)q, (const float*)thr, (const float*)ptie, (const float4*)s,
      (const int*)starts, (const int*)wends, tile, (int*)lpos, (float*)ld2, (int*)lcnt);
  return (int)cudaGetLastError();
}
