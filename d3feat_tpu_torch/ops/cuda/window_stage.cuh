// Staging of a query tile's window of sorted support rows [ws, we) through
// shared memory, shared by K1 (select.cu) and the list stage
// (band_lists.cu): CHUNK-row stages copied by cp.async, double-buffered,
// so a CTA reads the window from global memory once for all its queries
// and the next stage's copy overlaps the work on the current one.
//
//   const int nch = window_chunks(ws, we);
//   if (nch > 0) stage_chunk(rows[0], s, ws, we);
//   for (int c = 0; c < nch; ++c) {
//     const bool more = c + 1 < nch;
//     if (more) stage_chunk(rows[(c + 1) & 1], s, ws + (c + 1) * CHUNK, we);
//     wait_chunk(more);
//     ... rows[c & 1][0, min(CHUNK, we - base)) hold positions base + ...
//     __syncthreads();  // the buffer is staged again two chunks on
//   }
#pragma once
#include <cuda_runtime.h>

#define CHUNK 256  // window rows per shared-memory stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ int window_chunks(int ws, int we) {
  return we > ws ? (we - ws + CHUNK - 1) / CHUNK : 0;
}

// rows base + [0, CHUNK) below we into buf, by every thread of the block,
// as one cp.async group
__device__ __forceinline__ void stage_chunk(float4* buf, const float4* __restrict__ s, int base,
                                            int we) {
  for (int i = threadIdx.x; i < CHUNK; i += blockDim.x)
    if (base + i < we) cp_async16(&buf[i], s + base + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for the current stage (and not the next one, when it is in flight),
// then make it visible to the whole block
__device__ __forceinline__ void wait_chunk(bool more) {
  if (more)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}
