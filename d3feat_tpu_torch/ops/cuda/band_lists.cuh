// Per-query selected-row lists and kernel-point influence weights, shared
// by the list stage (band_lists.cu), K2 (band_conv.cu) and K4
// (band_conv_bwd.cu): the lists are built once per search and both
// kernels weigh the listed rows bit for bit alike, by the rule of the
// lists' mode (threshold or list, Influence).
#pragma once
#include <cuda_runtime.h>

#include "d2.cuh"

// Lists of one search are lw entries a query (lw, the lists' width: K1's
// cap K rounded up to LSEG, 2 LSEG or LMAX, as K1 keeps at most LMAX
// rows): entry j of query q is e = q * lw + j, so q = e >> list_shift(lw).
#define LSEG 64   // entries of a list segment; lw is a multiple of it
#define LMAX 256  // widest lists (K1's largest cap)

// whether lw is a lists' width (a power of two from LSEG to LMAX)
__host__ __device__ __forceinline__ bool list_width_ok(int lw) {
  return lw >= LSEG && lw <= LMAX && !(lw & (lw - 1));
}

__device__ __forceinline__ int list_shift(int lw) { return __ffs(lw) - 1; }

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// Linear influence of kernel point k (|k|^2 = kk) on the pair (q, s) with
// exact squared distance d2, by the reference's expansion
//     w = max(1 - sqrt(max(d2 + a + b, 0)) / extent, 0),
//     a = -2 s.k,  b = 2 q.k + |k|^2.
__device__ __forceinline__ float kp_weight(float d2, float4 sr, float4 qq, float kx, float ky,
                                           float kz, float kk, float inv_extent) {
  const float a = __fmul_rn(-2.f, dot3(sr.x, sr.y, sr.z, kx, ky, kz));
  const float b = __fadd_rn(__fmul_rn(2.f, dot3(qq.x, qq.y, qq.z, kx, ky, kz)), kk);
  const float d2kp = fmaxf(__fadd_rn(__fadd_rn(d2, a), b), 0.f);
  return fmaxf(__fsub_rn(1.f, __fmul_rn(__fsqrt_rn(d2kp), inv_extent)), 0.f);
}

// List mode's influence of kernel point k on the pair (q, s), as the TPU
// kernel computes it without thresholds (band_conv.py:220-227, 497-504):
// per axis d = s - (q + k), d2 = (dx dx + dy dy) + dz dz, and
//     w = max(1 - sqrt(d2) / extent, 0),
// a true division by extent.
__device__ __forceinline__ float kp_weight_list(float4 sr, float4 qq, float kx, float ky,
                                                float kz, float extent) {
  const float dx = __fsub_rn(sr.x, __fadd_rn(qq.x, kx));
  const float dy = __fsub_rn(sr.y, __fadd_rn(qq.y, ky));
  const float dz = __fsub_rn(sr.z, __fadd_rn(qq.z, kz));
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(d2), extent)), 0.f);
}

// The influence rule of a search's lists: threshold mode (kp_weight, from
// the entry's exact d2 in ld2) or list mode (kp_weight_list; no ld2). The
// weighing kernels are instantiated for each mode (their LIST parameter,
// chosen at launch by `list`), so threshold mode compiles without a branch.
struct Influence {
  float inv_extent;  // threshold mode: 1 / extent, rounded in f32
  float extent;      // list mode
  int list;          // 1: list mode
};

// the exact d2 of list entry e, kept by threshold mode only (list mode: 0)
template <bool LIST>
__device__ __forceinline__ float entry_d2(const float* ld2, size_t e) {
  if constexpr (LIST) return 0.f;
  else return ld2[e];
}

// the weight of kernel point k (|k|^2 = kk) on a listed pair with entry_d2 d2
template <bool LIST>
__device__ __forceinline__ float influence(const Influence& f, float d2, float4 sr, float4 qq,
                                           float kx, float ky, float kz, float kk) {
  if constexpr (LIST) return kp_weight_list(sr, qq, kx, ky, kz, f.extent);
  else return kp_weight(d2, sr, qq, kx, ky, kz, kk, f.inv_extent);
}

// One warp appends query qq's selected rows among n staged window rows
// (rows[0, n) stand for positions base + [0, n)): the rows with q's cloud
// id and (d2 < thr or d2 == thr and position <= ptie), in ascending
// position, into lpos/ld2 from entry cnt on (at most lw entries are
// kept). Returns the new count, uncapped (all lanes).
__device__ __forceinline__ int select_rows(const float4* rows, int base, int n, float4 qq,
                                           float th, float pt, int* lpos, float* ld2,
                                           int cnt, int lw) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool sel = false;
    float d2 = 0.f;
    if (j < n) {
      const float4 sr = rows[j];
      d2 = exact_d2(sr, qq.x, qq.y, qq.z);
      sel = (sr.w == qq.w) && (d2 < th || (d2 == th && (float)(base + j) <= pt));
    }
    const unsigned m = __ballot_sync(0xffffffffu, sel);
    if (sel) {
      const int idx = cnt + __popc(m & ((1u << lane) - 1u));
      if (idx < lw) {
        lpos[idx] = base + j;
        ld2[idx] = d2;
      }
    }
    cnt += __popc(m);
  }
  return cnt;
}
