// The products of K2 (band_conv.cu) and K4 (band_conv_bwd.cu) over the
// per-query lists of the list stage (band_lists.cu):
//
//   weighted[q][kp * C + c] = sum_j w_kp(q, j) x[lpos[q][j]][c]
//       the first product, per query: [16 kernel points (15 padded to one
//       m16 tile) x list] by [list x C gathered rows];
//   gemm3: C = A B over fixed reduction slices, for the second product
//       y = weighted W and for K4's dW = weighted^T gs and dx = G W^T (bf16
//       panels: V = gs W^T) (named for its 3xTF32 products; with bf16
//       panels one BF16 product).
//
// Every kernel is templated on the panel type T of its operands:
// - T = float: the products run on the tensor cores as 3xTF32: every f32
//   operand a is split into a_hi = tf32(a) and a_lo = tf32(a - a_hi)
//   (cvt.rna, round to nearest), and each product is a_lo b_hi + a_hi b_lo
//   + a_hi b_hi, three mma.sync.m16n8k8 TF32 steps accumulated in f32 in
//   that fixed order, which keeps about f32 accuracy (plain TF32 keeps
//   about three digits);
// - T = __nv_bfloat16 (the bf16 panels of compute_dtype="bfloat16"): the
//   operands are bf16 in memory (the influence weights are rounded to
//   nearest where they are computed), one mma.sync.m16n8k16 BF16 step per
//   product, accumulated in f32, fragments from ldmatrix; outputs that are
//   panels of a later product are written in bf16, rounded to nearest.
//   The first product (weighted_bf16_kernel) rounds where the TPU kernel
//   rounds: the TPU kernel walks the tile's window in chunks of `chunk`
//   rows and rounds each chunk's weighted rows to bf16 before multiplying
//   them by W, so here each query's list (ascending positions) is cut at
//   the window's chunk boundaries, each piece's sum is rounded to bf16,
//   and the pieces are added in f32: S = sum_c bf16(weighted_c). S is
//   written as two bf16 rows, hi = bf16(S) and lo = bf16(S - hi) (hi + lo
//   = S to about 2^-17 relative), so that S W = hi W + lo W stays exact
//   BF16 products: gemm_bf16 reduces both rows of a query against one
//   stage of W (two A operands, one B).
// The tensor cores' own additions truncate, so gemm3 and gemm_bf16 sum
// each 32-deep stage in fresh accumulators and add those in f32
// round-to-nearest.
// (The first product of a single input feature is FP32 FMA instead, on
// the panel's values.) Every output has one owner and a fixed reduction
// order, so results are the same from run to run. Fragment layouts
// (cute/atom/mma_traits_sm80.hpp), with g = lane / 4, t = lane % 4:
// SM80_16x8x8_F32TF32TF32F32_TN
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
// SM80_16x8x16_F32BF16BF16F32_TN (two bf16 a register, the lower index in
// the low half)
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
// and for both
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "band_lists.cuh"

typedef __nv_bfloat16 bf16;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (is_bf16<T>) return __float2bfloat16_rn(v);
  else return v;
}

// v rounded to the panel type T, as a float
template <typename T>
__device__ __forceinline__ float panel_round(float v) {
  return to_f32(from_f32<T>(v));
}

// two bf16 values in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: small terms first, then the large one
__device__ __forceinline__ void mma3(float* d, const unsigned* ah, const unsigned* al,
                                     const unsigned* bh, const unsigned* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// 16-byte row addresses of matrix i, and r[i] holds, in lane (g, t), its
// row g, columns 2t..2t+1 (.trans: its column g, rows 2t..2t+1), the
// lower index in the low half: the layout of an m16n8k16 A or B register
__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// dst[i] = bf16(src[i]), rounded to nearest: the bf16 panels of x, W, gs
__global__ void to_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

static inline cudaError_t to_bf16(const void* src, void* dst, size_t n, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  to_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)src, (bf16*)dst, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// density: act[r] = (sum_c x[r][c] > 0), the sum by lanes then a shuffle
// tree (bf16 panels: bf16_panels_kernel, over the rounded values)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
row_active_kernel(const T* __restrict__ x, int ns, int C, int* __restrict__ act) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= ns) return;
  const T* xr = x + (size_t)r * C;
  float part = 0.f;
  for (int c = lane; c < C; c += 32) part = __fadd_rn(part, to_f32(xr[c]));
  for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (lane == 0) act[r] = part > 0.f;
}

// den[q] = max(#listed rows of q with act, 1), by one warp
__device__ __forceinline__ void list_density(const int* __restrict__ lp, int n,
                                             const int* __restrict__ act, float* den) {
  const int lane = threadIdx.x & 31;
  int a = 0;
  for (int j = lane; j < n; j += 32) a += act[lp[j]];
  for (int o = 16; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane == 0) *den = fmaxf((float)a, 1.f);
}

// ---------------------------------------------------------------------------
// first product: one warp per query, the list in k-steps of 8 rows
// ---------------------------------------------------------------------------

// f32: NTL n-tiles of 8 channels per pass over the list, in k-steps of 8
// list rows. Each lane computes the influence weights of its A-fragment
// entries (kernel points g, g + 8 and list rows t, t + 4 of the k-step)
// and loads its B-fragment entries straight from the gathered rows.
template <typename T, int NTL, bool LIST>
__global__ void __launch_bounds__(256)
weighted_mma_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                    const T* __restrict__ x, const float* __restrict__ kp, int KP,
                    const int* __restrict__ lpos, const float* __restrict__ ld2,
                    const int* __restrict__ lcnt, int lw, const int* __restrict__ act, int nq,
                    int C, int ldw, Influence inf, const int* __restrict__ starts, int tile,
                    int chunk, T* __restrict__ wtd, float* __restrict__ den) {
  static_assert(!is_bf16<T>, "bf16 panels: weighted_bf16_kernel");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qi = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (qi >= nq) return;
  const int n = lcnt[qi];
  const float4 qq = q[qi];
  const int* lp = lpos + (size_t)qi * lw;
  T* out = wtd + (size_t)qi * ldw;
  const bool has0 = g < KP, has1 = g + 8 < KP;
  float k0x = 0.f, k0y = 0.f, k0z = 0.f, k1x = 0.f, k1y = 0.f, k1z = 0.f;
  if (has0) { k0x = kp[3 * g]; k0y = kp[3 * g + 1]; k0z = kp[3 * g + 2]; }
  if (has1) { k1x = kp[3 * g + 24]; k1y = kp[3 * g + 25]; k1z = kp[3 * g + 26]; }
  const float kk0 = dot3(k0x, k0y, k0z, k0x, k0y, k0z);
  const float kk1 = dot3(k1x, k1y, k1z, k1x, k1y, k1z);

  for (int c0 = 0; c0 < C; c0 += 8 * NTL) {
    float acc[NTL][4];
#pragma unroll
    for (int i = 0; i < NTL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const int nks = (n + 7) / 8;
    for (int ks = 0; ks < nks; ++ks) {
      int p[2];
      bool v[2];
      float w[2][2];  // kernel points g, g + 8 by the lane's rows
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = ks * 8 + t + 4 * i;
        v[i] = j < n;
        p[i] = v[i] ? lp[j] : 0;
        w[0][i] = w[1][i] = 0.f;
        if (v[i]) {
          const float4 sr = s[p[i]];
          const float d2 = entry_d2<LIST>(ld2, (size_t)qi * lw + j);
          if (has0) w[0][i] = influence<LIST>(inf, d2, sr, qq, k0x, k0y, k0z, kk0);
          if (has1) w[1][i] = influence<LIST>(inf, d2, sr, qq, k1x, k1y, k1z, kk1);
        }
      }
      unsigned ah[4], al[4];
      const float wa[4] = {w[0][0], w[1][0], w[0][1], w[1][1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(wa[i], ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int c = c0 + nt * 8 + g;
        const float b0 = (v[0] && c < C) ? x[(size_t)p[0] * C + c] : 0.f;
        const float b1 = (v[1] && c < C) ? x[(size_t)p[1] * C + c] : 0.f;
        unsigned bh[2], bl[2];
        split_tf32(b0, bh[0], bl[0]);
        split_tf32(b1, bh[1], bl[1]);
        mma3(acc[nt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = g + 8 * (e >> 1), c = c0 + nt * 8 + 2 * t + (e & 1);
        if (k >= KP || c >= C) continue;
        out[k * C + c] = acc[nt][e];
      }
    }
  }
  if (lane < ldw - KP * C) out[KP * C + lane] = 0.f;  // row padding
  list_density(lp, n, act, den + qi);
}

// bf16: one warp per query, WQ warps a CTA, lists of at most R entries
// (R = LSEG, or LMAX for wider lists; the shared rows are dynamic,
// bf16_smem). Once per query: each entry's
// influence weights for the 16 kernel points (rounded to bf16, kernel
// points past KP and entries past the count zero) into shared memory,
// entry-major (row R zero), and the pieces of the list, the entries of
// one chunk of the window each: every lane computes the chunk ids of its
// R / 32 entries, and a ballot of "chunk id differs from the previous
// entry's" gives each piece's first entry. Then, per pass of 8 * NTL
// channels, the listed rows of x gathered into shared memory by 16-byte
// cp.async (row R zero), and for each piece its k-steps of 16 entries
// from the piece's first entry (band_conv.cu says why the grouping is
// fixed): A (kernel points by entries) and B (entries by channels) fragments by
// ldmatrix.trans from any entry row (rows past the list read the zero
// row), the A fragments masked to the piece's entries. A piece's sum is
// rounded to bf16 and added into the query's f32 total.
#define WQ 3
#define WLD 24  // padded shared rows of the weights (16 kernel points): 16-byte aligned, conflict-free

// the dynamic shared bytes of weighted_bf16_kernel<NTL, ., R>: per warp,
// R + 1 rows of weights and of gathered x, and R positions
template <int NTL, int R>
constexpr size_t bf16_smem() {
  return (size_t)WQ * ((R + 1) * (WLD + 8 * NTL + 8) * sizeof(bf16) + R * sizeof(int));
}

// the first piece start after entry j0 (n if none), from the piece starts'
// ballots fw (bit j % 32 of word j / 32 for entry j)
template <int H>
__device__ __forceinline__ int next_start(const unsigned (&fw)[H], int j0, int n) {
#pragma unroll
  for (int w = 0; w < H; ++w) {
    const int lo = j0 + 1 - 32 * w;  // the word's bits from lo on
    if (lo >= 32) continue;
    const unsigned m = lo > 0 ? fw[w] & (~0u << lo) : fw[w];
    if (m) return min(32 * w + __ffs(m) - 1, n);
  }
  return n;
}

template <int NTL, bool LIST, int R>
__global__ void __launch_bounds__(WQ * 32)
weighted_bf16_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                     const bf16* __restrict__ x, const float* __restrict__ kp, int KP,
                     const int* __restrict__ lpos, const float* __restrict__ ld2,
                     const int* __restrict__ lcnt, int lw, const int* __restrict__ act, int nq,
                     int C, int ldw, Influence inf, const int* __restrict__ starts, int tile,
                     int chunk, bf16* __restrict__ wtd, float* __restrict__ den) {
  static_assert(NTL % 2 == 0, "B fragments come two n-tiles a load");
  constexpr int XLD = 8 * NTL + 8;  // padded shared rows of the gathered x
  constexpr int H = R / 32;         // entries a lane
  extern __shared__ __align__(16) unsigned char smem[];  // bf16_smem<NTL, R>() bytes
  __shared__ float kps[48];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < 3 * KP) kps[threadIdx.x] = kp[threadIdx.x];
  __syncthreads();
  const int qi = blockIdx.x * WQ + warp;
  if (qi >= nq) return;
  bf16* wsm = reinterpret_cast<bf16*>(smem) + warp * (R + 1) * WLD;
  bf16* xs = reinterpret_cast<bf16*>(smem) + WQ * (R + 1) * WLD + warp * (R + 1) * XLD;
  int* ps = reinterpret_cast<int*>(reinterpret_cast<bf16*>(smem) + WQ * (R + 1) * (WLD + XLD)) +
            warp * R;
  const int n = lcnt[qi];
  const float4 qq = q[qi];
  const int* lp = lpos + (size_t)qi * lw;
  const int ws = starts[qi / tile];  // the window's first row
  const bf16 zero = __float2bfloat16_rn(0.f);
  int cid[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    const bool v = j < n;
    const int p = v ? lp[j] : 0;
    cid[h] = v ? (p - ws) / chunk : -1;
    ps[j] = p;
    const float4 sr = s[p];
    const float d2 = v ? entry_d2<LIST>(ld2, (size_t)qi * lw + j) : 0.f;
    float w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      w[k] = 0.f;
      if (v && k < KP) {
        const float kx = kps[3 * k], ky = kps[3 * k + 1], kz = kps[3 * k + 2];
        w[k] = influence<LIST>(inf, d2, sr, qq, kx, ky, kz, dot3(kx, ky, kz, kx, ky, kz));
      }
    }
    uint4* row = reinterpret_cast<uint4*>(wsm + j * WLD);
    row[0] = make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]), pack_bf16(w[4], w[5]),
                        pack_bf16(w[6], w[7]));
    row[1] = make_uint4(pack_bf16(w[8], w[9]), pack_bf16(w[10], w[11]),
                        pack_bf16(w[12], w[13]), pack_bf16(w[14], w[15]));
  }
  if (lane < 16) wsm[R * WLD + lane] = zero;  // the zero row
  for (int c = lane; c < 8 * NTL; c += 32) xs[R * XLD + c] = zero;
  // the pieces' first entries: entry 0, and every entry whose chunk differs
  // from the previous entry's
  unsigned first[H];
  int last = 0;  // the chunk id of the entry before the word's first
#pragma unroll
  for (int h = 0; h < H; ++h) {
    int prev = __shfl_up_sync(0xffffffffu, cid[h], 1);
    if (lane == 0) prev = last;
    const int j = lane + 32 * h;
    first[h] = __ballot_sync(0xffffffffu, j < n && (j == 0 || cid[h] != prev));
    last = __shfl_sync(0xffffffffu, cid[h], 31);
  }
  __syncwarp();
  // the lane's ldmatrix rows: A (.trans of the entry-major weights) and B
  // (.trans of the entry-major rows of x) at entries k0 + ra, k0 + rb
  const int ra = (lane & 7) + 8 * (lane >> 4), ca = 8 * ((lane >> 3) & 1);
  const int rb = (lane & 7) + 8 * ((lane >> 3) & 1), cb = 8 * (lane >> 4);
  bf16* out = wtd + (size_t)qi * ldw;
  bf16* out_lo = wtd + (size_t)(nq + qi) * ldw;  // the lo rows

  for (int c0 = 0; c0 < C; c0 += 8 * NTL) {
    for (int i = lane; i < n * NTL; i += 32) {  // the pass's gathered rows
      const int j = i / NTL, c = c0 + 8 * (i % NTL);
      const bool v = c < C;
      cp_async16z(xs + j * XLD + 8 * (i % NTL), v ? x + (size_t)ps[j] * C + c : x, v);
    }
    cp_async_wait_all();
    __syncwarp();
    float tot[NTL][4];  // the sum of the rounded pieces
#pragma unroll
    for (int i = 0; i < NTL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][e] = 0.f;
    for (int j0 = 0; j0 < n;) {
      const int j1 = next_start<H>(first, j0, n);
      float acc[NTL][4];
#pragma unroll
      for (int i = 0; i < NTL; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      for (int k0 = j0; k0 < j1; k0 += 16) {
        unsigned a[4];
        ldsm_x4_t(a, wsm + min(k0 + ra, R) * WLD + ca);
        // the A fragment's entries k0 + 2t (+1, +8, +9) kept below j1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = k0 + 2 * t + 8 * (i >> 1);
          a[i] &= (j < j1 ? 0xffffu : 0u) | (j + 1 < j1 ? 0xffff0000u : 0u);
        }
        const int r = k0 + rb;
        const bf16* xr = xs + (r < n ? r : R) * XLD + cb;
#pragma unroll
        for (int nt = 0; nt < NTL; nt += 2) {
          unsigned b[4];
          ldsm_x4_t(b, xr + nt * 8);
          mma_bf16(acc[nt], a, b);
          mma_bf16(acc[nt + 1], a, b + 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tot[nt][e] = __fadd_rn(tot[nt][e], panel_round<bf16>(acc[nt][e]));
      j0 = j1;
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = g + 8 * h, c = c0 + nt * 8 + 2 * t;
        if (k >= KP || c >= C) continue;
        const float s0 = tot[nt][2 * h], s1 = tot[nt][2 * h + 1];
        const bf16 h0 = __float2bfloat16_rn(s0), h1 = __float2bfloat16_rn(s1);
        *reinterpret_cast<unsigned*>(out + k * C + c) = pack_bf16(h0, h1);
        *reinterpret_cast<unsigned*>(out_lo + k * C + c) =
            pack_bf16(__fsub_rn(s0, __bfloat162float(h0)), __fsub_rn(s1, __bfloat162float(h1)));
      }
    }
    __syncwarp();  // the next pass overwrites the gathered rows
  }
  if (lane < ldw - KP * C) {  // row padding
    out[KP * C + lane] = zero;
    out_lo[KP * C + lane] = zero;
  }
  list_density(lp, n, act, den + qi);
}

// Narrow inputs (C < SIMT_CMAX, the first conv's single feature): one thread
// per (query, kernel point), FP32 FMA over the list in ascending position,
// on the panel's values (bf16: the weights rounded to bf16, whose products
// with the bf16 features are exact, so each FMA rounds only its sum; each
// chunk's piece rounded to bf16 and the pieces added, as in the MMA
// kernel).
#define SIMT_CMAX 8
template <typename T, bool LIST>
__global__ void __launch_bounds__(256)
weighted_simt_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                     const T* __restrict__ x, const float* __restrict__ kp, int KP,
                     const int* __restrict__ lpos, const float* __restrict__ ld2,
                     const int* __restrict__ lcnt, int lw, const int* __restrict__ act, int nq,
                     int C, int ldw, Influence inf, const int* __restrict__ starts, int tile,
                     int chunk, T* __restrict__ wtd, float* __restrict__ den) {
  constexpr bool BF = is_bf16<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int qi = i >> 4, k = i & 15;
  if (qi >= nq) return;
  const int n = lcnt[qi];
  const float4 qq = q[qi];
  const int* lp = lpos + (size_t)qi * lw;
  T* out = wtd + (size_t)qi * ldw;
  T* out_lo = wtd + (size_t)(nq + qi) * ldw;  // bf16: the lo rows
  if (k < KP) {
    const float kx = kp[3 * k], ky = kp[3 * k + 1], kz = kp[3 * k + 2];
    const float kk = dot3(kx, ky, kz, kx, ky, kz);
    const int ws = BF ? starts[qi / tile] : 0;
    float acc[SIMT_CMAX], tot[SIMT_CMAX];
#pragma unroll
    for (int c = 0; c < SIMT_CMAX; ++c) acc[c] = tot[c] = 0.f;
    int cid = BF && n > 0 ? (lp[0] - ws) / chunk : 0;
    for (int j = 0; j < n; ++j) {
      const int p = lp[j];
      if (BF && (p - ws) / chunk != cid) {  // a new chunk: round the last piece
        cid = (p - ws) / chunk;
#pragma unroll
        for (int c = 0; c < SIMT_CMAX; ++c) {
          tot[c] = __fadd_rn(tot[c], panel_round<T>(acc[c]));
          acc[c] = 0.f;
        }
      }
      const float d2 = entry_d2<LIST>(ld2, (size_t)qi * lw + j);
      const float w = panel_round<T>(influence<LIST>(inf, d2, s[p], qq, kx, ky, kz, kk));
#pragma unroll
      for (int c = 0; c < SIMT_CMAX; ++c)
        if (c < C) acc[c] = __fmaf_rn(w, to_f32(x[(size_t)p * C + c]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < SIMT_CMAX; ++c) {
      if (c >= C) continue;
      if constexpr (BF) {
        const float sum = __fadd_rn(tot[c], panel_round<T>(acc[c]));
        const bf16 hi = __float2bfloat16_rn(sum);
        out[k * C + c] = hi;
        out_lo[k * C + c] = __float2bfloat16_rn(__fsub_rn(sum, __bfloat162float(hi)));
      } else {
        out[k * C + c] = acc[c];
      }
    }
  }
  if (k == 0) {
    for (int c = KP * C; c < ldw; ++c) {  // row padding
      out[c] = from_f32<T>(0.f);
      if (BF) out_lo[c] = from_f32<T>(0.f);
    }
    int a = 0;
    for (int j = 0; j < n; ++j) a += act[lp[j]];
    den[qi] = fmaxf((float)a, 1.f);
  }
}

// weighted rows [nq, ldw] (ldw >= KP * C, padding zero; bf16: [2 * nq,
// ldw], the hi rows then the lo rows, the pieces cut at the chunks of
// `chunk` rows from each tile's window start starts[q / tile]) and the
// densities (act: row_active_kernel's flags)
// weighted_bf16_kernel<NTL, LIST, R> on ctas CTAs, its dynamic shared
// memory allowed above the default 48 KB where it needs more
template <int NTL, bool LIST, int R, typename... A>
static inline void launch_bf16(unsigned ctas, cudaStream_t st, A... args) {
  constexpr size_t bytes = bf16_smem<NTL, R>();
  if constexpr (bytes > 48 * 1024)
    cudaFuncSetAttribute(weighted_bf16_kernel<NTL, LIST, R>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  weighted_bf16_kernel<NTL, LIST, R><<<ctas, WQ * 32, bytes, st>>>(args...);
}

template <typename T, bool LIST>
static inline void weighted_rows_in(const void* q, const void* s, const T* x, const void* kp,
                                    int KP, const void* lpos, const void* ld2, const void* lcnt,
                                    int lw, const int* act, int nq, int C, int ldw, Influence inf,
                                    const int* starts, int tile, int chunk, T* wtd, float* den,
                                    cudaStream_t st) {
#define W_ARGS                                                                             \
  (const float4*)q, (const float4*)s, x, (const float*)kp, KP, (const int*)lpos,            \
      (const float*)ld2, (const int*)lcnt, lw, act, nq, C, ldw, inf, starts, tile,         \
      chunk, wtd, den
  const unsigned warps = (unsigned)((nq + 7) / 8);
  if (C < SIMT_CMAX) {
    weighted_simt_kernel<T, LIST><<<(unsigned)((nq * 16 + 255) / 256), 256, 0, st>>>(W_ARGS);
  } else if constexpr (is_bf16<T>) {
    const unsigned ctas = (unsigned)((nq + WQ - 1) / WQ);
    if (lw <= LSEG) {
      if (C <= 16) launch_bf16<2, LIST, LSEG>(ctas, st, W_ARGS);
      else if (C <= 32) launch_bf16<4, LIST, LSEG>(ctas, st, W_ARGS);
      else launch_bf16<8, LIST, LSEG>(ctas, st, W_ARGS);
    } else {
      if (C <= 16) launch_bf16<2, LIST, LMAX>(ctas, st, W_ARGS);
      else if (C <= 32) launch_bf16<4, LIST, LMAX>(ctas, st, W_ARGS);
      else launch_bf16<8, LIST, LMAX>(ctas, st, W_ARGS);
    }
  } else {
    if (C <= 8) weighted_mma_kernel<T, 1, LIST><<<warps, 256, 0, st>>>(W_ARGS);
    else if (C <= 16) weighted_mma_kernel<T, 2, LIST><<<warps, 256, 0, st>>>(W_ARGS);
    else if (C <= 32) weighted_mma_kernel<T, 4, LIST><<<warps, 256, 0, st>>>(W_ARGS);
    else if (C <= 64) weighted_mma_kernel<T, 8, LIST><<<warps, 256, 0, st>>>(W_ARGS);
    else weighted_mma_kernel<T, 16, LIST><<<warps, 256, 0, st>>>(W_ARGS);
  }
#undef W_ARGS
}

// weighted rows [nq, ldw] (ldw >= KP * C, padding zero; bf16: [2 * nq,
// ldw], the hi rows then the lo rows, the pieces cut at the chunks of
// `chunk` rows from each tile's window start starts[q / tile]) and the
// densities (act: row_active_kernel's flags), weighed by inf's mode
template <typename T>
static inline cudaError_t weighted_rows(const void* q, const void* s, const T* x,
                                        const void* kp, int KP, const void* lpos,
                                        const void* ld2, const void* lcnt, int lw,
                                        const int* act, int nq, int C, int ldw, Influence inf,
                                        const int* starts, int tile, int chunk, T* wtd,
                                        float* den, cudaStream_t st) {
  if (nq == 0) return cudaSuccess;
  if (!list_width_ok(lw)) return cudaErrorInvalidValue;
  // bf16: the window starts and chunks, and rows of whole 16-byte chunks
  if (is_bf16<T> && (!starts || tile < 1 || chunk < 1 || (C >= SIMT_CMAX && C % 8)))
    return cudaErrorInvalidValue;
  if (inf.list)
    weighted_rows_in<T, true>(q, s, x, kp, KP, lpos, ld2, lcnt, lw, act, nq, C, ldw, inf,
                              starts, tile, chunk, wtd, den, st);
  else
    weighted_rows_in<T, false>(q, s, x, kp, KP, lpos, ld2, lcnt, lw, act, nq, C, ldw, inf,
                               starts, tile, chunk, wtd, den, st);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm3: out[z] = sum over k in slice z of A(m, k) B(k, n)
// ---------------------------------------------------------------------------

#define GBK 32       // reduction depth of a shared-memory stage
#define GTHREADS 128 // 4 warps, 2 x 2 over the CTA tile

// A(m, k) = A[m * lda + k] (A_K) or A[k * lda + m]; B(k, n) = B[k * ldb + n]
// (B_N) or, the reduction cut into blocks of kblock (a multiple of V, the
// panel elements in 16 bytes: 4 floats, 8 bf16),
// B[(k / kblock) * kstride + n * ldb + k % kblock] (kblock >= K: plain
// B[n * ldb + k]). The contiguous dimension of each operand is
// read in 16-byte cp.async chunks, double-buffered; a chunk that starts
// inside the matrix must lie inside the allocation (leading dimensions and
// row paddings are multiples of V; K's padding, where a chunk of a
// K-contiguous operand overhangs K, must be zero). Slice z covers the
// reduction indices [z * kc, min((z + 1) * kc, K)), kc a multiple of GBK,
// and writes out + z * zstride (ldc); rows are divided by rowdiv[m] when
// it is given. With row_ptr (nondecreasing, [M + 1]), a tile whose rows
// all have row_ptr[m] == row_ptr[m + 1] holds zero rows of A: it writes
// zeros without reading anything.
template <typename T, int BM, int BN, bool A_K, bool B_N>
__global__ void __launch_bounds__(GTHREADS)
gemm3_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
             int kblock, long long kstride, float* __restrict__ out, int ldc, long long zstride,
             int M, int N, int K, int kc, const float* __restrict__ rowdiv,
             const int* __restrict__ row_ptr) {
  static_assert(!is_bf16<T>, "bf16 panels: gemm_bf16_kernel");
  constexpr int V = 16 / sizeof(T);  // panel elements in a 16-byte chunk
  constexpr int KS = 8;              // reduction depth of one MMA
  // padded shared rows: conflict-free fragments, 16-byte aligned rows
  constexpr int ALD = A_K ? GBK + V : BM + 8;
  constexpr int BLD = B_N ? BN + 8 : GBK + V;
  constexpr int AS = A_K ? BM * ALD : GBK * ALD;
  constexpr int BS = B_N ? GBK * BLD : BN * BLD;
  constexpr int WM = BM / 2, WN = BN / 2, MT = WM / 16, NT = WN / 8;
  __shared__ __align__(16) T As[2][AS];
  __shared__ __align__(16) T Bs[2][BS];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) >> 1, wn = (tid >> 5) & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const bool empty = row_ptr && row_ptr[m0] == row_ptr[min(m0 + BM, M)];
  const int nkt = kend > kbeg && !empty ? (kend - kbeg + GBK - 1) / GBK : 0;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto stage = [&](int kt) {
    const int k0 = kbeg + kt * GBK, buf = kt & 1;
    if (A_K) {
      for (int i = tid; i < BM * (GBK / V); i += GTHREADS) {
        const int m = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gm = m0 + m, gk = k0 + kq;
        const bool v = gm < M && gk < kend;
        cp_async16z(&As[buf][m * ALD + kq], v ? A + (size_t)gm * lda + gk : A, v);
      }
    } else {
      for (int i = tid; i < GBK * (BM / V); i += GTHREADS) {
        const int k = i / (BM / V), mq = (i % (BM / V)) * V;
        const int gm = m0 + mq, gk = k0 + k;
        const bool v = gm < M && gk < kend;
        cp_async16z(&As[buf][k * ALD + mq], v ? A + (size_t)gk * lda + gm : A, v);
      }
    }
    if (B_N) {
      for (int i = tid; i < GBK * (BN / V); i += GTHREADS) {
        const int k = i / (BN / V), nq = (i % (BN / V)) * V;
        const int gn = n0 + nq, gk = k0 + k;
        const bool v = gn < N && gk < kend;
        cp_async16z(&Bs[buf][k * BLD + nq], v ? B + (size_t)gk * ldb + gn : B, v);
      }
    } else {
      for (int i = tid; i < BN * (GBK / V); i += GTHREADS) {
        const int n = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gn = n0 + n, gk = k0 + kq;
        const bool v = gn < N && gk < kend;
        const T* src = B + (size_t)(gk / kblock) * kstride + (size_t)gn * ldb + gk % kblock;
        cp_async16z(&Bs[buf][n * BLD + kq], v ? src : B, v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (nkt > 0) stage(0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      stage(kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const T* as = As[kt & 1];
    const T* bs = Bs[kt & 1];
    // the stage's products in their own accumulators: over a long
    // reduction the truncation of the tensor cores' additions would grow
    float st[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) st[i][j][0] = st[i][j][1] = st[i][j][2] = st[i][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += KS) {
      const int k = kk + t;
      unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * WM + mt * 16 + g;
        float v[4];
        if (A_K) {
          v[0] = as[r * ALD + k];
          v[1] = as[(r + 8) * ALD + k];
          v[2] = as[r * ALD + k + 4];
          v[3] = as[(r + 8) * ALD + k + 4];
        } else {
          v[0] = as[k * ALD + r];
          v[1] = as[k * ALD + r + 8];
          v[2] = as[(k + 4) * ALD + r];
          v[3] = as[(k + 4) * ALD + r + 8];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mt][i], al[mt][i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * WN + nt * 8 + g;
        const float u0 = B_N ? bs[k * BLD + n] : bs[n * BLD + k];
        const float u1 = B_N ? bs[(k + 4) * BLD + n] : bs[n * BLD + k + 4];
        split_tf32(u0, bh[nt][0], bl[nt][0]);
        split_tf32(u1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma3(st[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], st[i][j][e]);
    __syncthreads();
  }

  float* o = out + blockIdx.z * zstride;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      const float d = rowdiv ? rowdiv[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * WN + nt * 8 + 2 * t + e;
          if (col < N) {
            const float v = acc[mt][nt][2 * h + e];
            o[(size_t)row * ldc + col] = rowdiv ? __fdiv_rn(v, d) : v;
          }
        }
      }
    }
  }
}

// out[m][n] = (part[0][m][n] + part[1][m][n] + ...) in slice order, then
// divided by rowdiv[m] when it is given
__global__ void sum_slices_kernel(const float* __restrict__ part, int splits, int M, int N,
                                  float* __restrict__ out, int ldc,
                                  const float* __restrict__ rowdiv) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float v = part[i];
  for (int z = 1; z < splits; ++z) v = __fadd_rn(v, part[(size_t)z * mn + i]);
  const int m = (int)(i / N), n = (int)(i % N);
  out[(size_t)m * ldc + n] = rowdiv ? __fdiv_rn(v, rowdiv[m]) : v;
}

// out [M, N] (ldc) = A B over K, in `splits` slices of kc (partial sums in
// part [splits, M, N] when splits > 1), rows divided by rowdiv if given;
// kblock / kstride (0: one block) and row_ptr as in gemm3_kernel
template <typename T, bool A_K, bool B_N>
static cudaError_t gemm3(const T* A, int lda, const T* B, int ldb, float* out, int ldc,
                         int M, int N, int K, int splits, int kc, float* part,
                         const float* rowdiv, cudaStream_t st, int kblock = 0,
                         long long kstride = 0, const int* row_ptr = nullptr) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits > 1 && !part) return cudaErrorInvalidValue;
  if (kblock <= 0) kblock = K > 0 ? K : 1;
  float* dst = splits > 1 ? part : out;
  const int dld = splits > 1 ? N : ldc;
  const long long zs = (long long)M * N;
  const float* div = splits > 1 ? nullptr : rowdiv;
  if (N <= 32) {
    const dim3 grid((N + 31) / 32, (M + 63) / 64, splits);
    gemm3_kernel<T, 64, 32, A_K, B_N><<<grid, GTHREADS, 0, st>>>(A, lda, B, ldb, kblock,
                                                                 kstride, dst, dld, zs, M, N, K, kc, div,
                                                              row_ptr);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64, splits);
    gemm3_kernel<T, 64, 64, A_K, B_N><<<grid, GTHREADS, 0, st>>>(A, lda, B, ldb, kblock,
                                                                 kstride, dst, dld, zs, M, N, K, kc, div,
                                                              row_ptr);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)M * N;
  sum_slices_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, splits, M, N, out, ldc,
                                                                  rowdiv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm_bf16: out[z] = sum over k in slice z of A(m, k) B(k, n) (+ A2(m, k)
// B(k, n)), bf16 operands, f32 accumulation
// ---------------------------------------------------------------------------

// A(m, k) = A[m * lda + k] (A_K) or A[k * lda + m], B(k, n) = B[k * ldb + n]
// (B_N) or B[n * ldb + k], staged by 16-byte cp.async chunks,
// double-buffered, as in gemm3_kernel (leading dimensions multiples of 8);
// fragments by ldmatrix (.trans where k is not the operand's contiguous
// dimension); each 32-deep stage summed in fresh accumulators (the tensor
// cores' additions truncate) and added to the total in f32
// round-to-nearest. With TWO, a second A operand A2 = A + a2 (the same
// layout: the lo rows of the weighted rows beside their hi rows) shares
// the B stage: a CTA covers MB = BM / 2 output rows, its tile's upper
// half the rows of A and its lower half the same rows of A2, so each
// product has its own accumulators and the epilogue adds the two totals
// (A B + A2 B as two separate products added at the end). One slice
// (gridDim.z == 1) writes out (ldc), rows divided by rowdiv[m] when it is
// given, O = bf16 rounded to nearest; with slices, slice z writes each
// operand's total a to out + (z * NA + a) * zstride (f32, ldc) for
// sum_slices_bf16_kernel.
template <int BM, int BN, bool A_K, bool B_N, bool TWO, typename O>
__global__ void __launch_bounds__(GTHREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, long long a2, int lda, const bf16* __restrict__ B,
                 int ldb, O* __restrict__ out, int ldc, long long zstride, int M, int N, int K,
                 int kc, const float* __restrict__ rowdiv) {
  constexpr int V = 8;  // bf16 in a 16-byte chunk
  constexpr int NA = TWO ? 2 : 1, MB = BM / NA;
  constexpr int ALD = A_K ? GBK + V : BM + 8;  // padded rows: 16-byte aligned, conflict-free
  constexpr int BLD = B_N ? BN + 8 : GBK + V;
  constexpr int AS = A_K ? BM * ALD : GBK * ALD;
  constexpr int BS = B_N ? GBK * BLD : BN * BLD;
  constexpr int WM = BM / 2, WN = BN / 2, MT = WM / 16, NT = WN / 8;
  static_assert(NT % 2 == 0, "B fragments come two n-tiles a load");
  static_assert(!TWO || (MB == WM && MB * BN * 4 <= 2 * AS * 2), "A2's totals pass through As");
  __shared__ __align__(16) bf16 As[2][AS];
  __shared__ __align__(16) bf16 Bs[2][BS];
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = (tid >> 5) >> 1, wn = (tid >> 5) & 1;
  const int m0 = blockIdx.y * MB, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const int nkt = kend > kbeg ? (kend - kbeg + GBK - 1) / GBK : 0;
  // ldmatrix row addresses of the lane: i8 its row within a matrix, the
  // bits of lane >> 3 the matrix
  const int i8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto stage = [&](int kt) {
    const int k0 = kbeg + kt * GBK, buf = kt & 1;
    if (A_K) {
      for (int i = tid; i < BM * (GBK / V); i += GTHREADS) {
        const int m = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gm = m0 + m % MB, gk = k0 + kq;
        const bool v = gm < M && gk < kend;
        const bf16* src = A + (m >= MB ? a2 : 0) + (size_t)gm * lda + gk;
        cp_async16z(&As[buf][m * ALD + kq], v ? src : A, v);
      }
    } else {
      for (int i = tid; i < GBK * (BM / V); i += GTHREADS) {
        const int k = i / (BM / V), mq = (i % (BM / V)) * V;
        const int gm = m0 + mq % MB, gk = k0 + k;
        const bool v = gm < M && gk < kend;
        const bf16* src = A + (mq >= MB ? a2 : 0) + (size_t)gk * lda + gm;
        cp_async16z(&As[buf][k * ALD + mq], v ? src : A, v);
      }
    }
    if (B_N) {
      for (int i = tid; i < GBK * (BN / V); i += GTHREADS) {
        const int k = i / (BN / V), nq = (i % (BN / V)) * V;
        const int gn = n0 + nq, gk = k0 + k;
        const bool v = gn < N && gk < kend;
        cp_async16z(&Bs[buf][k * BLD + nq], v ? B + (size_t)gk * ldb + gn : B, v);
      }
    } else {
      for (int i = tid; i < BN * (GBK / V); i += GTHREADS) {
        const int n = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gn = n0 + n, gk = k0 + kq;
        const bool v = gn < N && gk < kend;
        cp_async16z(&Bs[buf][n * BLD + kq], v ? B + (size_t)gn * ldb + gk : B, v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (nkt > 0) stage(0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      stage(kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const bf16* bs = Bs[kt & 1];
    float st[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) st[i][j][0] = st[i][j][1] = st[i][j][2] = st[i][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      unsigned b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned r[4];
        const int n = wn * WN + nt * 8;
        if (B_N) ldsm_x4_t(r, bs + (kk + i8 + 8 * h1) * BLD + n + 8 * h2);
        else ldsm_x4(r, bs + (n + i8 + 8 * h2) * BLD + kk + 8 * h1);
        b[nt][0] = r[0];
        b[nt][1] = r[1];
        b[nt + 1][0] = r[2];
        b[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned af[4];
        const int m = wm * WM + mt * 16;
        if (A_K) ldsm_x4(af, as + (m + i8 + 8 * h1) * ALD + kk + 8 * h2);
        else ldsm_x4_t(af, as + (kk + i8 + 8 * h2) * ALD + m + 8 * h1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(st[mt][nt], af, b[nt]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], st[i][j][e]);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const bool slices = gridDim.z > 1;
  // with TWO and one slice, the A2 warps (wm = 1) hand their totals to the
  // A warps through shared memory, which add them to theirs
  float* lo = reinterpret_cast<float*>(As);  // [MB][BN]
  if (TWO && !slices) {
    __syncthreads();
    if (wm == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              lo[(mt * 16 + g + 8 * h) * BN + wn * WN + nt * 8 + 2 * t + e] =
                  acc[mt][nt][2 * h + e];
    }
    __syncthreads();
    if (wm == 1) return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = (TWO ? 0 : wm * WM) + mt * 16 + g + 8 * h, row = m0 + rl;
      if (row >= M) continue;
      const float d = rowdiv ? rowdiv[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = wn * WN + nt * 8 + 2 * t + e, col = n0 + cl;
          if (col >= N) continue;
          const size_t o = (size_t)row * ldc + col;
          float v = acc[mt][nt][2 * h + e];
          if (slices) {
            reinterpret_cast<float*>(out)[(blockIdx.z * NA + (TWO ? wm : 0)) * zstride + o] = v;
          } else {
            if (TWO) v = __fadd_rn(v, lo[rl * BN + cl]);
            out[o] = from_f32<O>(rowdiv ? __fdiv_rn(v, d) : v);
          }
        }
      }
    }
  }
}

// out[m][n] = (sum of part[z * NA][m][n] over the slices z, in order) (+
// the same of part[z * NA + 1] with NA = 2), then divided by rowdiv[m]
// when it is given
template <int NA>
__global__ void sum_slices_bf16_kernel(const float* __restrict__ part, int splits, int M, int N,
                                       float* __restrict__ out, int ldc,
                                       const float* __restrict__ rowdiv) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float v = 0.f;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    float s = part[a * mn + i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[(size_t)(z * NA + a) * mn + i]);
    v = a ? __fadd_rn(v, s) : s;
  }
  const int m = (int)(i / N), n = (int)(i % N);
  out[(size_t)m * ldc + n] = rowdiv ? __fdiv_rn(v, rowdiv[m]) : v;
}

// out [M, N] (ldc) = A B (+ A2 B, A2 = A + a2, with TWO) over K, in
// `splits` slices of kc (partial sums in part [splits, NA, M, N] when
// splits > 1; O = bf16 needs one slice), rows divided by rowdiv if given
template <bool A_K, bool B_N, bool TWO, typename O>
static cudaError_t gemm_bf16(const bf16* A, long long a2, int lda, const bf16* B, int ldb, O* out,
                             int ldc, int M, int N, int K, int splits, int kc, float* part,
                             const float* rowdiv, cudaStream_t st) {
  constexpr int NA = TWO ? 2 : 1;
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits > 1 && (!part || is_bf16<O>)) return cudaErrorInvalidValue;
  constexpr int MB = 64 / NA;  // output rows of a CTA (TWO: its tile holds them twice)
  const long long zs = (long long)M * N;
  const dim3 grid64((N + 63) / 64, (M + MB - 1) / MB, splits),
      grid32((N + 31) / 32, (M + MB - 1) / MB, splits);
  if (splits > 1) {  // f32 partial sums [splits, NA, M, N], then their sum
    if (N <= 32)
      gemm_bf16_kernel<64, 32, A_K, B_N, TWO, float><<<grid32, GTHREADS, 0, st>>>(
          A, a2, lda, B, ldb, part, N, zs, M, N, K, kc, nullptr);
    else
      gemm_bf16_kernel<64, 64, A_K, B_N, TWO, float><<<grid64, GTHREADS, 0, st>>>(
          A, a2, lda, B, ldb, part, N, zs, M, N, K, kc, nullptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if constexpr (!is_bf16<O>) {
      const size_t mn = (size_t)M * N;
      sum_slices_bf16_kernel<NA><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          part, splits, M, N, out, ldc, rowdiv);
    }
    return cudaGetLastError();
  }
  if (N <= 32)
    gemm_bf16_kernel<64, 32, A_K, B_N, TWO, O><<<grid32, GTHREADS, 0, st>>>(
        A, a2, lda, B, ldb, out, ldc, zs, M, N, K, kc, rowdiv);
  else
    gemm_bf16_kernel<64, 64, A_K, B_N, TWO, O><<<grid64, GTHREADS, 0, st>>>(
        A, a2, lda, B, ldb, out, ldc, zs, M, N, K, kc, rowdiv);
  return cudaGetLastError();
}

// the bf16 panels of K2, in one launch: blocks [0, row_blocks) write
// xb = bf16(x) row by row and the density flags act[r] = (sum_c xb[r][c] >
// 0) over the rounded values (the sum as in row_active_kernel, as the TPU
// kernel sums its bf16 panel); the blocks after them write Wb = bf16(W)
__global__ void __launch_bounds__(256)
bf16_panels_kernel(const float* __restrict__ x, int ns, int C, bf16* __restrict__ xb,
                   int* __restrict__ act, const float* __restrict__ W, size_t nw,
                   bf16* __restrict__ Wb, unsigned row_blocks) {
  if (blockIdx.x >= row_blocks) {
    const size_t i = (size_t)(blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
    if (i < nw) Wb[i] = __float2bfloat16_rn(W[i]);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= ns) return;
  const float* xr = x + (size_t)r * C;
  bf16* br = xb + (size_t)r * C;
  float part = 0.f;
  for (int c = lane; c < C; c += 32) {
    const bf16 v = __float2bfloat16_rn(xr[c]);
    br[c] = v;
    part = __fadd_rn(part, __bfloat162float(v));
  }
  for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (lane == 0) act[r] = part > 0.f;
}
