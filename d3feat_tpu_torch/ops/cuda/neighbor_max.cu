// K7: the neighbourhood max, float32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes the max over a neighbour
// list in XLA (d3feat_tpu/models/blocks.py's max pool of the strided blocks'
// shortcut and of the max_pool block, and the detector's local-max gate in
// d3feat_tpu/models/kpfcnn.py), and the port's twin
// (ops/neighbor_max.py::neighbor_max_plain) gathers the [Q, K, C] rows into
// device memory, then reduces them. Here, for each query q with list
// inds[q][0, K):
//     out[q][c] = max over k of x[inds[q][k]][c]
// where index S (the shadow: any index outside [0, S)) reads a zero row,
// so a shadow entry takes part in the max as +0.0. The comparison is
// torch.amax's: a NaN wins, else the larger. Every result is one of its
// inputs, so it equals the twin's bit for bit, up to the sign of a zero
// where +0.0 and -0.0 meet (equal under IEEE comparison).
//
// Bound: device memory. Each listed entry reads one row of C floats and does
// one comparison a float, so the kernel moves bytes and computes nearly
// nothing. The least traffic is the unique rows (4 S C bytes), the lists
// (4 Q K) and the output (4 Q C); a row listed by many queries is read again
// by each, from L2 where the band route's spatially sorted order gives
// neighbouring queries (neighbouring warps) the same rows.
//
// Design: one warp a (query, channel slice); the warps of a CTA take
// consecutive queries. A lane group of L lanes reads one row: lane l holds
// channels (l + L i) VEC of the slice, i < CPL, as 16-byte loads where C is a
// multiple of 4 and x and out are 16-byte aligned (VEC 4), else one float
// (VEC 1). The warp's R = 32 / L groups read R rows at once (narrow rows:
// the gate's 32 channels take 8 lanes a row). The warp loads 32 list entries
// with one coalesced load, one a lane, and broadcasts each by shuffle; U
// steps of R rows are loaded before their maxima, so each lane keeps U CPL
// loads in flight. A shadow entry is a load predicated off that yields +0.0:
// a list that is all shadow (a padding row) loads nothing and writes 0. At
// the end the groups' maxima meet in an xor butterfly and group 0 writes its
// slice. No shared memory, no atomics: one order, so the result is
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8  // warps a CTA, one (query, slice) each
#define FULL 0xffffffffu

// torch.amax's comparison: a NaN wins, else the larger
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float neg_inf() { return __int_as_float((int)0xff800000u); }

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldg(p);
  }
}

// VEC floats a load; L lanes a row; CPL loads a lane a row; U steps in flight
template <int VEC, int L, int CPL, int U>
__global__ void __launch_bounds__(WARPS * 32)
neighbor_max_kernel(const float* __restrict__ x, int S, int C, const int* __restrict__ inds,
                    int Q, int K, int slices, float* __restrict__ out) {
  constexpr int R = 32 / L;  // rows read at once, one a lane group
  static_assert(32 % (R * U) == 0, "a step of R U entries divides a load of 32");
  const int lane = threadIdx.x & 31, g = lane / L, l = lane % L;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)Q * slices) return;  // the whole warp leaves together
  const int q = (int)(w / slices), s = (int)(w % slices);
  const int* row = inds + (size_t)q * K;

  int col[CPL];
  bool on[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    col[i] = ((s * CPL + i) * L + l) * VEC;
    on[i] = col[i] < C;
  }
  float acc[CPL][VEC];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = neg_inf();

  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    const int mine = lane < n ? __ldg(row + k0 + lane) : 0;
    for (int j = 0; j < n; j += R * U) {
      float v[U][CPL][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = j + u * R + g;  // < 32: j is a multiple of R U, which divides 32
        const int idx = __shfl_sync(FULL, mine, src);
        const bool listed = src < n;
        const bool real = listed && idx >= 0 && idx < S;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          if (real && on[i]) {
            load_row<VEC>(x + (size_t)idx * C + col[i], v[u][i]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              v[u][i][e] = listed ? 0.f : neg_inf();  // the shadow +0; no entry
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < CPL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = max_nan(acc[i][e], v[u][i][e]);
    }
  }

  // the R groups' maxima: every group holds the same channels
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i][e] = max_nan(acc[i][e], __shfl_xor_sync(FULL, acc[i][e], o));
  if (g != 0) return;
  float* dst = out + (size_t)q * C;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (!on[i]) continue;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst + col[i]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      dst[col[i]] = acc[i][0];
    }
  }
}

template <int VEC, int L, int CPL, int U>
static int launch(const void* x, int S, int C, const void* inds, int Q, int K, void* out,
                  cudaStream_t st) {
  const int per_slice = L * CPL * VEC;  // channels a warp
  const int slices = (C + per_slice - 1) / per_slice;
  const long long warps = (long long)Q * slices;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  neighbor_max_kernel<VEC, L, CPL, U><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
      (const float*)x, S, C, (const int*)inds, Q, K, slices, (float*)out);
  return (int)cudaGetLastError();
}

// x [S, C] float32, inds [Q, K] int32 (S, or any index outside [0, S): the
// shadow, a zero row), out [Q, C] float32; all contiguous on the device
extern "C" int neighbor_max_launch(const void* x, int S, int C, const void* inds, int Q, int K,
                                   void* out, void* stream) {
  if (S < 0 || C < 1 || Q < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = C % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (!vec) {
    if (C <= 32) return launch<1, 32, 1, 4>(x, S, C, inds, Q, K, out, st);
    return launch<1, 32, 4, 2>(x, S, C, inds, Q, K, out, st);
  }
  const int nv = C / 4;  // 16-byte vectors a row
  if (nv <= 8) return launch<4, 8, 1, 4>(x, S, C, inds, Q, K, out, st);
  if (nv <= 16) return launch<4, 16, 1, 4>(x, S, C, inds, Q, K, out, st);
  if (nv <= 32) return launch<4, 32, 1, 4>(x, S, C, inds, Q, K, out, st);
  if (nv <= 64) return launch<4, 32, 2, 4>(x, S, C, inds, Q, K, out, st);
  return launch<4, 32, 4, 2>(x, S, C, inds, Q, K, out, st);  // 512 channels a slice
}
