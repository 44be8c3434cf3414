// Shared device code of the three ELL kernels (ell_spmm.cu, ell_sddmm.cu,
// ell_spmm_t.cu): how a warp lays a feature row over its lanes.
//
// One warp owns one output row.  A pass covers 32 * V * kUnroll columns:
// lane l holds, for j in [0, kUnroll), the V neighbouring columns that
// start at c0 + (j * 32 + l) * V, so that the 32 lanes of a warp read 32 * V
// neighbouring floats with one vector load each.  V (4, 2 or 1 floats per
// load) is the largest of those that divides the feature width F, which
// keeps every row start aligned to the load (rows are F * 4 bytes apart and
// the base pointers are aligned to V * 4 bytes; the wrappers check that).
// At the main path's F = 250 that is V = 2 and one pass of 256 columns with
// the last three lane slots masked; F = 65 takes V = 1.  Wider rows take
// more passes over the same slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ellrow {

constexpr int kWarps = 8;   // warps (= rows) per block
constexpr int kUnroll = 4;  // column groups per lane per pass

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// acc += w * row over this lane's columns of the pass that starts at c0.
template <int V>
__device__ __forceinline__ void axpy_row(float (&acc)[kUnroll][V], float w,
                                         const float* __restrict__ row,
                                         int c0, int f, int lane) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int c = c0 + (j * 32 + lane) * V;
    if (c < f) {  // F % V == 0, so c < f means c + V <= f
      float t[V];
      load_vec<V>(row + c, t);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = fmaf(w, t[v], acc[j][v]);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_row(const float (&acc)[kUnroll][V],
                                          float* __restrict__ row, int c0,
                                          int f, int lane) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int c = c0 + (j * 32 + lane) * V;
    if (c < f) store_vec<V>(row + c, acc[j]);
  }
}

inline int pick_vec(int f) { return f % 4 == 0 ? 4 : (f % 2 == 0 ? 2 : 1); }

inline unsigned row_blocks(long long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

}  // namespace ellrow
