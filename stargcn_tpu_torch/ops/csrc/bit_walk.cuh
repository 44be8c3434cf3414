// Device code shared by the bit-packed adjacency kernels (bit_expand.cu,
// bit_reduce.cu): the walk over one 512-byte step of a packed row, the
// fixed-order reduction of the warps that share an output row, and the
// choice of how many warps share one.
//
// A packed row is a string of bytes; bit b of byte s says that the b-th of
// the row's eight destinations has an edge from source s.  A warp loads 32
// consecutive 16-byte pieces (coalesced, evict-first so the streamed pack
// does not push the feature rows out of L2), a ballot finds the lanes that
// hold a non-zero byte, and each such lane's 16 bytes are broadcast.  For
// every non-zero byte the bf16-rounded source row is read once and added
// into the eight per-bit f32 accumulators its set bits select.  Lane l keeps
// columns l, l+32, ... of all eight accumulators in registers (unrolled, so
// no local memory); columns past F are masked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitwalk {

constexpr int kColTile = 256;      // feature columns per grid.y tile
constexpr int kMaxK = kColTile / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Pieces [base, base+32) of the packed row `prow` (n16 pieces of 16 bytes):
// acc[b][k] += bf16(src[s * row_stride + col0 + 32k]) for every set bit b of
// byte s.  All 32 lanes of the warp call it together.
template <typename T, int K>
__device__ __forceinline__ void walk_step(const uint4* prow, int n16, int base,
                                          int lane, const T* src,
                                          size_t row_stride, int col0, int f,
                                          float (&acc)[8][K]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (base + lane < n16) v = __ldcs(prow + base + lane);
  unsigned lanes = __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
  while (lanes) {
    const int from = __ffs(lanes) - 1;
    lanes &= lanes - 1u;
    uint32_t words[4];
    words[0] = __shfl_sync(0xffffffffu, v.x, from);
    words[1] = __shfl_sync(0xffffffffu, v.y, from);
    words[2] = __shfl_sync(0xffffffffu, v.z, from);
    words[3] = __shfl_sync(0xffffffffu, v.w, from);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t w = words[j];
      while (w) {
        const int p = (__ffs(w) - 1) >> 3;  // lowest non-zero byte
        const uint32_t byte = (w >> (8 * p)) & 0xffu;
        w &= ~(0xffu << (8 * p));
        const int s = ((base + from) << 4) + (j << 2) + p;
        const T* row = src + static_cast<size_t>(s) * row_stride;
        float xv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = col0 + 32 * k;
          xv[k] = c < f ? bf16_round(__ldg(row + c)) : 0.f;
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (byte & (1u << b)) {
#pragma unroll
            for (int k = 0; k < K; ++k) acc[b][k] += xv[k];
          }
        }
      }
    }
  }
}

// The `splits` consecutive warps that share an output row add their partial
// sums in a fixed order through shared memory (part 0 adds parts 1, 2, ...),
// and part 0 writes bit plane b to out0 + b * plane_stride.  Every warp of
// the block calls it (it synchronises the block), live or not.
template <int K, bool kSplit, int kWarps>
__device__ __forceinline__ void reduce_store(float (&acc)[8][K],
                                             float (*red)[kMaxK][32], int warp,
                                             int part, int splits, int lane,
                                             bool live, int col0, int f,
                                             float* out0,
                                             size_t plane_stride) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if constexpr (kSplit) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[warp][k][lane] = acc[b][k];
      __syncthreads();
      if (part == 0) {
        for (int q = 1; q < splits; ++q)
#pragma unroll
          for (int k = 0; k < K; ++k) acc[b][k] += red[warp + q][k][lane];
      }
      __syncthreads();
    }
    if (live && part == 0) {
      float* orow = out0 + b * plane_stride;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = col0 + 32 * k;
        if (c < f) orow[c] = acc[b][k];
      }
    }
  }
}

// Warps per output row (a power of two up to max_splits): it grows while the
// card would still hold fewer than ~8 waves of warps and each warp keeps at
// least 4 steps.  Few long rows need the extra warps to keep enough loads in
// flight; many short rows do not.
inline int pick_splits(long long rows, long long steps, int max_splits) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long resident_warps = static_cast<long long>(sms) * 64;
  int splits = 1;
  while (splits < max_splits && rows * splits * 2 <= 8 * resident_warps &&
         steps >= static_cast<long long>(splits) * 2 * 4)
    splits *= 2;
  return splits;
}

}  // namespace bitwalk
