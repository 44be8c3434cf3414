// bit_reduce_matmul on Hopper (sm_90a): contract a bit-packed multi-link
// adjacency with a per-rating cotangent table, the rating axis folded into
// the sum.  It is the backward of bit_expand_matmul through bit_pool_rated.
//
//   out[b, m, f] = sum_{r, s} bit_b(P[r*d8 + m, s]) * bf16(g[r, s, f])
//
// P is (R*d8, S_pad) uint8, the transpose layout of the forward's pack.
// g is (R, S_pad, F), f32 or bf16, addressed through its two row strides
// (the inner dimension is contiguous), so the (S_pad, R, F) cotangent that
// autograd hands over is read in place as a permuted view; it is rounded to
// bf16 and summed in f32.  out is (8, d8, F) f32.
//
// Replaces: stargcn_tpu/ops/bitdense.py:_k2_kernel (bit_reduce_matmul).
// That kernel folds the rating axis into a sequential grid dimension and
// carries one accumulator across its steps; blocks on this card run in no
// order, so here the owner of an output row loops over the R packed rows
// r*d8 + m itself.
//
// Bound on the H100: P, g and out moved once.  At ML-10M width (R=10, F=65)
// the gradient for the items reads P (14080 x 70656, 0.995 GB) and g
// (10 x 70656 x 65 f32, 184 MB) and writes 3 MB, about 0.35 ms at
// 3.35 TB/s; the gradient for the users reads 0.995 GB + 29 MB and writes
// 18 MB, about 0.31 ms.  The arithmetic the data needs is one F-wide add
// per set bit (about 1e7 per pack), far below the memory time.
//
// Design: a block of 16 warps owns 16/splits output rows m with all eight
// bit planes and every column of one feature tile.  The `splits` warps of a
// row share the R * ceil(S_pad/512) steps of its R packed rows, interleaved,
// and add their partial sums in a fixed order through shared memory: nothing
// crosses blocks, no atomics, the same result on every run.  The item
// gradient has only 1408 output rows, each folding ten packed rows of 70656
// bytes in which the popular items' set bits sit, so it takes 16 warps per
// row; the user gradient (8832 rows of ten short packed rows) takes fewer
// (bit_walk.cuh:pick_splits).  The walk of a step is bit_walk.cuh:walk_step,
// shared with bit_expand.cu.  Offsets into P and g are computed in size_t
// (they pass 2^31 at this size).  Columns past F (F=65 is odd, so g rows are
// not 16-byte aligned and are read per lane) are masked; a grid dimension
// tiles F above 256.

#include "bit_walk.cuh"

namespace {

using bitwalk::kColTile;
using bitwalk::kMaxK;

constexpr int kWarps = 16;         // warps per block

// kSplit: whether splits > 1 (see bit_expand.cu).
template <typename T, int K, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
bit_reduce_kernel(const uint8_t* __restrict__ P, const T* __restrict__ g,
                  float* __restrict__ out, int num_links, int s_pad, int f,
                  int d8, long long g_stride_r, long long g_stride_s,
                  int splits) {
  __shared__ float red[kSplit ? kWarps : 1][kMaxK][32];
  if (!kSplit) splits = 1;  // a constant for the compiler
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % splits;
  const int m = blockIdx.x * (kWarps / splits) + warp / splits;
  const bool live = m < d8;  // no early return: the block syncs below
  const int col0 = blockIdx.y * kColTile + lane;

  float acc[8][K];
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[b][k] = 0.f;

  const int n16 = s_pad >> 4;
  const int steps_per_row = (n16 + 31) >> 5;
  const int steps = live ? num_links * steps_per_row : 0;
  for (int t = part; t < steps; t += splits) {
    const int r = t / steps_per_row;
    const int base = (t - r * steps_per_row) << 5;
    const uint4* prow = reinterpret_cast<const uint4*>(
        P + (static_cast<size_t>(r) * d8 + m) * s_pad);
    bitwalk::walk_step<T, K>(prow, n16, base, lane,
                             g + static_cast<size_t>(r) * g_stride_r,
                             static_cast<size_t>(g_stride_s), col0, f, acc);
  }

  bitwalk::reduce_store<K, kSplit, kWarps>(
      acc, red, warp, part, splits, lane, live, col0, f,
      out + static_cast<size_t>(live ? m : 0) * f,
      static_cast<size_t>(d8) * f);
}

template <typename T>
void launch(const uint8_t* P, const T* g, float* out, int num_links,
            int s_pad, int f, int d8, long long g_stride_r,
            long long g_stride_s, cudaStream_t stream) {
  const long long steps =
      static_cast<long long>(num_links) * (((s_pad >> 4) + 31) >> 5);
  const int splits = bitwalk::pick_splits(d8, steps, kWarps);
  const int rows_per_block = kWarps / splits;
  const dim3 grid((d8 + rows_per_block - 1) / rows_per_block,
                  (f + kColTile - 1) / kColTile);
  const dim3 block(kWarps * 32);
  int k = (f + 31) / 32;
  if (k > kMaxK) k = kMaxK;
  switch (k) {
#define BIT_REDUCE_CASE(K)                                                \
  case K:                                                                 \
    if (splits > 1)                                                       \
      bit_reduce_kernel<T, K, true><<<grid, block, 0, stream>>>(          \
          P, g, out, num_links, s_pad, f, d8, g_stride_r, g_stride_s,     \
          splits);                                                        \
    else                                                                  \
      bit_reduce_kernel<T, K, false><<<grid, block, 0, stream>>>(         \
          P, g, out, num_links, s_pad, f, d8, g_stride_r, g_stride_s, 1); \
    break;
    BIT_REDUCE_CASE(1)
    BIT_REDUCE_CASE(2)
    BIT_REDUCE_CASE(3)
    BIT_REDUCE_CASE(4)
    BIT_REDUCE_CASE(5)
    BIT_REDUCE_CASE(6)
    BIT_REDUCE_CASE(7)
    BIT_REDUCE_CASE(8)
#undef BIT_REDUCE_CASE
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked that P
// rows are 16-byte aligned (s_pad % 16 == 0, P 16-byte aligned), that
// num_links, d8 and f are positive, that g is f32 (g_is_bf16 = 0) or bf16
// (1) with a contiguous inner dimension, and gives g's strides over r and
// s in elements.  Returns cudaGetLastError() after the launch.
extern "C" int bit_reduce_matmul_launch(const void* P, const void* g,
                                        int g_is_bf16, void* out,
                                        int num_links, int s_pad, int f,
                                        int d8, long long g_stride_r,
                                        long long g_stride_s, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(P);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    launch(p, static_cast<const __nv_bfloat16*>(g), o, num_links, s_pad, f,
           d8, g_stride_r, g_stride_s, st);
  } else {
    launch(p, static_cast<const float*>(g), o, num_links, s_pad, f, d8,
           g_stride_r, g_stride_s, st);
  }
  return static_cast<int>(cudaGetLastError());
}
