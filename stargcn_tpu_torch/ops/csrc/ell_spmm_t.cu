// ell_spmm_transpose on Hopper (sm_90a): the scatter adjoint of ell_spmm.
//
//   out[s, :] = sum over slots (i, k) with idx[i, k] == s of w[i, k] * g[i, :]
//
// g is (num_dst, F) f32 (the cotangent), out (num_src, F) f32.  The
// wrapper (ops/ell_kernels.py:ell_spmm_transpose) orders the live slots by
// source index first, a stable sort, and hands over the run of every source
// row: seg_ptr (num_src + 1) int32, and per sorted slot its destination
// row (dst_sorted, int32) and weight (w_sorted, f32).  Slots whose weight is
// 0 or whose index lies outside [0, num_src) are in no run.  All f32,
// summed in f32; nothing is rounded.
//
// Replaces: stargcn_tpu/ops/pallas_kernels.py:_spmm_t_kernel
// (ell_spmm_transpose).  The TPU has no fast scatter or atomics, so that
// kernel rebuilds the weighted incidence tile for every (source chunk,
// destination tile) pair and multiplies its transpose with the cotangent
// tile on the matrix unit, carrying the sum over sequential grid steps.
//
// Bound on the H100: bytes.  Every output row is written once (most of
// them zeros: the main path has ten source rows per frontier node and a few
// live slots), every live slot reads one cotangent row of 4F bytes (the
// distinct ones from HBM, repeats from L2), plus the sorted slot arrays.
//
// Design: one warp per source row sums its run in sorted order, which is
// ascending slot order, with the sums in registers, and writes the row
// (zeros for an empty run).  One owner per output row, no atomics: the same
// bits on every run, unlike a scatter with atomicAdd.  A source row that
// very many slots share (a popular item under a wide user frontier) is one
// warp's serial loop; its length bounds the kernel's time when the rest of
// the grid has drained.  Offsets into g and out are size_t.

#include "ell_row.cuh"

namespace {

using namespace ellrow;

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_t_kernel(const float* __restrict__ g,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ dst_sorted,
                  const float* __restrict__ w_sorted,
                  float* __restrict__ out, int num_src, int f) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= num_src) return;
  const int beg = __ldg(seg_ptr + row);
  const int end = __ldg(seg_ptr + row + 1);
  float* orow = out + static_cast<size_t>(row) * f;
  for (int c0 = 0; c0 < f; c0 += 32 * V * kUnroll) {
    float acc[kUnroll][V] = {};
#pragma unroll 4
    for (int p = beg; p < end; ++p) {
      const int i = __ldg(dst_sorted + p);
      const float ws = __ldg(w_sorted + p);
      axpy_row<V>(acc, ws, g + static_cast<size_t>(i) * f, c0, f, lane);
    }
    store_row<V>(acc, orow, c0, f, lane);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked the
// shapes and types, that num_src and f are positive ints, that seg_ptr is
// non-decreasing with every dst_sorted entry a row of g, and that g and out
// are aligned to the vector load.  Returns cudaGetLastError() after the
// launch.
extern "C" int ell_spmm_t_launch(const void* g, const void* seg_ptr,
                                 const void* dst_sorted,
                                 const void* w_sorted, void* out,
                                 int num_src, int f, void* stream) {
  const float* gg = static_cast<const float*>(g);
  const int* sp = static_cast<const int*>(seg_ptr);
  const int* ds = static_cast<const int*>(dst_sorted);
  const float* ws = static_cast<const float*>(w_sorted);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_blocks(num_src)), block(kWarps * 32);
  switch (pick_vec(f)) {
    case 4:
      ell_spmm_t_kernel<4><<<grid, block, 0, st>>>(gg, sp, ds, ws, o,
                                                   num_src, f);
      break;
    case 2:
      ell_spmm_t_kernel<2><<<grid, block, 0, st>>>(gg, sp, ds, ws, o,
                                                   num_src, f);
      break;
    default:
      ell_spmm_t_kernel<1><<<grid, block, 0, st>>>(gg, sp, ds, ws, o,
                                                   num_src, f);
  }
  return static_cast<int>(cudaGetLastError());
}
