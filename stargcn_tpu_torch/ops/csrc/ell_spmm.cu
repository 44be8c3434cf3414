// ell_spmm_fwd_only on Hopper (sm_90a): weighted neighbor pooling over a
// fixed-fanout (ELL) adjacency.
//
//   out[i, :] = sum_k w[i, k] * values[idx[i, k], :]
//
// values is (num_src, F) f32, idx (num_dst, K) int32, w (num_dst, K) f32
// with 0 on padded slots, out (num_dst, F) f32.  All f32, summed in f32 in
// slot order; nothing is rounded.  A slot whose weight is 0 or whose index
// lies outside [0, num_src) contributes nothing and its row is never read.
//
// Replaces: stargcn_tpu/ops/pallas_kernels.py:_spmm_kernel
// (ell_spmm_fwd_only, with _multi_hot).  The TPU has no fast gather, so
// that kernel walks every source chunk for every destination tile, builds
// a (BD, BS) weighted incidence tile from the indices and multiplies it
// with the value chunk on the matrix unit.  Here it is what it computes: a
// row gather.
//
// Bound on the H100: bytes.  Each live slot needs one source row of 4F
// bytes (1000 bytes at the main path's F = 250), each output row is written
// once; the arithmetic is one fma per byte quarter, far below the memory
// time.  Rows that several destinations share come from L2 after the first
// read, so the least the card must move is the distinct rows referenced,
// the indices and weights, and the output.
//
// Design: one warp per destination row, the row's columns laid over the
// lanes as ell_row.cuh describes, a loop over the K slots with the sums in
// registers.  Every lane reads the slot's index and weight (one broadcast
// load each).  Each output row has one owner and is written once: no
// atomics, the same bits on every run.  Offsets into values and out are
// size_t: 10 * 90k source rows of 250 floats pass 2^31 bytes.

#include "ell_row.cuh"

namespace {

using namespace ellrow;

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const float* __restrict__ values,
                const int* __restrict__ idx, const float* __restrict__ w,
                float* __restrict__ out, int num_dst, int k, int num_src,
                int f) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= num_dst) return;
  const int* irow = idx + row * k;
  const float* wrow = w + row * k;
  float* orow = out + static_cast<size_t>(row) * f;
  for (int c0 = 0; c0 < f; c0 += 32 * V * kUnroll) {
    float acc[kUnroll][V] = {};
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      const float ws = __ldg(wrow + s);
      const int src = __ldg(irow + s);
      if (ws == 0.0f || src < 0 || src >= num_src) continue;
      axpy_row<V>(acc, ws, values + static_cast<size_t>(src) * f, c0, f,
                  lane);
    }
    store_row<V>(acc, orow, c0, f, lane);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked the
// shapes and types, that num_dst, k, num_src and f are positive ints, and
// that values and out are aligned to the vector load.  Returns
// cudaGetLastError() after the launch.
extern "C" int ell_spmm_launch(const void* values, const void* idx,
                               const void* w, void* out, int num_dst, int k,
                               int num_src, int f, void* stream) {
  const float* v = static_cast<const float*>(values);
  const int* i = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_blocks(num_dst)), block(kWarps * 32);
  switch (pick_vec(f)) {
    case 4:
      ell_spmm_kernel<4><<<grid, block, 0, st>>>(v, i, ww, o, num_dst, k,
                                                 num_src, f);
      break;
    case 2:
      ell_spmm_kernel<2><<<grid, block, 0, st>>>(v, i, ww, o, num_dst, k,
                                                 num_src, f);
      break;
    default:
      ell_spmm_kernel<1><<<grid, block, 0, st>>>(v, i, ww, o, num_dst, k,
                                                 num_src, f);
  }
  return static_cast<int>(cudaGetLastError());
}
