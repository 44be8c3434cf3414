// ell_sddmm on Hopper (sm_90a): one inner product per slot of a
// fixed-fanout (ELL) adjacency.
//
//   out[i, k] = dot(q[i, :], values[idx[i, k], :])
//
// q is (num_dst, F) f32, values (num_src, F) f32, idx (num_dst, K) int32,
// out (num_dst, K) f32.  Every slot is computed, padded ones too (the
// weights are not an input); a slot whose index lies outside [0, num_src)
// gives 0 and reads nothing.  All f32, summed in f32; nothing is rounded.
//
// Replaces: stargcn_tpu/ops/pallas_kernels.py:_sddmm_kernel (ell_sddmm).
// That kernel multiplies every destination tile with every source chunk on
// the matrix unit (G = q @ vals^T) and then picks each slot's score out of
// G with K select-and-reduce passes, because the TPU has no fast gather.
// Here each slot's source row is gathered and reduced directly.  It is the
// gradient of ell_spmm for the slot weights, and the forward of
// seg_take_k_corr_pallas.
//
// Bound on the H100: bytes.  num_dst * K source rows of 4F bytes (the
// distinct ones from HBM, repeats from L2), q once, out once; two
// operations per byte quarter.
//
// Design: one warp per destination row.  The row's slice of q for the
// current pass stays in registers across the K slots; per slot the lanes
// multiply their columns of the gathered row, the partial sums are added
// over the warp with shuffles in a fixed order, and lane 0 writes the slot
// (adds to it on later passes, when F is wider than one pass).  One owner
// per output, no atomics, the same bits on every run.

#include "ell_row.cuh"

namespace {

using namespace ellrow;

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
ell_sddmm_kernel(const float* __restrict__ q,
                 const float* __restrict__ values,
                 const int* __restrict__ idx, float* __restrict__ out,
                 int num_dst, int k, int num_src, int f) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= num_dst) return;
  const int* irow = idx + row * k;
  float* orow = out + row * k;
  const float* qrow = q + static_cast<size_t>(row) * f;
  for (int c0 = 0; c0 < f; c0 += 32 * V * kUnroll) {
    float qreg[kUnroll][V] = {};
    axpy_row<V>(qreg, 1.0f, qrow, c0, f, lane);  // 1 * q + 0: q itself
    for (int s = 0; s < k; ++s) {
      const int src = __ldg(irow + s);
      float dot = 0.0f;
      if (src >= 0 && src < num_src) {  // the same for the whole warp
        const float* vrow = values + static_cast<size_t>(src) * f;
        float part[kUnroll] = {};
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int c = c0 + (j * 32 + lane) * V;
          if (c < f) {
            float t[V];
            load_vec<V>(vrow + c, t);
#pragma unroll
            for (int v = 0; v < V; ++v)
              part[j] = fmaf(qreg[j][v], t[v], part[j]);
          }
        }
        dot = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, d);
      }
      if (lane == 0) orow[s] = (c0 == 0) ? dot : orow[s] + dot;
    }
  }
}

}  // namespace

static_assert(ellrow::kUnroll == 4, "the partial sums are added as 2 + 2");

// Plain C entry point (loaded with ctypes).  The caller has checked the
// shapes and types, that num_dst, k, num_src and f are positive ints, and
// that q and values are aligned to the vector load.  Returns
// cudaGetLastError() after the launch.
extern "C" int ell_sddmm_launch(const void* q, const void* values,
                                const void* idx, void* out, int num_dst,
                                int k, int num_src, int f, void* stream) {
  const float* qq = static_cast<const float*>(q);
  const float* v = static_cast<const float*>(values);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_blocks(num_dst)), block(kWarps * 32);
  switch (pick_vec(f)) {
    case 4:
      ell_sddmm_kernel<4><<<grid, block, 0, st>>>(qq, v, i, o, num_dst, k,
                                                  num_src, f);
      break;
    case 2:
      ell_sddmm_kernel<2><<<grid, block, 0, st>>>(qq, v, i, o, num_dst, k,
                                                  num_src, f);
      break;
    default:
      ell_sddmm_kernel<1><<<grid, block, 0, st>>>(qq, v, i, o, num_dst, k,
                                                  num_src, f);
  }
  return static_cast<int>(cudaGetLastError());
}
