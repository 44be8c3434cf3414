// bit_expand_matmul and bit_expand_matmul16 on Hopper (sm_90a): expand a
// bit-packed multi-link adjacency against a feature table.
//
//   out[r, b, m, f] = sum_s bit_b(P[r*d8 + phys(m), s]) * bf16(x[s, f])
//
// P is (R*d8, S_pad) uint8; bit b of packed row r*d8+phys(m), column s, is
// set iff destination b*d8+m has an edge with rating level r from source s.
// phys is the identity for a natural pack (ril = 0) and the row map of
// bit_walk.cuh:physical_row for a pack built with row_interleave = ril
// (ril = 128 for KERNEL.BIT_IMPL: pallas16).  x is (S_pad, F), f32 or bf16;
// it is rounded to bf16 and summed in f32.  out is (R, 8, d8, F) f32 in
// natural order, the layout of the TPU kernels' output.
//
// Replaces: stargcn_tpu/ops/bitdense.py:_k1_kernel (bit_expand_matmul) and,
// with ril = 128, _k1_kernel16 (bit_expand_matmul16).  The first unpacks all
// eight bit planes of a (bm, bs) block into bf16 and feeds the matrix unit,
// carrying the sum across sequential grid steps over S.  The second
// bitcasts the u8 block to u16 so that one VPU lane holds two packed rows
// (the TPU pairs adjacent sublanes) and halves the unpack work; the pack's
// rows are interleaved so that the (plane, half) order of its accumulator is
// the natural order.  That pairing is a device of the TPU's vector unit with
// no counterpart here: the walk below never reads the pack as u16, it only
// sends each physical row's sums to the natural row the interleave put
// there, so both routes give the same bits from the same edges.
//
// Bound on the H100: the packed operand has to be read once.  At ML-10M
// width (R=10, F=65) the user direction reads P (88320 x 11264, 0.995 GB)
// and writes 184 MB, about 0.35 ms at 3.35 TB/s; the item direction reads
// 0.995 GB and writes 29 MB, about 0.31 ms.  The arithmetic the data
// needs is one F-wide add per set bit (about 1e7 set bits per pack, 0.93%
// of the bytes non-zero), far below the memory time.  A dense bf16
// tensor-core expansion would be ~1.03e12 FLOP per launch, ~1.05 ms at
// 989 TFLOP/s, so the kernel skips zero bytes instead of expanding them.
// The 16-bit route has the same bound: its row map moves no byte and adds
// two integer operations per packed row.
//
// Design: a block of 8 warps owns 8/splits packed rows and every column of
// one feature tile; the `splits` warps of a row walk interleaved 512-byte
// steps of S, and their partial sums are added in a fixed order through
// shared memory.  No two blocks write the same output and no atomics are
// used, so the result does not depend on scheduling.  `splits` (1, 2, 4 or
// 8, see bit_walk.cuh:pick_splits) grows for the item direction (14080 rows
// of 70656 bytes), which needs the extra warps to keep enough loads in
// flight; the user direction (88320 short rows) stays at one warp per row.
// The walk itself (coalesced 16-byte loads, a ballot to skip zero bytes, one
// bf16-rounded source row read per non-zero byte, per-bit f32 accumulators
// in registers) is bit_walk.cuh:walk_step, shared with bit_reduce.cu.  A
// dense P is still exact, only slower.  Columns past F (F=65 is odd) are
// masked.

#include "bit_walk.cuh"

namespace {

using bitwalk::kColTile;
using bitwalk::kMaxK;

constexpr int kWarps = 8;          // warps per block

// kSplit: whether splits > 1.  The reduction costs registers, so the
// unsplit instances leave it out and keep more warps resident.
template <typename T, int K, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
bit_expand_kernel(const uint8_t* __restrict__ P, const T* __restrict__ x,
                  float* __restrict__ out, int m8, int s_pad, int f,
                  int d8, int ril, int splits) {
  __shared__ float red[kSplit ? kWarps : 1][kMaxK][32];
  if (!kSplit) splits = 1;  // a constant for the compiler
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % splits;
  const int row = blockIdx.x * (kWarps / splits) + warp / splits;
  const bool live = row < m8;  // no early return: the block syncs below
  const int col0 = blockIdx.y * kColTile + lane;

  float acc[8][K];
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[b][k] = 0.f;

  const uint4* prow = reinterpret_cast<const uint4*>(
      P + static_cast<size_t>(live ? row : 0) * s_pad);
  const int n16 = live ? (s_pad >> 4) : 0;
  for (int base = part * 32; base < n16; base += splits * 32)
    bitwalk::walk_step<T, K>(prow, n16, base, lane, x,
                             static_cast<size_t>(f), col0, f, acc);

  const int r = row / d8;
  const int m = bitwalk::natural_row(row - r * d8, ril);
  bitwalk::reduce_store<K, kSplit, kWarps>(
      acc, red, warp, part, splits, lane, live, col0, f,
      out + (static_cast<size_t>(r) * 8 * d8 + m) * f,
      static_cast<size_t>(d8) * f);
}

template <typename T>
void launch(const uint8_t* P, const T* x, float* out, int m8, int s_pad,
            int f, int d8, int ril, cudaStream_t stream) {
  const int splits = bitwalk::pick_splits(m8, (s_pad >> 4) / 32, kWarps);
  const int rows_per_block = kWarps / splits;
  const dim3 grid((m8 + rows_per_block - 1) / rows_per_block,
                  (f + kColTile - 1) / kColTile);
  const dim3 block(kWarps * 32);
  int k = (f + 31) / 32;
  if (k > kMaxK) k = kMaxK;
  switch (k) {
#define BIT_EXPAND_CASE(K)                                                \
  case K:                                                                 \
    if (splits > 1)                                                       \
      bit_expand_kernel<T, K, true><<<grid, block, 0, stream>>>(          \
          P, x, out, m8, s_pad, f, d8, ril, splits);                      \
    else                                                                  \
      bit_expand_kernel<T, K, false><<<grid, block, 0, stream>>>(         \
          P, x, out, m8, s_pad, f, d8, ril, 1);                           \
    break;
    BIT_EXPAND_CASE(1)
    BIT_EXPAND_CASE(2)
    BIT_EXPAND_CASE(3)
    BIT_EXPAND_CASE(4)
    BIT_EXPAND_CASE(5)
    BIT_EXPAND_CASE(6)
    BIT_EXPAND_CASE(7)
    BIT_EXPAND_CASE(8)
#undef BIT_EXPAND_CASE
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked that
// P rows are 16-byte aligned (s_pad % 16 == 0, P 16-byte aligned), that
// m8 = R*d8 and f are positive, that x is f32 (x_is_bf16 = 0) or bf16 (1),
// and that ril is 0 or an even number that divides d8.  Returns
// cudaGetLastError() after the launch.
extern "C" int bit_expand_matmul_launch(const void* P, const void* x,
                                        int x_is_bf16, void* out, int m8,
                                        int s_pad, int f, int d8, int ril,
                                        void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(P);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    launch(p, static_cast<const __nv_bfloat16*>(x), o, m8, s_pad, f, d8, ril,
           st);
  } else {
    launch(p, static_cast<const float*>(x), o, m8, s_pad, f, d8, ril, st);
  }
  return static_cast<int>(cudaGetLastError());
}
