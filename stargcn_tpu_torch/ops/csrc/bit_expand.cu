// bit_expand_matmul and bit_expand_matmul16 on Hopper (sm_90a): expand a
// bit-packed multi-link adjacency against a feature table.
//
//   out[r, b, m, f] = sum_s bit_b(P[r*d8 + phys(m), s]) * bf16(x[s, f])
//
// P is (R*d8, S_pad) uint8; bit b of packed row r*d8+phys(m), column s, is
// set iff destination b*d8+m has an edge with rating level r from source s.
// phys is the identity for a natural pack (ril = 0) and the row map of
// bit_walk.cuh:physical_row for a pack built with row_interleave = ril
// (ril = 128 for KERNEL.BIT_IMPL: pallas16).  The wrapper
// (ops/bitdense.py:_expand) hands over x already rounded to bf16 (round to
// nearest even, as the TPU kernel rounds) in a table padded to fp columns,
// a multiple of 8; sums are f32.  out is (R, 8, d8, F) f32 in natural
// order, the layout of the TPU kernels' output.
//
// Replaces: stargcn_tpu/ops/bitdense.py:_k1_kernel (bit_expand_matmul) and,
// with ril = 128, _k1_kernel16 (bit_expand_matmul16).  The first unpacks all
// eight bit planes of a (bm, bs) block into bf16 and feeds the matrix unit,
// carrying the sum across sequential grid steps over S.  The second
// bitcasts the u8 block to u16 so that one VPU lane holds two packed rows
// (the TPU pairs adjacent sublanes); that pairing has no counterpart here:
// the walk reads the interleaved pack as bytes, row phys(m) for unit m, so
// both routes give the same bits from the same edges.
//
// Bound on the H100: the packed operand read once.  At ML-10M width (R=10,
// F=65) the user direction reads P (88320 x 11264, 0.995 GB) and writes
// 184 MB, 0.3527 ms at 3.35 TB/s; the item direction reads 0.995 GB and
// writes 29 MB, 0.3112 ms.  The arithmetic the data needs is one F-wide add
// per set bit (about 1e7 set bits, 0.93% of the bytes non-zero), far below
// the memory time; a dense bf16 tensor-core expansion would be ~1.03e12 FLOP
// a launch, ~1.05 ms at 989 TFLOP/s, above today's time, so the kernel
// skips zero bytes instead of expanding them.
//
// Design (the walk is bit_walk.cuh, shared with bit_reduce.cu): one unit
// per packed row; persistent blocks, groups of warps taking units from a
// counter.  Against the four points that held PR 4's kernel at 4-6x its
// bound:
// 1. Serial chain: each warp keeps 4 stages (2 KB) of the pack in flight
//    in a cp.async ring, compacts the non-zero bytes of each stage into a
//    list, and gathers 8 table rows before adding the first, so the stream
//    and the gathers overlap and no block barrier stops the stream.  The
//    eight plane sums sit in shared memory, so a set bit picks its plane
//    by address, without a branch.
// 2. Unaligned f32 rows rounded at every gather: x is rounded to bf16 once
//    a launch by the wrapper, into rows of 72 values (144 bytes, 16-byte
//    aligned at F = 65), one 8-byte load per lane.
// 3. L2: the table (10 MB in the item direction) stays in L2 beside the
//    stream, which is read evict-first.
// 4. Skewed rows: a short user-side row (22 stages) is one warp's unit; a
//    long item-side row (138 stages, a popular item's up to 15,260 non-zero
//    bytes) is a whole block's, its 8 warps taking the stages in turn and
//    adding their sums in a fixed order; groups take the next row from the
//    counter as they finish.
// No group writes another's output and no atomic adds a value: two
// launches give the same bits.  A dense P is still exact, only slower.  F
// above 256 is cut into column tiles (grid.y), each walking the pack again.

#define BITWALK_NS bit_expand
#include "bit_walk.cuh"

// Plain C entry point (loaded with ctypes).  The caller has checked that P
// rows are 16-byte aligned (s_pad % 16 == 0, P 16-byte aligned), that
// m8 = R*d8 and f are positive, that x is a contiguous (s_pad, f) f32
// (x_is_bf16 = 0) or bf16 (1) table, that tab holds s_pad * fp bf16 with fp
// a multiple of 8, that k, np and tiles are the plan of ops/bitdense.py:
// walk_plan, that sync holds tiles * (1 + d8) ints, and that ril is 0 or an
// even number that divides d8.  Rounds x into tab, then walks.  Returns the
// first CUDA error, or 0.
extern "C" int bit_expand_matmul_launch(const void* P, const void* x,
                                        int x_is_bf16, void* tab, void* out,
                                        void* sync, int m8, int s_pad, int f,
                                        int fp, int k, int np, int tiles,
                                        int d8, int ril, void* stream) {
  bit_expand::Walk w{};
  w.P = static_cast<const uint8_t*>(P);
  w.tab = static_cast<const __nv_bfloat16*>(tab);
  w.out = static_cast<float*>(out);
  w.sync = static_cast<int*>(sync);
  w.units = m8;
  w.levels = 1;
  w.s_pad = s_pad;
  w.f = f;
  w.fp = fp;
  w.d8 = d8;
  w.ril = ril;
  w.row_step = 1;
  w.level_step = 0;
  w.out_level = 8ll * d8 * f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = bit_expand::make_table(x, x_is_bf16, 0, f, w, 1, st);
  if (e != 0) return e;
  return bit_expand::run(w, k, np, tiles, false, st);
}
