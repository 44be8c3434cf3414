// bit_reduce_matmul and bit_reduce_matmul16 on Hopper (sm_90a): contract a
// bit-packed multi-link adjacency with a per-rating cotangent table, the
// rating axis folded into the sum.  It is the backward of bit_expand.cu
// through bit_pool_rated.
//
//   out[b, m, f] = sum_{r, s} bit_b(P[r*d8 + phys(m), s]) * bf16(g[r, s, f])
//
// P is (R*d8, S_pad) uint8, the transpose layout of the forward's pack;
// phys is the identity for a natural pack (ril = 0) and the row map of
// bit_walk.cuh:physical_row for a pack built with row_interleave = ril
// (ril = 128 for KERNEL.BIT_IMPL: pallas16).  The wrapper
// (ops/bitdense.py:_reduce) hands over g, which autograd gives as a
// permuted (S_pad, R, F) view; the launch rounds it to bf16 (nearest
// even) into a level-major table (R, S_pad, fp) with fp a multiple of 8;
// sums are f32.  out is (8, d8, F)
// f32 in natural order.
//
// Replaces: stargcn_tpu/ops/bitdense.py:_k2_kernel (bit_reduce_matmul) and,
// with ril = 128, _k2_kernel16 (bit_reduce_matmul16).  Those kernels fold
// the rating axis into a sequential grid dimension and carry one
// accumulator across its steps.  Blocks on this card run in no order, so
// here a unit folds the R packed rows of output row m itself where g's
// table fits L2, and otherwise the R rows are R units, handed out
// rating-major, whose sums are added into out[:, m] in the order
// r = 0..R-1 (a turn flag per m orders the adds).  _k2_kernel16 reads two
// packed rows per u16 lane, a device of the TPU's vector unit with no
// counterpart here: the walk reads the interleaved pack as bytes, row
// phys(m) for position m.  Unlike the reference (bitdense.py:424 halves its
// row block for F > 512 while the pack stays interleaved at 128, which
// scrambles the output rows), the map depends on ril alone, so the output
// is in natural order at every F.
//
// Bound on the H100: P, g and out moved once.  At ML-10M width (R=10, F=65)
// the gradient for the items reads P (14080 x 70656, 0.995 GB) and g
// (10 x 70656 x 65 f32, 184 MB) and writes 3 MB, 0.3527 ms at 3.35 TB/s;
// the gradient for the users reads 0.995 GB + 29 MB and writes 18 MB,
// 0.3112 ms.  The arithmetic the data needs is one F-wide add per set bit
// (about 1e7 per pack), far below the memory time.
//
// Design (the walk is bit_walk.cuh, shared with bit_expand.cu, whose note
// gives points 1, 2 and 4):
// 1. Each warp keeps 4 stages of the pack in flight and 8 row gathers.
// 2. g is rounded to bf16 once a launch (bit_walk.cuh:table_kernel, which
//    reads the cotangent in its own (S_pad, R) order) into a level-major
//    table of 16-byte aligned rows; its time is part of the launch's.
// 3. The table that does not fit: the item gradient's is 10 levels of
//    70656 x 72 bf16, 102 MB, twice the L2.  Its units take one level each
//    and are handed out rating-major (every m of level 0, then level 1,
//    ...), so the blocks at work gather from one or two levels' slices
//    (10 MB each, contiguous), which stay in L2 beside the evict-first
//    stream.  The user gradient's table (16 MB) fits, so a unit walks all
//    ten rows of its m and writes once.
// 4. Units of 64 stages or more are a block's (8 warps, stages in turn).
// The adds into out follow r = 0..R-1 and each unit's own sum has a fixed
// order, so two launches give the same bits; no atomic adds a value.
// On a device mesh a rank walks its row shard of the pack alone (one level
// a unit, chained from the first level it holds of each m) and the ranks'
// partial sums are added by an all-reduce (parallel/collectives.py).  F
// above 256 is cut into column tiles (grid.y), each walking the pack again.

#define BITWALK_NS bit_reduce
#include "bit_walk.cuh"

// Plain C entry point (loaded with ctypes).  The caller has checked that P
// rows are 16-byte aligned (s_pad % 16 == 0, P 16-byte aligned), that P
// holds `rows` packed rows starting at row unit0 of the whole (num_links *
// d8, s_pad) pack (a whole pack: unit0 = 0, rows = num_links * d8; a row
// shard, aligned to ril, walks one level a unit, levels = 1, and out is
// zeroed by the caller: an m with no row in the shard is not written),
// that num_links, d8 and f are positive, that g is f32 (g_is_bf16 = 0) or bf16
// (1) with a contiguous inner dimension and row strides g_stride_r,
// g_stride_s (elements), that tab holds num_links * s_pad * fp bf16 with fp
// a multiple of 8, that levels (1 or num_links), k, np and tiles are the
// plan of ops/bitdense.py:walk_plan, that sync holds tiles * (1 + d8)
// ints, and that ril is 0 or an even number that divides d8.  Rounds g into
// tab, then walks.  Returns the first CUDA error, or 0.
extern "C" int bit_reduce_matmul_launch(const void* P, const void* g,
                                        int g_is_bf16, long long g_stride_r,
                                        long long g_stride_s, void* tab,
                                        void* out, void* sync, int num_links,
                                        int levels, int s_pad, int f, int fp,
                                        int k, int np, int tiles, int d8,
                                        int ril, int rows, int unit0,
                                        void* stream) {
  bit_reduce::Walk w{};
  w.P = static_cast<const uint8_t*>(P);
  w.tab = static_cast<const __nv_bfloat16*>(tab);
  w.out = static_cast<float*>(out);
  w.sync = static_cast<int*>(sync);
  w.units = rows / levels;
  w.unit0 = unit0;
  w.levels = levels;
  w.s_pad = s_pad;
  w.f = f;
  w.fp = fp;
  w.d8 = d8;
  w.ril = ril;
  w.row_step = 1;  // the table is (R, S_pad, fp): one level is contiguous
  w.level_step = s_pad;
  w.out_level = 0;
  w.out_m = f;
  w.out_b = static_cast<long long>(d8) * f;
  w.out_shift = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = bit_reduce::make_table(g, g_is_bf16, g_stride_r,
                                       g_stride_s, w, num_links, st);
  if (e != 0) return e;
  return bit_reduce::run(w, k, np, tiles, levels < num_links, st);
}
