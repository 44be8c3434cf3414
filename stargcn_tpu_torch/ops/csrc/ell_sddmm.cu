// ell_sddmm on Hopper (sm_90a): one inner product per slot of a
// fixed-fanout (ELL) adjacency.
//
//   out[i, k] = dot(q[i, :], values[idx[i, k], :])
//
// q is (num_dst, F) f32, values (num_src, F) f32, idx (num_dst, K) int32,
// out (num_dst, K) f32.  Every slot is scored, padded ones too (the
// weights are not an input); a slot whose index lies outside [0, num_src)
// gives 0 and reads nothing.  All f32, summed in f32; nothing is rounded.
//
// Replaces: stargcn_tpu/ops/pallas_kernels.py:170 ell_sddmm (its
// pallas_call at :187, _sddmm_kernel).  That kernel multiplies every
// destination tile with every source chunk on the matrix unit (G = q @
// vals^T) and picks each slot's score out of G with K select-and-reduce
// passes, because the TPU has no fast gather.  Here each slot's source row
// is gathered and reduced directly.  It is the gradient of ell_spmm for the
// slot weights, and the forward of seg_take_k_corr_pallas.
//
// Bound on the H100: bytes.  q once, the distinct source rows that the
// slots name once (repeats come from L2), the indices and the output; two
// operations per byte quarter, far below the memory time.  What holds it
// now (PERF.md): into users 25,620 full rows gather 8 distinct 1 KB rows
// each, 204,960 gathers of 40,388 distinct rows, so about 205 MB pass
// from L2 beside q's 87 MB stream (about two thirds of the bound by
// device time); into items the source rows are distinct and come from HBM
// (about three quarters).
//
// What held the first design back: a warp a row, and for each slot
// in turn a broadcast load of its index, the row gather, a 5-step shuffle
// sum and a 4-byte store by lane 0.  The sum sat between one slot's gather
// and the next, so a warp had one gather in flight; K slots cost K
// reductions (40 shuffles at K = 8); and the plan's padded slots (491,606
// of 696,320 into users, all naming row 0) cost a gather and a sum each.
//
// Design: a warp still owns a row, and takes its slots 32 at a time (a
// window).
//   * Lane s loads slot s's index: one coalesced load for the window, at
//     the same time as the row's q.
//   * __match_any_sync finds the slots that name the same source; only the
//     first of each (its leader) is computed, and the repeats copy its
//     score.  Each score is the same tree of sums wherever it is computed
//     (below), so this gives the bits of computing every slot.  A padded
//     row of the plan (all 8 slots on row 0) costs one dot, not 8.
//   * The window's live leaders are packed into lanes 0.. (lane p holds the
//     source of the p-th leader) and taken in rounds of R = (32 / W) * G:
//     the warp splits into slot groups of W lanes, and each lane of a group
//     gathers its columns of G leaders' rows before any sum.
//   * The G partial dots of a group are summed with one transposing
//     butterfly: log2(G) steps that halve the list, then plain xor steps,
//     (G - 1) + log2(W) - log2(G) shuffles instead of G log2(W).  Lane sub
//     of a group ends with position sub >> (log2 W - log2 G).
//   * Each slot lane fetches its leader's score with one shuffle, and the
//     window's K scores go out in one coalesced store.
//   * W is 32 where a slot's columns fill a warp (V floats a lane, kUnroll
//     loads a lane a pass, more passes past 32 * V * kUnroll columns: a
//     fixed order).  At narrow F (F / V <= 16) W is the least power of two
//     of at least F / V lanes (4 at the least) and G = min(W, 8), so
//     several slots share a warp instruction instead of leaving lanes idle.
//   * G is 1 at W = 32 (kWideGathers).  The card is held by rows in
//     flight, not by gathers in flight: with one row's 2 * kUnroll floats
//     a lane (38 registers at V = 2 under kMinBlocks = 6, ptxas -v in
//     chip_smoke.py phase 2) 48 warps, 48 rows' q, stay on an SM; with
//     G = 4 (68 registers) 24, and that was slower into users and level
//     into items (the times below).  The loads of q carry the evict-first
//     hint: q is read once, and the source rows it would push out of L2
//     are read again by other rows.
//   * __launch_bounds__(256, kMinBlocks = 6): without the minimum ptxas
//     planned 32 registers at (V 2, W 32) and the call into items ran
//     about a fifth slower; with a minimum of 1 it planned 48.
// The sum of a score: each lane's fma chain over its columns (the kUnroll
// loads added as (0 + 1) + (2 + 3)), then the pairs at lane distance W/2,
// W/4, ..., 1, whatever G, the round or the slot's position; passes add in
// order.  One owner per output, no atomics, the same bits on every run.  At
// W = 32 these are the first design's bits.
//
// The launcher takes the plan (V, W) that ell_kernels.sddmm_plan picks and
// refuses another.
//
// Designs built and dropped, each this file with one text changed
// (python -m stargcn_tpu_torch.probes.ell_sddmm_sweep, which times them on
// the same inputs): device ms a call by the profiler (median of three
// rounds) on a sampled step's plan blocks at F = 250, into users (87296 x
// 8) / into items (17408 x 8), and at seg_take_k_corr_pallas's F = 64
// (6000 x 15, plan W = 16, G = 8); registers at (V 2, W 32).  NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md's findings name the run.
//   kept (G = 1, kMinBlocks = 6, 38)    0.0591 / 0.0321   F = 64 0.00465
//   kMinBlocks = 1 (48)                 0.0616 / 0.0316          0.00437
//   kMinBlocks = 5 (44)                 0.0615 / 0.0315          0.00496
//   kMinBlocks = 8 (32)                 0.0589 / 0.0360          0.00550
//   G = 2, kMinBlocks = 1 (64)          0.0657 / 0.0316
//   G = 4, kMinBlocks = 1 (68)          0.0732 / 0.0325
//   G = 8, kMinBlocks = 1 (99)          0.0965 / 0.0353
//   every slot computed (38)            0.0891 / 0.0340          0.00417
//   q without the evict-first hint      0.0623 / 0.0326          0.00464
//   a warp a slot at F = 64 (W = 32)                             0.01217
// On the plan blocks each other choice gained at most 4% in one direction
// and lost more in the other.  At F = 64 kMinBlocks = 1 and every slot
// computed took 6% and 10% less device time (the rows there seldom repeat
// an index, so the reuse costs the match and saves nothing), but the call
// there is held by the wrapper's host path, not by the kernel, and the
// main path's F = 250 decides.  Also built and dropped while
// the design was chosen, its times not kept: a persistent warp that loads
// the next row's q and indices while it computes this row (a few percent
// faster into users, slower into items).

#include "ell_row.cuh"

namespace {

using namespace ellrow;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideGathers = 1;  // leader rows a lane gathers at W = 32
constexpr int kMinBlocks = 6;    // blocks an SM that ptxas plans for

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// Position of the n-th set bit of m (n from 0, n < popc(m)), by halving.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= half;
      pos += half;
    } else {
      m = low;
    }
  }
  return pos;
}

// x[g] summed over the W lanes of a lane group, for every g at once (G <=
// W, both powers of two).  Step st keeps the half of the list that lane
// bit W >> (st + 1) names and adds the partner's copy of it; the steps
// past log2(G) are plain xor sums.  Every shuffle runs in every lane.
template <int W, int G>
__device__ __forceinline__ float transpose_sum(float (&x)[G], int sub) {
  constexpr int kSteps = log2i(G);
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int half = G >> (st + 1);
    const int d = W >> (st + 1);
    const bool upper = (sub & d) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? x[i] : x[i + half];
      const float keep = upper ? x[i + half] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, d);
    }
  }
  float v = x[0];
#pragma unroll
  for (int d = W >> (kSteps + 1); d > 0; d >>= 1)
    v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// load_vec with the evict-first hint: a row of q is read once.
template <int V>
__device__ __forceinline__ void load_stream(const float* __restrict__ p,
                                            float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
}

// This lane's part of one dot product: an fma chain a load, the loads
// added pairwise.
template <int U, int V>
__device__ __forceinline__ float lane_dot(const float (&qr)[U][V],
                                          const float (&vr)[U][V]) {
  float part[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    part[j] = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) part[j] = fmaf(qr[j][v], vr[j][v], part[j]);
  }
  if constexpr (U == 4) {
    return (part[0] + part[1]) + (part[2] + part[3]);
  } else {
    static_assert(U == 1, "a pass holds 1 or 4 loads a lane");
    return part[0];
  }
}

template <int V, int W>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
ell_sddmm_kernel(const float* __restrict__ q,
                 const float* __restrict__ values,
                 const int* __restrict__ idx, float* __restrict__ out,
                 int num_dst, int k, int num_src, int f) {
  constexpr int G = W == 32 ? kWideGathers : (W < 8 ? W : 8);
  constexpr int U = W == 32 ? kUnroll : 1;  // loads a lane a pass
  constexpr int R = (32 / W) * G;           // leaders a round
  constexpr int kShift = log2i(W) - log2i(G);
  static_assert(G >= 1 && G <= W && (G & (G - 1)) == 0, "G: 1, 2, 4, 8");
  const int lane = threadIdx.x & 31;
  const int sub = lane & (W - 1);  // lane within its slot group
  const int grp = lane / W;        // slot group
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= num_dst) return;  // the whole warp
  const int* irow = idx + row * k;
  float* orow = out + row * k;
  const float* qrow = q + static_cast<size_t>(row) * f;
  for (int w0 = 0; w0 < k; w0 += 32) {
    const bool slot = w0 + lane < k;
    const int src = slot ? __ldg(irow + w0 + lane) : -1;
    const bool live = src >= 0 && src < num_src;
    const int first = __ffs(__match_any_sync(kFull, src)) - 1;
    const unsigned leaders = __ballot_sync(kFull, live && first == lane);
    const int n_lead = __popc(leaders);
    const int rank = __popc(leaders & ((1u << first) - 1u));
    // lane p < n_lead: the source of the p-th leader
    const int lead_src = __shfl_sync(kFull, src, nth_set_bit(leaders, lane));
    float score = 0.0f;
    for (int c0 = 0; c0 < f; c0 += W * V * U) {
      float qr[U][V];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int c = c0 + (j * W + sub) * V;
        if (c < f) {  // F % V == 0, so c < f means c + V <= f
          load_stream<V>(qrow + c, qr[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) qr[j][v] = 0.0f;
        }
      }
      float got = 0.0f;
      for (int r0 = 0; r0 < n_lead; r0 += R) {
        float vr[G][U][V];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int p = r0 + grp * G + g;
          const int s = __shfl_sync(kFull, lead_src, p & 31);
          const float* vrow = values + static_cast<size_t>(s) * f;
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const int c = c0 + (j * W + sub) * V;
            if (p < n_lead && c < f) {
              load_vec<V>(vrow + c, vr[g][j]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) vr[g][j][v] = 0.0f;
            }
          }
        }
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = lane_dot<U, V>(qr, vr[g]);
        const float sum = transpose_sum<W, G>(part, sub);
        const int at = rank - r0;  // this slot's leader, within the round
        const bool here = live && at >= 0 && at < R;
        const float mine = __shfl_sync(
            kFull, sum, here ? (at / G) * W + ((at % G) << kShift) : lane);
        if (here) got = mine;
      }
      score = c0 == 0 ? got : score + got;
    }
    if (slot) orow[w0 + lane] = live ? score : 0.0f;
  }
}

template <int V, int W>
int launch(const void* q, const void* values, const void* idx, void* out,
           int num_dst, int k, int num_src, int f, cudaStream_t st) {
  ell_sddmm_kernel<V, W><<<row_blocks(num_dst), kWarps * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(values),
      static_cast<const int*>(idx), static_cast<float*>(out), num_dst, k,
      num_src, f);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int dispatch(int width, const void* q, const void* values, const void* idx,
             void* out, int num_dst, int k, int num_src, int f,
             cudaStream_t st) {
  switch (width) {
    case 4:
      return launch<V, 4>(q, values, idx, out, num_dst, k, num_src, f, st);
    case 8:
      return launch<V, 8>(q, values, idx, out, num_dst, k, num_src, f, st);
    case 16:
      return launch<V, 16>(q, values, idx, out, num_dst, k, num_src, f, st);
    case 32:
      return launch<V, 32>(q, values, idx, out, num_dst, k, num_src, f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

static_assert(ellrow::kUnroll == 4, "the loads are added as 2 + 2");

// Plain C entry point (loaded with ctypes).  The caller has checked the
// shapes and types, that num_dst, k, num_src and f are positive ints, and
// that q and values are aligned to the vector load of `vec` floats, which
// divides f.  (vec, width) is ell_kernels.sddmm_plan's plan; another
// returns cudaErrorInvalidValue and launches nothing.  Otherwise returns
// cudaGetLastError() after the launch.
extern "C" int ell_sddmm_launch(const void* q, const void* values,
                                const void* idx, void* out, int num_dst,
                                int k, int num_src, int f, int vec,
                                int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec < 1 || f % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 4:
      return dispatch<4>(width, q, values, idx, out, num_dst, k, num_src,
                         f, st);
    case 2:
      return dispatch<2>(width, q, values, idx, out, num_dst, k, num_src,
                         f, st);
    case 1:
      return dispatch<1>(width, q, values, idx, out, num_dst, k, num_src,
                         f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
