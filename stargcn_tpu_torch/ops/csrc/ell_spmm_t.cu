// ell_spmm_transpose on Hopper (sm_90a): the scatter adjoint of ell_spmm,
// with the ordering of the slots by source row done on the card.
//
//   out[s, :] = sum over slots (i, k) with idx[i, k] == s of w[i, k] * g[i, :]
//
// idx / w are (num_dst, K) int32 / f32 (the ELL block), g is (num_dst, F)
// f32 (the cotangent), out (num_src, F) f32, zeros included.  A slot is
// live when w != 0 and 0 <= idx < num_src; the others add nothing.  All
// f32, summed in f32; nothing is rounded.
//
// Replaces: stargcn_tpu/ops/pallas_kernels.py:_spmm_t_kernel
// (ell_spmm_transpose).  The TPU has no fast scatter or atomics, so that
// kernel rebuilds the weighted incidence tile for every (source chunk,
// destination tile) pair and multiplies its transpose with the cotangent
// tile on the matrix unit, carrying the sum over sequential grid steps.
//
// Bound on the H100: bytes.  Every output row is written once (most of
// them zeros: on the main path 77% of the rows into users and 93% into
// items have no live slot), every destination row with a live slot reads
// its cotangent row once, plus idx and w.  The gathers read a cotangent row
// once per live slot (about four times a row into users); what L2 does not
// hold of that comes from HBM, above the bound.
//
// Design.  One output row has one owner and its sum one fixed order, so two
// launches give the same bits; no float atomics.  One C call launches a
// chain of kernels on the caller's stream:
//
//   The ordering (what ops/ell_kernels.py:sort_slots computes: seg_ptr, and
//   each live slot's destination row and weight, in ascending (i, k) order
//   within each source's run), a counting sort, as the key range (num_src)
//   is known:
//   1. ell_t_clear zeros the counters; ell_t_count gives each live slot a
//      rank in its source's run by an integer atomicAdd (exact in any
//      order; the ranks themselves follow the order, and step 4 undoes it).
//   2. ell_t_scan_reduce / ell_t_scan_apply scan the counts into seg_ptr,
//      reduce / scan / add over tiles of 1024 counts (the last tile to
//      finish its sum scans the tile sums).  The first also lists the runs
//      longer than short_max.
//   3. ell_t_place writes each live slot's entry (flat id p = i * K + k,
//      source, weight bits) at seg_ptr[s] + rank: one 16-byte store.
//   4. ell_t_sort_short: a thread a slot, for runs of at most short_max
//      slots: its place is the count of the run's ids below its own (the
//      ids are unique, so the order does not depend on the atomics').
//      ell_t_sort_long: a block a longer run sets a bit per id in a
//      bitmap of kWindowWords words in shared memory and reads the ids back
//      in order through a block-wide scan of the words' popcounts, window
//      after window.  The main path's runs are at most a few hundred slots
//      long, so short_max (the wrapper's SHORT_RUN) keeps them all in the
//      first kernel.
//   The sum (only when out is given):
//   5. The output's memset: the empty rows are most of the bytes, and the
//      memset streams them faster than kernels that write only the empty
//      rows did (they skip 7-23% of the bytes but open many write fronts).
//   6. ell_t_sum: chunk warp c sums the sorted slots [32 c, 32 c + 32),
//      their entries fetched by one coalesced load and broadcast by
//      shuffle, kGather cotangent rows in flight.  A run inside the chunk
//      is written to out; a run that crosses a chunk boundary leaves a
//      partial row per chunk in scratch, and the last of its chunks to
//      arrive (an integer counter) adds them in chunk order (in groups of
//      kCombine, which keeps the rounding of a run of many chunks small)
//      and writes the row.  A long run is so split over as many warps as
//      it has chunks.
//
// Scratch (one int32 tensor from the wrapper, laid out by make_layout and
// mirrored by ops/ell_kernels.py:_order_layout): seg_ptr, dst_sorted and
// w_sorted first (order_slots returns views of them), then the counts,
// chunk counters and two scalar counters (cleared together), ranks, tile
// sums, the long-run list, the entries, and the sum's partial rows.
// Offsets into g, out and the partials are size_t.  No library kernel and
// no block-level primitive of the toolkit's headers is used.

#include <algorithm>

#include "ell_row.cuh"

namespace {

using namespace ellrow;

constexpr int kThreads = 256;             // ordering kernels, a block
constexpr int kScanItems = 4;             // counts a thread in the scan
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kLongThreads = 512;         // a long run's block
constexpr int kWindowWords = 4096;        // 2^17 ids, 16 KB of bitmap
constexpr int kLongBlocks = 256;          // blocks of the long-run sort
constexpr int kChunk = 32;                // sorted slots a chunk warp sums
constexpr int kGather = 2;                // cotangent rows in flight a warp
constexpr int kMaxChunkWarps = 8192;      // chunk warps at most
constexpr int kCombine = 32;              // partials a group in a combine

constexpr long long up64(long long x) { return (x + 63) / 64 * 64; }

struct Layout {
  long long seg_ptr, dst, w, cnt, arrive, counters, zero_end, rank,
      tile_off, long_list, entry, partial, total;
};

Layout make_layout(long long n_slots, long long num_src, long long f,
                   long long short_max) {
  const long long n_chunks = (n_slots + kChunk - 1) / kChunk;
  const long long n_tiles = (num_src + kScanTile - 1) / kScanTile;
  Layout L;
  long long at = 0;
  L.seg_ptr = at;   at += up64(num_src + 1);
  L.dst = at;       at += up64(n_slots);
  L.w = at;         at += up64(n_slots);
  L.cnt = at;       at += num_src;
  L.arrive = at;    at += n_chunks;
  L.counters = at;  at += 2;  // [0] long runs listed, [1] tiles summed
  L.zero_end = at;  at = up64(at);
  L.rank = at;      at += up64(n_slots);
  L.tile_off = at;  at += up64(n_tiles);
  L.long_list = at; at += up64(n_slots / (short_max + 1) + 1);
  L.entry = at;     at += 4 * up64(n_slots);
  L.partial = at;   at += 2 * n_chunks * f;
  L.total = at;
  return L;
}

// Exclusive scan of one int a thread over the block (at most 32 warps);
// *total gets the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    sh[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = sh[nw - 1];
  const int excl = x - v + (warp > 0 ? sh[warp - 1] : 0);
  __syncthreads();  // sh may be written again on return
  return excl;
}

// ------------------------------- ordering -------------------------------

// Four consecutive ints from p (any alignment), 0 past n.
__device__ __forceinline__ void load4(const int* __restrict__ p, long long at,
                                      long long n, int (&v)[4]) {
  if (at + 4 <= n && (reinterpret_cast<uintptr_t>(p + at) & 15) == 0) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + at));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = at + j < n ? __ldg(p + at + j) : 0;
  }
}

// Four consecutive ints to p + at (p 16-byte aligned), none past n.
__device__ __forceinline__ void store4(int* __restrict__ p, long long at,
                                       long long n, const int (&v)[4]) {
  if (at + 4 <= n) {
    *reinterpret_cast<int4*>(p + at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (at + j < n) p[at + j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
ell_t_count(const int* __restrict__ idx, const float* __restrict__ w,
            int n_slots, int num_src, int* __restrict__ cnt,
            int* __restrict__ rank) {
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (p0 >= n_slots) return;
  int s[4], wb[4], r[4];
  load4(idx, p0, n_slots, s);
  load4(reinterpret_cast<const int*>(w), p0, n_slots, wb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // live: a weight other than +-0 (NaN too) and an index in range
    const bool live = (wb[j] & 0x7fffffff) != 0 && s[j] >= 0 && s[j] < num_src
                      && p0 + j < n_slots;
    r[j] = live ? atomicAdd(cnt + s[j], 1) : -1;
  }
  store4(rank, p0, n_slots, r);
}

__global__ void __launch_bounds__(kThreads)
ell_t_scan_reduce(const int* __restrict__ cnt, int num_src, int short_max,
                  int n_tiles, int* __restrict__ tile_off,
                  int* __restrict__ counters, int* __restrict__ long_list) {
  __shared__ int sh[32];
  __shared__ bool last;
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile
                         + threadIdx.x * kScanItems;
  int v[kScanItems];
  load4(cnt, base, num_src, v);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    sum += v[j];
    if (v[j] > short_max)
      long_list[atomicAdd(counters, 1)] = static_cast<int>(base + j);
  }
  int total;
  block_excl_scan(sum, sh, &total);
  if (threadIdx.x == 0) {
    tile_off[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(counters + 1, 1) == n_tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last tile to finish: the tile sums' exclusive scan, in place.
  __threadfence();
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int tv = t < n_tiles ? __ldcg(tile_off + t) : 0;
    int tot;
    const int ex = block_excl_scan(tv, sh, &tot);
    if (t < n_tiles) tile_off[t] = carry + ex;
    carry += tot;
  }
}

__global__ void __launch_bounds__(kThreads)
ell_t_scan_apply(const int* __restrict__ cnt, int num_src,
                 const int* __restrict__ tile_off, int* __restrict__ seg_ptr) {
  __shared__ int sh[32];
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile
                         + threadIdx.x * kScanItems;
  int v[kScanItems];
  load4(cnt, base, num_src, v);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) sum += v[j];
  int total;
  int at = block_excl_scan(sum, sh, &total) + __ldg(tile_off + blockIdx.x);
  int out[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    out[j] = at;
    at += v[j];
  }
  store4(seg_ptr, base, num_src, out);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1)
    seg_ptr[num_src] = at;  // counts past num_src are 0: the total
}

// Zeros over the counts, chunk counters and scalar counters.
__global__ void __launch_bounds__(kThreads)
ell_t_clear(int* __restrict__ p, long long n) {
  const long long at =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  const int z[4] = {0, 0, 0, 0};
  if (at < n) store4(p, at, n, z);
}

// A placed slot: its flat id p = i * K + k, its source s and its weight's
// bits, 16 bytes (one store a slot; the sort and the sum read them in
// order).
__global__ void __launch_bounds__(kThreads)
ell_t_place(const int* __restrict__ idx, const float* __restrict__ w,
            const int* __restrict__ rank, int n_slots,
            const int* __restrict__ seg_ptr, int4* __restrict__ entry) {
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (p0 >= n_slots) return;
  int s[4], r[4], wb[4];
  load4(rank, p0, n_slots, r);
  load4(idx, p0, n_slots, s);
  load4(reinterpret_cast<const int*>(w), p0, n_slots, wb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r[j] < 0 || p0 + j >= n_slots) continue;
    entry[__ldg(seg_ptr + s[j]) + r[j]] =
        make_int4(static_cast<int>(p0 + j), s[j], wb[j], 0);
  }
}

// A thread a sorted slot, for runs of at most short_max slots: its place
// in the run is the count of the run's slot ids below its own.
__global__ void __launch_bounds__(kThreads)
ell_t_sort_short(const int4* __restrict__ entry,
                 const int* __restrict__ seg_ptr, int num_src, int k,
                 int short_max, int* __restrict__ dst_sorted,
                 float* __restrict__ w_sorted) {
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= __ldg(seg_ptr + num_src)) return;
  const int4 me = __ldg(entry + pos);
  const int b = __ldg(seg_ptr + me.y), e = __ldg(seg_ptr + me.y + 1);
  if (e - b > short_max) return;  // ell_t_sort_long's
  const int* ids = reinterpret_cast<const int*>(entry);
  int r = 0;
#pragma unroll 4
  for (int j = b; j < e; ++j)
    r += __ldg(ids + 4 * static_cast<size_t>(j)) < me.x;
  dst_sorted[b + r] = me.x / k;
  w_sorted[b + r] = __int_as_float(me.z);
}

__global__ void __launch_bounds__(kLongThreads)
ell_t_sort_long(const int4* __restrict__ entry,
                const int* __restrict__ seg_ptr,
                const int* __restrict__ long_list,
                const int* __restrict__ counters, const float* __restrict__ w,
                int k, int n_slots, int* __restrict__ dst_sorted,
                float* __restrict__ w_sorted) {
  __shared__ unsigned bits[kWindowWords];
  __shared__ int sh[32];
  const int n_long = counters[0];
  constexpr long long win = 32LL * kWindowWords;
  constexpr int per = kWindowWords / kLongThreads;
  const int w0 = threadIdx.x * per, w1 = w0 + per;
  const int* ids = reinterpret_cast<const int*>(entry);
  for (int e = blockIdx.x; e < n_long; e += gridDim.x) {
    const int s = long_list[e];
    const int b = __ldg(seg_ptr + s), n = __ldg(seg_ptr + s + 1) - b;
    int emitted = 0;
    for (long long lo = 0; lo < n_slots; lo += win) {
      for (int j = threadIdx.x; j < kWindowWords; j += kLongThreads)
        bits[j] = 0u;
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kLongThreads) {
        const long long off =
            __ldg(ids + 4 * (static_cast<size_t>(b) + j)) - lo;
        if (off >= 0 && off < win)
          atomicOr(bits + (off >> 5), 1u << (off & 31));
      }
      __syncthreads();
      int c = 0;
      for (int j = w0; j < w1; ++j) c += __popc(bits[j]);
      int total;
      int at = b + emitted + block_excl_scan(c, sh, &total);
      for (int j = w0; j < w1; ++j) {
        unsigned m = bits[j];
        while (m) {
          const int p = static_cast<int>(lo + 32LL * j + (__ffs(m) - 1));
          m &= m - 1;
          dst_sorted[at] = p / k;
          w_sorted[at] = __ldg(w + p);
          ++at;
        }
      }
      emitted += total;
      __syncthreads();  // the bitmap is cleared for the next window or run
    }
  }
}

// ---------------------------------- sum ----------------------------------

template <int V>
__device__ __forceinline__ void load_vec_cg(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcg(p);
  }
}

// This lane's columns of the pass that starts at c0 (0 past f); through L2
// where the row was written by another warp of this launch.
template <int V, bool kCg>
__device__ __forceinline__ void load_row(float (&t)[kUnroll][V],
                                         const float* row, int c0, int f,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int c = c0 + (j * 32 + lane) * V;
    if (c < f) {
      if constexpr (kCg) load_vec_cg<V>(row + c, t[j]);
      else load_vec<V>(row + c, t[j]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) t[j][v] = 0.0f;
    }
  }
}

// The last chunk warp of a crossing run adds its partial rows in chunk
// order (slot 1 of the chunk it starts in, then slot 0 of each later one):
// each group of kCombine partials in turn, and the group sums in turn, so
// that a run of many chunks rounds as a sum of about kCombine + chunks /
// kCombine terms.
template <int V>
__device__ void combine_run(const float* partial, float* __restrict__ orow,
                            int c_start, int c_end, int f, int lane) {
  for (int c0 = 0; c0 < f; c0 += 32 * V * kUnroll) {
    float acc[kUnroll][V] = {};
    for (int g0 = c_start; g0 <= c_end; g0 += kCombine) {
      float grp[kUnroll][V];
      load_row<V, true>(
          grp, partial + (2 * static_cast<size_t>(g0) + (g0 == c_start)) * f,
          c0, f, lane);
      const int g1 = min(c_end, g0 + kCombine - 1);
#pragma unroll 4
      for (int c = g0 + 1; c <= g1; ++c) {
        float t[kUnroll][V];
        load_row<V, true>(t, partial + 2 * static_cast<size_t>(c) * f, c0, f,
                          lane);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) grp[j][v] += t[j][v];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[j][v] += grp[j][v];
    }
    store_row<V>(acc, orow, c0, f, lane);
  }
}

// Counts this chunk's arrival at run s's counter; the last arrival adds
// the run's partial rows and writes it.
template <int V>
__device__ void arrive_run(int s, const int* __restrict__ seg_ptr,
                           const float* partial, int* arrive,
                           float* __restrict__ out, int f, int lane) {
  const int c_start = __ldg(seg_ptr + s) / kChunk;
  const int c_end = (__ldg(seg_ptr + s + 1) - 1) / kChunk;
  int old = 0;
  if (lane == 0) old = atomicAdd(arrive + c_start, 1);
  old = __shfl_sync(0xffffffffu, old, 0);
  if (old != c_end - c_start) return;
  __threadfence();
  combine_run<V>(partial, out + static_cast<size_t>(s) * f, c_start, c_end,
                 f, lane);
}

// Chunk warp c sums the sorted slots [32 c, 32 c + 32): their entries in
// one coalesced load, broadcast by shuffle, kGather cotangent rows in
// flight, each run's products added in slot order.  A run inside the chunk
// is written to out; a run that crosses a chunk boundary leaves its piece
// in a partial row: slot 0 for the run at the chunk's first slot when it
// began in an earlier chunk, slot 1 for the run at its last slot when it
// goes on into a later one (a run over the whole chunk and beyond takes
// slot 0).  The last chunk of a crossing run to arrive adds its partials.
template <int V>
__device__ void sum_chunk(const float* __restrict__ g,
                          const int* __restrict__ seg_ptr,
                          const int* __restrict__ dst_sorted,
                          const float* __restrict__ w_sorted,
                          const int4* __restrict__ entry, float* partial,
                          int* arrive, float* __restrict__ out, int f,
                          int chunk, int total, int lane) {
  const int pos0 = chunk * kChunk;
  const int nv = min(kChunk, total - pos0);
  int my_i = 0, my_r = -1;
  float my_w = 0.0f;
  if (lane < nv) {
    my_i = __ldg(dst_sorted + pos0 + lane);
    my_w = __ldg(w_sorted + pos0 + lane);
    my_r = __ldg(reinterpret_cast<const int*>(entry + pos0 + lane) + 1);
  }
  const int r_first = __shfl_sync(0xffffffffu, my_r, 0);
  const int r_last = __shfl_sync(0xffffffffu, my_r, nv - 1);
  const bool head = __ldg(seg_ptr + r_first) < pos0;
  const bool tail = __ldg(seg_ptr + r_last + 1) > pos0 + kChunk;
  float* p_head = partial + 2 * static_cast<size_t>(chunk) * f;
  float* p_tail = p_head + f;
  for (int c0 = 0; c0 < f; c0 += 32 * V * kUnroll) {
    float acc[kUnroll][V] = {};
    int cur = r_first;
    for (int j0 = 0; j0 < nv; j0 += kGather) {
      float t[kGather][kUnroll][V];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = __shfl_sync(0xffffffffu, my_i, (j0 + u) & 31);
        if (j0 + u < nv)
          load_row<V, false>(t[u], g + static_cast<size_t>(i) * f, c0, f,
                             lane);
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int r = __shfl_sync(0xffffffffu, my_r, (j0 + u) & 31);
        const float ws = __shfl_sync(0xffffffffu, my_w, (j0 + u) & 31);
        if (j0 + u < nv) {
          if (r != cur) {  // warp-uniform: a run ends inside the chunk
            store_row<V>(acc, cur == r_first && head
                                  ? p_head
                                  : out + static_cast<size_t>(cur) * f,
                         c0, f, lane);
#pragma unroll
            for (int j = 0; j < kUnroll; ++j)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;
            cur = r;
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[j][v] = fmaf(ws, t[u][j][v], acc[j][v]);
        }
      }
    }
    store_row<V>(acc, cur == r_first && head ? p_head
                      : tail ? p_tail : out + static_cast<size_t>(cur) * f,
                 c0, f, lane);
  }
  if (!head && !tail) return;
  __threadfence();  // the partial rows before the arrival counts
  __syncwarp();
  if (head) arrive_run<V>(r_first, seg_ptr, partial, arrive, out, f, lane);
  if (tail && !(head && r_last == r_first))
    arrive_run<V>(r_last, seg_ptr, partial, arrive, out, f, lane);
}

// Chunk c to warp c, strided where there are more chunks than warps: the
// live chunks fill the first blocks, and the blocks past them return at
// once.  The empty rows are zeros already (the output's memset before this
// launch).
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
ell_t_sum(const float* __restrict__ g, const int* __restrict__ seg_ptr,
          const int* __restrict__ dst_sorted,
          const float* __restrict__ w_sorted, const int4* __restrict__ entry,
          float* partial, int* arrive, float* __restrict__ out, int num_src,
          int f) {
  const int lane = threadIdx.x & 31;
  const int total = __ldg(seg_ptr + num_src);
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long me =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  for (long long c = me; c < chunks; c += warps)
    sum_chunk<V>(g, seg_ptr, dst_sorted, w_sorted, entry, partial, arrive,
                 out, f, static_cast<int>(c), total, lane);
}

template <int V>
void launch_sum(const float* g, const int* seg_ptr, const int* ds,
                const float* ws, const int4* entry, float* partial,
                int* arrive, float* out, int num_src, int f,
                long long n_chunks, cudaStream_t st) {
  // A warp a chunk up to kMaxChunkWarps (n_chunks counts dead slots too).
  const long long blocks =
      (std::min<long long>(n_chunks, kMaxChunkWarps) + kWarps - 1) / kWarps;
  ell_t_sum<V><<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(
      g, seg_ptr, ds, ws, entry, partial, arrive, out, num_src, f);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Orders the live slots of the
// block (idx, w), and, when out is not null, sums the cotangent g into out.
// ws is the int32 scratch of ws_elems elements laid out by make_layout:
// its first parts hold seg_ptr, dst_sorted and w_sorted.  The caller has
// checked the shapes and types, that num_dst * k, num_src and f fit an int,
// that num_src, k and short_max are positive, that g is aligned to the
// vector load and that out and ws are aligned to 16 bytes.  Returns
// cudaErrorInvalidValue, launching nothing, where ws is smaller than the
// layout; else cudaGetLastError() after the launches.
extern "C" int ell_spmm_t_launch(const void* g, const void* idx,
                                 const void* w, void* out, void* ws,
                                 long long ws_elems, int num_dst, int k,
                                 int num_src, int f, int short_max,
                                 void* stream) {
  const long long n_slots = static_cast<long long>(num_dst) * k;
  const Layout L = make_layout(n_slots, num_src, out ? f : 0, short_max);
  if (ws_elems < L.total || n_slots <= 0 || num_src <= 0 || short_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* base = static_cast<int*>(ws);
  int* seg_ptr = base + L.seg_ptr;
  int* dst_sorted = base + L.dst;
  float* w_sorted = reinterpret_cast<float*>(base + L.w);
  int* cnt = base + L.cnt;
  int* counters = base + L.counters;
  int4* entry = reinterpret_cast<int4*>(base + L.entry);
  const int* ii = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  const int ns = static_cast<int>(n_slots);
  const auto blocks = [](long long n, long long per) {
    return static_cast<unsigned>((n + per - 1) / per);
  };
  const int n_tiles = static_cast<int>(blocks(num_src, kScanTile));

  ell_t_clear<<<blocks(L.zero_end - L.cnt, 4 * kThreads), kThreads, 0, st>>>(
      cnt, L.zero_end - L.cnt);
  ell_t_count<<<blocks(n_slots, 4 * kThreads), kThreads, 0, st>>>(
      ii, ww, ns, num_src, cnt, base + L.rank);
  ell_t_scan_reduce<<<n_tiles, kThreads, 0, st>>>(
      cnt, num_src, short_max, n_tiles, base + L.tile_off, counters,
      base + L.long_list);
  ell_t_scan_apply<<<n_tiles, kThreads, 0, st>>>(cnt, num_src,
                                                 base + L.tile_off, seg_ptr);
  ell_t_place<<<blocks(n_slots, 4 * kThreads), kThreads, 0, st>>>(
      ii, ww, base + L.rank, ns, seg_ptr, entry);
  ell_t_sort_short<<<blocks(n_slots, kThreads), kThreads, 0, st>>>(
      entry, seg_ptr, num_src, k, short_max, dst_sorted, w_sorted);
  const long long long_max = n_slots / (short_max + 1LL) + 1;
  ell_t_sort_long<<<static_cast<unsigned>(std::min<long long>(
                        long_max, kLongBlocks)),
                    kLongThreads, 0, st>>>(entry, seg_ptr,
                                           base + L.long_list, counters, ww,
                                           k, ns, dst_sorted, w_sorted);
  if (out) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(num_src) * f * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* gg = static_cast<const float*>(g);
    float* o = static_cast<float*>(out);
    float* partial = reinterpret_cast<float*>(base + L.partial);
    int* arrive = base + L.arrive;
    const long long n_chunks = (n_slots + kChunk - 1) / kChunk;
    switch (pick_vec(f)) {
      case 4:
        launch_sum<4>(gg, seg_ptr, dst_sorted, w_sorted, entry, partial,
                      arrive, o, num_src, f, n_chunks, st);
        break;
      case 2:
        launch_sum<2>(gg, seg_ptr, dst_sorted, w_sorted, entry, partial,
                      arrive, o, num_src, f, n_chunks, st);
        break;
      default:
        launch_sum<1>(gg, seg_ptr, dst_sorted, w_sorted, entry, partial,
                      arrive, o, num_src, f, n_chunks, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
