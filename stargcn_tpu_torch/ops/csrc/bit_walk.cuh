// Device code shared by the bit-packed adjacency kernels (bit_expand.cu,
// bit_reduce.cu): one persistent walk over packed rows that both kernels
// launch, with the pack streamed through a shared-memory ring and the
// non-zero bytes gathered from a bf16 feature table.
//
// A packed row is a string of s_pad bytes; bit b of byte s says that the
// b-th of the row's eight destinations has an edge from source s.  A unit
// is `levels` packed rows of one position m: u = rr * d8 + m walks rows
// (rr * levels + l) * d8 + physical_row(m, ril), l = 0..levels-1, and gives
// the eight plane sums
//
//   acc[b, c] = sum over those rows' bytes s with bit b set of
//               tab[row of source s, level rr * levels + l][c]
//
// for the columns c of one column tile, where tab is the bf16 table that
// table_kernel rounds from the caller's f32 or bf16 operand (rows of fp
// columns, fp a multiple of 8, zero past F, so every row is 16-byte
// aligned; row s * row_step + level * level_step).  bit_expand stores the
// sums (levels 1, one table); bit_reduce folds all R levels into one unit
// where its table fits L2 (the user gradient), else takes one level per
// unit and adds the units of one m into its output in the order r = 0, 1,
// ..., R-1 (the item gradient).
//
// A launch may walk a row shard of the pack alone (one rank's rows on a
// device mesh, parallel/shardings.py): P then points at the shard's first
// packed row, and units unit0 .. unit0 + units - 1 (one level each) are
// walked.  Output element (unit of level rr and row m, plane b) lies at
// rr * out_level + m * out_m + b * out_b - out_shift: the whole pack's
// layout, or for an expand on a shard the shard's own rows, one after
// another (out_shift takes the shard's first row off).
//
// The walk (persistent blocks of 8 warps; groups of NP warps take units
// from a counter, NP = 1 for short rows, 8 for long ones):
// - a unit is cut into 512-byte stages, one 16-byte piece per lane; the
//   group's warps take its stages in turn, and each warp keeps a ring of
//   kStages stages in flight with cp.async (L2 evict-first, so the stream
//   does not push the table out of L2), running on across units; no block
//   barrier stops the stream;
// - when a stage has landed, the warp compacts its non-zero bytes into its
//   shared-memory list (a 16-bit mask per lane, a warp scan of the counts),
//   after the entries it holds; the list holds a whole stage, so a dense
//   pack stays exact;
// - whenever kBatch / K entries are held, that many table rows are
//   gathered before the first is added, so the gathers of a warp overlap
//   one another and the ring's loads.  Lane l adds columns 4l..4l+3 of each
//   128-column round; the eight plane sums of a warp live in shared memory,
//   so a set bit b adds the row at an address that b selects (a switch or
//   predicated adds over eight register planes cost more than the gathers);
// - at a unit's end a warp stores its sums (NP = 1), or the 8 warps' sums
//   are added in the fixed order w = 0..7 (NP = 8).
// So each output's summation order is a function of its rows' bytes and
// the shape alone: not of the grid, the schedule, or the row map (the
// 16-bit route gives the natural route's bits).  The counter hands out
// work and the turn flags order the adds; no atomic adds a value.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The including file names the outer namespace (BITWALK_NS: bit_expand or
// bit_reduce), so each kernel's name in a profiler trace says which op
// launched it.
#ifndef BITWALK_NS
#error "define BITWALK_NS before including bit_walk.cuh"
#endif

// Internal linkage: bit_expand.cu and bit_reduce.cu are separate shared
// libraries, and a template's function-local static with external linkage
// would be one object across both once loaded (a GNU unique symbol), so one
// library's kernel would skip the other's shared-memory attribute.
namespace BITWALK_NS {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;              // stages in flight per warp
constexpr int kQueue = 2 * kStages;     // unit id slots of a group
constexpr int kBatch = 8;               // row gathers in flight per warp (K=1)
constexpr int kRound = 128;             // columns per register round

// The row map of a pack built with row_interleave = ril (ops/bitdense.py:
// pack_bits; ril = 0 is the natural order).  Inside each block of ril rows
// of the d8 axis, natural position w sits at physical row
// 2*(w % (ril/2)) + w / (ril/2).  The TPU's 16-bit kernels need that order
// because a u8 -> u16 bitcast there pairs adjacent sublanes (packed rows 2k
// and 2k+1) into one lane; nothing on this card pairs rows, so the walk
// reads the pack as bytes and only the row it reads for a unit changes.
__device__ __forceinline__ int physical_row(int m, int ril) {
  if (ril == 0) return m;
  const int half = ril >> 1;
  const int w = m % ril;
  return m - w + 2 * (w % half) + w / half;
}

struct Walk {
  const uint8_t* P;          // (num_links * d8, s_pad) uint8
  const __nv_bfloat16* tab;  // bf16 rows of fp columns: row s * row_step +
                             // level * level_step holds source s, level
  float* out;
  int* sync;                 // tiles counters, then tiles * d8 turn flags
  int units;                 // units of this launch
  int unit0;                 // the first unit's global id (a row shard)
  int levels;                // packed rows (rating levels) per unit
  int s_pad, f, fp, d8, ril;
  int row_step;              // table rows between sources s and s + 1
  int level_step;            // table rows between levels (0: one table)
  long long out_level;       // elements between out's levels (expand)
  long long out_m;           // elements between out's rows m
  long long out_b;           // elements between out's bit planes b
  long long out_shift;       // elements before the shard's first row
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t pol) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(s),
      "l"(src), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Bit j (0..15) set iff byte j of the 16-byte piece is non-zero.
__device__ __forceinline__ uint32_t nonzero_mask(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t h = (((w[j] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[j]) &
                       0x80808080u;
    const uint32_t m4 = ((h >> 7) & 1u) | ((h >> 14) & 2u) |
                        ((h >> 21) & 4u) | ((h >> 28) & 8u);
    mask |= m4 << (4 * j);
  }
  return mask;
}

__device__ __forceinline__ uint32_t byte_at(uint4 v, int j) {
  const uint32_t w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
  return (w >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ uint2 load_row8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// Gathers n <= kB table rows (entries a.. of a warp's list: the row of the
// entry's source and level, and its byte) and only then adds them: the loads are volatile
// asm, issued together ahead of the first add.  Each set bit b adds the
// row's four columns of this lane into plane b of the warp's accumulator
// in shared memory (accw: this lane's float4 of plane 0; planes kPlane
// floats apart), so the plane is an address, not a branch.  a is a
// multiple of 4.
template <int K, int kB>
__device__ __forceinline__ void gather_add(const uint32_t* ents,
                                           const uint8_t* bytes, int a, int n,
                                           const __nv_bfloat16* tab, int fp,
                                           int col, float* accw) {
  constexpr int kPlane = kRound * K;
  uint32_t bits[kB / 4];  // four entries' bytes per word
#pragma unroll
  for (int q = 0; q < kB / 4; ++q) {
    const uint32_t word = reinterpret_cast<const uint32_t*>(bytes + a)[q];
    const int live = n - 4 * q;
    bits[q] = live >= 4 ? word
              : live <= 0 ? 0u
                          : word & ((1u << (8 * live)) - 1u);
  }
  uint2 x[kB][K];
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const uint32_t e = q < n ? ents[a + q] : 0u;
    const __nv_bfloat16* row = tab + static_cast<size_t>(e) * fp + col;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      x[q][kk] = make_uint2(0u, 0u);
      if (q < n && col + kk * kRound < fp)
        x[q][kk] = load_row8(row + kk * kRound);
    }
  }
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    uint32_t b8 = (bits[q / 4] >> (8 * (q % 4))) & 0xffu;  // warp-uniform
    while (b8) {
      const int b = __ffs(b8) - 1;
      b8 &= b8 - 1u;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        float4* p = reinterpret_cast<float4*>(accw + b * kPlane + kk * kRound);
        float4 v = *p;
        v.x += __uint_as_float(x[q][kk].x << 16);
        v.y += __uint_as_float(x[q][kk].x & 0xffff0000u);
        v.z += __uint_as_float(x[q][kk].y << 16);
        v.w += __uint_as_float(x[q][kk].y & 0xffff0000u);
        *p = v;
      }
    }
  }
}

constexpr int kList = 544;  // kBatch - 1 carried over + one stage of 512

// Per warp: its ring, its list (entries, then bytes) and its eight plane
// accumulators (f32, kRound * k columns each).
inline size_t smem_bytes(int k) {
  return static_cast<size_t>(kWarps) *
         (kStages * 512 + kList * 5 + 8 * kRound * k * 4);
}

// NP warps walk one unit: NP = 1 (a warp per unit, short rows) or 8 (the
// block per unit, long rows; its warps take the unit's stages in turn).
// kChain: bit_reduce with one level per unit, whose units r*d8 + m add
// into output row m in the order r = 0..R-1 (NP = 8 only).
// K: 128-column register rounds per column tile (1 or 2).
template <int K, int NP, bool kChain>
__global__ void __launch_bounds__(kThreads, K == 1 ? 3 : 2)
    walk_kernel(Walk w) {
  static_assert(NP == 1 || NP == kWarps, "a unit is a warp's or a block's");
  static_assert(!kChain || NP == kWarps, "the turn wait is the block's");
  constexpr int kTile = kRound * K;
  constexpr int kB = kBatch / K < 4 ? 4 : kBatch / K;  // a multiple of 4
  constexpr int kGroups = kWarps / NP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * kStages * 32;
  unsigned char* lists = smem + kWarps * kStages * 512;
  uint32_t* ents = reinterpret_cast<uint32_t*>(lists) + warp * kList;
  uint8_t* bytes = lists + kWarps * kList * 4 + warp * kList;
  float* accs = reinterpret_cast<float*>(lists + kWarps * kList * 5);
  __shared__ int queue[kGroups][kQueue];
  int* myq = queue[warp / NP];
  const int part = warp % NP;
  const bool leader = t % (NP * 32) == 0;

  const int col0 = blockIdx.y * kTile;
  const int col = col0 + 4 * lane;
  // This lane's float4 of plane 0 in the warp's accumulator.
  float* accw = accs + warp * 8 * kTile + 4 * lane;
  auto clear_acc = [&]() {
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        *reinterpret_cast<float4*>(accw + b * kTile + kk * kRound) =
            make_float4(0.f, 0.f, 0.f, 0.f);
  };
  int* counter = w.sync + blockIdx.y;
  int* turn = w.sync + gridDim.y + static_cast<size_t>(blockIdx.y) * w.d8;
  const int n16 = w.s_pad >> 4;
  const int sr = (n16 + 31) >> 5;            // 512-byte stages per row
  const int stages = w.levels * sr;          // stages per unit
  const int mine = stages > part ? (stages - part + NP - 1) / NP : 0;
  const uint64_t pol = evict_first_policy();

  // Unit ids: myq[k % kQueue] is the group's k-th unit.  The producer runs
  // up to kStages units ahead (one stage a unit), so while the group works
  // on unit k the leader holds ids up to k + kStages + 1 in the queue, and
  // one more in flight in a register, so that no thread waits on the
  // counter or reads a slot being written.
  int pending = 0;
  if (leader) {
    for (int q = 0; q <= kStages + 1; ++q) myq[q] = atomicAdd(counter, 1);
    pending = atomicAdd(counter, 1);
  }
  if (NP > 1) __syncthreads(); else __syncwarp();

  // A cursor over this warp's stages: the group's k-th unit, its z-th stage
  // of this warp (stage part + z * NP of the unit: level l, stage st of
  // that row), advanced without division.
  const int l0 = part / sr;
  const int st0 = part - l0 * sr;
  const size_t level_bytes = static_cast<size_t>(w.d8) * w.s_pad;
  struct Cursor {
    int k, z, l, st;
    const uint8_t* row;  // the packed row of level l
    bool live;
  };
  auto start = [&](Cursor& c, int k) {
    c.k = k;
    c.z = 0;
    c.l = l0;
    c.st = st0;
    const int u = myq[k % kQueue];
    c.live = u < w.units;
    const int ug = c.live ? u + w.unit0 : 0;
    const int rr = ug / w.d8;
    const int m = ug - rr * w.d8;
    c.row = w.P + (static_cast<size_t>(rr * w.levels + l0) * w.d8 +
                   physical_row(m, w.ril) - (c.live ? w.unit0 : 0)) *
                      w.s_pad;
  };
  auto advance = [&](Cursor& c) {
    if (++c.z == mine) {
      start(c, c.k + 1);
      return;
    }
    c.st += NP;
    while (c.st >= sr) {
      c.st -= sr;
      ++c.l;
      c.row += level_bytes;
    }
  };

  // The producer runs kStages - 1 stages ahead of the consumer, one commit
  // group per stage.
  Cursor pc;
  int slot = 0;
  auto issue = [&]() {
    const int piece = pc.st * 32 + lane;
    if (pc.live && piece < n16)
      cp_async16(ring + slot * 32 + lane,
                 pc.row + static_cast<size_t>(piece) * 16, pol);
    cp_async_commit();
    slot = (slot + 1) & (kStages - 1);
    advance(pc);
  };
  if (mine > 0) {
    start(pc, 0);
    for (int j = 0; j < kStages - 1; ++j) issue();
  }

  clear_acc();

  int cslot = 0;  // the ring slot of the consumer's stage
  for (int k = 0;; ++k) {
    const int u = myq[k % kQueue];
    if (u >= w.units) break;  // the same for the whole group
    if (leader) {
      myq[(k + kStages + 2) % kQueue] = pending;
      pending = atomicAdd(counter, 1);
    }
    const int ug = u + w.unit0;  // the unit's global id
    const int rr = ug / w.d8;    // the unit's first level / levels
    const int m = ug - rr * w.d8;
    const __nv_bfloat16* tab =
        w.tab + static_cast<size_t>(rr) * w.levels * w.level_step * w.fp;
    // A chained unit adds to the sum of the unit one level before it where
    // that unit is in this launch (all of them but the first level's on a
    // whole pack; on a row shard, all but the first level the shard holds
    // of this m).  Its turn is read now and needed only at its end.
    const bool after = kChain && u >= w.d8;
    int seen = after && t == 0 ? load_acquire(turn + m) : 0;

    int held = 0;  // entries in this warp's list, the same in every lane
    int l = l0, st = st0;
    for (int z = 0; z < mine; ++z) {
      issue();
      cp_async_wait<kStages - 1>();  // this lane's piece of the stage
      const int piece = st * 32 + lane;
      const uint4 v = piece < n16 ? ring[cslot * 32 + lane]
                                  : make_uint4(0u, 0u, 0u, 0u);
      cslot = (cslot + 1) & (kStages - 1);
      // Entry j of this piece: source piece * 16 + j, level l of the unit.
      const uint32_t rbase =
          static_cast<uint32_t>(piece) * 16 * w.row_step + l * w.level_step;
      st += NP;
      while (st >= sr) {
        st -= sr;
        ++l;
      }
      if (!__any_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u)) continue;

      // Compact the stage's non-zero bytes after the entries held.
      uint32_t mask = nonzero_mask(v);
      const int cnt = __popc(mask);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int off = held + incl - cnt;
      while (mask) {
        const int j = __ffs(mask) - 1;
        mask &= mask - 1u;
        ents[off] = rbase + j * w.row_step;
        bytes[off] = static_cast<uint8_t>(byte_at(v, j));
        ++off;
      }
      held += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      if (held < kB) continue;

      // Whole batches now; the rest (< kB) moves to the list's front.
      int a = 0;
      for (; a + kB <= held; a += kB)
        gather_add<K, kB>(ents, bytes, a, kB, tab, w.fp, col, accw);
      const int rest = held - a;
      uint32_t e = 0, bb = 0;
      if (lane < rest) {
        e = ents[a + lane];
        bb = bytes[a + lane];
      }
      __syncwarp();
      if (lane < rest) {
        ents[lane] = e;
        bytes[lane] = static_cast<uint8_t>(bb);
      }
      held = rest;
      __syncwarp();
    }
    if (held > 0)
      gather_add<K, kB>(ents, bytes, 0, held, tab, w.fp, col, accw);
    __syncwarp();

    float* obase = w.out + rr * w.out_level + m * w.out_m - w.out_shift;
    if (NP == 1) {
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float4 v =
              *reinterpret_cast<const float4*>(accw + b * kTile + kk * kRound);
          const float vs[4] = {v.x, v.y, v.z, v.w};
          float* o = obase + b * w.out_b;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cc = col + kk * kRound + c;
            if (cc < w.f) o[cc] = vs[c];
          }
        }
      clear_acc();
      __syncwarp();
      continue;
    }

    // The block's unit: add the warps' sums in the order 0..7.
    __syncthreads();
    if (after) {
      if (t == 0) {
        // Unit rr-1 of this m was taken before this one by a running
        // block, so the wait ends; the bound turns a fault into an error.
        long long spins = 0;
        while (seen < rr) {
          __nanosleep(100);
          if (++spins > (1ll << 27)) __trap();
          seen = load_acquire(turn + m);
        }
      }
      __syncthreads();
    }
    const int cols = min(kTile, w.f - col0);
    for (int idx = t; idx < 8 * cols; idx += kThreads) {
      const int b = idx / cols;
      const int cc = idx - b * cols;
      float s = accs[b * kTile + cc];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s += accs[(q * 8 + b) * kTile + cc];
      float* o = obase + b * w.out_b + col0 + cc;
      if (after) s = __ldcg(o) + s;
      __stcg(o, s);
    }
    __syncthreads();  // the sums are read; the unit ids are visible
    clear_acc();      // each lane its own, before its next adds
    if (kChain && t == 0) {
      __threadfence();
      store_release(turn + m, rr + 1);
    }
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bf16 table: out row s * row_step + r * level_step (r < levels) is
// in[r * stride_r + s * stride_s + c] rounded to bf16 (nearest even), for
// c < f, then zero up to fp.  One thread per pair of output columns.
template <typename T>
__global__ void __launch_bounds__(256)
    table_kernel(const T* __restrict__ in, long long stride_r,
                 long long stride_s, int levels, int s_pad, int f, int fp,
                 int row_step, int level_step, uint32_t* __restrict__ out) {
  const int pairs = fp >> 1;
  const long long total = static_cast<long long>(levels) * s_pad * pairs;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / pairs;  // (s, r) order: the cotangent's own
    const int c = static_cast<int>(i - row * pairs) * 2;
    const int s = static_cast<int>(row / levels);
    const int r = static_cast<int>(row - static_cast<long long>(s) * levels);
    const T* src = in + r * stride_r + static_cast<long long>(s) * stride_s;
    const float lo = c < f ? to_float(src[c]) : 0.f;
    const float hi = c + 1 < f ? to_float(src[c + 1]) : 0.f;
    const uint32_t v =
        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16;
    out[(static_cast<size_t>(s) * row_step + r * level_step) * pairs +
        (c >> 1)] = v;
  }
}

inline int make_table(const void* in, int in_is_bf16, long long stride_r,
                      long long stride_s, const Walk& w, int table_levels,
                      cudaStream_t stream) {
  uint32_t* out = reinterpret_cast<uint32_t*>(
      const_cast<__nv_bfloat16*>(w.tab));
  const long long total =
      static_cast<long long>(table_levels) * w.s_pad * (w.fp >> 1);
  const long long blocks = (total + 255) / 256;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  if (in_is_bf16)
    table_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(in), stride_r, stride_s,
        table_levels, w.s_pad, w.f, w.fp, w.row_step, w.level_step, out);
  else
    table_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(in), stride_r, stride_s, table_levels,
        w.s_pad, w.f, w.fp, w.row_step, w.level_step, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int NP, bool kChain>
int launch_k(const Walk& w, int tiles, cudaStream_t stream) {
  auto kernel = walk_kernel<K, NP, kChain>;
  const size_t smem = smem_bytes(K);
  static int blocks = 0;  // resident blocks on the card, found once
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  int grid = blocks / tiles;
  if (grid < 1) grid = 1;
  const int groups = (w.units + kWarps / NP - 1) / (kWarps / NP);
  if (grid > groups) grid = groups;
  kernel<<<dim3(grid, tiles), kThreads, smem, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// Zero the counters and turn flags, then launch the instance of the plan
// (ops/bitdense.py:walk_plan): k (1 or 2), np (1 or 8), tiles, and whether
// the units of one output row are chained (levels == 1 on bit_reduce).
inline int run(const Walk& w, int k, int np, int tiles, bool chain,
               cudaStream_t stream) {
  const size_t flags = static_cast<size_t>(tiles) * (1 + w.d8);
  cudaError_t e = cudaMemsetAsync(w.sync, 0, flags * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (chain && np != kWarps) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 1 && np == 1) return launch_k<1, 1, false>(w, tiles, stream);
  if (k == 2 && np == 1) return launch_k<2, 1, false>(w, tiles, stream);
  if (k == 1 && np == kWarps)
    return chain ? launch_k<1, kWarps, true>(w, tiles, stream)
                 : launch_k<1, kWarps, false>(w, tiles, stream);
  if (k == 2 && np == kWarps)
    return chain ? launch_k<2, kWarps, true>(w, tiles, stream)
                 : launch_k<2, kWarps, false>(w, tiles, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace BITWALK_NS
