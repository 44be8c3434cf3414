// bit_expand_matmul on Hopper (sm_90a): expand a bit-packed multi-link
// adjacency against a feature table.
//
//   out[r, b, m, f] = sum_s bit_b(P[r*d8 + m, s]) * bf16(x[s, f])
//
// P is (R*d8, S_pad) uint8; bit b of packed row r*d8+m, column s, is set
// iff destination b*d8+m has an edge with rating level r from source s.
// x is (S_pad, F), f32 or bf16; it is rounded to bf16 and summed in f32.
// out is (R, 8, d8, F) f32, the layout of the TPU kernel's output.
//
// Replaces: stargcn_tpu/ops/bitdense.py:_k1_kernel (bit_expand_matmul).
// That kernel unpacks all eight bit planes of a (bm, bs) block into bf16
// and feeds the matrix unit, carrying the sum across sequential grid
// steps over S.
//
// Bound on the H100: the packed operand has to be read once.  At ML-10M
// width (R=10, F=65) the user direction reads P (88320 x 11264, 0.995 GB)
// and writes 184 MB, about 0.35 ms at 3.35 TB/s; the item direction reads
// 0.995 GB and writes 29 MB, about 0.31 ms.  The arithmetic the data
// needs is one F-wide add per set bit (about 1e7 set bits per pack, 0.93%
// of the bytes non-zero), far below the memory time.  A dense bf16
// tensor-core expansion would be ~1.03e12 FLOP per launch, ~1.05 ms at
// 989 TFLOP/s, so the kernel skips zero bytes instead of expanding them.
//
// Design: a block of 8 warps owns 8/splits packed rows and every column of
// one feature tile; the `splits` warps of a row walk interleaved 512-byte
// steps of S with coalesced 16-byte loads, and their partial sums are added
// in a fixed order through shared memory.  No two blocks write the same
// output and no atomics are used, so the result does not depend on
// scheduling.  `splits` (1, 2, 4 or 8) grows while the card would still
// hold fewer than ~8 waves of warps and each warp keeps >= 4 steps: the
// item direction (14080 rows of 70656 bytes) needs the extra warps to keep
// enough loads in flight, the user direction (88320 short rows) does not.
// In a step, a ballot finds the lanes holding a non-zero byte; each such
// lane's 16 bytes are broadcast and, for every non-zero byte, the
// bf16-rounded source row is read once and added into the eight per-bit
// accumulators its set bits select.  Lane l keeps columns l, l+32, ... of
// all eight accumulators in registers (unrolled, so no local memory).  P is
// read with an evict-first hint so the streamed pack does not push x out
// of L2.  A dense P is still exact, only slower.  Columns past F (F=65 is
// odd) are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kColTile = 256;      // feature columns per grid.y tile
constexpr int kMaxK = kColTile / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kSplit: whether splits > 1.  The reduction costs registers, so the
// unsplit instances leave it out and keep more warps resident.
template <typename T, int K, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
bit_expand_kernel(const uint8_t* __restrict__ P, const T* __restrict__ x,
                  float* __restrict__ out, int m8, int s_pad, int f,
                  int d8, int splits) {
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
  for (int base = part * 32; base < n16; base += splits * 32) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base + lane < n16) v = __ldcs(prow + base + lane);
    unsigned lanes = __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
    while (lanes) {
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1u;
      uint32_t words[4];
      words[0] = __shfl_sync(0xffffffffu, v.x, src);
      words[1] = __shfl_sync(0xffffffffu, v.y, src);
      words[2] = __shfl_sync(0xffffffffu, v.z, src);
      words[3] = __shfl_sync(0xffffffffu, v.w, src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w = words[j];
        while (w) {
          const int p = (__ffs(w) - 1) >> 3;  // lowest non-zero byte
          const uint32_t byte = (w >> (8 * p)) & 0xffu;
          w &= ~(0xffu << (8 * p));
          const int s = ((base + src) << 4) + (j << 2) + p;
          const T* xr = x + static_cast<size_t>(s) * f;
          float xv[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = col0 + 32 * k;
            xv[k] = c < f ? bf16_round(__ldg(xr + c)) : 0.f;
          }
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            if (byte & (1u << b)) {
#pragma unroll
              for (int k = 0; k < K; ++k) acc[b][k] += xv[k];
            }
          }
        }
      }
    }
  }

  const int r = row / d8;
  const int m = row - r * d8;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if constexpr (kSplit) {
      // Part 0 adds parts 1..splits-1 in order: deterministic.
#pragma unroll
      for (int k = 0; k < K; ++k) red[warp][k][lane] = acc[b][k];
      __syncthreads();
      if (part == 0) {
        for (int q = 1; q < splits; ++q)
#pragma unroll
          for (int k = 0; k < K; ++k) acc[b][k] += red[warp + q][k][lane];
      }
      __syncthreads();
    }
    if (live && part == 0) {
      float* orow = out + ((static_cast<size_t>(r) * 8 + b) * d8 + m) * f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = col0 + 32 * k;
        if (c < f) orow[c] = acc[b][k];
      }
    }
  }
}

// Warps per packed row: see the design note above.
int pick_splits(int m8, int s_pad) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long resident_warps = static_cast<long long>(sms) * 64;
  const int steps = (s_pad >> 4) / 32;
  int splits = 1;
  while (splits < kWarps &&
         static_cast<long long>(m8) * splits * 2 <= 8 * resident_warps &&
         steps >= splits * 2 * 4)
    splits *= 2;
  return splits;
}

template <typename T>
void launch(const uint8_t* P, const T* x, float* out, int m8, int s_pad,
            int f, int d8, cudaStream_t stream) {
  const int splits = pick_splits(m8, s_pad);
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
          P, x, out, m8, s_pad, f, d8, splits);                           \
    else                                                                  \
      bit_expand_kernel<T, K, false><<<grid, block, 0, stream>>>(         \
          P, x, out, m8, s_pad, f, d8, 1);                                \
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
// m8 = R*d8 and f are positive, and that x is f32 (x_is_bf16 = 0) or
// bf16 (1).  Returns cudaGetLastError() after the launch.
extern "C" int bit_expand_matmul_launch(const void* P, const void* x,
                                        int x_is_bf16, void* out, int m8,
                                        int s_pad, int f, int d8,
                                        void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(P);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    launch(p, static_cast<const __nv_bfloat16*>(x), o, m8, s_pad, f, d8, st);
  } else {
    launch(p, static_cast<const float*>(x), o, m8, s_pad, f, d8, st);
  }
  return static_cast<int>(cudaGetLastError());
}
