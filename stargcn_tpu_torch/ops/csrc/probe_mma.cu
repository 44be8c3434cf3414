// probe_mma on Hopper (sm_90a): a grouped matrix product on the tensor
// cores, in bf16 -> f32 and in int8 -> int32, at the shapes of the TPU probe.
//
//   out[m, n] = sum_g sum_k A[g*M + m, k] * B[k, n]
//
// A is (G*M, K) and B (K, N), both row-major, both bf16 or both int8; out is
// (M, N) f32 or int32.  The probe asks whether the int8 tensor-core path runs
// at about twice the bf16 one on this card, as it does on paper.
//
// Replaces: scripts/probe_int8_mxu.py:run (its kernel at :26-40), which
// carries one (M, N) accumulator across G sequential grid steps, each a
// (M, K) x (K, N) jnp.dot on the matrix unit.
//
// Bound on the H100 at the probe's shapes (G = 512, M = 256, K = 1024,
// N = 256): A is read once, 268 MB in bf16 (80.1 us at 3.35 TB/s) and
// 134 MB in int8 (40.1 us), against 68.7 G multiply-adds x 2 = 68.7 GOP at
// 989 TFLOP/s (69.5 us) and 1,979 TOP/s (34.7 us).  So both types are bound
// by reading A, by a small margin: a kernel near its bound shows the ratio
// of the memory rates (2x), and one far from it the ratio of what the
// tensor-core path it uses delivers.
//
// Design (a simple kernel, right first: mma.sync through nvcuda::wmma, not
// wgmma or TMA).  The grid splits G over blocks so that the card fills (a
// 256 x 256 output has only 4 tiles of 64 x 256): block (i, j, c) owns
// output rows [64i, 64i+64), columns [256j, 256j+256) and the groups of
// chunk c.  For each 64-byte step of K it loads the (k-step x 256) slice of
// B once and keeps it in registers as wmma fragments, then streams the
// (64 x k-step) tiles of A of all its groups through a 4-stage cp.async ring
// in shared memory.  Eight warps each keep a 32 x 64 accumulator.  Each
// block writes its partial sum; a second kernel adds the partials of every
// output in chunk order, so f32 results do not depend on scheduling (no
// atomics).  Shared tiles are stored as 16-element-wide column chunks so
// every fragment pointer is 32-byte aligned for both element sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 256;        // output columns per block
constexpr int kKB = 64;         // bytes of K per step
constexpr int kStages = 4;      // A tiles in flight per block
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_mma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   typename AccOf<T>::type* __restrict__ part, int groups,
                   int m, int k, int n, int chunk) {
  using Acc = typename AccOf<T>::type;
  constexpr int kKT = kKB / static_cast<int>(sizeof(T));  // K per step
  constexpr int kKC = kKT / 16;                           // wmma k-chunks
  constexpr int kEpp = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int kStage = kBM * kKT;                       // elements
  // A stage: [kc][row][16]; B slice: [n chunk][k][16].
  __shared__ __align__(128) unsigned char a_raw[kStages * kStage * sizeof(T)];
  __shared__ __align__(128) unsigned char b_raw[kKT * kBN * sizeof(T)];
  T* const As = reinterpret_cast<T*>(a_raw);
  T* const Bs = reinterpret_cast<T*>(b_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;          // 0..1: rows wm*32 .. +32
  const int wn = warp & 3;           // 0..3: columns wn*64 .. +64
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g0 = blockIdx.z * chunk;
  const int ng = min(chunk, groups - g0);
  const int ksteps = k / kKT;
  const int tiles = ksteps * ng;

  // This thread's 16 bytes of every A tile.
  const int a_row = tid >> 2;
  const int a_e = (tid & 3) * kEpp;
  T* const a_dst = As + ((a_e >> 4) * kBM + a_row) * 16 + (a_e & 15);
  auto prefetch = [&](int t) {
    if (t < tiles) {
      const int ks = t / ng;
      const int g = g0 + (t - ks * ng);
      cp_async16(a_dst + (t % kStages) * kStage,
                 A + (static_cast<size_t>(g) * m + m0 + a_row) * k +
                     ks * kKT + a_e);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));
  wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[kKC][4];

  for (int t = 0; t < kStages - 1; ++t) prefetch(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t % ng == 0) {
      // A new step of K: its slice of B into shared memory, then into this
      // warp's fragments, which every group of the chunk reuses.
      const int k0 = (t / ng) * kKT;
      constexpr int kPpr = kBN / kEpp;  // 16-byte pieces per row
#pragma unroll
      for (int i = 0; i < kKT * kPpr / kThreads; ++i) {
        const int p = tid + i * kThreads;
        const int kk = p / kPpr;
        const int e = (p - kk * kPpr) * kEpp;
        *reinterpret_cast<uint4*>(Bs + ((e >> 4) * kKT + kk) * 16 +
                                  (e & 15)) =
            *reinterpret_cast<const uint4*>(
                B + static_cast<size_t>(k0 + kk) * n + n0 + e);
      }
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(bf[kc][j],
                                 Bs + ((wn * 4 + j) * kKT + kc * 16) * 16,
                                 16);
    }
    const T* stage = As + (t % kStages) * kStage;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i],
                               stage + (kc * kBM + wm * 32 + i * 16) * 16,
                               16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[kc][j], acc[i][j]);
    }
    prefetch(t + kStages - 1);
  }
  cp_async_wait<0>();

  Acc* dst = part + static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          dst + static_cast<size_t>(m0 + wm * 32 + i * 16) * n + n0 +
              wn * 64 + j * 16,
          acc[i][j], n, wmma::mem_row_major);
}

// out[i] = part[0][i] + part[1][i] + ... in chunk order.
template <typename Acc>
__global__ void sum_partials_kernel(const Acc* __restrict__ part,
                                    Acc* __restrict__ out, int chunks,
                                    int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  Acc s = part[i];
  for (int c = 1; c < chunks; ++c)
    s += part[static_cast<size_t>(c) * size + i];
  out[i] = s;
}

template <typename T>
int launch(const T* A, const T* B, typename AccOf<T>::type* part,
           typename AccOf<T>::type* out, int groups, int m, int k, int n,
           int chunk, int chunks, cudaStream_t stream) {
  const dim3 grid(m / kBM, n / kBN, chunks);
  grouped_mma_kernel<T><<<grid, kThreads, 0, stream>>>(A, B, part, groups,
                                                       m, k, n, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = m * n;
  sum_partials_kernel<<<(size + 255) / 256, 256, 0, stream>>>(part, out,
                                                               chunks, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked that
// A (groups*m, k) and B (k, n) are contiguous, 16-byte aligned and of one
// type (is_int8 = 0: bf16, 1: int8), that m % 64 == 0, n % 256 == 0 and
// k * element size % 64 == 0, that part holds chunks * m * n and out m * n
// elements of the sum's type (f32 or int32), and that chunk * chunks covers
// groups with chunk * (chunks - 1) < groups.  Returns cudaGetLastError()
// after the launches.
extern "C" int probe_mma_launch(const void* A, const void* B, int is_int8,
                                void* part, void* out, int groups, int m,
                                int k, int n, int chunk, int chunks,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return launch(static_cast<const signed char*>(A),
                  static_cast<const signed char*>(B), static_cast<int*>(part),
                  static_cast<int*>(out), groups, m, k, n, chunk, chunks, st);
  return launch(static_cast<const __nv_bfloat16*>(A),
                static_cast<const __nv_bfloat16*>(B),
                static_cast<float*>(part), static_cast<float*>(out), groups, m,
                k, n, chunk, chunks, st);
}
