// probe_mma on Hopper (sm_90a): a grouped matrix product on the tensor
// cores, in bf16 -> f32 and in int8 -> int32, at the shapes of the TPU probe.
//
//   out[m, n] = sum_g sum_k A[g*M + m, k] * B[k, n]
//
// A is (G*M, K) and B (K, N), both row-major, both bf16 or both int8; out is
// (M, N) f32 or int32.  The probe asks whether the int8 tensor-core path runs
// at about twice the bf16 one on this card, as it does on paper, so every one
// of the 2*G*M*K*N operations runs on the tensor cores (summing A over the
// groups first would give the same out and answer nothing).
//
// Replaces: scripts/probe_int8_mxu.py:run (its kernel at :26-40), which
// carries one (M, N) accumulator across G sequential grid steps, each a
// (M, K) x (K, N) jnp.dot on the matrix unit.
//
// Bound on the H100 at the probe's shapes (G = 512, M = 256, K = 1024,
// N = 256): A is read once, 268 MB in bf16 (80.1 us at 3.35 TB/s) and
// 134 MB in int8 (40.1 us), against 68.7 GOP at 989 TFLOP/s (69.5 us) and
// 1,979 TOP/s (34.7 us).  Both types are bound by reading A, by a small
// margin, so the kernel has to keep the A stream and the tensor cores busy
// at once.
//
// Design: TMA loads under mbarriers feed wgmma, with warp specialisation.
// Block (i, j, c) owns output rows [128i, 128i+128), columns [256j, 256j+256)
// and the groups of chunk c; the plan (probes/probe_int8_mma.py:launch_plan)
// sizes the chunks so that about one block runs on each SM.
// - Warpgroup 2 is the producer: after setmaxnreg gives its registers away,
//   one thread walks K in stages of 256 bytes (two 128-byte k-steps) on the
//   outside and the chunk's groups on the inside.  For each stage of K it
//   loads the (256 bytes x 256) slab of B once, into one of two slab
//   buffers; for each (stage, group) the 128 x 256-byte tile of A into a
//   ring of kAStages stages, as 64-row boxes of one k-step each (half of
//   them where the tile has only 64 rows), a row's two k-steps asked for one
//   after the other.  Every load is a TMA box with the 128-byte swizzle and
//   256-byte L2 promotion (a stage's two boxes of a row fill one 256-byte
//   line); A is marked evict-first in L2, B evict-last, so B's slab crosses
//   L2 once per chunk and stays there.
// - Warpgroups 0 and 1 are the consumers, 64 rows each: per A stage eight
//   wgmma.mma_async m64n256 (k16 for bf16, k32 for s8) into a 64 x 256
//   accumulator of 128 registers a thread, kept across all stages and
//   groups.  A stage is handed back to the producer once the next stage's
//   wgmma group is issued and the previous one has completed.
// - Operands: A is K-major as it lies.  bf16 B (K, N) is read as it lies
//   through the descriptor's transpose bit (MN-major: 64-column boxes
//   8 KB apart, LBO 8192, SBO 1024).  s8 wgmma takes K-major operands only,
//   so a small kernel first writes B^T (N, K) into the workspace; that pass
//   is part of the launch and of its time.
// - Each block writes its partial tile; a second kernel adds the partials
//   of every output in a fixed order, so f32 results do not depend on
//   scheduling and repeat bit for bit (no atomics).  With one chunk the
//   block writes out directly.
// The constants below were chosen on the card with
// probes/probe_mma_sweep.py, which builds this file with one of them
// changed at a time (PERF.md records its runs).
// Every wait on an mbarrier gives up after two seconds with a trap: a fault
// in the pipeline becomes a launch error, not a hung card.

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;             // output rows per block (2 x 64)
constexpr int kBN = 256;             // output columns per block
constexpr int kKB = 128;             // bytes of a k-step: one swizzle row
constexpr int kSub = 2;              // k-steps per stage
constexpr int kAStages = 3;          // A stages in flight per block
constexpr int kBSlabs = 2;           // B slabs in flight per block
constexpr int kTile = 64 * kKB;      // 8 KB: 64 rows of one k-step
constexpr int kAHalf = kSub * kTile;  // one consumer's rows of an A stage
constexpr int kAStage = 2 * kAHalf;  // 32 KB
constexpr int kBSub = kBN * kKB;     // 32 KB: one k-step of B
constexpr int kBSlab = kSub * kBSub;  // 64 KB
constexpr int kBarriers = 2 * kAStages + 2 * kBSlabs;
// 1 KB of slack to align the tiles to the swizzle's 1024-byte period.
constexpr int kSmemBytes =
    1024 + kAStages * kAStage + kBSlabs * kBSlab + 8 * kBarriers;
constexpr int kThreads = 384;        // consumers: warpgroups 0, 1; producer 2
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;  // L2 cache hints
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;
constexpr unsigned long long kWaitNs = 2000000000ull;

template <bool kInt8> struct AccOf;
template <> struct AccOf<false> { using type = float; using vec2 = float2; using vec4 = float4; };
template <> struct AccOf<true> { using type = int; using vec2 = int2; using vec4 = int4; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Arrive where pred is non-zero: one predicated instruction, no branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(pred)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// D (64 x 256) += A (64 x 16, K-major) * B (16 x 256, MN-major), bf16 in,
// f32 accumulate.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 256) += A (64 x 32, K-major) * B (32 x 256, K-major), s8 in, s32
// accumulate (the form above, at twice the K per instruction).
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving reads of the accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
grouped_mma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   typename AccOf<kInt8>::type* __restrict__ part, int groups,
                   int m, int n, int ksteps, int chunk) {
  using Acc = typename AccOf<kInt8>::type;
  using Acc2 = typename AccOf<kInt8>::vec2;
  extern __shared__ unsigned char smem_raw[];
  // Tiles on the swizzle's 1024-byte period: the descriptors' base offset
  // is then 0.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_base = (raw + 1023u) & ~1023u;
  const uint32_t b_base = a_base + kAStages * kAStage;
  const uint32_t bars = b_base + kBSlabs * kBSlab;
  auto a_full = [&](int s) { return bars + 8u * s; };
  auto a_empty = [&](int s) { return bars + 8u * (kAStages + s); };
  auto b_full = [&](int s) { return bars + 8u * (2 * kAStages + s); };
  auto b_empty = [&](int s) {
    return bars + 8u * (2 * kAStages + kBSlabs + s);
  };

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g0 = blockIdx.z * chunk;
  const int ng = min(chunk, groups - g0);
  const int halves = min(2, (m - m0) / 64);  // consumers with rows: 1 or 2
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(a_full(s), 1);
      mbar_init(a_empty(s), halves);
    }
    for (int s = 0; s < kBSlabs; ++s) {
      mbar_init(b_full(s), 1);
      mbar_init(b_empty(s), halves);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      tma_prefetch(&map_a);
      tma_prefetch(&map_b);
      const int a_bytes = halves * kAHalf;
      int t = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int bs = ks % kBSlabs;
        mbar_wait(b_empty(bs), ((ks / kBSlabs) & 1) ^ 1);
        mbar_expect_tx(b_full(bs), kBSlab);
        const uint32_t b_dst = b_base + bs * kBSlab;
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          const int step = ks * kSub + sub;
          if (kInt8) {
            // B^T (N, K): 256 rows of 128 bytes of K.
            tma_load_2d(b_dst + sub * kBSub, &map_b, b_full(bs), step * kKB,
                        n0, kEvictLast);
          } else {
            // B (K, N): four boxes of 64 k-rows x 64 columns (128 bytes).
#pragma unroll
            for (int c = 0; c < 4; ++c)
              tma_load_2d(b_dst + sub * kBSub + c * (kBSub / 4), &map_b,
                          b_full(bs), n0 + 64 * c, step * (kKB / 2),
                          kEvictLast);
          }
        }
        constexpr int kStepElems = kInt8 ? kKB : kKB / 2;
        const int kc = ks * kSub * kStepElems;
        for (int gi = 0; gi < ng; ++gi, ++t) {
          const int s = t % kAStages;
          mbar_wait(a_empty(s), ((t / kAStages) & 1) ^ 1);
          mbar_expect_tx(a_full(s), a_bytes);
          const int row = (g0 + gi) * m + m0;
          // A row's k-steps of a stage are asked for one after the other.
          for (int h = 0; h < halves; ++h)
#pragma unroll
            for (int sub = 0; sub < kSub; ++sub)
              tma_load_2d(a_base + s * kAStage + h * kAHalf + sub * kTile,
                          &map_a, a_full(s), kc + sub * kStepElems,
                          row + 64 * h, kEvictFirst);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    if (wg >= halves) return;
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    const int leader = (threadIdx.x % 128) == 0;
    int t = 0;
    int prev_a = -1, prev_b = -1;  // buffers to hand back after the next wait
    for (int ks = 0; ks < ksteps; ++ks) {
      const int bs = ks % kBSlabs;
      mbar_wait(b_full(bs), (ks / kBSlabs) & 1);
      const uint32_t b_addr = b_base + bs * kBSlab;
      for (int gi = 0; gi < ng; ++gi, ++t) {
        const int s = t % kAStages;
        mbar_wait(a_full(s), (t / kAStages) & 1);
        const uint32_t a_addr = a_base + s * kAStage + wg * kAHalf;
        wgmma_fence();
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // A: 8-row groups 1024 bytes apart; each k-slice is 32 bytes on.
            const uint64_t da =
                smem_desc(a_addr + sub * kTile + 32 * kk, 16, 1024);
            const uint32_t b_sub = b_addr + sub * kBSub;
            if constexpr (kInt8) {
              wgmma_s8(acc, da, smem_desc(b_sub + 32 * kk, 16, 1024));
            } else {
              // B MN-major: 64-column boxes 8192 bytes apart (LBO), 8
              // k-rows 1024 bytes apart (SBO); each k16 slice is 16 rows on.
              wgmma_bf16(acc, da, smem_desc(b_sub + 2048 * kk, 8192, 1024));
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev_a >= 0) mbar_arrive_if(a_empty(prev_a), leader);
        if (prev_b >= 0) mbar_arrive_if(b_empty(prev_b), leader);
        prev_a = s;
        prev_b = gi == ng - 1 ? bs : -1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Fragment layout of m64nNk16/k32: warp w holds rows 16w..16w+15; lane
    // l row l/4 (and +8), columns 8j + 2(l%4) (and +1) for j = 0..31.
    const int lane = threadIdx.x % 32;
    const int row = m0 + wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    Acc* dst = part + static_cast<size_t>(blockIdx.z) * m * n +
               static_cast<size_t>(row) * n + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      Acc2 lo, hi;
      lo.x = acc[4 * j];
      lo.y = acc[4 * j + 1];
      hi.x = acc[4 * j + 2];
      hi.y = acc[4 * j + 3];
      *reinterpret_cast<Acc2*>(dst + 8 * j) = lo;
      *reinterpret_cast<Acc2*>(dst + static_cast<size_t>(8) * n + 8 * j) = hi;
    }
  }
}

// B^T for the s8 route: bt (N, K) from b (K, N), in 64 x 64 tiles of 256
// threads, each of which loads one 16-byte piece of b and stores one of bt.
__global__ void transpose_s8_kernel(const signed char* __restrict__ b,
                                    signed char* __restrict__ bt, int k,
                                    int n) {
  __shared__ unsigned char tile[64][65];  // [k][n], padded
  const int k0 = blockIdx.y * 64;
  const int n0 = blockIdx.x * 64;
  const int r = threadIdx.x / 4, q = (threadIdx.x % 4) * 16;
  const uint4 in = *reinterpret_cast<const uint4*>(
      b + static_cast<size_t>(k0 + r) * n + n0 + q);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&in);
#pragma unroll
  for (int j = 0; j < 16; ++j) tile[r][q + j] = bytes[j];
  __syncthreads();
  uint4 o;
  unsigned char* ob = reinterpret_cast<unsigned char*>(&o);
#pragma unroll
  for (int j = 0; j < 16; ++j) ob[j] = tile[q + j][r];  // bt row n0 + r
  *reinterpret_cast<uint4*>(bt + static_cast<size_t>(n0 + r) * k + k0 + q) =
      o;
}

// out[i] = the sum of part[c][i] over the chunks c, four outputs a thread
// and kSumSplit threads an output: thread q adds chunks [q C / kSumSplit,
// (q + 1) C / kSumSplit) in order, then thread 0 adds the kSumSplit sums
// in order.  The order is fixed by C alone, so results repeat bit for bit;
// more threads an output keep more loads in flight against L2's latency.
template <typename V>
__device__ __forceinline__ void add4(V& s, const V& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

constexpr int kSumSplit = 4;                 // threads an output
constexpr int kSumOutputs = 128 / kSumSplit;  // outputs a block of 128

template <typename V>
__global__ void __launch_bounds__(128)
sum_partials_kernel(const V* __restrict__ part, V* __restrict__ out,
                    int chunks, int size4) {
  __shared__ V sums[kSumSplit][kSumOutputs];
  const int o = threadIdx.x % kSumOutputs;
  const int q = threadIdx.x / kSumOutputs;
  const int i = blockIdx.x * kSumOutputs + o;
  if (i < size4) {
    const int lo = q * chunks / kSumSplit, hi = (q + 1) * chunks / kSumSplit;
    const V* p = part + i;
    V s = {};
    int c = lo;
    for (; c + 8 <= hi; c += 8) {
      V v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = p[static_cast<size_t>(c + j) * size4];
#pragma unroll
      for (int j = 0; j < 8; ++j) add4(s, v[j]);
    }
    for (; c < hi; ++c) add4(s, p[static_cast<size_t>(c) * size4]);
    sums[q][o] = s;
  }
  __syncthreads();
  if (q == 0 && i < size4) {
    V s = sums[0][o];
#pragma unroll
    for (int j = 1; j < kSumSplit; ++j) add4(s, sums[j][o]);
    out[i] = s;
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no libcuda at link time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// A 2-D map of a row-major (rows, cols) matrix of esize-byte elements,
// loaded in (box_rows, box_cols) boxes with the 128-byte swizzle; parts of a
// box outside the matrix read as zeros.
bool encode_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
               bool int8, int rows, int cols, int box_rows, int box_cols) {
  const int esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kInt8>
int launch(const void* A, const void* B, void* bt, void* part, void* out,
           int groups, int m, int k, int n, int chunk, int chunks,
           cudaStream_t stream) {
  using Acc = typename AccOf<kInt8>::type;
  using Acc4 = typename AccOf<kInt8>::vec4;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int esize = kInt8 ? 1 : 2;
  CUtensorMap map_a, map_b;
  bool ok = encode_2d(encode, &map_a, A, kInt8, groups * m, k, 64,
                      kKB / esize);
  if (kInt8) {
    transpose_s8_kernel<<<dim3(n / 64, k / 64), 256, 0, stream>>>(
        static_cast<const signed char*>(B), static_cast<signed char*>(bt), k,
        n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ok = ok && encode_2d(encode, &map_b, bt, true, n, k, kBN, kKB);
  } else {
    ok = ok && encode_2d(encode, &map_b, B, false, k, n, kKB / 2, 64);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = grouped_mma_kernel<kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ksteps = (k * esize + kSub * kKB - 1) / (kSub * kKB);
  Acc* dst = static_cast<Acc*>(chunks == 1 ? out : part);
  kernel<<<dim3((m + kBM - 1) / kBM, n / kBN, chunks), kThreads, kSmemBytes,
           stream>>>(map_a, map_b, dst, groups, m, n, ksteps, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int size4 = m * n / 4;
  sum_partials_kernel<<<(size4 + kSumOutputs - 1) / kSumOutputs, 128, 0,
                        stream>>>(
      static_cast<const Acc4*>(part), static_cast<Acc4*>(out), chunks, size4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller
// (probes/probe_int8_mma.py:grouped_matmul, from launch_plan) has checked
// that A (groups*m, k) and B (k, n) are contiguous, 16-byte aligned and of
// one type (is_int8 = 0: bf16, 1: int8), that m % 64 == 0, n % 256 == 0 and
// k * element size % 64 == 0, that part holds chunks * m * n and out m * n
// elements of the sum's type (f32 or int32), bt n * k bytes (int8 only),
// that chunk * chunks covers groups with chunk * (chunks - 1) < groups, and
// that smem_bytes is this kernel's dynamic shared memory.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue where
// smem_bytes disagrees or a tensor map cannot be encoded).
extern "C" int probe_mma_launch(const void* A, const void* B, int is_int8,
                                void* bt, void* part, void* out, int groups,
                                int m, int k, int n, int chunk, int chunks,
                                int smem_bytes, void* stream) {
  if (smem_bytes != kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return launch<true>(A, B, bt, part, out, groups, m, k, n, chunk, chunks,
                        st);
  return launch<false>(A, B, bt, part, out, groups, m, k, n, chunk, chunks,
                       st);
}
