// probe_bitcast on Hopper (sm_90a): the u16 row-pair view of a u8 block.
//
//   out[k, s] = v[2k, s] | v[2k + 1, s] << 8
//
// v is (M, S) uint8 with M even, out (M/2, S) uint16, both row-major.
//
// Replaces: scripts/probe_bitcast.py:33-40, a Pallas kernel whose body is
// pltpu.bitcast(x, uint16).  On the TPU that bitcast of a (32, 256) u8 block
// gives (16, 256) u16 with the low byte from row 2k and the high byte from
// row 2k + 1: the hardware pairs adjacent sublanes (the (32, 128) column
// pairing is refused).  The TPU's 16-bit bitdense kernels rely on it, and
// pack_bits(row_interleave=bm) orders the rows for it.  Nothing on this card
// pairs rows: a u16 load here reads two adjacent bytes of one row,
// little-endian (the probe prints that reading too), so this kernel forms
// the TPU's pairing explicitly.
//
// Bound on the H100: M*S bytes read and M*S bytes written, 16 KB at the
// probe's size (about 5 ns at 3.35 TB/s); the launch itself dominates, so
// the wrapper's host path (probes/probe_bitcast.py:row_pair_u16) is kept
// lean.  Each thread makes 8 outputs from two 8-byte loads, one from each
// row of its pair, interleaved with __byte_perm into one 16-byte store.
// Where S % 8 != 0 or v is not 8-byte aligned, the same kernel reads and
// writes one element a thread instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kWide>
__global__ void probe_bitcast_kernel(const uint8_t* __restrict__ v,
                                     uint16_t* __restrict__ out,
                                     int half_rows, int cols) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kWide) {
    // Thread i: output row k, columns [8c, 8c + 8).
    const int per_row = cols / 8;
    if (i >= static_cast<long long>(half_rows) * per_row) return;
    const long long k = i / per_row;
    const long long s = (i - k * per_row) * 8;
    const uint2 lo = *reinterpret_cast<const uint2*>(v + 2 * k * cols + s);
    const uint2 hi =
        *reinterpret_cast<const uint2*>(v + (2 * k + 1) * cols + s);
    // Byte j of a word pair: lo byte j, then hi byte j.
    uint4 w;
    w.x = __byte_perm(lo.x, hi.x, 0x5140);
    w.y = __byte_perm(lo.x, hi.x, 0x7362);
    w.z = __byte_perm(lo.y, hi.y, 0x5140);
    w.w = __byte_perm(lo.y, hi.y, 0x7362);
    *reinterpret_cast<uint4*>(out + k * cols + s) = w;
  } else {
    if (i >= static_cast<long long>(half_rows) * cols) return;
    const long long k = i / cols;
    const long long s = i - k * cols;
    const uint8_t lo = v[(2 * k) * cols + s];
    const uint8_t hi = v[(2 * k + 1) * cols + s];
    out[i] = static_cast<uint16_t>(lo | (hi << 8));
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked that v
// is a contiguous (2 * half_rows, cols) uint8 matrix and out a contiguous
// (half_rows, cols) 16-bit one, 16-byte aligned.  Returns cudaGetLastError()
// after the launch.
extern "C" int probe_bitcast_launch(const void* v, void* out, int half_rows,
                                    int cols, void* stream) {
  const bool wide =
      cols % 8 == 0 && reinterpret_cast<uintptr_t>(v) % 8 == 0;
  const long long total =
      static_cast<long long>(half_rows) * cols / (wide ? 8 : 1);
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(v);
  uint16_t* dst = static_cast<uint16_t*>(out);
  if (wide)
    probe_bitcast_kernel<true><<<blocks, threads, 0, st>>>(src, dst,
                                                           half_rows, cols);
  else
    probe_bitcast_kernel<false><<<blocks, threads, 0, st>>>(src, dst,
                                                            half_rows, cols);
  return static_cast<int>(cudaGetLastError());
}
