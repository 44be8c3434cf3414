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
// the TPU's pairing explicitly, one output element per thread.
//
// Bound on the H100: M*S bytes read and M*S bytes written, 16 KB at the
// probe's size (about 5 ns at 3.35 TB/s); the launch itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void probe_bitcast_kernel(const uint8_t* __restrict__ v,
                                     uint16_t* __restrict__ out,
                                     int half_rows, int cols) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(half_rows) * cols) return;
  const long long k = i / cols;
  const long long s = i - k * cols;
  const uint8_t lo = v[(2 * k) * cols + s];
  const uint8_t hi = v[(2 * k + 1) * cols + s];
  out[i] = static_cast<uint16_t>(lo | (hi << 8));
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The caller has checked that v
// is a contiguous (2 * half_rows, cols) uint8 matrix and out a contiguous
// (half_rows, cols) 16-bit one.  Returns cudaGetLastError() after the
// launch.
extern "C" int probe_bitcast_launch(const void* v, void* out, int half_rows,
                                    int cols, void* stream) {
  const long long total = static_cast<long long>(half_rows) * cols;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  probe_bitcast_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(v), static_cast<uint16_t*>(out), half_rows,
      cols);
  return static_cast<int>(cudaGetLastError());
}
