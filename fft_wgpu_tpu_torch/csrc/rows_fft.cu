// Batched complex-to-complex FFT along the last axis, one row per block.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_batched_core
// (its one pl.pallas_call over _kernel_rows_bal, _kernel_rows_bal_pipe,
// _kernel and _kernel_rows_dit).  Per row of n = 2^7 .. 2^14 points it
// computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, planar float32 (re, im) in and out.
//
// What bounds it: device memory.  Each point is read once and written once,
// 16 bytes of planar float32, against about 5*log2(n) flops, well under the
// card's float32 flop-per-byte balance (an H100 SXM has 3.35 TB/s of device
// memory for 67 TFLOP/s of float32 on the CUDA cores, data sheet).  One row
// per block keeps every intermediate out of device memory, as the
// VMEM-resident TPU kernel did: the first pass reads the row from device
// memory into registers, the passes in between go through the row held in
// dynamic shared memory (2 * n * 4 bytes, 128 KB at n = 16384), and the last
// pass stores from registers to device memory with the scale folded in.
//
// A ping-pong pair of shared buffers would need 256 KB at n = 16384, more
// than the 227 KB a block may hold, so the row lives in one buffer: each
// pass reads all of its radix-r inputs into registers, synchronises, and
// then writes the Stockham autosort positions.  Because a block has read its
// whole row before it stores any of it, the output may alias the input (the
// plan's donate=True runs in place).
//
// The passes are those of stockham.cuh: radix 4, with one radix-2 pass
// first when log2(n) is odd, on the CUDA cores in float32 FMAs.  Twiddles
// come from a per-(n, sign) float32 table of the n-th roots of unity
// generated in float64 on the host.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// The output may alias the input, so the row pointers carry no __restrict__.
template <int LOG2N>
__global__ void __launch_bounds__(threads_for(LOG2N))
rows_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw, float sign,
                float scale) {
  constexpr int N = 1 << LOG2N;
  constexpr int T = threads_for(LOG2N);
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + N;
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  fft_passes<LOG2N, T>(GlobalIn{in_re + off, in_im + off}, Shared{sr, si},
                       GlobalOut{out_re + off, out_im + off, scale}, tw, sign);
}

template <int LOG2N>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, long long rows, float sign,
                   float scale, cudaStream_t stream) {
  constexpr int N = 1 << LOG2N;
  constexpr int smem = 2 * N * static_cast<int>(sizeof(float));
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  rows_fft_kernel<LOG2N><<<static_cast<unsigned>(rows), threads_for(LOG2N),
                           smem, stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), sign, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points.
// tw holds n interleaved (cos, sin) float32 pairs of exp(sign*2pi*i*m/n).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int rows_fft_f32(const void* in_re, const void* in_im, void* out_re,
                 void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  if (rows < 1 || rows > 2147483647LL || (sign != 1 && sign != -1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
    case 7: return launch<7>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 8: return launch<8>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 9: return launch<9>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 10: return launch<10>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 11: return launch<11>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 12: return launch<12>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 13: return launch<13>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 14: return launch<14>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rows_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
