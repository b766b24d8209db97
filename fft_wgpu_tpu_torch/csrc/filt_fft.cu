// Batched complex-to-complex FFT along the last axis with a filter multiply
// fused into its loads, one row per block: the spectral filter and the
// filter bank.
//
// Replaces the TPU kernels fft_wgpu_tpu/ops/pallas_fft.py::_fft_filtered_core
// (B9, its pl.pallas_call over _kernel_rows_bal_filt and _kernel_filt) and
// ::_fft_bank_core (B10, over _kernel_rows_bal_bank and _kernel_bank).  For
// n = 2^7 .. 2^14, planar float32:
//
//   filt:  y[r] = scale * FFT_sign(x[r] * h)      x: [rows, n], h: [n]
//   bank:  y[s] = scale * FFT_sign(x * h[s])      x: [n],       h: [S, n]
//
// Both are the row kernel's Stockham passes (stockham.cuh, as in
// rows_fft.cu) whose first pass loads through ProductIn, x[k] * h[k] (the
// source chirp_fft.cu's forward pass uses).  They differ only in which
// operand moves with the block: row r of the filter reads x at r*n and h
// at 0, row s of the bank reads x at 0 and h at s*n.  So the product is
// never written to device memory, and the bank's signal is never
// materialised at [S, n]; the scale is folded into the last pass's store.
//
// What bounds them: device memory, as for the row kernel: per row, 8 bytes
// read per point of the operand that moves and 8 written, the shared
// operand (one row) read from L2.  The bank of the CWT plan, S = 128 rows
// of n = 16384, is one wave of 128 blocks (one an SM: a 128 KB row, 1024
// threads) on the H100's 132 SMs, so one block's seven passes set its
// time, not bytes; splitting a row over a thread-block cluster, as
// big_fft.cu does, would fill the card, and is later work.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

template <int LOG2N>
__global__ void __launch_bounds__(threads_for(LOG2N))
filt_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ hr, const float* __restrict__ hi,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const float2* __restrict__ tw, long long x_stride,
                long long h_stride, float sign, float scale) {
  constexpr int N = 1 << LOG2N;
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const size_t xo = static_cast<size_t>(r * x_stride);
  const size_t ho = static_cast<size_t>(r * h_stride);
  const size_t o = static_cast<size_t>(r) * N;
  fft_passes<LOG2N, threads_for(LOG2N)>(
      ProductIn{xr + xo, xi + xo, hr + ho, hi + ho, N}, Shared{smem, smem + N},
      GlobalOut{out_re + o, out_im + o, scale}, tw, sign);
}

template <int LOG2N>
cudaError_t launch(const void* xr, const void* xi, const void* hr, const void* hi,
                   void* out_re, void* out_im, const void* tw, long long rows,
                   long long x_stride, long long h_stride, float sign, float scale,
                   cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2N) * static_cast<int>(sizeof(float));
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filt_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  filt_fft_kernel<LOG2N><<<static_cast<unsigned>(rows), threads_for(LOG2N), smem,
                           stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(hr), static_cast<const float*>(hi),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), x_stride, h_stride, sign, scale);
  return cudaGetLastError();
}

// `rows` output rows of n = 2^log2n; row r reads x at r*x_stride and h at
// r*h_stride (floats of each plane).
int run(const void* xr, const void* xi, const void* hr, const void* hi, void* out_re,
        void* out_im, const void* tw, long long rows, int log2n, long long x_stride,
        long long h_stride, int sign, float scale, void* stream) {
  if (rows < 1 || rows > 2147483647LL || (sign != 1 && sign != -1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
#define FILT_CASE(L)                                                          \
  case L:                                                                     \
    return launch<L>(xr, xi, hr, hi, out_re, out_im, tw, rows, x_stride,      \
                     h_stride, sg, scale, s);
    FILT_CASE(7) FILT_CASE(8) FILT_CASE(9) FILT_CASE(10)
    FILT_CASE(11) FILT_CASE(12) FILT_CASE(13) FILT_CASE(14)
#undef FILT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// filt over `rows` contiguous rows x of n = 2^log2n planar float32 points,
// each times the one row h of n floats per plane.  tw holds n interleaved
// (cos, sin) float32 pairs of exp(sign*2pi*i*j/n).  Launches on `stream`
// and returns cudaGetLastError() (0 = ok).
int filt_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                 void* out_re, void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  return run(xr, xi, hr, hi, out_re, out_im, tw, rows, log2n, 1LL << log2n, 0, sign,
             scale, stream);
}

// bank over `rows` contiguous filter rows h of n = 2^log2n planar float32
// points, each times the one signal row x.  tw as for filt_fft_f32.
int bank_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                 void* out_re, void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  return run(xr, xi, hr, hi, out_re, out_im, tw, rows, log2n, 0, 1LL << log2n, sign,
             scale, stream);
}

const char* filt_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
