// Batched complex-to-real FFT along the last axis through a half-length
// complex FFT.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_irfft_rows_core
// (its pl.pallas_call over _kernel_c2r_bal, _kernel_c2r_pipe and
// _kernel_c2r) for pow2 n = 2^7 .. 2^14 (the TPU kernel starts at 2^8).
// Per half spectrum X[0 .. n/2], planar float32 in rows of `bins` floats
// (n/2 + 1, or the padded serving form pad_bins(n) whose pad columns are
// never read), it computes the real row
//
//     x[j] = scale * sum_{k<n} Xh[k] * exp(+2*pi*i * k*j / n),
//
// Xh the Hermitian extension of X, with the imaginary parts of the DC and
// Nyquist bins ignored (numpy's irfft is scale = 1/n).
//
// The reverse of r2c_fft.cu: the first Stockham pass (stockham.cuh) forms
//
//     Z[k] = (X[k] + conj(X[m-k])) + i t[k] (X[k] - conj(X[m-k])),  k < m,
//
// with m = n/2 and t[k] = exp(+2*pi*i*k/n) from a float32 table generated
// in float64, at load from device memory; the m-point inverse runs in
// shared memory, and the last pass stores z[j] interleaved as
// x[2j] = Re z[j], x[2j+1] = Im z[j] with the scale folded in (the math of
// fft_wgpu_tpu/ops/rfft.py::_irfft_even_split without its halving, which
// the 1/m it pairs with undoes).
//
// The product C2R (c2r_prod_fft_f32) replaces the TPU kernel
// fft_wgpu_tpu/ops/pallas_fft.py::irfft_prod_rows_split (B8, its
// pl.pallas_call over _kernel_c2r_bal_prod), the fftconvolve / oaconvolve
// epilogue: the same C2R of X = A * B, with the complex product formed for
// both X[k] and X[m-k] at load, so it is never written to device memory.
// B is a spectrum of A's shape, or one row broadcast over every row of A
// (its row index fixed at 0).  The DC and Nyquist imaginary parts are taken
// off the product, not off A or B (numpy's irfft of A * B).  The packing is
// one source templated on how a bin is read (Bins or ProductBins), so both
// entry points share it.
//
// What bounds it: device memory, 8*(n/2+1)/n bytes read and 4 written per
// point; the product reads both spectra (134 MB read and 67 MB written at
// 2048 x 8192 with equal shapes).  A row lives in shared memory (n*4
// bytes); rows of fewer than 512 points share a block (one per
// threadIdx.y, 128 threads a block), and rows past the last load zeros and
// store nothing.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// Rows per block: enough that a block has at least 128 threads.
__host__ __device__ constexpr int c2r_rows(int log2m) {
  return threads_for(log2m) >= 128 ? 1 : 128 / threads_for(log2m);
}

// Bin k of one half-spectrum row as stored.
struct Bins {
  const float* r;
  const float* i;
  __device__ __forceinline__ void get(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
};

// Bin k of the product A * B of two half-spectrum rows.
struct ProductBins {
  const float* ar;
  const float* ai;
  const float* br;
  const float* bi;
  __device__ __forceinline__ void get(int k, float& a, float& b) const {
    const float a_r = ar[k], a_i = ai[k], b_r = br[k], b_i = bi[k];
    a = a_r * b_r - a_i * b_i;
    b = a_r * b_i + a_i * b_r;
  }
};

// Z[k] of row r, formed at load from X[k] and X[m-k].
template <class Spectrum>
struct HalfSpectrumIn {
  Spectrum x;
  const float2* half;
  int m;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (!valid) {
      a = b = 0.f;
      return;
    }
    float ar, ai, br, bi;
    x.get(k, ar, ai);
    x.get(m - k, br, bi);
    if (k == 0) ai = bi = 0.f;  // DC with Nyquist: both imaginary parts are ignored
    const float er = ar + br, ei = ai - bi;
    const float dr = ar - br, di = ai + bi;
    const float2 t = __ldg(&half[k]);
    a = er - (t.x * di + t.y * dr);
    b = ei + (t.x * dr - t.y * di);
  }
};

// The real row, z[k] stored as x[2k] = Re, x[2k+1] = Im, times the scale,
// in one 8-byte store (the wrapper allocates the output, so rows of an
// even number of floats are 8-byte aligned).
struct InterleavedOut {
  float* x;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (valid) reinterpret_cast<float2*>(x)[k] = make_float2(a * scale, b * scale);
  }
};

// PROD: the row's spectrum is A * B (b_stride floats between B's rows: 0
// for a broadcast B); else it is A alone and B is not read.
template <int LOG2M, bool PROD>
__global__ void __launch_bounds__(threads_for(LOG2M) * c2r_rows(LOG2M))
c2r_fft_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
               const float* __restrict__ br, const float* __restrict__ bi,
               float* __restrict__ out, const float2* __restrict__ tw,
               const float2* __restrict__ half, long long rows, int bins,
               long long b_stride, float scale) {
  constexpr int M = 1 << LOG2M;
  constexpr int T = threads_for(LOG2M);
  extern __shared__ float smem[];
  float* sr = smem + threadIdx.y * 2 * M;
  float* si = sr + M;
  const long long r = static_cast<long long>(blockIdx.x) * c2r_rows(LOG2M) + threadIdx.y;
  const bool valid = r < rows;
  const size_t i = static_cast<size_t>(valid ? r : 0) * bins;
  const size_t o = static_cast<size_t>(valid ? r : 0) * 2 * M;
  const Shared s{sr, si};
  const InterleavedOut dst{out + o, scale, valid};
  if constexpr (PROD) {
    const size_t j = static_cast<size_t>((valid ? r : 0) * b_stride);
    fft_passes<LOG2M, T>(
        HalfSpectrumIn<ProductBins>{{ar + i, ai + i, br + j, bi + j}, half, M, valid},
        s, dst, tw, 1.f);
  } else {
    fft_passes<LOG2M, T>(HalfSpectrumIn<Bins>{{ar + i, ai + i}, half, M, valid}, s,
                         dst, tw, 1.f);
  }
}

template <int LOG2M, bool PROD>
cudaError_t launch(const void* ar, const void* ai, const void* br, const void* bi,
                   void* out, const void* tw, const void* half, long long rows,
                   int bins, long long b_stride, float scale, cudaStream_t stream) {
  constexpr int RB = c2r_rows(LOG2M);
  constexpr int smem = RB * 2 * (1 << LOG2M) * static_cast<int>(sizeof(float));
  const long long blocks = (rows + RB - 1) / RB;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        c2r_fft_kernel<LOG2M, PROD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  c2r_fft_kernel<LOG2M, PROD><<<static_cast<unsigned>(blocks),
                                dim3(threads_for(LOG2M), RB), smem, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai),
      static_cast<const float*>(br), static_cast<const float*>(bi),
      static_cast<float*>(out), static_cast<const float2*>(tw),
      static_cast<const float2*>(half), rows, bins, b_stride, scale);
  return cudaGetLastError();
}

template <bool PROD>
int run(const void* ar, const void* ai, const void* br, const void* bi, void* out,
        const void* tw, const void* half, long long rows, int log2m, int bins,
        long long b_stride, float scale, void* stream) {
  if (rows < 1 || log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define C2R_CASE(L)                                                                 \
  case L:                                                                           \
    return launch<L, PROD>(ar, ai, br, bi, out, tw, half, rows, bins, b_stride,    \
                           scale, s);
    C2R_CASE(6) C2R_CASE(7) C2R_CASE(8) C2R_CASE(9)
    C2R_CASE(10) C2R_CASE(11) C2R_CASE(12) C2R_CASE(13)
#undef C2R_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C2R of `rows` planar half-spectrum rows of `bins` >= n/2 + 1 floats
// (bins 0..n/2 read) into contiguous real rows of n = 2^(log2m + 1)
// float32 points.  tw holds m = n/2 interleaved (cos, sin) float32 pairs
// of exp(+2pi*i*j/m), half holds at least m pairs of exp(+2pi*i*k/n).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int c2r_fft_f32(const void* in_re, const void* in_im, void* out, const void* tw,
                const void* half, long long rows, int log2m, int bins,
                float scale, void* stream) {
  return run<false>(in_re, in_im, nullptr, nullptr, out, tw, half, rows, log2m, bins,
                    0, scale, stream);
}

// C2R of the products A * B: A as the input of c2r_fft_f32, B rows of the
// same `bins`, `b_rows` of them: 1 (broadcast over A's rows) or `rows`.
int c2r_prod_fft_f32(const void* ar, const void* ai, const void* br, const void* bi,
                     void* out, const void* tw, const void* half, long long rows,
                     long long b_rows, int log2m, int bins, float scale, void* stream) {
  if (b_rows != 1 && b_rows != rows) return cudaErrorInvalidValue;
  return run<true>(ar, ai, br, bi, out, tw, half, rows, log2m, bins,
                   b_rows == 1 ? 0 : bins, scale, stream);
}

const char* c2r_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
