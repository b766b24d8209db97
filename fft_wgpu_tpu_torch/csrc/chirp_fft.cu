// The two passes of Bluestein's algorithm and the chirp-z transform, one
// row per block, each an m-point FFT with its multiplies fused into the
// first pass's loads and the last pass's stores.
//
// Replaces the TPU kernels fft_wgpu_tpu/ops/pallas_fft.py::_fft_filt_pad_core
// (B11, its pl.pallas_call over _kernel_rows_bal_filt_pad) and
// ::_fft_filt_narrow_core (B12, over _kernel_rows_bal_filt_narrow).  For
// m = 2^7 .. 2^14:
//
//   chirp_fwd:  Y = FFT_m(zero_pad_m(h * x)),          x: rows of n_in <= m
//   chirp_inv:  y = g * (scale * FFT_m(H * x))[:n_out],  x: rows of m
//
// h is [n_in], H is [m], g is [n_out], planar float32, broadcast over rows;
// n_in and n_out are any lengths up to m (the TPU kernels needed multiples
// of 128, so their callers padded the tables and sliced the result).
//
// Both are the row kernel's Stockham passes (stockham.cuh, as in
// rows_fft.cu) with their own source and sink: ProductIn loads x[k]*h[k] for
// k < n_in and zeros beyond (the zero-pad is never written to device
// memory), ChirpOut stores only the k < n_out outputs, as
// scale*y[k]*g[k], into rows of n_out.  The TPU kernel also cut its stage-2
// product to the contributing outputs; a radix-4 Stockham pass has no such
// cut, so chirp_inv computes all m outputs and drops the rest at the store.
//
// What bounds them: device memory.  Each point of a row is read once and
// written once (chirp_fwd: 8 bytes per input point and per output point,
// m >= 2*n_in - 1 outputs; chirp_inv the reverse) against about
// 5*m*log2(m) flops per row.  A Bluestein transform of n points so moves
// about 3*m >= 6n complex points through device memory in two launches.
// The faster design holds the whole m-row in one block from the chirp
// through to the post-chirp (read n, write n); that is later work.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// The first n_out outputs, times scale and the table g, into a row of
// device memory; the others are dropped.
struct ChirpOut {
  float* r;
  float* i;
  const float* gr;
  const float* gi;
  int n_out;
  float scale;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (k >= n_out) return;
    a *= scale;
    b *= scale;
    const float g_r = __ldg(&gr[k]), g_i = __ldg(&gi[k]);
    r[k] = a * g_r - b * g_i;
    i[k] = a * g_i + b * g_r;
  }
};

template <int LOG2M>
__global__ void __launch_bounds__(threads_for(LOG2M))
chirp_fwd_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                 const float* __restrict__ hr, const float* __restrict__ hi,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 const float2* __restrict__ tw, int n_in, float sign) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ float smem[];
  const size_t in = static_cast<size_t>(blockIdx.x) * n_in;
  const size_t out = static_cast<size_t>(blockIdx.x) * M;
  fft_passes<LOG2M, threads_for(LOG2M)>(
      ProductIn{in_re + in, in_im + in, hr, hi, n_in}, Shared{smem, smem + M},
      GlobalOut{out_re + out, out_im + out, 1.f}, tw, sign);
}

template <int LOG2M>
__global__ void __launch_bounds__(threads_for(LOG2M))
chirp_inv_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                 const float* __restrict__ Hr, const float* __restrict__ Hi,
                 const float* __restrict__ gr, const float* __restrict__ gi,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 const float2* __restrict__ tw, int n_out, float sign, float scale) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ float smem[];
  const size_t in = static_cast<size_t>(blockIdx.x) * M;
  const size_t out = static_cast<size_t>(blockIdx.x) * n_out;
  fft_passes<LOG2M, threads_for(LOG2M)>(
      ProductIn{in_re + in, in_im + in, Hr, Hi, M}, Shared{smem, smem + M},
      ChirpOut{out_re + out, out_im + out, gr, gi, n_out, scale}, tw, sign);
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int LOG2M>
cudaError_t launch_fwd(const void* in_re, const void* in_im, const void* hr,
                       const void* hi, void* out_re, void* out_im, const void* tw,
                       long long rows, int n_in, float sign, cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2M) * static_cast<int>(sizeof(float));
  const cudaError_t e = prepare(chirp_fwd_kernel<LOG2M>, smem);
  if (e != cudaSuccess) return e;
  chirp_fwd_kernel<LOG2M><<<static_cast<unsigned>(rows), threads_for(LOG2M), smem,
                            stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<const float*>(hr), static_cast<const float*>(hi),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), n_in, sign);
  return cudaGetLastError();
}

template <int LOG2M>
cudaError_t launch_inv(const void* in_re, const void* in_im, const void* Hr,
                       const void* Hi, const void* gr, const void* gi, void* out_re,
                       void* out_im, const void* tw, long long rows, int n_out,
                       float sign, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2M) * static_cast<int>(sizeof(float));
  const cudaError_t e = prepare(chirp_inv_kernel<LOG2M>, smem);
  if (e != cudaSuccess) return e;
  chirp_inv_kernel<LOG2M><<<static_cast<unsigned>(rows), threads_for(LOG2M), smem,
                            stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<const float*>(Hr), static_cast<const float*>(Hi),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), n_out, sign, scale);
  return cudaGetLastError();
}

bool valid(long long rows, int log2m, int n, int sign) {
  return rows >= 1 && rows <= 2147483647LL && log2m >= 7 && log2m <= 14 && n >= 1 &&
         n <= (1 << log2m) && (sign == 1 || sign == -1);
}

}  // namespace

extern "C" {

// chirp_fwd over `rows` contiguous rows of n_in planar float32 points into
// rows of m = 2^log2m.  h holds n_in floats per plane; tw holds m
// interleaved (cos, sin) float32 pairs of exp(sign*2pi*i*j/m).  Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
int chirp_fwd_f32(const void* in_re, const void* in_im, const void* hr,
                  const void* hi, void* out_re, void* out_im, const void* tw,
                  long long rows, int n_in, int log2m, int sign, void* stream) {
  if (!valid(rows, log2m, n_in, sign)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2m) {
#define FWD_CASE(L) \
  case L:           \
    return launch_fwd<L>(in_re, in_im, hr, hi, out_re, out_im, tw, rows, n_in, sg, s);
    FWD_CASE(7) FWD_CASE(8) FWD_CASE(9) FWD_CASE(10)
    FWD_CASE(11) FWD_CASE(12) FWD_CASE(13) FWD_CASE(14)
#undef FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

// chirp_inv over `rows` contiguous rows of m = 2^log2m planar float32
// points into rows of n_out.  H holds m floats per plane, g n_out; tw as
// for chirp_fwd_f32.  Returns cudaGetLastError() (0 = ok).
int chirp_inv_f32(const void* in_re, const void* in_im, const void* Hr,
                  const void* Hi, const void* gr, const void* gi, void* out_re,
                  void* out_im, const void* tw, long long rows, int n_out,
                  int log2m, int sign, float scale, void* stream) {
  if (!valid(rows, log2m, n_out, sign)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2m) {
#define INV_CASE(L)                                                              \
  case L:                                                                        \
    return launch_inv<L>(in_re, in_im, Hr, Hi, gr, gi, out_re, out_im, tw, rows, \
                         n_out, sg, scale, s);
    INV_CASE(7) INV_CASE(8) INV_CASE(9) INV_CASE(10)
    INV_CASE(11) INV_CASE(12) INV_CASE(13) INV_CASE(14)
#undef INV_CASE
    default: return cudaErrorInvalidValue;
  }
}

const char* chirp_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
