// Batched real-to-complex FFT along the last axis through a half-length
// complex FFT.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_rfft_rows_core
// (its pl.pallas_call over _kernel_r2c_bal, _kernel_r2c_pipe and
// _kernel_r2c) for pow2 n = 2^7 .. 2^14.  Per real row x of n points it
// computes the half spectrum
//
//     X[k] = scale * sum_j x[j] * exp(-2*pi*i * k*j / n),   k = 0 .. n/2,
//
// planar float32 out, in rows of `bins` floats: n/2 + 1 (numpy's shape,
// unaligned rows) or the padded serving form pad_bins(n) with exact zeros
// past bin n/2.
//
// The n real points are read as m = n/2 complex points z[j] = x[2j] +
// i x[2j+1] by the first Stockham pass (stockham.cuh), the m-point forward
// transform Z runs in shared memory, and the store recombines
//
//     X[k] = (Z[k] + conj(Z[m-k]))/2 - (i/2) t[k] (Z[k] - conj(Z[m-k])),
//
// with Z[m] = Z[0] and t[k] = exp(-2*pi*i*k/n) from a float32 table
// generated in float64 on the host (the math of
// fft_wgpu_tpu/ops/rfft.py::_rfft_even_split, in one pass).  The TPU kernel
// contracted with real DFT matrices because Mosaic has no lane reverse;
// Z[m-k] is a reversed read of shared memory here.
//
// What bounds it: device memory, 4 bytes read and 8*(n/2+1)/n written per
// point against about 2.5*log2(n) flops.  Each row lives in shared memory
// (n*4 bytes, 32 KB at n = 16384).  Rows of fewer than 512 points share a
// block (RB rows, one per threadIdx.y) so that a block has 128 threads;
// rows past the last load zeros and store nothing.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// Rows per block: enough that a block has at least 128 threads.
__host__ __device__ constexpr int r2c_rows(int log2m) {
  return threads_for(log2m) >= 128 ? 1 : 128 / threads_for(log2m);
}

// Row r read as m complex points z[k] = x[2k] + i x[2k+1].
struct PairedRealIn {
  const float* x;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (!valid) {
      a = b = 0.f;
      return;
    }
    a = x[2 * k];
    b = x[2 * k + 1];
  }
};

template <int LOG2M>
__global__ void __launch_bounds__(threads_for(LOG2M) * r2c_rows(LOG2M))
r2c_fft_kernel(const float* __restrict__ in, float* __restrict__ out_re,
               float* __restrict__ out_im, const float2* __restrict__ tw,
               const float2* __restrict__ half, long long rows, int bins,
               float scale) {
  constexpr int M = 1 << LOG2M;
  constexpr int T = threads_for(LOG2M);
  extern __shared__ float smem[];
  float* sr = smem + threadIdx.y * 2 * M;
  float* si = sr + M;
  const long long r = static_cast<long long>(blockIdx.x) * r2c_rows(LOG2M) + threadIdx.y;
  const bool valid = r < rows;
  const Shared z{sr, si};
  fft_passes<LOG2M, T>(
      PairedRealIn{in + static_cast<size_t>(valid ? r : 0) * 2 * M, valid}, z, z,
      tw, -1.f);
  // The passes end with a barrier: Z is in shared memory for the whole row.
  if (!valid) return;
  const size_t o = static_cast<size_t>(r) * bins;
  for (int k = threadIdx.x; k < bins; k += T) {
    float xr = 0.f, xi = 0.f;
    if (k <= M) {
      const int a = k & (M - 1), b = (M - k) & (M - 1);
      const float er = 0.5f * (sr[a] + sr[b]), ei = 0.5f * (si[a] - si[b]);
      const float dr = 0.5f * (sr[a] - sr[b]), di = 0.5f * (si[a] + si[b]);
      const float2 t = __ldg(&half[k]);
      xr = (er + (t.x * di + t.y * dr)) * scale;
      xi = (ei - (t.x * dr - t.y * di)) * scale;
    }
    out_re[o + k] = xr;
    out_im[o + k] = xi;
  }
}

template <int LOG2M>
cudaError_t launch(const void* in, void* out_re, void* out_im, const void* tw,
                   const void* half, long long rows, int bins, float scale,
                   cudaStream_t stream) {
  constexpr int RB = r2c_rows(LOG2M);
  constexpr int smem = RB * 2 * (1 << LOG2M) * static_cast<int>(sizeof(float));
  const long long blocks = (rows + RB - 1) / RB;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        r2c_fft_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  r2c_fft_kernel<LOG2M><<<static_cast<unsigned>(blocks),
                          dim3(threads_for(LOG2M), RB), smem, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out_re),
      static_cast<float*>(out_im), static_cast<const float2*>(tw),
      static_cast<const float2*>(half), rows, bins, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// R2C of `rows` contiguous real rows of n = 2^(log2m + 1) float32 points
// into planar rows of `bins` >= n/2 + 1 floats (zeros past bin n/2).  tw
// holds m = n/2 interleaved (cos, sin) float32 pairs of exp(-2pi*i*j/m),
// half holds m + 1 pairs of exp(-2pi*i*k/n).  Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
int r2c_fft_f32(const void* in, void* out_re, void* out_im, const void* tw,
                const void* half, long long rows, int log2m, int bins,
                float scale, void* stream) {
  if (rows < 1 || log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define R2C_CASE(L) \
  case L:           \
    return launch<L>(in, out_re, out_im, tw, half, rows, bins, scale, s);
    R2C_CASE(6) R2C_CASE(7) R2C_CASE(8) R2C_CASE(9)
    R2C_CASE(10) R2C_CASE(11) R2C_CASE(12) R2C_CASE(13)
#undef R2C_CASE
    default: return cudaErrorInvalidValue;
  }
}

const char* r2c_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
