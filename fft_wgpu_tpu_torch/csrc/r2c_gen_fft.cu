// Batched real-to-complex FFT along the last axis for composite lengths
// that are not powers of two, odd and even, one row per block.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_rfft_gen_core
// (its pl.pallas_call over _kernel_r2c_gen).  For n = n1 * n2 in the
// envelope of gen_fft.cu it computes per real row x the half spectrum
//
//     X[k] = scale * sum_m x[m] * exp(-2*pi*i * k*m / n),   k <= n/2,
//
// planar float32 out, in rows of `bins` floats: n/2 + 1 (numpy's shape) or
// the padded serving form pad_bins(n) with exact zeros past bin n/2.
//
// It is gen_fft.cu with a real row: stage 1 reads only the real plane (half
// the multiply-adds of the complex stage), and stage 2 computes only the
// bins k < n/2 + 1, as the TPU kernel cut its stage-2 product to the
// ceil((n/2 + 1)/n1) contributing k2 rows.  Unlike the half-length packing
// of r2c_fft.cu it needs no even n.
//
// What bounds it: the direct sums of gen_fft.cuh, n*n1/2 + (n/2)*n2 complex
// multiply-adds per row, on the CUDA cores; device memory moves 4 bytes in
// and about 4 bytes out per point.  A simple first design: one block per
// row, the row in shared memory.

#include <cuda_runtime.h>

#include "gen_fft.cuh"

namespace {

using namespace fftk;

__global__ void __launch_bounds__(kGenMaxThreads)
r2c_gen_fft_kernel(const float* __restrict__ in, float* __restrict__ out_re,
                   float* __restrict__ out_im, const float2* __restrict__ tw,
                   int n1, int n2, int bins, float scale) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const int P = gen_pitch(n2);
  const int mp = n / 2 + 1;
  float* sr = smem;
  float* si = smem + n1 * P;
  gen_load(in + static_cast<size_t>(blockIdx.x) * n, sr, n1, n2, P);
  __syncthreads();
  gen_stage1<true>(sr, si, n1, n2, P, tw);
  const size_t o = static_cast<size_t>(blockIdx.x) * bins;
  gen_stage2(sr, si, n1, n2, P, mp, tw, RowOut{out_re + o, out_im + o, scale});
  for (int k = mp + threadIdx.x; k < bins; k += blockDim.x) {
    out_re[o + k] = 0.f;
    out_im[o + k] = 0.f;
  }
}

}  // namespace

extern "C" {

// R2C of `rows` contiguous real rows of n = n1 * n2 float32 points into
// planar rows of `bins` >= n/2 + 1 floats (zeros past bin n/2).  tw holds n
// interleaved (cos, sin) float32 pairs of exp(-2pi*i*m/n).  Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
int r2c_gen_fft_f32(const void* in, void* out_re, void* out_im, const void* tw,
                    long long rows, int n1, int n2, int bins, float scale,
                    void* stream) {
  if (rows < 1 || rows > 2147483647LL || n1 < 2 || n2 < n1 || n2 > 256 ||
      n1 * n2 > kGenPer * kGenMaxThreads || bins < n1 * n2 / 2 + 1) {
    return cudaErrorInvalidValue;
  }
  const int smem = gen_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        r2c_gen_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  r2c_gen_fft_kernel<<<static_cast<unsigned>(rows), gen_threads(n1 * n2), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out_re),
      static_cast<float*>(out_im), static_cast<const float2*>(tw), n1, n2, bins,
      scale);
  return cudaGetLastError();
}

const char* r2c_gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
