// Batched complex-to-complex FFT along the last axis for composite lengths
// that are not powers of two, one row per block.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_rows_gen_core
// (its pl.pallas_call over _kernel_rows_gen).  For n = n1 * n2 in
// 512 .. 16384, not a power of two, with the split (n1, n2) of
// _choose_general_split (n1 <= n2 <= 256, least n1 + n2), it computes per row
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, planar float32 (re, im) in and out, in one pass over
// device memory: the row is read into shared memory, both stages of
// gen_fft.cuh run there, and stage 2 stores X with the scale folded in.
//
// The TPU kernel contracted both factors on the MXU after a transpose into
// the sublane axis.  Here both stages are direct sums in float32 FMAs on the
// CUDA cores (see gen_fft.cuh), n*(n1 + n2) complex multiply-adds per row:
// 4095 = 63 * 65 costs 128 per point, 4097 = 17 * 241 costs 258.
//
// What bounds it: those sums, not device memory.  At 4097 x 1024 they are
// 8.7 GFLOP, 0.13 ms at the 67 TFLOP/s of float32 of an H100 SXM at its
// 700 W limit (data sheet), against 0.020 ms to move the 67 MB in and out
// at its 3.35 TB/s; and every multiply-add also reads two floats of shared
// memory.  This first design keeps the row in shared memory (at most 132 KB
// at n = 16383), one block per row, kGenPer outputs per thread; making the
// stages faster (register blocking over k1, a radix split of the factors) is
// later work.

#include <cuda_runtime.h>

#include "gen_fft.cuh"

namespace {

using namespace fftk;

__global__ void __launch_bounds__(kGenMaxThreads)
gen_fft_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
               float* __restrict__ out_re, float* __restrict__ out_im,
               const float2* __restrict__ tw, int n1, int n2, float scale) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const int P = gen_pitch(n2);
  float* sr = smem;
  float* si = smem + n1 * P;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  gen_load(in_re + off, sr, n1, n2, P);
  gen_load(in_im + off, si, n1, n2, P);
  __syncthreads();
  gen_stage1<false>(sr, si, n1, n2, P, tw);
  gen_stage2(sr, si, n1, n2, P, n, tw, RowOut{out_re + off, out_im + off, scale});
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = n1 * n2 planar float32 points.
// tw holds n interleaved (cos, sin) float32 pairs of exp(sign*2pi*i*m/n):
// the sign of the transform is the table's.  Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
int gen_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                const void* tw, long long rows, int n1, int n2, float scale,
                void* stream) {
  if (rows < 1 || rows > 2147483647LL || n1 < 2 || n2 < n1 || n2 > 256 ||
      n1 * n2 > kGenPer * kGenMaxThreads) {
    return cudaErrorInvalidValue;
  }
  const int smem = gen_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gen_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  gen_fft_kernel<<<static_cast<unsigned>(rows), gen_threads(n1 * n2), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), n1, n2, scale);
  return cudaGetLastError();
}

const char* gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
