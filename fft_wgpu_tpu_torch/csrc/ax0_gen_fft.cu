// Batched complex-to-complex FFT along axis -2 of [b, n, m] for composite
// lengths that are not powers of two: the m columns of each n x m plane are
// the batch.
//
// Replaces the composite range of the TPU kernel
// fft_wgpu_tpu/ops/pallas_fft.py::_fft_axis0_core (its pl.pallas_call over
// _kernel_ax0 with the split of _choose_general_split; ax0_fft.cu ports its
// pow2 range).  For n = n1 * n2 in 512 .. 16384, not a power of two,
// n1 <= n2 <= 256 (least n1 + n2), it computes for every column
//
//     X[k, c] = scale * sum_i x[i, c] * exp(sign * 2*pi*i * k*i / n)
//
// in natural order, planar float32 (re, im) in and out, with no transpose
// in device memory.  It is the plan's route for a composite axis -2 of a
// CUDA tensor, and, on the free view [..., n, Y*Z], for axes before it.
//
// Each block takes a tile of TM neighbouring columns, loaded and stored
// row-contiguous as in ax0_fft.cu (TM contiguous floats of one row of the
// plane per load and store), and holds each column in shared memory as the
// n1 x n2 matrix of gen_fft.cuh with its odd pitch P, at an odd column
// stride, so the tile's transposing load and store hit distinct banks.
// gen_fft.cuh's stages then run per column, threadIdx.y the column and
// blockDim.x threads each: stage 1 in place as for the rows, stage 2 in
// place too, so the column ends in natural order in shared memory and the
// tile's store writes rows coalesced (a per-output store straight to device
// memory would stride by m).  Columns past m (a ragged last tile) compute
// on zeros and are not stored, so every thread reaches every barrier.
// Shared memory: TM * 2 * (n1*P | 1) * 4 bytes, at most 2^17 bytes of
// columns (TM = 1 and 1024 threads at n = 16383).  A block reads its whole
// tile before it stores, and tiles are disjoint, so the output may alias
// the input.
//
// What bounds it: the direct sums, n*(n1 + n2) complex multiply-adds per
// column (1080 = 30 * 36: 66 per point, 17.5 GFLOP for 16 x 1080 x 1920),
// as for gen_fft.cu, not device memory (16 bytes per point); making the
// stages faster (register blocking, a radix split of the factors) is
// later work, shared with the row kernels.

#include <cuda_runtime.h>

#include "gen_fft.cuh"

namespace {

using namespace fftk;

// Floats between two columns of the tile: the n1 x P matrix, odd.
__host__ __device__ inline int ax0_gen_ld(int n1, int n2) {
  return (n1 * gen_pitch(n2)) | 1;
}

// Columns per block: at most 32 (128 bytes of one row), at most 1024
// threads, at most 2^17 bytes of columns, and at least one.
int ax0_gen_cols(int n1, int n2) {
  const int per_col = 2 * ax0_gen_ld(n1, n2) * static_cast<int>(sizeof(float));
  int tm = kGenMaxThreads / gen_threads(n1 * n2);
  tm = tm < 32 ? tm : 32;
  tm = tm < (1 << 17) / per_col ? tm : (1 << 17) / per_col;
  return tm > 1 ? tm : 1;
}

__global__ void __launch_bounds__(kGenMaxThreads)
ax0_gen_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                   float* out_im, const float2* __restrict__ tw, int n1, int n2,
                   long long m, long long tiles, float scale) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const int P = gen_pitch(n2);
  const int LD = ax0_gen_ld(n1, n2);
  const int TM = blockDim.y;
  float* sr = smem;
  float* si = smem + TM * LD;
  const long long plane = blockIdx.x / tiles;
  const long long c0 = (blockIdx.x % tiles) * TM;
  const size_t base = static_cast<size_t>(plane) * n * m + c0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * TM;
  // element i = j1*n2 + j2 of column c to A[j1][j2] of its matrix
  for (int idx = tid; idx < n * TM; idx += nt) {
    const int i = idx / TM, c = idx - (idx / TM) * TM;
    const int j1 = i / n2;
    const int d = c * LD + j1 * P + (i - j1 * n2);
    const bool in = c0 + c < m;
    const size_t g = base + static_cast<size_t>(i) * m + c;
    sr[d] = in ? in_re[g] : 0.f;
    si[d] = in ? in_im[g] : 0.f;
  }
  __syncthreads();
  float* cr = sr + threadIdx.y * LD;
  float* ci = si + threadIdx.y * LD;
  gen_stage1<false>(cr, ci, n1, n2, P, tw);
  gen_stage2_in_place(cr, ci, n1, n2, P, scale, tw);
  // X[k] of column c is now at c*LD + k
  for (int idx = tid; idx < n * TM; idx += nt) {
    const int k = idx / TM, c = idx - (idx / TM) * TM;
    if (c0 + c < m) {
      const size_t g = base + static_cast<size_t>(k) * m + c;
      out_re[g] = sr[c * LD + k];
      out_im[g] = si[c * LD + k];
    }
  }
}

}  // namespace

extern "C" {

// Transforms axis -2 of `planes` contiguous [n, m] planes, n = n1 * n2,
// planar float32.  tw holds n interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/n): the sign of the transform is the table's.  Launches
// on `stream` and returns cudaGetLastError() (0 = ok).
int ax0_gen_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                    const void* tw, long long planes, long long m, int n1, int n2,
                    float scale, void* stream) {
  if (planes < 1 || m < 1 || n1 < 2 || n2 < n1 || n2 > 256 ||
      n1 * n2 > kGenPer * kGenMaxThreads) {
    return cudaErrorInvalidValue;
  }
  const int tm = ax0_gen_cols(n1, n2);
  const long long tiles = (m + tm - 1) / tm;
  if (planes * tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int smem = tm * 2 * ax0_gen_ld(n1, n2) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ax0_gen_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  ax0_gen_fft_kernel<<<static_cast<unsigned>(planes * tiles),
                       dim3(gen_threads(n1 * n2), tm), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), n1, n2, m, tiles, scale);
  return cudaGetLastError();
}

const char* ax0_gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
