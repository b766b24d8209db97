// Batched complex-to-complex FFT along axis -2 of [b, n, m]: the m columns
// of each n x m plane are the batch.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_axis0_core
// (its pl.pallas_call over _kernel_ax0 and _kernel_ax0_pipe) for pow2
// n = 2^7 .. 2^14.  For every column it computes
//
//     X[k, c] = scale * sum_i x[i, c] * exp(sign * 2*pi*i * k*i / n)
//
// in natural order, planar float32 (re, im) in and out, with no transpose
// in device memory.  It is pass 1 of the four-step (ops/fourstep.py) and the
// plan's route for axis -2 of a CUDA tensor.
//
// What bounds it: device memory, as for the row kernel (16 bytes of planar
// float32 read and written per point against about 5*log2(n) flops), and
// here also the access pattern: a column is strided by m in device memory.
// Each block takes a tile of TM neighbouring columns, so every load and
// store moves TM contiguous floats of one row of the plane (64 bytes at
// TM = 16, the 2^22 four-step split n = 1024), and holds the tile in shared
// memory as TM contiguous columns (n*TM*8 bytes <= 128 KB + padding; TM = 1
// at n = 16384).  A column is padded by one float so the tile's transposing
// load and store hit distinct banks.  The Stockham passes (stockham.cuh)
// then run on each column in place, one column per threadIdx.y, and the
// scale is folded into the store.  Columns past m (a ragged last tile) load
// zeros and are not stored.  Tiles are counted in gridDim.x, not gridDim.y
// (65535 at most).  A block reads its whole tile before it stores, and tiles
// are disjoint, so the output may alias the input.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// Columns per block: the tile holds at most 2^17 bytes of columns, and at
// most 32 columns (128 bytes of one row).
__host__ __device__ constexpr int ax0_cols(int log2n) {
  return min_int(32, (1 << 17) / (8 << log2n) > 0 ? (1 << 17) / (8 << log2n) : 1);
}

// Threads per column: 1024 per block in all.
__host__ __device__ constexpr int ax0_threads(int log2n) {
  return min_int(threads_for(log2n), 1024 / ax0_cols(log2n));
}

template <int LOG2N>
__global__ void __launch_bounds__(1024)
ax0_fft_kernel(const float* in_re, const float* in_im, float* out_re,
               float* out_im, const float2* __restrict__ tw, long long m,
               long long tiles, float sign, float scale) {
  constexpr int N = 1 << LOG2N;
  constexpr int TM = ax0_cols(LOG2N);
  constexpr int T = ax0_threads(LOG2N);
  constexpr int LD = N + 1;
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + TM * LD;
  const long long plane = blockIdx.x / tiles;
  const long long c0 = (blockIdx.x % tiles) * TM;
  const size_t base = static_cast<size_t>(plane) * N * m + c0;
  const int tid = threadIdx.y * T + threadIdx.x;
  for (int idx = tid; idx < N * TM; idx += T * TM) {
    const int i = idx / TM, c = idx % TM;
    const bool in = c0 + c < m;
    const size_t g = base + static_cast<size_t>(i) * m + c;
    sr[c * LD + i] = in ? in_re[g] : 0.f;
    si[c * LD + i] = in ? in_im[g] : 0.f;
  }
  __syncthreads();
  const Shared col{sr + threadIdx.y * LD, si + threadIdx.y * LD};
  fft_passes<LOG2N, T>(col, col, col, tw, sign);
  for (int idx = tid; idx < N * TM; idx += T * TM) {
    const int i = idx / TM, c = idx % TM;
    if (c0 + c < m) {
      const size_t g = base + static_cast<size_t>(i) * m + c;
      out_re[g] = sr[c * LD + i] * scale;
      out_im[g] = si[c * LD + i] * scale;
    }
  }
}

template <int LOG2N>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, long long planes, long long m,
                   float sign, float scale, cudaStream_t stream) {
  constexpr int TM = ax0_cols(LOG2N);
  constexpr int smem = 2 * TM * ((1 << LOG2N) + 1) * static_cast<int>(sizeof(float));
  const long long tiles = (m + TM - 1) / TM;
  if (planes * tiles > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ax0_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  ax0_fft_kernel<LOG2N><<<static_cast<unsigned>(planes * tiles),
                          dim3(ax0_threads(LOG2N), TM), smem, stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), m, tiles, sign, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms axis -2 of `planes` contiguous [n, m] planes, n = 2^log2n,
// planar float32.  tw holds n interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/n).  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
int ax0_fft_f32(const void* in_re, const void* in_im, void* out_re,
                void* out_im, const void* tw, long long planes, long long m,
                int log2n, int sign, float scale, void* stream) {
  if (planes < 1 || m < 1 || (sign != 1 && sign != -1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
    case 7: return launch<7>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 8: return launch<8>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 9: return launch<9>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 10: return launch<10>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 11: return launch<11>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 12: return launch<12>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 13: return launch<13>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    case 14: return launch<14>(in_re, in_im, out_re, out_im, tw, planes, m, sg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ax0_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
