// Row FFT with the four-step outer twiddle at load and a transposed store:
// [b, R, n] -> [b, n, R].
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_rows_t_core
// (its pl.pallas_call over _kernel_rows_t_bal and _kernel_rows_t) for pow2
// n = 2^7 .. 2^14.  Row r of each plane is first multiplied by
// w^(r*m) = exp(sign * 2*pi*i * r*m / outer_n) when an outer table is given,
// then transformed as by the row kernel, and stored transposed:
//
//     out[b, k, r] = scale * sum_m w^(r*m) x[b, r, m] exp(sign*2*pi*i*k*m/n)
//
// This is pass 2 of the four-step (ops/fourstep.py): with R = n1 rows of
// n2 points and outer_n = n1*n2, the output viewed flat is the natural-order
// transform of length n1*n2.
//
// What bounds it: device memory (16 bytes per point read and written), and
// here two gathers.  The outer twiddle is read from a float32 table of the
// outer_n-th roots generated in float64 (32 MiB at outer_n = 2^22), at the
// index (r*m) mod outer_n reduced in 64-bit integers, so a row reads the
// table at stride r; the table mostly stays in the 50 MB L2.  The
// transposed store has stride R: one block holds TR rows (TR*n*8 bytes
// <= 128 KB + padding: TR = 8 up to n = 2048, 4 at n = 4096, 1 at
// n = 16384), so each store moves TR contiguous floats (32 bytes, one
// sector, at TR = 8).  The first pass reads each row from device memory
// with the twiddle applied, the passes run in shared memory (stockham.cuh),
// and the tile is stored transposed with the scale folded in, from a buffer
// padded by one float per row so the transposing read hits distinct banks.
// Rows past R (a ragged last tile) load zeros and are not stored.  The
// global row index comes from blockIdx, so a row's twiddle never depends on
// how the rows were tiled.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// Rows per block: at most 2^17 bytes of rows, and at most 8 rows.
__host__ __device__ constexpr int rows_t_rows(int log2n) {
  return min_int(8, (1 << 17) / (8 << log2n) > 0 ? (1 << 17) / (8 << log2n) : 1);
}

// Threads per row: at most 1024 per block.
__host__ __device__ constexpr int rows_t_threads(int log2n) {
  return min_int(threads_for(log2n), 1024 / rows_t_rows(log2n));
}

// Row r of the input, times w^((r*m) mod outer_n) at load (outer may be null).
struct TwiddledRowIn {
  const float* r;
  const float* i;
  const float2* outer;
  unsigned long long row;
  unsigned long long outer_n;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (!valid) {
      a = b = 0.f;
      return;
    }
    a = r[k];
    b = i[k];
    if (outer != nullptr) cmul(a, b, __ldg(&outer[row * k % outer_n]));
  }
};

template <int LOG2N>
__global__ void __launch_bounds__(1024)
rows_t_fft_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  const float2* __restrict__ tw, const float2* __restrict__ outer,
                  long long outer_n, long long rows, long long tiles, float sign,
                  float scale) {
  constexpr int N = 1 << LOG2N;
  constexpr int TR = rows_t_rows(LOG2N);
  constexpr int T = rows_t_threads(LOG2N);
  constexpr int LD = N + 1;
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + TR * LD;
  const long long plane = blockIdx.x / tiles;
  const long long r0 = (blockIdx.x % tiles) * TR;
  const long long r = r0 + threadIdx.y;
  const bool valid = r < rows;
  const size_t off = (static_cast<size_t>(plane) * rows + (valid ? r : 0)) * N;
  const Shared row{sr + threadIdx.y * LD, si + threadIdx.y * LD};
  fft_passes<LOG2N, T>(
      TwiddledRowIn{in_re + off, in_im + off, outer,
                    static_cast<unsigned long long>(r),
                    static_cast<unsigned long long>(outer_n), valid},
      row, row, tw, sign);
  const size_t base = static_cast<size_t>(plane) * N * rows + r0;
  for (int idx = threadIdx.y * T + threadIdx.x; idx < N * TR; idx += T * TR) {
    const int k = idx / TR, t = idx % TR;
    if (r0 + t < rows) {
      const size_t g = base + static_cast<size_t>(k) * rows + t;
      out_re[g] = sr[t * LD + k] * scale;
      out_im[g] = si[t * LD + k] * scale;
    }
  }
}

template <int LOG2N>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, const void* outer,
                   long long outer_n, long long planes, long long rows,
                   float sign, float scale, cudaStream_t stream) {
  constexpr int TR = rows_t_rows(LOG2N);
  constexpr int smem = 2 * TR * ((1 << LOG2N) + 1) * static_cast<int>(sizeof(float));
  const long long tiles = (rows + TR - 1) / TR;
  if (planes * tiles > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_t_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  rows_t_fft_kernel<LOG2N><<<static_cast<unsigned>(planes * tiles),
                             dim3(rows_t_threads(LOG2N), TR), smem, stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), static_cast<const float2*>(outer),
      outer_n, rows, tiles, sign, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms the `rows` rows of n = 2^log2n points of each of `planes`
// contiguous [rows, n] planes and stores each plane as [n, rows], planar
// float32.  tw holds n interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/n); outer, when not null, holds outer_n pairs of
// exp(sign*2pi*i*k/outer_n).  The output must not alias the input.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int rows_t_fft_f32(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, const void* outer,
                   long long outer_n, long long planes, long long rows,
                   int log2n, int sign, float scale, void* stream) {
  if (planes < 1 || rows < 1 || (sign != 1 && sign != -1) ||
      (outer != nullptr && outer_n < 1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
#define ROWS_T_CASE(L)                                                          \
  case L:                                                                       \
    return launch<L>(in_re, in_im, out_re, out_im, tw, outer, outer_n, planes, \
                     rows, sg, scale, s);
    ROWS_T_CASE(7) ROWS_T_CASE(8) ROWS_T_CASE(9) ROWS_T_CASE(10)
    ROWS_T_CASE(11) ROWS_T_CASE(12) ROWS_T_CASE(13) ROWS_T_CASE(14)
#undef ROWS_T_CASE
    default: return cudaErrorInvalidValue;
  }
}

const char* rows_t_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
