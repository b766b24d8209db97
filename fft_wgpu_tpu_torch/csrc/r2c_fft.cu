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
// into either of two layouts: planar float32 rows of `bins` floats
// (r2c_fft_f32; n/2 + 1, numpy's shape, or the padded serving form
// pad_bins(n) with exact zeros past bin n/2), or interleaved complex64 rows
// of n/2 + 1 points, one 8-byte pair a bin (r2c_fft_c64, the torch
// complex64 tensor that rfft returns, so the caller needs no merge).
//
// The n real points are read as m = n/2 complex points z[j] = x[2j] +
// i x[2j+1], one 8-byte load a point, by the first pass; the m-point
// forward transform Z runs on mixed_fft.cuh's compiled plan for m
// (plan_fft; 2048 = 16*16*8) over the row held in shared memory as padded
// interleaved pairs (PadShared), m/16 threads a row and 16 points a thread,
// with each pass's twiddles in a table of its own (the host's
// ops/cuda_fft.py::_pass_roots_np(m, -1)); the last pass leaves Z in shared
// memory, and the store recombines
//
//     X[k] = (Z[k] + conj(Z[m-k]))/2 - (i/2) t[k] (Z[k] - conj(Z[m-k])),
//
// with Z[m] = Z[0] and t[k] = exp(-2*pi*i*k/n) from a float32 table
// generated in float64 on the host (the math of
// fft_wgpu_tpu/ops/rfft.py::_rfft_even_split, in one pass), the scale
// folded in.  The TPU kernel contracted with real DFT matrices because
// Mosaic has no lane reverse; Z[m-k] is a reversed read of shared memory
// here.
//
// What bounds it: device memory, 4 bytes read and 8*(n/2+1)/n written per
// point against about 2.5*log2(n) flops (4096 x 4096: 0.040 ms at 3.35
// TB/s).  Each row lives in shared memory (m*8.5 bytes, 68 KB at n =
// 16384).  Rows of fewer than 2048 points share a block (one per
// threadIdx.y) so that a block has 128 threads, and each m has its own
// launch bound (R2cShape, as the row kernel's); rows past the last read row
// 0 and store nothing.  The store sweeps the block's rows in order, all its
// threads on consecutive bins.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The launch shape of m = 2^LOG2M half-length points: threads a row (16
// points each), rows a block, and the blocks an SM that the launch bound
// asks registers for.
template <int LOG2M>
struct R2cShape {
  static constexpr int kThreads = (1 << LOG2M) / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kSmem = kRows * padded_len(1 << LOG2M) * static_cast<int>(sizeof(float2));
};

struct R2cArgs {
  const float2* in;  // real rows, read as (x[2j], x[2j+1]) pairs
  float* out_re;     // planar layout, rows of `bins`
  float* out_im;
  float2* out;       // interleaved layout, rows of m + 1
  const float2* tw;    // _pass_roots_np(m, -1)
  const float2* half;  // exp(-2pi*i*k/n), k = 0 .. m
  long long rows;
  int bins;
  float scale;
};

// The row in device memory as m complex points, read by the first pass.
struct PairIn {
  const float2* p;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const float2 v = p[k];
    a = v.x;
    b = v.y;
  }
};

// This thread's row (one per threadIdx.y): its source and its buffer, the
// last pass's sink too.  A row past the last reads row 0 (and the store
// skips it).
template <int LOG2M>
struct R2cRow {
  const R2cArgs& g;
  static constexpr int M = 1 << LOG2M;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(M)};
  }
  __device__ __forceinline__ PairIn src() const {
    return PairIn{g.in + static_cast<size_t>(valid() ? row() : 0) * M};
  }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

template <int LOG2M, bool C64>
__global__ void __launch_bounds__(R2cShape<LOG2M>::kBlock, R2cShape<LOG2M>::kMinBlocks)
r2c_fft_kernel(const __grid_constant__ R2cArgs g) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ float2 smem[];
  plan_fft<-1, LOG2M>(R2cRow<LOG2M>{g}, g.tw);
  // The last pass ends with a barrier: Z of every row of the block is in
  // shared memory.  The block's output rows are one contiguous run of
  // device memory; its threads store it in order, consecutive threads on
  // consecutive bins (with 4 or 8 threads a row at m = 64 or 128, a row
  // per thread group would scatter the stores).
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.y;
  const long long left = g.rows - row0;
  const int rows = left < blockDim.y ? static_cast<int>(left) : static_cast<int>(blockDim.y);
  const int bins = C64 ? M + 1 : g.bins;
  const size_t o = static_cast<size_t>(row0) * bins;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * bins; i += nthreads) {
    const int r = i / bins, k = i - r * bins;
    float xr = 0.f, xi = 0.f;
    if (k <= M) {
      const PadShared z{smem + r * padded_len(M)};
      float ar, ai, br, bi;
      z.load(k & (M - 1), ar, ai);
      z.load((M - k) & (M - 1), br, bi);
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float dr = 0.5f * (ar - br), di = 0.5f * (ai + bi);
      const float2 t = __ldg(&g.half[k]);
      xr = (er + (t.x * di + t.y * dr)) * g.scale;
      xi = (ei - (t.x * dr - t.y * di)) * g.scale;
    }
    if constexpr (C64) {
      g.out[o + i] = make_float2(xr, xi);
    } else {
      g.out_re[o + i] = xr;
      g.out_im[o + i] = xi;
    }
  }
}

template <int LOG2M, bool C64>
cudaError_t launch(const R2cArgs& g, cudaStream_t stream) {
  using S = R2cShape<LOG2M>;
  auto* kernel = r2c_fft_kernel<LOG2M, C64>;
  const long long blocks = (g.rows + S::kRows - 1) / S::kRows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (S::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(S::kThreads, S::kRows), S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <bool C64>
int dispatch(const R2cArgs& g, int log2m, void* stream) {
  // the pairs are read as 8-byte loads
  if (g.rows < 1 || reinterpret_cast<size_t>(g.in) % 8 != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 6: return launch<6, C64>(g, s);
    case 7: return launch<7, C64>(g, s);
    case 8: return launch<8, C64>(g, s);
    case 9: return launch<9, C64>(g, s);
    case 10: return launch<10, C64>(g, s);
    case 11: return launch<11, C64>(g, s);
    case 12: return launch<12, C64>(g, s);
    case 13: return launch<13, C64>(g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// R2C of `rows` contiguous real rows of n = 2^(log2m + 1) float32 points
// (8-byte aligned) into planar rows of `bins` >= n/2 + 1 floats (zeros past
// bin n/2).  tw holds the pass roots of m = n/2 (_pass_roots_np(m, -1)),
// half the m + 1 roots exp(-2pi*i*k/n), both interleaved (cos, sin) float32
// pairs.  Launches on `stream` and returns cudaGetLastError() (0 = ok).
int r2c_fft_f32(const void* in, void* out_re, void* out_im, const void* tw,
                const void* half, long long rows, int log2m, int bins,
                float scale, void* stream) {
  if (log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1) return cudaErrorInvalidValue;
  const R2cArgs g{static_cast<const float2*>(in), static_cast<float*>(out_re),
                  static_cast<float*>(out_im), nullptr, static_cast<const float2*>(tw),
                  static_cast<const float2*>(half), rows, bins, scale};
  return dispatch<false>(g, log2m, stream);
}

// The same into interleaved complex64 rows of n/2 + 1 points.
int r2c_fft_c64(const void* in, void* out, const void* tw, const void* half, long long rows,
                int log2m, float scale, void* stream) {
  const R2cArgs g{static_cast<const float2*>(in), nullptr, nullptr, static_cast<float2*>(out),
                  static_cast<const float2*>(tw), static_cast<const float2*>(half), rows,
                  (1 << log2m) + 1, scale};
  return dispatch<true>(g, log2m, stream);
}

const char* r2c_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
