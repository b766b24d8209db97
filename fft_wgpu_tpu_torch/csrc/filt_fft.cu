// Batched complex-to-complex FFT along the last axis with a filter multiply
// fused into its loads: the spectral filter (B9) and the filter bank (B10).
//
// Replaces the TPU kernels fft_wgpu_tpu/ops/pallas_fft.py::_fft_filtered_core
// (B9, its pl.pallas_call over _kernel_rows_bal_filt and _kernel_filt) and
// ::_fft_bank_core (B10, over _kernel_rows_bal_bank and _kernel_bank).  For
// n = 2^7 .. 2^14:
//
//   filt:  y[r] = scale * FFT_sign(x[r] * h)      x: [rows, n], h: [n]
//   bank:  y[s] = scale * FFT_sign(x * h[s])      x: [n],       h: [S, n]
//
// The product is never written to device memory, and the bank's signal is
// never materialised at [S, n]; the scale is folded into the last pass's
// store.
//
// filt is the row kernel's design (rows_fft.cu, B1) with the multiply in
// its first pass's loads: n's plan compiled in (mixed_fft.cuh's plan_fft;
// 4096 = 16*16*16) at n/16 threads a row and 16 points a thread, 128 /
// (n/16) rows a block up to n = 1024 (one per threadIdx.y), a launch bound
// per n (FiltShape: RowsShape's, but 64 registers at n = 4096), the row in
// shared memory as padded interleaved pairs (PadShared) and each pass's
// twiddles in a table of their own (ops/cuda_fft.py::_pass_roots_np).  Two
// layouts: planar (re, im) float32 planes, h as two planes too
// (filt_fft_f32), and interleaved complex64, one 8-byte pair a point, h
// one complex64 row (filt_fft_c64: torch complex64 tensors as they lie, so
// SpectralFilter and hilbert need no split and no merge).  The complex64
// entry's input rows may be shorter than n: n_in <= n pairs a row (the row
// stride), points past n_in read as zero, so hilbert's inverse reads the
// R2C kernel's half spectrum of n/2 + 1 bins as it lies (its weights past
// bin n/2 are zero: the same function as the full transform's).  h is read
// from L2 by every row.  A block reads its whole row before it stores any
// of it, so the output may alias the input (n_in = n).
//
// bank is the first port's kernel, unchanged: stockham.cuh's radix-4
// passes, one row a block, the first pass through ProductIn x[k] * h[s][k]
// with the signal shared by every row.
//
// What bounds them: device memory, as for the row kernel: per row, 8 bytes
// read per point of the operand that moves and 8 written, the shared
// operand (one row) read from L2: filt at 4096 x 4096 needs 0.080 ms.  The
// bank of the CWT plan, S = 128 rows of n = 16384, is one wave of 128
// blocks (one an SM: a 128 KB row, 1024 threads) on the H100's 132 SMs, so
// one block's seven passes set its time, not bytes; splitting a row over a
// thread-block cluster, as big_fft.cu does, would fill the card, and is
// later work.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// ---------------------------------------------------------------------- //
// filt (B9): the compiled pow2 passes
// ---------------------------------------------------------------------- //

// The row kernel's launch shape (mixed_fft.cuh's RowsShape) with a launch
// bound of its own at n = 4096: 64 registers, four blocks of 256 threads an
// SM (RowsShape's three, 80 registers, measured 4-14% slower here:
// scripts/time_pow2_variants.py --lib filt_fft).  At 64 registers (n =
// 4096, and 16384, whose 1024 threads allow no more) the first pass, which
// holds x and h of its 16 points, spills 4-8 B; staging the product in
// shared memory first removes the spill and measured 1.3x slower.
template <int LOG2N>
struct FiltShape : RowsShape<LOG2N> {
  static constexpr int kMinBlocks = LOG2N == 12 ? 4 : RowsShape<LOG2N>::kMinBlocks;
};

struct FiltArgs {
  const float* in_re;  // planar layout: rows of n points
  const float* in_im;
  float* out_re;
  float* out_im;
  const float* hr;   // the filter as two planes of n points
  const float* hi;
  const float2* in;  // interleaved layout: rows of n_in pairs
  float2* out;       // rows of n pairs
  const float2* h;   // the filter as one row of n pairs
  const float2* tw;  // _pass_roots_np(n, sign)
  long long rows;
  int n_in;
  float scale;
};

// An interleaved row of n_in points times the interleaved filter, zero
// past n_in.  No __restrict__: the output may alias the input.
struct C64ProductIn {
  const float2* x;
  const float2* h;
  int n_in;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (k >= n_in) {
      a = b = 0.f;
      return;
    }
    const float2 v = x[k];
    const float2 w = __ldg(&h[k]);
    a = v.x * w.x - v.y * w.y;
    b = v.x * w.y + v.y * w.x;
  }
};

// This thread's row (one per threadIdx.y) and its source (the row times
// the filter, formed in the first pass's loads), buffer and sink, built
// where a pass needs them.  A row past the last reads row 0 and stores
// nothing.
template <int LOG2N, bool C64>
struct FiltRow {
  const FiltArgs& g;
  static constexpr int N = 1 << LOG2N;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ size_t line() const {
    return static_cast<size_t>(valid() ? row() : 0);
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(N)};
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (C64) {
      return C64ProductIn{g.in + line() * g.n_in, g.h, g.n_in};
    } else {
      return ProductIn{g.in_re + line() * N, g.in_im + line() * N, g.hr, g.hi, N};
    }
  }
  __device__ __forceinline__ auto dst() const {
    if constexpr (C64) {
      return C64Out{g.out + line() * N, g.scale, valid()};
    } else {
      return PlanarOut{g.out_re + line() * N, g.out_im + line() * N, g.scale, valid()};
    }
  }
};

template <int SIGN, int LOG2N, bool C64>
__global__ void __launch_bounds__(FiltShape<LOG2N>::kBlock, FiltShape<LOG2N>::kMinBlocks)
filt_fft_kernel(const __grid_constant__ FiltArgs g) {
  plan_fft<SIGN, LOG2N>(FiltRow<LOG2N, C64>{g}, g.tw);
}

template <int LOG2N, bool C64>
cudaError_t filt_launch(int sign, const FiltArgs& g, cudaStream_t stream) {
  using S = FiltShape<LOG2N>;
  auto* kernel = sign < 0 ? filt_fft_kernel<-1, LOG2N, C64> : filt_fft_kernel<1, LOG2N, C64>;
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
int filt_dispatch(const FiltArgs& g, int log2n, int sign, void* stream) {
  if (g.rows < 1 || (sign != 1 && sign != -1) || log2n < 7 || log2n > 14 || g.n_in < 1 ||
      g.n_in > (1 << log2n)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return filt_launch<7, C64>(sign, g, s);
    case 8: return filt_launch<8, C64>(sign, g, s);
    case 9: return filt_launch<9, C64>(sign, g, s);
    case 10: return filt_launch<10, C64>(sign, g, s);
    case 11: return filt_launch<11, C64>(sign, g, s);
    case 12: return filt_launch<12, C64>(sign, g, s);
    case 13: return filt_launch<13, C64>(sign, g, s);
    default: return filt_launch<14, C64>(sign, g, s);
  }
}

// ---------------------------------------------------------------------- //
// bank (B10): stockham.cuh's radix-4 passes, one row a block
// ---------------------------------------------------------------------- //

template <int LOG2N>
__global__ void __launch_bounds__(threads_for(LOG2N))
bank_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ hr, const float* __restrict__ hi,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const float2* __restrict__ tw, long long x_stride,
                long long h_stride, float sign, float scale) {
  constexpr int N = 1 << LOG2N;
  extern __shared__ float bank_smem[];  // filt's rows declare smem as float2
  const long long r = blockIdx.x;
  const size_t xo = static_cast<size_t>(r * x_stride);
  const size_t ho = static_cast<size_t>(r * h_stride);
  const size_t o = static_cast<size_t>(r) * N;
  fft_passes<LOG2N, threads_for(LOG2N)>(
      ProductIn{xr + xo, xi + xo, hr + ho, hi + ho, N}, Shared{bank_smem, bank_smem + N},
      GlobalOut{out_re + o, out_im + o, scale}, tw, sign);
}

template <int LOG2N>
cudaError_t bank_launch(const void* xr, const void* xi, const void* hr, const void* hi,
                        void* out_re, void* out_im, const void* tw, long long rows,
                        long long x_stride, long long h_stride, float sign, float scale,
                        cudaStream_t stream) {
  constexpr int smem = 2 * (1 << LOG2N) * static_cast<int>(sizeof(float));
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bank_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  bank_fft_kernel<LOG2N><<<static_cast<unsigned>(rows), threads_for(LOG2N), smem,
                           stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(hr), static_cast<const float*>(hi),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), x_stride, h_stride, sign, scale);
  return cudaGetLastError();
}

// `rows` output rows of n = 2^log2n; row r reads x at r*x_stride and h at
// r*h_stride (floats of each plane).
int bank_run(const void* xr, const void* xi, const void* hr, const void* hi, void* out_re,
             void* out_im, const void* tw, long long rows, int log2n, long long x_stride,
             long long h_stride, int sign, float scale, void* stream) {
  if (rows < 1 || rows > 2147483647LL || (sign != 1 && sign != -1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
#define BANK_CASE(L)                                                          \
  case L:                                                                     \
    return bank_launch<L>(xr, xi, hr, hi, out_re, out_im, tw, rows, x_stride, \
                          h_stride, sg, scale, s);
    BANK_CASE(7) BANK_CASE(8) BANK_CASE(9) BANK_CASE(10)
    BANK_CASE(11) BANK_CASE(12) BANK_CASE(13) BANK_CASE(14)
#undef BANK_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// filt over `rows` contiguous rows x of n = 2^log2n planar float32 points,
// each times the one row h of n floats per plane.  tw holds the roots of
// exp(sign*2pi*i/n) that the passes of n's plan read (_pass_roots_np:
// interleaved (cos, sin) float32 pairs).  The output may alias the input.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int filt_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                 void* out_re, void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  const FiltArgs g{static_cast<const float*>(xr), static_cast<const float*>(xi),
                   static_cast<float*>(out_re), static_cast<float*>(out_im),
                   static_cast<const float*>(hr), static_cast<const float*>(hi), nullptr,
                   nullptr, nullptr, static_cast<const float2*>(tw), rows, 1 << log2n, scale};
  return filt_dispatch<false>(g, log2n, sign, stream);
}

// The same over interleaved complex64 rows, (re, im) float32 pairs, 8-byte
// aligned: input rows of n_in pairs (1 <= n_in <= n; points past n_in are
// zero), output rows of n, the filter h one row of n pairs.  With n_in = n
// the output may alias the input.
int filt_fft_c64(const void* x, const void* h, void* out, const void* tw, long long rows,
                 int log2n, int n_in, int sign, float scale, void* stream) {
  const FiltArgs g{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   static_cast<const float2*>(x), static_cast<float2*>(out),
                   static_cast<const float2*>(h), static_cast<const float2*>(tw), rows, n_in,
                   scale};
  return filt_dispatch<true>(g, log2n, sign, stream);
}

// bank over `rows` contiguous filter rows h of n = 2^log2n planar float32
// points, each times the one signal row x.  tw holds n interleaved
// (cos, sin) float32 pairs of exp(sign*2pi*i*j/n).
int bank_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                 void* out_re, void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  return bank_run(xr, xi, hr, hi, out_re, out_im, tw, rows, log2n, 0, 1LL << log2n, sign,
                  scale, stream);
}

const char* filt_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
