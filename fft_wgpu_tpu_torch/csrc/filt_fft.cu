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
// store.  Both are one kernel, whose rows differ in which operand moves
// from row to row: filt's x (h one shared row), or the bank's h (x one
// shared row).  Which one is fixed when the kernel is compiled (BANK), so
// that the shared row's pointers stay kernel parameters: with both strides
// as run-time arguments ptxas held them in registers and spilled 52-148 B
// a thread at n = 256..16384, where this layout spills 0-8 B.
//
// It is the row kernel's design (rows_fft.cu, B1) with the multiply in
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
// bin n/2 are zero: the same function as the full transform's).  The shared
// row (filt's h, the bank's x) is read from L2 by every row.  A block reads
// its whole row before it stores any of it, so filt's output may alias its
// input (n_in = n).
//
// bank is the planar path of the same kernel with the roles swapped
// (bank_fft_f32).
//
// What bounds them: device memory, as for the row kernel: per row, 8 bytes
// read per point of the operand that moves and 8 written, the shared
// operand (one row) read from L2: filt at 4096 x 4096 needs 0.080 ms.  The
// bank of the CWT plan, S = 128 rows of n = 16384, is one wave of 128
// blocks (one an SM: a 136 KB padded row, 1024 threads) on the H100's 132
// SMs, so one block's four passes set its time more than its 34 MB of
// device memory (0.010 ms).

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// ---------------------------------------------------------------------- //
// filt (B9) and bank (B10): the compiled pow2 passes
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
  const float* hr;   // the filter as two planes of n points (the bank: rows of them)
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

// This thread's row (one per threadIdx.y) and its source (x times h,
// formed in the first pass's loads: the row's x and the one h, or with BANK
// the one x and the row's h), buffer and sink, built where a pass needs
// them.  A row past the last reads row 0 and stores nothing.
template <int LOG2N, bool C64, bool BANK>
struct FiltRow {
  static_assert(!(C64 && BANK), "the bank is planar");
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
    } else if constexpr (BANK) {
      return ProductIn{g.in_re, g.in_im, g.hr + line() * N, g.hi + line() * N, N};
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

template <int SIGN, int LOG2N, bool C64, bool BANK>
__global__ void __launch_bounds__(FiltShape<LOG2N>::kBlock, FiltShape<LOG2N>::kMinBlocks)
filt_fft_kernel(const __grid_constant__ FiltArgs g) {
  plan_fft<SIGN, LOG2N>(FiltRow<LOG2N, C64, BANK>{g}, g.tw);
}

template <int LOG2N, bool C64, bool BANK>
cudaError_t filt_launch(int sign, const FiltArgs& g, cudaStream_t stream) {
  using S = FiltShape<LOG2N>;
  auto* kernel = sign < 0 ? filt_fft_kernel<-1, LOG2N, C64, BANK>
                          : filt_fft_kernel<1, LOG2N, C64, BANK>;
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

template <bool C64, bool BANK>
int filt_dispatch(const FiltArgs& g, int log2n, int sign, void* stream) {
  if (g.rows < 1 || (sign != 1 && sign != -1) || log2n < 7 || log2n > 14 || g.n_in < 1 ||
      g.n_in > (1 << log2n)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return filt_launch<7, C64, BANK>(sign, g, s);
    case 8: return filt_launch<8, C64, BANK>(sign, g, s);
    case 9: return filt_launch<9, C64, BANK>(sign, g, s);
    case 10: return filt_launch<10, C64, BANK>(sign, g, s);
    case 11: return filt_launch<11, C64, BANK>(sign, g, s);
    case 12: return filt_launch<12, C64, BANK>(sign, g, s);
    case 13: return filt_launch<13, C64, BANK>(sign, g, s);
    default: return filt_launch<14, C64, BANK>(sign, g, s);
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
  return filt_dispatch<false, false>(g, log2n, sign, stream);
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
  return filt_dispatch<true, false>(g, log2n, sign, stream);
}

// bank over `rows` contiguous filter rows h of n = 2^log2n planar float32
// points, each times the one signal row x, into `rows` contiguous output
// rows; tw as filt_fft_f32's.
int bank_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                 void* out_re, void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  const FiltArgs g{static_cast<const float*>(xr), static_cast<const float*>(xi),
                   static_cast<float*>(out_re), static_cast<float*>(out_im),
                   static_cast<const float*>(hr), static_cast<const float*>(hi), nullptr,
                   nullptr, nullptr, static_cast<const float2*>(tw), rows, 1 << log2n, scale};
  return filt_dispatch<false, true>(g, log2n, sign, stream);
}

const char* filt_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
