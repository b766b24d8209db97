// Batched complex-to-real FFT along the last axis through a half-length
// complex FFT (B7), and its product form (B8), one kernel design for both.
//
// Replaces the TPU kernels fft_wgpu_tpu/ops/pallas_fft.py::_irfft_rows_core
// (B7, its pl.pallas_call over _kernel_c2r_bal, _kernel_c2r_pipe and
// _kernel_c2r) and ::irfft_prod_rows_split (B8, over _kernel_c2r_bal_prod,
// the fftconvolve / oaconvolve epilogue) for pow2 n = 2^7 .. 2^14 (the TPU
// kernels start at 2^8 and 2^9).  Per half spectrum X[0 .. n/2] it
// computes the real row
//
//     x[j] = scale * sum_{k<n} Xh[k] * exp(+2*pi*i * k*j / n),
//
// Xh the Hermitian extension of X, with the imaginary parts of the DC and
// Nyquist bins ignored (numpy's irfft is scale = 1/n).  X comes from one
// of three sources, rows of `bins` >= n/2 + 1 bins (n/2 + 1, or the padded
// serving form pad_bins(n) whose pad columns are never read):
//
//   c2r_fft_f32       X = A, planar float32 planes;
//   c2r_fft_c64       X = A, interleaved complex64 pairs (a torch complex64
//                     tensor as it lies, 8-byte aligned), so that irfft,
//                     irfft2 and irfftn of complex64 need no split;
//   c2r_prod_fft_f32  X = A * B, both planar, B a spectrum of A's shape or
//                     one row broadcast over every row of A, the product
//                     never written to device memory (numpy's irfft of
//                     A * B).
//
// It is r2c_fft.cu's design (B6) run backwards, on mixed_fft.cuh's compiled
// plan for m = n/2 (plan_fft; 2048 = 16*16*8) at m/16 threads a row and 16
// points a thread, rows of m < 2048 sharing a block (one per threadIdx.y,
// at least 128 threads) with a launch bound per m (C2rShape, as R2cShape).
// A sweep over the block's rows, consecutive threads on consecutive bins,
// kStage bins a thread a round (B8; B7 kStageA) with every load of the
// round issued before any store, reads each bin once (B through the read-only cache: a
// broadcast row, read by every block, stays in L2) and stages X[k] in the
// row's padded shared slots (PadShared).  The m + 1 bins fit the m slots
// because the DC and Nyquist bins need only their real parts: slot 0 holds
// (Re X[0], Re X[m]).  The plan's first pass reads X[k] and X[m-k] from the
// staged row and forms
//
//     Z[k] = (X[k] + conj(X[m-k])) + i t[k] (X[k] - conj(X[m-k])),  k < m,
//
// in place (its reads and writes are split by the pass's barrier), t[k] =
// exp(+2*pi*i*k/n) from a float32 table generated in float64, with the
// twiddles of each pass from their own table (ops/cuda_fft.py::
// _pass_roots_np(m, +1)); the last pass stores z[j] as x[2j] = Re z[j],
// x[2j+1] = Im z[j], one 8-byte pair, times the scale (the math of
// fft_wgpu_tpu/ops/rfft.py::_irfft_even_split without its halving, which
// the 1/m it pairs with undoes).  Rows past the last stage nothing and
// store nothing.  A block reads its rows before it writes any of them, but
// the output rows (n floats) are longer than the input's, so the output
// must not alias the input.
//
// What bounds it: device memory.  B7 reads 8*(n/2+1)/n bytes and writes 4
// a point (67 MB read and 67 MB written at 4096 x 4096: 0.040 ms at 3.35
// TB/s); B8 reads both spectra, 16*(n/2+1)/n bytes a point (134 MB read
// and 67 MB written at 2048 x 8192 with equal shapes: 0.060 ms), against
// about 2.5*log2(n) flops a point.  Staging the row once with many loads
// in flight replaced the first design's first pass, which read X[k] and
// X[m-k] straight from device memory (two scattered reads a bin, the
// second walking backwards), and its radix-4 passes.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The real row, z[k] stored as x[2k] = Re, x[2k+1] = Im, times the scale,
// in one 8-byte store (the wrapper allocates the output, so rows of an
// even number of floats are 8-byte aligned).
struct InterleavedOut {
  float* x;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (valid) reinterpret_cast<float2*>(x)[k] = make_float2(a * scale, b * scale);
  }
};

// The launch shape of m = 2^LOG2M half-length points: threads a row (16
// points each), rows a block, the blocks an SM that the launch bound asks
// registers for (R2cShape's), the rows' shared memory, and the bins a
// thread stages a round: B8's 4*kStage loads, or B7's kStageA bins of one
// or two loads each, in flight at once (16 bins beat 4 and 8 by 4-9% for
// B7, and lost to 8 for B8 at 4 of 11 shapes:
// scripts/time_pow2_variants.py --lib c2r_fft).
template <int LOG2M>
struct C2rShape {
  static constexpr int kM = 1 << LOG2M;
  static constexpr int kStage = 8;  // bins a thread stages a round
  static constexpr int kStageA = 16;  // the same from A alone
  static constexpr int kThreads = kM / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kSmem = kRows * padded_len(kM) * static_cast<int>(sizeof(float2));
};

// Where X comes from: A * B (B8), A as planes or A as complex64 (B7).
enum Source { kProduct, kPlanar, kC64 };

struct C2rArgs {
  const float* ar;  // A's planes (kProduct, kPlanar), rows of `bins`
  const float* ai;
  const float2* a;  // A as complex64 pairs (kC64), rows of `bins`
  const float* br;  // B's planes (kProduct), rows of `bins` b_stride apart (0: one broadcast row)
  const float* bi;
  float* out;          // real rows of 2m points
  const float2* tw;    // _pass_roots_np(m, +1)
  const float2* half;  // exp(+2pi*i*k/n), k = 0 .. m
  long long rows;
  long long b_stride;
  int bins;
  float scale;
};

// Bin k of row r of the source.
template <Source SRC>
__device__ __forceinline__ float2 source_bin(const C2rArgs& g, long long r, int k) {
  const size_t a = static_cast<size_t>(r) * g.bins + k;
  if constexpr (SRC == kC64) {
    return g.a[a];
  } else if constexpr (SRC == kPlanar) {
    return make_float2(g.ar[a], g.ai[a]);
  } else {
    const size_t b = static_cast<size_t>(r * g.b_stride) + k;
    const float a_r = g.ar[a], a_i = g.ai[a];
    const float b_r = __ldg(&g.br[b]), b_i = __ldg(&g.bi[b]);
    return make_float2(a_r * b_r - a_i * b_i, a_r * b_i + a_i * b_r);
  }
}

// Stage X of the block's rows, bins 0 .. M, in the rows' shared slots (slot
// 0: Re X[0], Re X[M]), consecutive threads on consecutive bins, kStage
// (from A alone kStageA) bins a thread a round: every load of a round, then
// every store (a thread past the last bin loads the last again and stores
// nothing); ends with a barrier.
template <int LOG2M, Source SRC>
__device__ __forceinline__ void stage(const C2rArgs& g) {
  using S = C2rShape<LOG2M>;
  constexpr int M = S::kM, U = SRC == kProduct ? S::kStage : S::kStageA;
  extern __shared__ float2 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * S::kRows;
  const int rows = g.rows - row0 < S::kRows ? static_cast<int>(g.rows - row0) : S::kRows;
  const int total = rows * (M + 1);
  const int flat = threadIdx.y * S::kThreads + threadIdx.x;
  for (int i0 = flat; i0 < total; i0 += U * S::kBlock) {
    float2 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(i0 + u * S::kBlock, total - 1);
      const int r = i / (M + 1), k = i - r * (M + 1);
      x[u] = source_bin<SRC>(g, row0 + r, k);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * S::kBlock;
      if (i < total) {
        const int r = i / (M + 1), k = i - r * (M + 1);
        float2* slot = smem + r * padded_len(M) + padded(k & (M - 1));
        if (k == 0) {
          slot->x = x[u].x;
        } else if (k == M) {
          slot->y = x[u].x;
        } else {
          *slot = x[u];
        }
      }
    }
  }
  __syncthreads();
}

// Z[k] of the staged row, from X[k] and X[M-k]: the first pass's source,
// read in place.
template <int M>
struct StagedIn {
  PadShared x;
  const float2* half;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    float ar, ai, br, bi;
    x.load(k, ar, ai);
    x.load((M - k) & (M - 1), br, bi);
    if (k == 0) {  // slot 0: Re X[0], Re X[M]; both imaginary parts are ignored
      br = ai;
      ai = bi = 0.f;
    }
    const float er = ar + br, ei = ai - bi;
    const float dr = ar - br, di = ai + bi;
    const float2 t = __ldg(&half[k]);
    a = er - (t.x * di + t.y * dr);
    b = ei + (t.x * dr - t.y * di);
  }
};

// This thread's row (one per threadIdx.y): its staged buffer, the first
// pass's source in it, and the real row in device memory, the last pass's
// sink (nothing stored for a row past the last).
template <int LOG2M>
struct C2rRow {
  const C2rArgs& g;
  static constexpr int M = 1 << LOG2M;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(M)};
  }
  __device__ __forceinline__ StagedIn<M> src() const { return StagedIn<M>{shared(), g.half}; }
  __device__ __forceinline__ InterleavedOut dst() const {
    const bool valid = row() < g.rows;
    return InterleavedOut{g.out + static_cast<size_t>(valid ? row() : 0) * 2 * M, g.scale,
                          valid};
  }
};

// B7, from planes or complex64 pairs, and B8: the staging sweep, then the
// passes.
template <int LOG2M, bool C64>
__global__ void __launch_bounds__(C2rShape<LOG2M>::kBlock, C2rShape<LOG2M>::kMinBlocks)
c2r_fft_kernel(const __grid_constant__ C2rArgs g) {
  stage<LOG2M, C64 ? kC64 : kPlanar>(g);
  plan_fft<1, LOG2M>(C2rRow<LOG2M>{g}, g.tw);
}

template <int LOG2M>
__global__ void __launch_bounds__(C2rShape<LOG2M>::kBlock, C2rShape<LOG2M>::kMinBlocks)
c2r_prod_kernel(const __grid_constant__ C2rArgs g) {
  stage<LOG2M, kProduct>(g);
  plan_fft<1, LOG2M>(C2rRow<LOG2M>{g}, g.tw);
}

template <int LOG2M, Source SRC>
cudaError_t launch(const C2rArgs& g, cudaStream_t stream) {
  using S = C2rShape<LOG2M>;
  auto* kernel = SRC == kProduct ? c2r_prod_kernel<LOG2M>
                                 : c2r_fft_kernel<LOG2M, SRC == kC64>;
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

// Checks the arguments every source shares, then launches m = 2^log2m's kernel.
template <Source SRC>
int dispatch(const C2rArgs& g, int log2m, void* stream) {
  if (g.rows < 1 || log2m < 6 || log2m > 13 || g.bins < (1 << log2m) + 1 ||
      reinterpret_cast<size_t>(g.out) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 6: return launch<6, SRC>(g, s);
    case 7: return launch<7, SRC>(g, s);
    case 8: return launch<8, SRC>(g, s);
    case 9: return launch<9, SRC>(g, s);
    case 10: return launch<10, SRC>(g, s);
    case 11: return launch<11, SRC>(g, s);
    case 12: return launch<12, SRC>(g, s);
    default: return launch<13, SRC>(g, s);
  }
}

}  // namespace

extern "C" {

// C2R of `rows` planar half-spectrum rows of `bins` >= n/2 + 1 floats
// (bins 0..n/2 read) into contiguous real rows of n = 2^(log2m + 1)
// float32 points, out 8-byte aligned.  tw holds the pass roots of m = n/2
// (_pass_roots_np(m, +1)), half the m + 1 roots exp(+2pi*i*k/n), both
// interleaved (cos, sin) float32 pairs.  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
int c2r_fft_f32(const void* in_re, const void* in_im, void* out, const void* tw,
                const void* half, long long rows, int log2m, int bins, float scale,
                void* stream) {
  const C2rArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im), nullptr,
                  nullptr, nullptr, static_cast<float*>(out), static_cast<const float2*>(tw),
                  static_cast<const float2*>(half), rows, 0, bins, scale};
  return dispatch<kPlanar>(g, log2m, stream);
}

// The same from interleaved complex64 rows of `bins` >= n/2 + 1 (re, im)
// float32 pairs, 8-byte aligned.
int c2r_fft_c64(const void* in, void* out, const void* tw, const void* half, long long rows,
                int log2m, int bins, float scale, void* stream) {
  if (reinterpret_cast<size_t>(in) % 8 != 0) return cudaErrorInvalidValue;
  const C2rArgs g{nullptr, nullptr, static_cast<const float2*>(in), nullptr, nullptr,
                  static_cast<float*>(out), static_cast<const float2*>(tw),
                  static_cast<const float2*>(half), rows, 0, bins, scale};
  return dispatch<kC64>(g, log2m, stream);
}

// C2R of the products A * B: A as the input of c2r_fft_f32, B rows of the
// same `bins`, `b_rows` of them: 1 (broadcast over A's rows) or `rows`.
int c2r_prod_fft_f32(const void* ar, const void* ai, const void* br, const void* bi,
                     void* out, const void* tw, const void* half, long long rows,
                     long long b_rows, int log2m, int bins, float scale, void* stream) {
  if (b_rows != 1 && b_rows != rows) return cudaErrorInvalidValue;
  const C2rArgs g{static_cast<const float*>(ar), static_cast<const float*>(ai), nullptr,
                  static_cast<const float*>(br), static_cast<const float*>(bi),
                  static_cast<float*>(out), static_cast<const float2*>(tw),
                  static_cast<const float2*>(half), rows, b_rows == 1 ? 0 : bins, bins,
                  scale};
  return dispatch<kProduct>(g, log2m, stream);
}

const char* c2r_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
