// Batched complex-to-real FFT along the last axis through a half-length
// complex FFT, and its product form.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_irfft_rows_core
// (its pl.pallas_call over _kernel_c2r_bal, _kernel_c2r_pipe and
// _kernel_c2r) for pow2 n = 2^7 .. 2^14 (the TPU kernel starts at 2^8).
// Per half spectrum X[0 .. n/2], planar float32 in rows of `bins` floats
// (n/2 + 1, or the padded serving form pad_bins(n) whose pad columns are
// never read), it computes the real row
//
//     x[j] = scale * sum_{k<n} Xh[k] * exp(+2*pi*i * k*j / n),
//
// Xh the Hermitian extension of X, with the imaginary parts of the DC and
// Nyquist bins ignored (numpy's irfft is scale = 1/n).
//
// The reverse of r2c_fft.cu: the first Stockham pass (stockham.cuh) forms
//
//     Z[k] = (X[k] + conj(X[m-k])) + i t[k] (X[k] - conj(X[m-k])),  k < m,
//
// with m = n/2 and t[k] = exp(+2*pi*i*k/n) from a float32 table generated
// in float64, at load from device memory; the m-point inverse runs in
// shared memory, and the last pass stores z[j] interleaved as
// x[2j] = Re z[j], x[2j+1] = Im z[j] with the scale folded in (the math of
// fft_wgpu_tpu/ops/rfft.py::_irfft_even_split without its halving, which
// the 1/m it pairs with undoes).  A row lives in shared memory (n*4
// bytes); rows of fewer than 512 points share a block (one per
// threadIdx.y, 128 threads a block), and rows past the last load zeros and
// store nothing.
//
// The product C2R (c2r_prod_fft_f32) replaces the TPU kernel
// fft_wgpu_tpu/ops/pallas_fft.py::irfft_prod_rows_split (B8, its
// pl.pallas_call over _kernel_c2r_bal_prod), the fftconvolve / oaconvolve
// epilogue: the same C2R of X = A * B, B a spectrum of A's shape or one row
// broadcast over every row of A, the product never written to device
// memory, the DC and Nyquist imaginary parts taken off the product (numpy's
// irfft of A * B).  It is r2c_fft.cu's design (B6) run backwards, on
// mixed_fft.cuh's compiled plan for m (plan_fft; 2048 = 16*16*8) at m/16
// threads a row and 16 points a thread, rows of m < 2048 sharing a block
// (one per threadIdx.y, at least 128 threads) with a launch bound per m
// (ProdShape, as R2cShape).  A sweep over the block's rows, consecutive
// threads on consecutive bins, kStage bins a thread a round with every
// load of the round issued before any store, reads A[k] and B[k] once each
// (B through the read-only cache: a broadcast row, read by every block,
// stays in L2), forms the product once and stages X[k] in the row's padded
// shared slots (PadShared).  The m + 1 bins fit the m slots because the DC and Nyquist
// bins need only their real parts: slot 0 holds (Re X[0], Re X[m]).  The
// plan's first pass reads X[k] and X[m-k] from the staged row and forms
// Z[k] above in place (its reads and writes are split by the pass's
// barrier), with the twiddles of each pass from their own table
// (ops/cuda_fft.py::_pass_roots_np(m, +1)); the last pass stores x[2j] and
// x[2j+1] as one 8-byte pair, times the scale.  Rows past the last stage
// nothing and store nothing.
//
// What bounds both: device memory.  B7 reads 8*(n/2+1)/n bytes and writes 4
// a point; B8 reads both spectra, 16*(n/2+1)/n bytes a point (134 MB read
// and 67 MB written at 2048 x 8192 with equal shapes: 0.060 ms at 3.35
// TB/s), against about 2.5*log2(n) flops.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// ---------------------------------------------------------------------- //
// B7: stockham.cuh's passes
// ---------------------------------------------------------------------- //

// Rows per block: enough that a block has at least 128 threads.
__host__ __device__ constexpr int c2r_rows(int log2m) {
  return threads_for(log2m) >= 128 ? 1 : 128 / threads_for(log2m);
}

// Bin k of one half-spectrum row as stored.
struct Bins {
  const float* r;
  const float* i;
  __device__ __forceinline__ void get(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
};

// Z[k] of row r, formed at load from X[k] and X[m-k].
struct HalfSpectrumIn {
  Bins x;
  const float2* half;
  int m;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (!valid) {
      a = b = 0.f;
      return;
    }
    float ar, ai, br, bi;
    x.get(k, ar, ai);
    x.get(m - k, br, bi);
    if (k == 0) ai = bi = 0.f;  // DC with Nyquist: both imaginary parts are ignored
    const float er = ar + br, ei = ai - bi;
    const float dr = ar - br, di = ai + bi;
    const float2 t = __ldg(&half[k]);
    a = er - (t.x * di + t.y * dr);
    b = ei + (t.x * dr - t.y * di);
  }
};

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

template <int LOG2M>
__global__ void __launch_bounds__(threads_for(LOG2M) * c2r_rows(LOG2M))
c2r_fft_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
               float* __restrict__ out, const float2* __restrict__ tw,
               const float2* __restrict__ half, long long rows, int bins, float scale) {
  constexpr int M = 1 << LOG2M;
  constexpr int T = threads_for(LOG2M);
  extern __shared__ float c2r_smem[];  // the product kernel's rows declare float2
  float* sr = c2r_smem + threadIdx.y * 2 * M;
  float* si = sr + M;
  const long long r = static_cast<long long>(blockIdx.x) * c2r_rows(LOG2M) + threadIdx.y;
  const bool valid = r < rows;
  const size_t i = static_cast<size_t>(valid ? r : 0) * bins;
  const size_t o = static_cast<size_t>(valid ? r : 0) * 2 * M;
  const Shared s{sr, si};
  const InterleavedOut dst{out + o, scale, valid};
  fft_passes<LOG2M, T>(HalfSpectrumIn{{ar + i, ai + i}, half, M, valid}, s, dst, tw, 1.f);
}

template <int LOG2M>
cudaError_t launch(const void* ar, const void* ai, void* out, const void* tw,
                   const void* half, long long rows, int bins, float scale,
                   cudaStream_t stream) {
  constexpr int RB = c2r_rows(LOG2M);
  constexpr int smem = RB * 2 * (1 << LOG2M) * static_cast<int>(sizeof(float));
  const long long blocks = (rows + RB - 1) / RB;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        c2r_fft_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  c2r_fft_kernel<LOG2M><<<static_cast<unsigned>(blocks), dim3(threads_for(LOG2M), RB), smem,
                          stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai), static_cast<float*>(out),
      static_cast<const float2*>(tw), static_cast<const float2*>(half), rows, bins, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------- //
// B8: the product, staged once, on mixed_fft.cuh's compiled passes
// ---------------------------------------------------------------------- //

// The launch shape of m = 2^LOG2M half-length points: threads a row (16
// points each), rows a block, the blocks an SM that the launch bound asks
// registers for (R2cShape's), the rows' shared memory, and the bins a
// thread stages a round (their 4*kStage loads in flight at once).
template <int LOG2M>
struct ProdShape {
  static constexpr int kM = 1 << LOG2M;
  static constexpr int kStage = 8;  // bins a thread stages a round
  static constexpr int kThreads = kM / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kSmem = kRows * padded_len(kM) * static_cast<int>(sizeof(float2));
};

struct ProdArgs {
  const float* ar;  // A's planes, rows of `bins`
  const float* ai;
  const float* br;  // B's planes, rows of `bins` b_stride apart (0: one broadcast row)
  const float* bi;
  float* out;          // real rows of 2m points
  const float2* tw;    // _pass_roots_np(m, +1)
  const float2* half;  // exp(+2pi*i*k/n), k = 0 .. m
  long long rows;
  long long b_stride;
  int bins;
  float scale;
};

// Stage X = A * B of the block's rows, bins 0 .. M, in the rows' shared
// slots (slot 0: Re X[0], Re X[M]), consecutive threads on consecutive
// bins, kStage bins a thread a round: every load of a round, then every
// store (a thread past the last bin loads the last again and stores
// nothing); ends with a barrier.
template <int LOG2M>
__device__ __forceinline__ void stage_product(const ProdArgs& g) {
  using S = ProdShape<LOG2M>;
  constexpr int M = S::kM, U = S::kStage;
  extern __shared__ float2 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * S::kRows;
  const int rows = g.rows - row0 < S::kRows ? static_cast<int>(g.rows - row0) : S::kRows;
  const int total = rows * (M + 1);
  const int flat = threadIdx.y * S::kThreads + threadIdx.x;
  for (int i0 = flat; i0 < total; i0 += U * S::kBlock) {
    float a_r[U], a_i[U], b_r[U], b_i[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(i0 + u * S::kBlock, total - 1);
      const int r = i / (M + 1), k = i - r * (M + 1);
      const size_t a = static_cast<size_t>(row0 + r) * g.bins + k;
      const size_t b = static_cast<size_t>((row0 + r) * g.b_stride) + k;
      a_r[u] = g.ar[a];
      a_i[u] = g.ai[a];
      b_r[u] = __ldg(&g.br[b]);
      b_i[u] = __ldg(&g.bi[b]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * S::kBlock;
      if (i < total) {
        const int r = i / (M + 1), k = i - r * (M + 1);
        const float xr = a_r[u] * b_r[u] - a_i[u] * b_i[u];
        float2* slot = smem + r * padded_len(M) + padded(k & (M - 1));
        if (k == 0) {
          slot->x = xr;
        } else if (k == M) {
          slot->y = xr;
        } else {
          *slot = make_float2(xr, a_r[u] * b_i[u] + a_i[u] * b_r[u]);
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
struct ProdRow {
  const ProdArgs& g;
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

template <int LOG2M>
__global__ void __launch_bounds__(ProdShape<LOG2M>::kBlock, ProdShape<LOG2M>::kMinBlocks)
c2r_prod_kernel(const __grid_constant__ ProdArgs g) {
  stage_product<LOG2M>(g);
  plan_fft<1, LOG2M>(ProdRow<LOG2M>{g}, g.tw);
}

template <int LOG2M>
cudaError_t launch_prod(const ProdArgs& g, cudaStream_t stream) {
  using S = ProdShape<LOG2M>;
  auto* kernel = c2r_prod_kernel<LOG2M>;
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

#define C2R_LOG2M_CASES(CASE) \
  CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13)

}  // namespace

extern "C" {

// C2R of `rows` planar half-spectrum rows of `bins` >= n/2 + 1 floats
// (bins 0..n/2 read) into contiguous real rows of n = 2^(log2m + 1)
// float32 points.  tw holds m = n/2 interleaved (cos, sin) float32 pairs
// of exp(+2pi*i*j/m), half holds at least m pairs of exp(+2pi*i*k/n).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int c2r_fft_f32(const void* in_re, const void* in_im, void* out, const void* tw,
                const void* half, long long rows, int log2m, int bins, float scale,
                void* stream) {
  if (rows < 1 || log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define C2R_CASE(L) \
  case L: return launch<L>(in_re, in_im, out, tw, half, rows, bins, scale, s);
    C2R_LOG2M_CASES(C2R_CASE)
#undef C2R_CASE
    default: return cudaErrorInvalidValue;
  }
}

// C2R of the products A * B: A as the input of c2r_fft_f32, B rows of the
// same `bins`, `b_rows` of them: 1 (broadcast over A's rows) or `rows`;
// out 8-byte aligned.  tw holds the pass roots of m = n/2
// (_pass_roots_np(m, +1)), half the m + 1 roots exp(+2pi*i*k/n), both
// interleaved (cos, sin) float32 pairs.
int c2r_prod_fft_f32(const void* ar, const void* ai, const void* br, const void* bi,
                     void* out, const void* tw, const void* half, long long rows,
                     long long b_rows, int log2m, int bins, float scale, void* stream) {
  if (rows < 1 || log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1 ||
      (b_rows != 1 && b_rows != rows) || reinterpret_cast<size_t>(out) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const ProdArgs g{static_cast<const float*>(ar), static_cast<const float*>(ai),
                   static_cast<const float*>(br), static_cast<const float*>(bi),
                   static_cast<float*>(out), static_cast<const float2*>(tw),
                   static_cast<const float2*>(half), rows, b_rows == 1 ? 0 : bins, bins,
                   scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define PROD_CASE(L) \
  case L: return launch_prod<L>(g, s);
    C2R_LOG2M_CASES(PROD_CASE)
#undef PROD_CASE
    default: return cudaErrorInvalidValue;
  }
}

const char* c2r_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
