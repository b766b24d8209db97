// Batched real-to-complex FFT along the last axis for composite lengths
// that are not powers of two, odd and even.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_rfft_gen_core
// (its pl.pallas_call over _kernel_r2c_gen).  For n in the envelope of
// gen_fft.cu it computes per real row x the half spectrum
//
//     X[k] = scale * sum_m x[m] * exp(-2*pi*i * k*m / n),   k <= n/2,
//
// planar float32 out, in rows of `bins` floats: n/2 + 1 (numpy's shape) or
// the padded serving form pad_bins(n) with exact zeros past bin n/2.
//
// The TPU kernel ran the two-factor contraction on the real row.  Here the
// row runs the mixed-radix passes of mixed_fft.cuh in one launch and one
// pass over device memory:
// - even n: the n real points are read as m = n/2 complex points
//   z[j] = x[2j] + i x[2j+1], the m-point transform Z runs in shared memory
//   (its plan, from _mixed_radix_plan(m), is handed in), and the store
//   recombines X[k] = (Z[k] + conj(Z[m-k]))/2 - (i/2) t[k] (Z[k] -
//   conj(Z[m-k])) with t[k] = exp(-2*pi*i*k/n), as r2c_fft.cu does for
//   pow2 n;
// - odd n: the n-point complex transform of the real row: the first pass
//   loads no imaginary plane, the last stores only the bins k <= n/2.
// Each row is its own transform: packing two rows into one would make a
// row's error depend on the size of its neighbour.
//
// What bounds it: device memory moves 4 bytes in and about 4 out per point
// (0.010 ms at 1024 x 4095 at 3.35 TB/s); the passes cost what gen_fft.cu's
// do, on n/2 points for even n.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// A real row as complex points with zero imaginary part (a row past the
// last reads the first: its outputs are never stored).
struct RealIn {
  const float* x;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = x[k];
    b = 0.f;
  }
};

// A real row read as complex points z[k] = x[2k] + i x[2k+1].
struct PairedRealIn {
  const float* x;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = x[2 * k];
    b = x[2 * k + 1];
  }
};

// Bins k < mp of a row with the scale folded in; nothing past bin n/2 or
// for a row past the last.
struct HalfOut {
  float* r;
  float* i;
  float scale;
  int mp;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid || k >= mp) return;
    r[k] = a * scale;
    i[k] = b * scale;
  }
};

struct R2cArgs {
  const float* in;
  float* out_re;
  float* out_im;
  const float2* tw;
  long long rows;
  MixedPlan plan;  // of m = n/2 points for even n, else of n
  int n;
  int bins;
  float scale;
};

// This thread's row (one per threadIdx.y), its sources and sinks, built
// from the kernel's arguments where a pass needs them.
template <bool EVEN>
struct R2cRow {
  const R2cArgs& g;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ const float* x() const {
    return g.in + static_cast<size_t>(valid() ? row() : 0) * g.n;
  }
  __device__ __forceinline__ size_t o() const {
    return static_cast<size_t>(valid() ? row() : 0) * g.bins;
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (EVEN) {
      return PairedRealIn{x()};
    } else {
      return RealIn{x()};
    }
  }
  __device__ __forceinline__ auto dst() const {
    if constexpr (EVEN) {
      return shared();
    } else {
      return HalfOut{g.out_re + o(), g.out_im + o(), g.scale, g.n / 2 + 1, valid()};
    }
  }
  __device__ __forceinline__ Shared shared() const {
    extern __shared__ float smem[];
    float* sr = smem + threadIdx.y * 2 * g.plan.n;
    return Shared{sr, sr + g.plan.n};
  }
  __device__ __forceinline__ float2* roots() const {
    extern __shared__ float smem[];
    return reinterpret_cast<float2*>(smem + blockDim.y * 2 * g.plan.n);
  }
};

template <bool EVEN>
__global__ void __launch_bounds__(kMixMaxThreads)
r2c_gen_fft_kernel(const __grid_constant__ R2cArgs g) {
  const R2cRow<EVEN> row{g};
  const int mp = g.n / 2 + 1;
  // even n: the m-point passes, w_m^e = w_n^(2e), the n-point table at stride 2
  mixed_fft<-1>(row, g.plan, g.tw, EVEN ? 2 : 1);
  if (!row.valid()) return;
  float* out_re = g.out_re + row.o();
  float* out_im = g.out_im + row.o();
  if constexpr (EVEN) {
    // The passes end with a barrier: Z is in shared memory for the whole row.
    const int m = g.plan.n;
    const Shared z = row.shared();
    for (int k = threadIdx.x; k < g.bins; k += blockDim.x) {
      float xr = 0.f, xi = 0.f;
      if (k <= m) {
        const int a = k == m ? 0 : k, b = k == 0 ? 0 : m - k;
        const float er = 0.5f * (z.r[a] + z.r[b]), ei = 0.5f * (z.i[a] - z.i[b]);
        const float dr = 0.5f * (z.r[a] - z.r[b]), di = 0.5f * (z.i[a] + z.i[b]);
        const float2 t = __ldg(&g.tw[k]);
        xr = (er + (t.x * di + t.y * dr)) * g.scale;
        xi = (ei - (t.x * dr - t.y * di)) * g.scale;
      }
      out_re[k] = xr;
      out_im[k] = xi;
    }
  } else {
    for (int k = mp + threadIdx.x; k < g.bins; k += blockDim.x) {
      out_re[k] = 0.f;
      out_im[k] = 0.f;
    }
  }
}

template <bool EVEN>
cudaError_t launch(const R2cArgs& g, cudaStream_t stream) {
  const MixedShape shape = mixed_shape(g.plan, EVEN);
  if (shape.threads == 0) return cudaErrorInvalidValue;
  const long long blocks = (g.rows + shape.rows - 1) / shape.rows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (shape.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        r2c_gen_fft_kernel<EVEN>, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
    if (e != cudaSuccess) return e;
  }
  r2c_gen_fft_kernel<EVEN><<<static_cast<unsigned>(blocks),
                             dim3(shape.threads, shape.rows), shape.smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// R2C of `rows` contiguous real rows of n float32 points into planar rows
// of `bins` >= n/2 + 1 floats (zeros past bin n/2).  radix[0..np) is the
// plan of the transform: of n/2 points for even n, of n for odd n.  tw
// holds n interleaved (cos, sin) float32 pairs of exp(-2pi*i*m/n).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int r2c_gen_fft_f32(const void* in, void* out_re, void* out_im, const void* tw,
                    long long rows, int n, const int* radix, int np, int bins,
                    float scale, void* stream) {
  const bool even = n % 2 == 0;
  R2cArgs g{static_cast<const float*>(in), static_cast<float*>(out_re),
            static_cast<float*>(out_im), static_cast<const float2*>(tw), rows, {}, n,
            bins, scale};
  if (rows < 1 || n > 16384 || bins < n / 2 + 1 ||
      !mixed_plan_make(radix, np, even ? n / 2 : n, &g.plan)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return even ? launch<true>(g, s) : launch<false>(g, s);
}

const char* r2c_gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
