// Batched complex-to-complex FFT along the last axis for composite lengths
// that are not powers of two.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_rows_gen_core
// (its pl.pallas_call over _kernel_rows_gen).  For n in 512 .. 16384, not a
// power of two, with a split n = n1 * n2 into factors <= 256 (the JAX
// kernel's envelope), it computes per row
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, planar float32 (re, im) in and out, in one launch and
// one pass over device memory: the first pass of the plan reads the row,
// the passes run in shared memory, and the last pass stores X with the
// scale folded in.
//
// The TPU kernel contracted both factors of the split on the MXU after a
// transpose into the sublane axis.  On the CUDA cores that would be two
// direct DFTs, n*(n1 + n2) complex multiply-adds a row (128 a point at
// 4095 = 63 * 65), each with two shared-memory loads and a gathered root:
// load-bound at 20x the byte bound.  Here the row runs the mixed-radix
// Stockham passes of mixed_fft.cuh, planned by
// ops/cuda_fft.py::_mixed_radix_plan (4095 = 9*5*7*13, at most 34
// multiply-adds a point), hard-coded butterflies in registers, a generic
// register-tiled pass for a prime factor from 17 to 251.
//
// What bounds it on this card: device memory, 16 bytes a point in and out
// (0.020 ms at 1024 x 4095 at 3.35 TB/s), for lengths of small factors;
// the generic pass's p FMAs an output and their shared-memory loads for a
// large prime factor (4097 = 17 * 241).  The row sits in shared memory
// (8 bytes a point, 131 KB at 16383); rows that take fewer than 128
// threads share a block, one per threadIdx.y.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// Row of device memory (a row past the last reads the first: its
// outputs are never stored).
struct RowIn {
  const float* r;
  const float* i;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
};

// Row of device memory with the scale folded in; nothing for a row past
// the last.
struct RowOut {
  float* r;
  float* i;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid) return;
    r[k] = a * scale;
    i[k] = b * scale;
  }
};

struct GenArgs {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* tw;
  long long rows;
  MixedPlan plan;
  float scale;
};

// This thread's row (one per threadIdx.y), its sources and sinks, built
// from the kernel's arguments where a pass needs them.
struct GenRow {
  const GenArgs& g;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ size_t off() const {
    return static_cast<size_t>(valid() ? row() : 0) * g.plan.n;
  }
  __device__ __forceinline__ RowIn src() const {
    return RowIn{g.in_re + off(), g.in_im + off()};
  }
  __device__ __forceinline__ RowOut dst() const {
    return RowOut{g.out_re + off(), g.out_im + off(), g.scale, valid()};
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

template <int SIGN>
__global__ void __launch_bounds__(kMixMaxThreads)
gen_fft_kernel(const __grid_constant__ GenArgs g) {
  mixed_fft<SIGN>(GenRow{g}, g.plan, g.tw, 1);
}

template <int SIGN>
cudaError_t launch(const GenArgs& g, const MixedShape& shape, cudaStream_t stream) {
  const long long blocks = (g.rows + shape.rows - 1) / shape.rows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (shape.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gen_fft_kernel<SIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
    if (e != cudaSuccess) return e;
  }
  gen_fft_kernel<SIGN><<<static_cast<unsigned>(blocks), dim3(shape.threads, shape.rows),
                         shape.smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n planar float32 points by the plan
// radix[0..np) (product n, from _mixed_radix_plan).  tw holds n interleaved
// (cos, sin) float32 pairs of exp(sign*2pi*i*m/n), sign = -1 or +1.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int gen_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                const void* tw, long long rows, int n, const int* radix, int np,
                int sign, float scale, void* stream) {
  GenArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
            static_cast<float*>(out_re), static_cast<float*>(out_im),
            static_cast<const float2*>(tw), rows, {}, scale};
  if (rows < 1 || n > 16384 || (sign != -1 && sign != 1) ||
      !mixed_plan_make(radix, np, n, &g.plan)) {
    return cudaErrorInvalidValue;
  }
  const MixedShape shape = mixed_shape(g.plan, false);
  const auto s = static_cast<cudaStream_t>(stream);
  return sign < 0 ? launch<-1>(g, shape, s) : launch<1>(g, shape, s);
}

const char* gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
