// Batched 2-D complex-to-complex FFT over the two trailing axes of
// [planes, A, B], both axes in one pass over device memory.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft2_fused_core
// (its pl.pallas_call over _kernel_fft2f) for its envelope: A and B pow2
// >= 128 with A*B <= 2^16.  Per plane it computes
//
//     X[ka, kb] = scale * sum_{a,b} x[a, b] * exp(sign*2*pi*i*(ka*a/A + kb*b/B))
//
// in natural order, from and to device memory in either of two layouts:
// planar (re, im) float32 planes (fft2f_fft_f32) or interleaved complex64,
// one 8-byte pair a point (fft2f_fft_c64, a torch complex64 tensor as it
// lies, so fftn of complex64 needs no split and no merge).
//
// What bounds it: device memory (16 bytes read and written a point against
// about 5*log2(A*B) flops) and on-chip memory: a plane of 2^16 points is
// 512 KB of complex64, more than the 227 KB one block may hold.  So a plane
// is spread over a thread-block cluster of C = A*B / 4096 blocks (4 to 16)
// on neighbouring SMs, each holding 4096 points (kFft2fLog2P; 35 KB as
// padded interleaved pairs in 256 threads, four blocks an SM, so that one
// block's device-memory phases overlap another's passes):
//
//   1. block b runs the B-point row FFTs of its band of A/C rows, one row a
//      threadIdx.y, read from device memory by the first pass, into its
//      shared memory; cluster barrier (every band is done);
//   2. block b runs the A-point column FFTs of its B/C columns, the lanes
//      of a warp across the columns: the first pass reads point a of its
//      column from the band of block a / (A/C) (distributed shared memory)
//      and, between its reads and its writes, synchronises the cluster
//      (every read of every band precedes any overwrite: mixed_fft.cuh's
//      pass_barrier); the last pass stores rows ka of its columns from
//      registers to device memory, the scale folded in.
//
// Every pass is mixed_fft.cuh's, on the plan compiled in for its length
// (plan_fft; 256 = 16*16), 16 points a thread, each pass's twiddles in a
// table of its own (the host's ops/cuda_fft.py::_pass_roots_np).  Rows sit
// in shared memory as PadShared rows; columns at a stride of padded_len(A) |
// 1 pairs, so that consecutive lanes on consecutive columns hit distinct
// banks.  Measured against this design (scripts/time_pow2_variants.py,
// PERF.md): 8192 points a block, equal at 256^3 and slower at 16 planes; a
// gather of the columns into registers and a transposing write before the
// column passes, 1.4x slower; the cluster butterfly of ax0_fft.cu (each
// point across the cluster once, after a C-point DFT in registers), 1.8x
// slower.  Every read of a plane precedes the second cluster barrier and
// every store follows it; planes are disjoint, so the output may alias the
// input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

constexpr int kFft2fLog2P = 12;      // log2 of the points a block holds
constexpr int kFft2fRegisters = 64;  // a thread's registers, by the launch bound

template <int LOG2A, int LOG2B>
struct Fft2fShape {
  static constexpr int kA = 1 << LOG2A;
  static constexpr int kB = 1 << LOG2B;
  static constexpr int kC = 1 << (LOG2A + LOG2B - kFft2fLog2P);  // blocks of a cluster
  static constexpr int kThreads = (1 << kFft2fLog2P) / 16;
  static constexpr int kMinBlocks = 65536 / kFft2fRegisters / kThreads;
  static constexpr int kRows = kA / kC;  // rows of a block's band
  static constexpr int kCols = kB / kC;  // columns of a block
  static constexpr int kLd = padded_len(kA) | 1;
  static constexpr int kRowPairs = kRows * padded_len(kB);
  static constexpr int kColPairs = kCols * kLd;
  static constexpr int kSmem =
      (kRowPairs > kColPairs ? kRowPairs : kColPairs) * static_cast<int>(sizeof(float2));
  static_assert(kC >= 2 && kC <= 16, "a cluster of 2 to 16 blocks");
};

struct Fft2fArgs {
  const float* in_re;  // planar layout
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* in;  // interleaved layout
  float2* out;
  const float2* twa;  // _pass_roots_np(A, sign): the column passes'
  const float2* twb;  // _pass_roots_np(B, sign): the row passes'
  float scale;
};

// Output k of a block's column (row k of the plane), written by the last
// column pass with the scale folded in.
template <bool C64>
struct ColOut {
  const Fft2fArgs& g;
  size_t off;   // row 0 of the column
  size_t step;  // B
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    const size_t i = off + static_cast<size_t>(k) * step;
    if constexpr (C64) {
      g.out[i] = make_float2(a * g.scale, b * g.scale);
    } else {
      g.out_re[i] = a * g.scale;
      g.out_im[i] = b * g.scale;
    }
  }
};

// Row i = threadIdx.y of block b's band: its source in device memory and
// its buffer, the last pass's sink too.
template <int LOG2A, int LOG2B, bool C64>
struct Fft2fRow {
  using S = Fft2fShape<LOG2A, LOG2B>;
  const Fft2fArgs& g;
  size_t plane;  // the plane's first point
  int b;         // the block's rank in its cluster
  __device__ __forceinline__ size_t off() const {
    return plane + static_cast<size_t>(b * S::kRows + static_cast<int>(threadIdx.y)) * S::kB;
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(S::kB)};
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (C64) {
      return C64In{g.in + off()};
    } else {
      return GlobalIn{g.in_re + off(), g.in_im + off()};
    }
  }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

// Point a of column col of block b's columns, in the band of block a / (A/C)
// (distributed shared memory): the first column pass's source, whose
// barrier between its reads and its writes is the cluster's.
template <int LOG2A, int LOG2B>
struct BandIn {
  using S = Fft2fShape<LOG2A, LOG2B>;
  int b;
  int col;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int a, float& x, float& y) const {
    extern __shared__ float2 smem[];
    PadShared{cg::this_cluster().map_shared_rank(smem + (a % S::kRows) * padded_len(S::kB),
                                                 a / S::kRows)}
        .load(b * S::kCols + col, x, y);
  }
  __device__ __forceinline__ void barrier() const { cg::this_cluster().sync(); }
};

// This thread's column of block b's columns (thread % columns; its index
// among the column's A/16 threads is thread / columns): read from the
// bands, transformed in its own shared memory, stored to rows ka.
template <int LOG2A, int LOG2B, bool C64>
struct Fft2fCol {
  using S = Fft2fShape<LOG2A, LOG2B>;
  const Fft2fArgs& g;
  size_t plane;
  int b;
  __device__ __forceinline__ int flat() const {
    return static_cast<int>(threadIdx.y * blockDim.x + threadIdx.x);
  }
  __device__ __forceinline__ int col() const { return flat() % S::kCols; }
  __device__ __forceinline__ int2 lanes() const {
    return make_int2(S::kA / 16, flat() / S::kCols);
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + col() * S::kLd};
  }
  __device__ __forceinline__ BandIn<LOG2A, LOG2B> src() const { return {b, col()}; }
  __device__ __forceinline__ ColOut<C64> dst() const {
    return {g, plane + static_cast<size_t>(b * S::kCols + col()), static_cast<size_t>(S::kB)};
  }
};

template <int SIGN, int LOG2A, int LOG2B, bool C64>
__global__ void __launch_bounds__(Fft2fShape<LOG2A, LOG2B>::kThreads,
                                  Fft2fShape<LOG2A, LOG2B>::kMinBlocks)
fft2f_fft_kernel(const __grid_constant__ Fft2fArgs g) {
  using S = Fft2fShape<LOG2A, LOG2B>;
  const int b = static_cast<int>(cg::this_cluster().block_rank());
  const size_t plane = static_cast<size_t>(blockIdx.x / S::kC) * S::kA * S::kB;
  plan_fft<SIGN, LOG2B>(Fft2fRow<LOG2A, LOG2B, C64>{g, plane, b}, g.twb);
  cg::this_cluster().sync();  // every band is transformed
  plan_fft<SIGN, LOG2A>(Fft2fCol<LOG2A, LOG2B, C64>{g, plane, b}, g.twa);
}

template <int LOG2A, int LOG2B, bool C64>
cudaError_t launch(int sign, const Fft2fArgs& g, long long planes, cudaStream_t stream) {
  using S = Fft2fShape<LOG2A, LOG2B>;
  if (planes * S::kC > 2147483647LL) return cudaErrorInvalidValue;
  void (*kernel)(Fft2fArgs) = sign < 0 ? fft2f_fft_kernel<-1, LOG2A, LOG2B, C64>
                                       : fft2f_fft_kernel<1, LOG2A, LOG2B, C64>;
  cudaError_t e = cudaSuccess;
  if constexpr (S::kSmem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
  }
  if constexpr (S::kC > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * S::kC));
  cfg.blockDim = dim3(S::kB / 16, S::kRows);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool C64>
int dispatch(const Fft2fArgs& g, long long planes, int log2a, int log2b, int log2c, int sign,
             void* stream) {
  if (planes < 1 || (sign != 1 && sign != -1) || log2c != log2a + log2b - kFft2fLog2P) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define FFT2F_CASE(LA, LB) \
  if (log2a == LA && log2b == LB) return launch<LA, LB, C64>(sign, g, planes, s);
  FFT2F_CASE(7, 7) FFT2F_CASE(7, 8) FFT2F_CASE(8, 7)
  FFT2F_CASE(7, 9) FFT2F_CASE(9, 7) FFT2F_CASE(8, 8)
#undef FFT2F_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Transforms both trailing axes of `planes` contiguous [A, B] planes,
// A = 2^log2a, B = 2^log2b, pow2 >= 128 with A*B <= 2^16, planar float32,
// in clusters of 2^log2c = A*B/4096 blocks (the host's _FFT2F_LOG2P).  twa
// and twb hold the pass roots of A and of B (_pass_roots_np(., sign)),
// interleaved (cos, sin) float32 pairs.  The output may alias the input.
// Launches on `stream` and returns the launch's error (0 = ok).
int fft2f_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                  const void* twa, const void* twb, long long planes, int log2a, int log2b,
                  int log2c, int sign, float scale, void* stream) {
  const Fft2fArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                    static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr,
                    nullptr, static_cast<const float2*>(twa),
                    static_cast<const float2*>(twb), scale};
  return dispatch<false>(g, planes, log2a, log2b, log2c, sign, stream);
}

// The same over interleaved complex64 planes: (re, im) float32 pairs, 8-byte
// aligned.  The output may alias the input.
int fft2f_fft_c64(const void* in, void* out, const void* twa, const void* twb,
                  long long planes, int log2a, int log2b, int log2c, int sign, float scale,
                  void* stream) {
  const Fft2fArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                    static_cast<float2*>(out), static_cast<const float2*>(twa),
                    static_cast<const float2*>(twb), scale};
  return dispatch<true>(g, planes, log2a, log2b, log2c, sign, stream);
}

const char* fft2f_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
