// Batched 2-D complex-to-complex FFT over the two trailing axes of
// [planes, A, B], both axes in one pass over device memory.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft2_fused_core
// (its pl.pallas_call over _kernel_fft2f) for its envelope: A and B pow2
// >= 128 with A*B <= 2^16.  Per plane it computes
//
//     X[ka, kb] = scale * sum_{a,b} x[a, b] * exp(sign*2*pi*i*(ka*a/A + kb*b/B))
//
// in natural order, planar float32 (re, im) in and out.
//
// What bounds it: on-chip memory.  The TPU kernel holds a whole plane in
// VMEM and transposes it twice; a plane of 2^16 points is 512 KB of planar
// float32, more than the 227 KB one block may hold.  So a plane is spread
// over a thread-block cluster of C = A*B / 2^13 blocks (2, 4 or 8) on
// neighbouring SMs, each holding Q = 2^13 points (64 KB plus padding):
//
//   1. block b runs the B-point row FFTs of its band of A/C rows, reading
//      them from device memory (coalesced) into its shared memory;
//   2. cluster barrier;
//   3. block b gathers its B/C columns, all A points of each, from the
//      bands of every block (distributed shared memory) into registers, 32
//      points a thread;
//   4. cluster barrier: every read of every band precedes any overwrite;
//   5. block b writes the gathered columns into its own shared memory as
//      contiguous columns and runs the A-point column FFTs there;
//   6. block b stores its columns in natural order, coalesced along B,
//      with the scale folded in.
//
// Device memory sees one read and one write per point, against two round
// trips for the per-axis route (row kernel, then axis(-2) kernel).  The band
// goes through registers in step 3, so one buffer per block suffices.  The
// steps of one block run one after another with a barrier between, so the
// block is small enough that two share an SM and one's device-memory phases
// overlap the other's: 256 threads of at most 128 registers, 66 KB of
// shared memory.  (Q = 2^14 points in 132 KB blocks of 1024 threads, one
// block an SM, took 5-41% longer on every plane of the envelope and lost to
// the per-axis route on all of them, PERF.md.)  Rows and columns in shared memory are
// padded by one float so that the transposing accesses of steps 3, 5 and 6
// hit distinct banks.  The passes are those of stockham.cuh; T = min(A, B)/4
// threads work on one row or column and 256/T rows or columns run at once.
// The cluster barrier of step 2 orders every block's reads of the plane
// before any block's store, and planes are disjoint, so the output may
// alias the input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

constexpr int kThreads = 256;
constexpr int kLog2Q = 13;  // points held by one block
constexpr int kPer = (1 << kLog2Q) / kThreads;  // gathered points a thread

__host__ __device__ constexpr int fft2f_cluster(int log2a, int log2b) {
  return 1 << (log2a + log2b - kLog2Q);
}

// Threads per row or column.
__host__ __device__ constexpr int fft2f_threads(int log2a, int log2b) {
  return min_int(threads_for(log2a), threads_for(log2b));
}

// Floats of one plane (re or im) in a block's shared memory: the larger of
// the padded band [A/C][B+1] and the padded columns [B/C][A+1].
__host__ __device__ constexpr int fft2f_half(int log2a, int log2b) {
  return (((1 << log2a) / fft2f_cluster(log2a, log2b)) * ((1 << log2b) + 1)) >
                 (((1 << log2b) / fft2f_cluster(log2a, log2b)) * ((1 << log2a) + 1))
             ? ((1 << log2a) / fft2f_cluster(log2a, log2b)) * ((1 << log2b) + 1)
             : ((1 << log2b) / fft2f_cluster(log2a, log2b)) * ((1 << log2a) + 1);
}

template <int LOG2A, int LOG2B>
__global__ void __launch_bounds__(kThreads, 2)
fft2f_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                 float* out_im, const float2* __restrict__ twa,
                 const float2* __restrict__ twb, float sign, float scale) {
  constexpr int A = 1 << LOG2A;
  constexpr int B = 1 << LOG2B;
  constexpr int C = fft2f_cluster(LOG2A, LOG2B);
  constexpr int AB = A / C;  // rows of this block's band
  constexpr int BC = B / C;  // columns this block transforms
  constexpr int T = fft2f_threads(LOG2A, LOG2B);
  constexpr int RY = kThreads / T;
  constexpr int LDB = B + 1;
  constexpr int LDA = A + 1;
  static_assert(C >= 2 && C <= 8, "a portable cluster of several blocks");
  static_assert(AB % RY == 0 && BC % RY == 0, "rows and columns split evenly");
  static_assert(AB * B == kPer * kThreads, "every thread gathers kPer points");
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + fft2f_half(LOG2A, LOG2B);
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const size_t plane = static_cast<size_t>(blockIdx.x / C) * A * B;
  const int tid = threadIdx.y * T + threadIdx.x;

  // 1. the row FFTs of this block's band, read from device memory
  for (int r0 = 0; r0 < AB; r0 += RY) {
    const int r = r0 + threadIdx.y;
    const size_t g = plane + static_cast<size_t>(b * AB + r) * B;
    const Shared row{sr + r * LDB, si + r * LDB};
    fft_passes<LOG2B, T>(GlobalIn{in_re + g, in_im + g}, row, row, twb, sign);
  }
  cluster.sync();

  // 3. this block's columns from every band, into registers
  float vr[kPer], vi[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    const int c = idx % BC, a = idx / BC;
    const int off = (a % AB) * LDB + b * BC + c;
    vr[p] = cluster.map_shared_rank(sr, a / AB)[off];
    vi[p] = cluster.map_shared_rank(si, a / AB)[off];
  }
  cluster.sync();

  // 5. the gathered columns, contiguous, and their FFTs in place
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    const int c = idx % BC, a = idx / BC;
    sr[c * LDA + a] = vr[p];
    si[c * LDA + a] = vi[p];
  }
  __syncthreads();
  for (int c0 = 0; c0 < BC; c0 += RY) {
    const int c = c0 + threadIdx.y;
    const Shared col{sr + c * LDA, si + c * LDA};
    fft_passes<LOG2A, T>(col, col, col, twa, sign);
  }

  // 6. natural order, coalesced along B
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    const int c = idx % BC, a = idx / BC;
    const size_t g = plane + static_cast<size_t>(a) * B + b * BC + c;
    out_re[g] = sr[c * LDA + a] * scale;
    out_im[g] = si[c * LDA + a] * scale;
  }
}

template <int LOG2A, int LOG2B>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* twa, const void* twb,
                   long long planes, float sign, float scale,
                   cudaStream_t stream) {
  constexpr int C = fft2f_cluster(LOG2A, LOG2B);
  constexpr int T = fft2f_threads(LOG2A, LOG2B);
  constexpr int smem = 2 * fft2f_half(LOG2A, LOG2B) * static_cast<int>(sizeof(float));
  if (planes * C > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = fft2f_fft_kernel<LOG2A, LOG2B>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * C));
  cfg.blockDim = dim3(T, kThreads / T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(in_re),
                         static_cast<const float*>(in_im),
                         static_cast<float*>(out_re), static_cast<float*>(out_im),
                         static_cast<const float2*>(twa),
                         static_cast<const float2*>(twb), sign, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms both trailing axes of `planes` contiguous [A, B] planes,
// A = 2^log2a, B = 2^log2b, pow2 >= 128 with A*B <= 2^16, planar float32.
// twa and twb hold A and B interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/A) and exp(sign*2pi*i*k/B).  The output may alias the
// input.  Launches on `stream` and returns the launch's error
// (0 = ok).
int fft2f_fft_f32(const void* in_re, const void* in_im, void* out_re,
                  void* out_im, const void* twa, const void* twb,
                  long long planes, int log2a, int log2b, int sign, float scale,
                  void* stream) {
  if (planes < 1 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
#define FFT2F_CASE(LA, LB)                                                      \
  if (log2a == LA && log2b == LB)                                               \
    return launch<LA, LB>(in_re, in_im, out_re, out_im, twa, twb, planes, sg, \
                          scale, s);
  FFT2F_CASE(7, 7) FFT2F_CASE(7, 8) FFT2F_CASE(8, 7)
  FFT2F_CASE(7, 9) FFT2F_CASE(9, 7) FFT2F_CASE(8, 8)
#undef FFT2F_CASE
  return cudaErrorInvalidValue;
}

const char* fft2f_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
