// Whole-row complex-to-complex FFT in one launch, the row held on chip by a
// thread-block cluster, planar float32 or interleaved complex64 rows.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/bigfft.py::_fft_big_core (its
// pl.pallas_call over _kernel, fft_wgpu_tpu/ops/bigfft.py:139), which keeps
// a whole row of 2^15 .. 2^21 points in VMEM.  Per row of n points it
// computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, reading and writing each point of device memory once,
// in either of two layouts: planar (re, im) float32 planes (big_fft_f32) or
// interleaved complex64 (big_fft_c64, a torch complex64 tensor as it lies).
//
// What bounds it: device memory, 16 bytes a point read and written once
// (0.0801 ms at 256 x 2^16 and 0.0200 ms at 16 x 2^18 on 3.35 TB/s), and
// on-chip memory.  A row of 2^15 points is 256 KB, more than the 227 KB one
// block may hold, so the row is spread over a cluster of C blocks on
// neighbouring SMs, each holding Q = n/C points (at most 16384, 136 KB
// padded).  C = 4 at 2^15 and C = 8, the portable cluster size, at 2^16
// and 2^17 give blocks of 8192 or 16384 points; C = 16 (a non-portable
// size, allowed by a function attribute) covers 2^18.  The host picks C
// (ops/bigfft.py::_cluster) and the kernel checks it.
//
// An n-point transform over C blocks turns the whole row twice, once on
// each side of the blocks' own Q-point transforms.  The first turn is the
// kernel's read of device memory at stride C, the second goes through
// distributed shared memory (a block reading its peers' shared memory), so
// each point crosses distributed shared memory once.  With x[q*C + b] and
// X[k2 + Q*k1] (decimation in time):
//
//   1. block b runs Q's compiled plan (mixed_fft.cuh's plan_fft; 16384 =
//      16*16*8*8) on its decimated row x[q*C + b], q < Q, whose first pass
//      reads device memory at stride C (consecutive lanes on consecutive
//      q), into its own shared memory: Y_b[k2];
//   2. cluster barrier: every block's Y is in place and every read of the
//      row is done;
//   3. block b takes the positions k2 in [b*P, (b+1)*P), P = Q/C: it reads
//      Y_c[k2] from the C blocks, twiddles them by w_n^(c*k2), takes the
//      C-point DFT in registers (mixed_fft.cuh's dft<C> butterfly),
//        X[k2 + Q*k1] = sum_c w_C^(c*k1) * w_n^(c*k2) * Y_c[k2],
//      and stores the C outputs with the scale folded in, consecutive
//      lanes on consecutive k2;
//   4. cluster barrier, since no block may exit while others read its
//      shared memory.
//
// Chosen by measurement on an H100 (scripts/time_pow2_variants.py --lib
// big_fft, which keeps every design below as a variant): the design
// before, whose every point crossed distributed shared memory twice
// (written to its owner block before the blocks' passes, read back from
// the C blocks after them), was 1.2-1.4x slower at every shape timed; the
// decimation in frequency, whose last pass stores X[b + C*k2] at stride C
// (the output through L2), 1.5-2.5x slower; two or four decimated rows a
// block (the R points of a 32-byte sector read by one block) slower again,
// their strided read slower than this one's; the twiddle in the last
// pass's store 4-8% slower than in the butterfly step; C = 8 at 2^15 and
// C = 16 at 2^17 no faster at the main path's row counts; one block an SM
// at Q = 8192 slower.  The strided read fetches a 32-byte sector for each
// 8-byte point (4 bytes planar); the C blocks of a row read each sector's
// other points from L2 within the same phase.
//
// Each block runs Q/16 threads, so that a thread holds 16 points in every
// step: one radix-16 or two radix-8 butterflies a pass, 16/C positions of C
// points in the butterfly step.  A block's row in shared memory is
// mixed_fft.cuh's padded interleaved layout (PadShared).
//
// Twiddles, all from one float32 table generated in float64 on the host
// (ops/bigfft.py::_big_roots_np): w_n^(c*k2) for k2 < Q, c < C as
// w_n^(p*c) * w_n^(l*c) with l = k2 mod 32 (a lane) and p = k2 - l, the
// first factor one root of the table w_n^(32*m) read by the whole warp at
// once, the second a root of the table w_n^(l*c), [C][32], read by
// consecutive lanes; then the roots of each pass of Q's plan
// (_pass_roots_np(Q)).  All reads of a row's device memory precede the
// first cluster barrier and all its writes follow it, so the output may
// alias the input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

struct BigArgs {
  const float* in_re;  // planar layout
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* in;  // interleaved layout
  float2* out;
  const float2* tw;  // _big_roots_np(n, sign)
  float scale;
};

// Threads a block: a thread per 16 points of the block's Q, and the launch
// bound's blocks an SM (two at Q = 8192, 64 registers; up to 80 at Q = 4096).
template <int LOG2Q>
struct BigShape {
  static constexpr int kThreads = (1 << LOG2Q) / 16;
  static constexpr int kMinBlocks = kThreads == 256 ? 3 : kThreads == 512 ? 2 : 1;
  static constexpr int kSmem = padded_len(1 << LOG2Q) * static_cast<int>(sizeof(float2));
};

// Point q of a block's decimated row, x[q*C] from its first point.
template <int C, bool C64>
struct StridedIn {
  const float* r;  // planar
  const float* i;
  const float2* z;  // complex64
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int q, float& a, float& b) const {
    if constexpr (C64) {
      const float2 v = z[static_cast<size_t>(q) * C];
      a = v.x;
      b = v.y;
    } else {
      a = r[static_cast<size_t>(q) * C];
      b = i[static_cast<size_t>(q) * C];
    }
  }
};

// A block's Q-point transform: its decimated row in device memory -> the
// block's shared memory.
template <class Src>
struct BigRow {
  Src in;
  PadShared s;
  __device__ __forceinline__ const Src& src() const { return in; }
  __device__ __forceinline__ const PadShared& shared() const { return s; }
  __device__ __forceinline__ const PadShared& dst() const { return s; }
};

template <int SIGN, int LOG2N, int LOG2C, bool C64>
__global__ void __launch_bounds__(BigShape<LOG2N - LOG2C>::kThreads,
                                  BigShape<LOG2N - LOG2C>::kMinBlocks)
big_fft_kernel(const __grid_constant__ BigArgs g) {
  constexpr int N = 1 << LOG2N;
  constexpr int C = 1 << LOG2C;
  constexpr int LOG2Q = LOG2N - LOG2C;
  constexpr int Q = 1 << LOG2Q;
  constexpr int T = BigShape<LOG2Q>::kThreads;
  constexpr int P = Q / C;   // positions of a block
  constexpr int PT = 16 / C;  // positions of a thread
  static_assert(PT * T == P, "a thread holds 16 points");
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x);
  const size_t row = static_cast<size_t>(blockIdx.x / C) * N;

  // 1. Y_b = the Q-point transform of x[q*C + b], from device memory
  StridedIn<C, C64> in{};
  if constexpr (C64) {
    in.z = g.in + row + b;
  } else {
    in.r = g.in_re + row + b;
    in.i = g.in_im + row + b;
  }
  plan_fft<SIGN, LOG2Q>(BigRow<StridedIn<C, C64>>{in, {smem}}, g.tw + C * 32 + N / 32);
  cluster.sync();

  // 3. X[k2 + Q*k1] from Y_c[k2] of every block c
  const float2* lane_tw = g.tw + (tid & 31);  // w_n^(l*c) at [c*32]
  const float2* warp_tw = g.tw + C * 32;      // w_n^(32*m)
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int k2 = b * P + tid + i * T;
    float zr[C], zi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      PadShared{cluster.map_shared_rank(smem, c)}.load(k2, zr[c], zi[c]);
    }
#pragma unroll
    for (int c = 1; c < C; ++c) {  // w_n^(c*k2)
      float2 w = __ldg(&warp_tw[(k2 >> 5) * c]);
      cmul(w.x, w.y, __ldg(&lane_tw[c * 32]));
      cmul(zr[c], zi[c], w);
    }
    dft<C, SIGN>(zr, zi);
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      const size_t o = row + k2 + static_cast<size_t>(Q) * k1;
      if constexpr (C64) {
        g.out[o] = make_float2(zr[k1] * g.scale, zi[k1] * g.scale);
      } else {
        g.out_re[o] = zr[k1] * g.scale;
        g.out_im[o] = zi[k1] * g.scale;
      }
    }
  }
  cluster.sync();  // no block exits while others read its shared memory
}

template <int LOG2N, int LOG2C, bool C64>
auto kernel_of(int sign) {
  return sign < 0 ? big_fft_kernel<-1, LOG2N, LOG2C, C64> : big_fft_kernel<1, LOG2N, LOG2C, C64>;
}

// The launch configuration of `rows` rows: a cluster of C blocks a row.
template <int LOG2N, int LOG2C, bool C64>
cudaError_t configure(int sign, long long rows, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  using S = BigShape<LOG2N - LOG2C>;
  constexpr int C = 1 << LOG2C;
  if (rows * C > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = kernel_of<LOG2N, LOG2C, C64>(sign);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e != cudaSuccess) return e;
  if constexpr (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * C));
  cfg->blockDim = dim3(S::kThreads);
  cfg->dynamicSmemBytes = S::kSmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int LOG2N, int LOG2C, bool C64>
cudaError_t launch(int sign, const BigArgs& g, long long rows, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<LOG2N, LOG2C, C64>(sign, rows, stream, &cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel_of<LOG2N, LOG2C, C64>(sign), g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of the launch fit on the card at once.
template <int LOG2N, int LOG2C, bool C64>
cudaError_t max_clusters(int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<LOG2N, LOG2C, C64>(-1, 1LL << 12, nullptr, &cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(count, kernel_of<LOG2N, LOG2C, C64>(-1), &cfg);
}

// The compiled (n, C) pairs: C = 4 at 2^15, 8 at 2^16 and 2^17, 16 at 2^18.
template <bool C64>
int dispatch(const BigArgs& g, long long rows, int log2n, int log2c, int sign, void* stream) {
  if (rows < 1 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n * 8 + log2c) {
    case 15 * 8 + 2: return launch<15, 2, C64>(sign, g, rows, s);
    case 16 * 8 + 3: return launch<16, 3, C64>(sign, g, rows, s);
    case 17 * 8 + 3: return launch<17, 3, C64>(sign, g, rows, s);
    case 18 * 8 + 4: return launch<18, 4, C64>(sign, g, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool C64>
int clusters(int log2n, int log2c, int* count) {
  switch (log2n * 8 + log2c) {
    case 15 * 8 + 2: return max_clusters<15, 2, C64>(count);
    case 16 * 8 + 3: return max_clusters<16, 3, C64>(count);
    case 17 * 8 + 3: return max_clusters<17, 3, C64>(count);
    case 18 * 8 + 4: return max_clusters<18, 4, C64>(count);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points,
// n = 2^15 .. 2^18, in clusters of 2^log2c blocks (ops/bigfft.py::_cluster).
// tw holds _big_roots_np(n, sign) as interleaved (cos, sin) float32 pairs.
// The output may alias the input.
// Launches on `stream` and returns the launch's error (0 = ok).
int big_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                const void* tw, long long rows, int log2n, int log2c, int sign, float scale,
                void* stream) {
  const BigArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                  static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                  static_cast<const float2*>(tw), scale};
  return dispatch<false>(g, rows, log2n, log2c, sign, stream);
}

// The same over interleaved complex64 rows: (re, im) float32 pairs, 8-byte
// aligned.
int big_fft_c64(const void* in, void* out, const void* tw, long long rows, int log2n,
                int log2c, int sign, float scale, void* stream) {
  const BigArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                  static_cast<float2*>(out), static_cast<const float2*>(tw), scale};
  return dispatch<true>(g, rows, log2n, log2c, sign, stream);
}

// How many clusters of n = 2^log2n's launch (2^log2c blocks, the planar
// entry's kernel, or the complex64 one's with c64 != 0) fit on the current
// device at once, into *count (cudaOccupancyMaxActiveClusters); returns
// the error (0 = ok).
int big_fft_max_clusters(int log2n, int log2c, int c64, int* count) {
  return c64 ? clusters<true>(log2n, log2c, count) : clusters<false>(log2n, log2c, count);
}

const char* big_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
