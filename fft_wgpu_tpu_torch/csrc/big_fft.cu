// Whole-row complex-to-complex FFT in one launch, the row held on chip by a
// thread-block cluster, planar float32 or interleaved complex64 rows.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/bigfft.py::_fft_big_core (its
// pl.pallas_call over _kernel), which keeps a whole row of 2^15 .. 2^21
// points in VMEM.  Per row of n points it computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, reading and writing each point of device memory once,
// in either of two layouts: planar (re, im) float32 planes (big_fft_f32) or
// interleaved complex64 (big_fft_c64, a torch complex64 tensor as it lies).
//
// What bounds it: on-chip memory.  A row of 2^15 points is 256 KB, more
// than the 227 KB one block may hold, so the row is spread over a cluster of
// C blocks on neighbouring SMs, each holding Q = n/C points (at most 16384,
// 136 KB padded), which write and read one another's shared memory
// (distributed shared memory).  C = 4 at 2^15 and C = 8, the portable
// cluster size, at 2^16 and 2^17 give blocks of 8192 or 16384 points (at
// 2^15, 4 blocks of 8192 ran 11% faster than 8 of 4096 on an H100); C = 16
// (a non-portable size, allowed by a function attribute) covers 2^18.  The
// host picks C (ops/bigfft.py::_cluster) and the kernel checks it.  With
// x[c*Q + q], X[k1 + C*k2] and P = Q/C:
//
//   3. block b takes the positions q in [b*P, (b+1)*P) of every chunk: it
//      reads x[c*Q + q] for c < C straight from device memory (consecutive
//      lanes on consecutive q), then, after a cluster barrier, takes the
//      C-point DFT in registers (mixed_fft.cuh's dft<C> butterfly),
//        Y_k1[q] = w_n^(q*k1) * sum_c x[c*Q + q] * w_C^(c*k1),
//      and writes Y_k1[q] to block k1 at position q;
//   4. cluster barrier;
//   5. block b runs Q's compiled plan (mixed_fft.cuh's plan_fft; 8192 =
//      16*8*8*8) on Y_b in its own shared memory: Z[b, k2] = X[b + C*k2];
//   6. cluster barrier;
//   7. block b takes the positions pos in [b*P, (b+1)*P): for each it reads
//      Z[c, pos] from the C blocks (consecutive lanes on consecutive pos)
//      and stores the C consecutive outputs X[C*pos + c] as 16-byte vector
//      stores, with the scale folded in;
//   8. cluster barrier, since no block may exit while others read its
//      shared memory.
//
// Device memory sees one read and one write a point; distributed shared
// memory carries each point twice, written in step 3 and read in step 7.
// Each block runs Q/16 threads, so that a thread holds 16 points in every
// step: 16/C positions of C points in steps 3 and 7, one radix-16 or two
// radix-8 butterflies a pass in step 5.  Each row of shared memory is
// mixed_fft.cuh's padded interleaved layout (PadShared).
//
// Twiddles, all from one float32 table generated in float64 on the host
// (ops/bigfft.py::_big_roots_np): w_n^(q*k1) = w_n^(q0*k1) * w_n^(l*k1)
// with l = q mod 32 (a lane) and q0 = q - l, the first factor one root of
// the table w_n^(32*m) read by the whole warp at once, the second a root of
// the table w_n^(l*k1), [C][32], read by consecutive lanes; then the roots
// of each pass of Q's plan (_pass_roots_np(Q)).  All global reads of a row
// precede the barrier of step 4 and all its writes follow step 6, so the
// output may alias the input.

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

// Step 5's row: the block's own shared memory, source and sink of every pass.
struct BigRow {
  PadShared s;
  __device__ __forceinline__ const PadShared& src() const { return s; }
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

  // 3. this block's positions of every chunk, from device memory
  float xr[PT][C], xi[PT][C];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const size_t q = row + b * P + tid + i * T;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (C64) {
        const float2 v = g.in[q + c * Q];
        xr[i][c] = v.x;
        xi[i][c] = v.y;
      } else {
        xr[i][c] = g.in_re[q + c * Q];
        xi[i][c] = g.in_im[q + c * Q];
      }
    }
  }
  // every block of the cluster runs before any writes to its shared memory
  cluster.sync();
  const float2* lane_tw = g.tw + (tid & 31);  // w_n^(l*k1) at [k1*32]
  const float2* warp_tw = g.tw + C * 32;      // w_n^(32*m)
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + tid + i * T;
    dft<C, SIGN>(xr[i], xi[i]);
#pragma unroll
    for (int k1 = 1; k1 < C; ++k1) {
      float2 w = __ldg(&warp_tw[(q >> 5) * k1]);
      cmul(w.x, w.y, __ldg(&lane_tw[k1 * 32]));
      cmul(xr[i][k1], xi[i][k1], w);
    }
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      PadShared{cluster.map_shared_rank(smem, k1)}.store(q, xr[i][k1], xi[i][k1]);
    }
  }
  cluster.sync();

  // 5. the Q-point transform of Y_b in place
  plan_fft<SIGN, LOG2Q>(BigRow{PadShared{smem}}, g.tw + C * 32 + N / 32);
  cluster.sync();

  // 7. natural order: X[C*pos + c] = Z[c, pos]
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pos = b * P + tid + i * T;
    float zr[C], zi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      PadShared{cluster.map_shared_rank(smem, c)}.load(pos, zr[c], zi[c]);
      zr[c] *= g.scale;
      zi[c] *= g.scale;
    }
    const size_t t = row + static_cast<size_t>(C) * pos;
    if constexpr (C64) {
      float4* o = reinterpret_cast<float4*>(g.out + t);
#pragma unroll
      for (int h = 0; h < C / 2; ++h) {
        o[h] = make_float4(zr[2 * h], zi[2 * h], zr[2 * h + 1], zi[2 * h + 1]);
      }
    } else {
      float4* o_re = reinterpret_cast<float4*>(g.out_re + t);
      float4* o_im = reinterpret_cast<float4*>(g.out_im + t);
#pragma unroll
      for (int h = 0; h < C / 4; ++h) {
        o_re[h] = make_float4(zr[4 * h], zr[4 * h + 1], zr[4 * h + 2], zr[4 * h + 3]);
        o_im[h] = make_float4(zi[4 * h], zi[4 * h + 1], zi[4 * h + 2], zi[4 * h + 3]);
      }
    }
  }
  cluster.sync();
}

template <int LOG2N, int LOG2C, bool C64>
cudaError_t launch(int sign, const BigArgs& g, long long rows, cudaStream_t stream) {
  using S = BigShape<LOG2N - LOG2C>;
  constexpr int C = 1 << LOG2C;
  if (rows * C > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = sign < 0 ? big_fft_kernel<-1, LOG2N, LOG2C, C64>
                          : big_fft_kernel<1, LOG2N, LOG2C, C64>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e != cudaSuccess) return e;
  if constexpr (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * C));
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points,
// n = 2^15 .. 2^18, in clusters of 2^log2c blocks (ops/bigfft.py::_cluster).
// tw holds _big_roots_np(n, sign) as interleaved (cos, sin) float32 pairs.
// The outputs are 16-byte aligned; the output may alias the input.
// Launches on `stream` and returns the launch's error (0 = ok).
int big_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                const void* tw, long long rows, int log2n, int log2c, int sign, float scale,
                void* stream) {
  const BigArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                  static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                  static_cast<const float2*>(tw), scale};
  return dispatch<false>(g, rows, log2n, log2c, sign, stream);
}

// The same over interleaved complex64 rows: (re, im) float32 pairs, the
// input 8-byte and the output 16-byte aligned.
int big_fft_c64(const void* in, void* out, const void* tw, long long rows, int log2n,
                int log2c, int sign, float scale, void* stream) {
  const BigArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                  static_cast<float2*>(out), static_cast<const float2*>(tw), scale};
  return dispatch<true>(g, rows, log2n, log2c, sign, stream);
}

const char* big_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
