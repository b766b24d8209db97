// Whole-row complex-to-complex FFT in one launch, the row held on chip by a
// thread-block cluster.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/bigfft.py::_fft_big_core (its
// pl.pallas_call over _kernel), which keeps a whole row of 2^15 .. 2^21
// points in VMEM.  Per row of n points it computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, planar float32 (re, im) in and out, reading and writing
// each point of device memory once.
//
// What bounds it: on-chip memory.  A row of 2^15 points is 256 KB of planar
// float32, more than the 227 KB one block may hold, so the row is spread
// over a cluster of C blocks on neighbouring SMs, each holding Q = n/C
// contiguous points (at most 16384, 128 KB), which read and write one
// another's shared memory (distributed shared memory).  C = 8, the portable
// cluster size, covers n <= 2^17; C = 16 (a non-portable size, allowed by a
// function attribute) covers 2^18.  With x[c*Q + q], X[k1 + C*k2] and
// P = Q/C:
//
//   1. block b loads its chunk x[b*Q .. b*Q + Q) (coalesced);
//   2. cluster barrier;
//   3. block b takes the positions q in [b*P, (b+1)*P) of every chunk: for
//      each it reads x[c*Q + q] from all C blocks, takes the C-point DFT
//        Y_k1[q] = w_n^(q*k1) * sum_c x[c*Q + q] * w_C^(c*k1),
//      and writes Y_k1[q] to block k1 at position q.  One thread reads and
//      writes position q of every block, and no other thread touches it, so
//      the exchange runs in place;
//   4. cluster barrier;
//   5. block b runs the Q-point Stockham passes (stockham.cuh) on Y_b in
//      its own shared memory: Z[b, k2] = X[b + C*k2];
//   6. cluster barrier;
//   7. block b' stores X[b'*Q + u] = Z[t mod C, t div C] for t = b'*Q + u,
//      gathered from the owning blocks, coalesced and with the scale folded;
//   8. cluster barrier, since no block may exit while others read its
//      shared memory.
//
// Device memory sees one read and one write per point.  Distributed shared
// memory carries each point three times: read and written in step 3, read
// in step 7.  (A first version had block b compute only its own k1 = b in
// step 3, reading all n points into every block: C*n reads per row, 2.1x
// slower at 256 x 2^16 on the card, PERF.md.)  Every twiddle comes from one
// float32 table of the n-th roots generated in float64: w_C^e = tw[e*Q],
// w_Q^e = tw[e*C].  All global reads of a row precede the barrier of step 2
// and all its writes follow step 6, so the output may alias the input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

// Threads per block: 512, so a thread may hold 128 registers for the C
// inputs and outputs of step 3 (1024 threads, capped at 64 registers and
// reading the C-point twiddles in the inner loop, were 1.5x slower at
// 256 x 2^16 on the card, PERF.md).
constexpr int kBigThreads = 512;

template <int LOG2N, int LOG2C>
__global__ void __launch_bounds__(kBigThreads)
big_fft_kernel(const float* in_re, const float* in_im, float* out_re,
               float* out_im, const float2* __restrict__ tw, float sign,
               float scale) {
  constexpr int N = 1 << LOG2N;
  constexpr int C = 1 << LOG2C;
  constexpr int LOG2Q = LOG2N - LOG2C;
  constexpr int Q = 1 << LOG2Q;
  constexpr int T = kBigThreads;
  static_assert(Q / 4 >= T, "every thread has a butterfly");
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + Q;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const size_t row = static_cast<size_t>(blockIdx.x / C) * N;

  // 1-2. this block's chunk
  for (int q = threadIdx.x; q < Q; q += T) {
    sr[q] = in_re[row + b * Q + q];
    si[q] = in_im[row + b * Q + q];
  }
  cluster.sync();

  // 3. the C-point DFTs of this block's positions, written to their owners
  constexpr int P = Q / C;
  float2 wc[C];  // w_C^j
#pragma unroll
  for (int j = 0; j < C; ++j) wc[j] = __ldg(&tw[j * Q]);
  for (int q = b * P + threadIdx.x; q < (b + 1) * P; q += T) {
    float xr[C], xi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xr[c] = cluster.map_shared_rank(sr, c)[q];
      xi[c] = cluster.map_shared_rank(si, c)[q];
    }
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 w = wc[(c * k1) & (C - 1)];
        ar += xr[c] * w.x - xi[c] * w.y;
        ai += xr[c] * w.y + xi[c] * w.x;
      }
      cmul(ar, ai, __ldg(&tw[q * k1]));
      cluster.map_shared_rank(sr, k1)[q] = ar;
      cluster.map_shared_rank(si, k1)[q] = ai;
    }
  }
  cluster.sync();

  // 5. the Q-point transform of Y_b in place
  const Shared z{sr, si};
  fft_passes<LOG2Q, T, C>(z, z, z, tw, sign);
  cluster.sync();

  // 7. natural order: X[t] = Z[t mod C, t div C]
  for (int u = threadIdx.x; u < Q; u += T) {
    const int t = b * Q + u;
    const int owner = t & (C - 1);
    const int pos = t >> LOG2C;
    out_re[row + t] = cluster.map_shared_rank(sr, owner)[pos] * scale;
    out_im[row + t] = cluster.map_shared_rank(si, owner)[pos] * scale;
  }
  cluster.sync();
}

template <int LOG2N, int LOG2C>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, long long rows, float sign,
                   float scale, cudaStream_t stream) {
  constexpr int C = 1 << LOG2C;
  constexpr int smem = 2 * (1 << (LOG2N - LOG2C)) * static_cast<int>(sizeof(float));
  if (rows * C > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = big_fft_kernel<LOG2N, LOG2C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  cfg.blockDim = dim3(kBigThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(in_re),
                         static_cast<const float*>(in_im),
                         static_cast<float*>(out_re), static_cast<float*>(out_im),
                         static_cast<const float2*>(tw), sign, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points,
// n = 2^15 .. 2^18.  tw holds n interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/n).  The output may alias the input.  Launches on
// `stream` and returns the launch's error (0 = ok).
int big_fft_f32(const void* in_re, const void* in_im, void* out_re,
                void* out_im, const void* tw, long long rows, int log2n,
                int sign, float scale, void* stream) {
  if (rows < 1 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
    case 15: return launch<15, 3>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 16: return launch<16, 3>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 17: return launch<17, 3>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 18: return launch<18, 4>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* big_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
