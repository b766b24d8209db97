// Batched complex-to-complex FFT along axis -2 of [b, n, m]: the m columns
// of each n x m plane are the batch.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_axis0_core
// (its pl.pallas_call over _kernel_ax0 and _kernel_ax0_pipe) for pow2
// n = 2^7 .. 2^14, and on the free view [..., n, Y*Z] _fft_axis3_core.  For
// every column it computes
//
//     X[k, c] = scale * sum_i x[i, c] * exp(sign * 2*pi*i * k*i / n)
//
// in natural order, with no transpose in device memory, from and to device
// memory in either of two layouts: planar (re, im) float32 planes
// (ax0_fft_f32) or interleaved complex64, one 8-byte pair a point
// (ax0_fft_c64, a torch complex64 tensor as it lies).  It is pass 1 of the
// four-step (ops/fourstep.py) and the route of axis -2 and of the axes
// before it for a CUDA tensor.
//
// What bounds it: device memory, as for the row kernel (16 bytes read and
// written a point against about 5*log2(n) flops), and the access pattern: a
// column is strided by m in device memory, so a load or store moves runs of
// neighbouring columns of one row.  A cluster of C blocks takes a tile of
// CT neighbouring columns, and every access to device memory moves runs of
// CT columns of one row: CT*8 bytes of complex64 (64 bytes at CT = 8 for
// n = 512 .. 2048; 32 at CT = 4, which measured faster from 4096 on) or
// CT*4 bytes of each planar plane (16 columns, 64 bytes, up to n = 512; 8
// above).  The lanes of a warp span the tile's columns (column = thread
// % CT), so one load instruction of a warp reads 32/CT such runs.
//
// With x[c*Q + q] (Q = n/C), X[k1 + C*k2]:
//
//   1. (C > 1: n >= 4096 planar, 8192 complex64) block b takes the
//      positions q in [b*P, (b+1)*P) (P = Q/C) of every column: it reads
//      x[c*Q + q] for c < C from device memory, then, after a cluster
//      barrier, takes the C-point DFT in
//      registers (mixed_fft.cuh's dft<C>), multiplies output k1 by
//      w_n^(q*k1) (a root of the n-point table), and writes it to block k1
//      at position q of its column (distributed shared memory); cluster
//      barrier;
//   2. block b runs Q's compiled plan (mixed_fft.cuh's plan_fft) on each
//      of its CT columns, one column per CT-th thread, Q/16 threads a
//      column, 16 points a thread; with C = 1 its first pass reads the
//      column from device memory; its last pass stores Z[k2] = X[b + C*k2]
//      from registers to device memory, the scale folded in.
//
// Each column sits in shared memory as mixed_fft.cuh's padded interleaved
// pairs (PadShared), the columns 16/CT pairs (1 at CT >= 16) further apart
// than a padded row, so that the lanes' columns fall on distinct banks.  A
// cluster of up to 8 blocks is portable; 16 (n = 16384 planar) is allowed
// by a function attribute.  Shapes: ax0_log2c and ax0_cols
// (ops/cuda_fft.py::_ax0_log2c mirrors the first: the host builds the pass
// twiddles of Q; tests hold the two equal).  Blocks of 256 or 512 threads
// and 35 or 70 KB let two or three of them share an SM, so one block's
// loads overlap another's passes; at n = 2048 (and 4096 complex64) one
// block of 1024 threads and 139 KB holds whole columns and needs no
// cluster, which measured faster than clusters of smaller blocks.  Columns past
// m (a ragged last tile) load zeros and are not stored.  Tiles are counted
// in gridDim.x.  Every read of a cluster's tile precedes its second cluster
// barrier (C > 1) or its first block barrier (C = 1), and every store
// follows it; tiles are disjoint, so the output may alias the input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

// log2 of the blocks of a cluster, and the columns of its tile, for n =
// 2^log2n, log2n = 7 .. 14, planar (c64 = 0) and complex64 (c64 = 1): the
// shapes that measured fastest on an H100 among those of
// scripts/time_pow2_variants.py (one block of up to 2048 points a column,
// 4096 too for 4 complex64 columns; then clusters of 2048 or 1024 points a
// block's column; 4 complex64 columns from 4096 on).
__host__ __device__ constexpr int ax0_log2c(int log2n, int c64) {
  constexpr int t[2][8] = {{0, 0, 0, 0, 0, 2, 3, 4}, {0, 0, 0, 0, 0, 0, 2, 3}};
  return t[c64][log2n - 7];
}
__host__ __device__ constexpr int ax0_cols(int log2n, int c64) {
  constexpr int t[2][8] = {{32, 16, 16, 8, 8, 8, 8, 8}, {32, 16, 8, 8, 8, 4, 4, 4}};
  return t[c64][log2n - 7];
}

template <int LOG2N, bool C64>
struct Ax0Shape {
  static constexpr int kLog2C = ax0_log2c(LOG2N, C64);
  static constexpr int kC = 1 << kLog2C;               // blocks of a cluster
  static constexpr int kCols = ax0_cols(LOG2N, C64);   // columns of the tile
  static constexpr int kLog2Q = LOG2N - kLog2C;
  static constexpr int kQ = 1 << kLog2Q;               // points of a block's column
  static constexpr int kLanes = kQ / 16;               // threads of a column
  static constexpr int kThreads = kLanes * kCols;
  static constexpr int kLd = padded_len(kQ) + (kCols >= 16 ? 1 : 16 / kCols);
  static constexpr int kSmem = kCols * kLd * static_cast<int>(sizeof(float2));
  static constexpr int kMinBlocks =
      kThreads <= 128 ? 6 : kThreads == 256 ? 3 : 1024 / kThreads;
  static_assert(kThreads <= 1024 && 16 % kC == 0 && kQ >= 64, "launch shape");
};

struct Ax0Args {
  const float* in_re;  // planar layout
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* in;  // interleaved layout
  float2* out;
  const float2* tw_n;  // exp(sign*2pi*i*e/n), e < n: step 1's twiddles
  const float2* tw;    // _pass_roots_np(Q, sign): the passes' twiddles
  long long m;         // columns of a plane
  long long tiles;     // column tiles of a plane
  float scale;
};

// Point (row) k of a column in device memory at stride m, read by a first
// pass; zeros for a column past m.  No __restrict__: the output may alias
// the input.
template <bool C64>
struct ColIn {
  const Ax0Args& g;
  size_t off;  // the column's first point
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const size_t i = off + static_cast<size_t>(k) * g.m;
    if constexpr (C64) {
      const float2 v = valid ? g.in[i] : make_float2(0.f, 0.f);
      a = v.x;
      b = v.y;
    } else {
      a = valid ? g.in_re[i] : 0.f;
      b = valid ? g.in_im[i] : 0.f;
    }
  }
};

// Output k of a block's column, row r0 + C*k of the plane, written by the
// last pass with the scale folded in; nothing for a column past m.
template <bool C64>
struct ColOut {
  const Ax0Args& g;
  size_t off;    // row r0 of the column
  size_t step;   // C*m
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid) return;
    const size_t i = off + static_cast<size_t>(k) * step;
    if constexpr (C64) {
      g.out[i] = make_float2(a * g.scale, b * g.scale);
    } else {
      g.out_re[i] = a * g.scale;
      g.out_im[i] = b * g.scale;
    }
  }
};

// This thread's column of the tile (thread % CT; its index among the
// column's Q/16 threads is thread / CT) and its source, buffer and sink,
// built where a pass needs them.
template <int LOG2N, bool C64>
struct Ax0Col {
  using S = Ax0Shape<LOG2N, C64>;
  const Ax0Args& g;
  size_t base;  // the tile's first point: plane * n * m + its first column
  int b;        // the block's rank in its cluster
  bool valid;   // this thread's column is < m
  __device__ __forceinline__ int col() const { return threadIdx.x % S::kCols; }
  __device__ __forceinline__ int2 lanes() const {
    return make_int2(S::kLanes, static_cast<int>(threadIdx.x) / S::kCols);
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + col() * S::kLd};
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (S::kC == 1) {
      return ColIn<C64>{g, base + col(), valid};
    } else {
      return shared();
    }
  }
  __device__ __forceinline__ ColOut<C64> dst() const {
    return ColOut<C64>{g, base + static_cast<size_t>(b) * g.m + col(),
                       static_cast<size_t>(S::kC) * g.m, valid};
  }
};

// Step 1: this block's positions of every column of the tile, C points each,
// from device memory, through the C-point butterfly and its twiddles, to
// the blocks that transform them.
template <int SIGN, int LOG2N, bool C64>
__device__ __forceinline__ void cluster_butterfly(const Ax0Args& g, size_t base, int col,
                                                  bool valid) {
  using S = Ax0Shape<LOG2N, C64>;
  constexpr int C = S::kC, Q = S::kQ, CT = S::kCols;
  constexpr int P = Q / C;    // positions of a block
  constexpr int PT = 16 / C;  // positions of a thread
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int t = static_cast<int>(threadIdx.x) / CT;
  float xr[PT][C], xi[PT][C];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + t + i * S::kLanes;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t at = base + static_cast<size_t>(c * Q + q) * g.m + col;
      if constexpr (C64) {
        const float2 v = valid ? g.in[at] : make_float2(0.f, 0.f);
        xr[i][c] = v.x;
        xi[i][c] = v.y;
      } else {
        xr[i][c] = valid ? g.in_re[at] : 0.f;
        xi[i][c] = valid ? g.in_im[at] : 0.f;
      }
    }
  }
  // every block of the cluster runs before any writes to its shared memory
  cluster.sync();
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + t + i * S::kLanes;
    dft<C, SIGN>(xr[i], xi[i]);
#pragma unroll
    for (int k1 = 1; k1 < C; ++k1) cmul(xr[i][k1], xi[i][k1], __ldg(&g.tw_n[q * k1]));
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      PadShared{cluster.map_shared_rank(smem + col * S::kLd, k1)}.store(q, xr[i][k1],
                                                                         xi[i][k1]);
    }
  }
  cluster.sync();  // every column of every block is in place
}

template <int SIGN, int LOG2N, bool C64>
__global__ void __launch_bounds__(Ax0Shape<LOG2N, C64>::kThreads,
                                  Ax0Shape<LOG2N, C64>::kMinBlocks)
ax0_fft_kernel(const __grid_constant__ Ax0Args g) {
  using S = Ax0Shape<LOG2N, C64>;
  const long long tile = blockIdx.x / S::kC;
  const int b = static_cast<int>(blockIdx.x % S::kC);
  const long long c0 = (tile % g.tiles) * S::kCols;
  const size_t base = static_cast<size_t>(tile / g.tiles) * (static_cast<size_t>(1) << LOG2N) *
                          static_cast<size_t>(g.m) + static_cast<size_t>(c0);
  const int col = static_cast<int>(threadIdx.x) % S::kCols;
  const bool valid = c0 + col < g.m;
  if constexpr (S::kC > 1) cluster_butterfly<SIGN, LOG2N, C64>(g, base, col, valid);
  plan_fft<SIGN, S::kLog2Q>(Ax0Col<LOG2N, C64>{g, base, b, valid}, g.tw);
}

template <int LOG2N, bool C64>
cudaError_t launch(int sign, const Ax0Args& g, long long planes, cudaStream_t stream) {
  using S = Ax0Shape<LOG2N, C64>;
  if (planes * g.tiles * S::kC > 2147483647LL) return cudaErrorInvalidValue;
  void (*kernel)(Ax0Args) = sign < 0 ? ax0_fft_kernel<-1, LOG2N, C64>
                                     : ax0_fft_kernel<1, LOG2N, C64>;
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
  cfg.gridDim = dim3(static_cast<unsigned>(planes * g.tiles * S::kC));
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = S::kC > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool C64>
int dispatch(Ax0Args g, long long planes, int log2n, int log2c, int sign, void* stream) {
  if (planes < 1 || g.m < 1 || (sign != 1 && sign != -1) || log2n < 7 || log2n > 14 ||
      log2c != ax0_log2c(log2n, C64)) {
    return cudaErrorInvalidValue;
  }
  const long long ct = ax0_cols(log2n, C64);
  g.tiles = (g.m + ct - 1) / ct;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return launch<7, C64>(sign, g, planes, s);
    case 8: return launch<8, C64>(sign, g, planes, s);
    case 9: return launch<9, C64>(sign, g, planes, s);
    case 10: return launch<10, C64>(sign, g, planes, s);
    case 11: return launch<11, C64>(sign, g, planes, s);
    case 12: return launch<12, C64>(sign, g, planes, s);
    case 13: return launch<13, C64>(sign, g, planes, s);
    case 14: return launch<14, C64>(sign, g, planes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Transforms axis -2 of `planes` contiguous [n, m] planes, n = 2^log2n,
// planar float32, in clusters of 2^log2c blocks (ax0_log2c; the host's
// _ax0_log2c).  tw_n holds exp(sign*2pi*i*e/n), e < n, tw the pass roots of
// Q = n/2^log2c (_pass_roots_np(Q, sign)), both interleaved (cos, sin)
// float32 pairs.  The output may alias the input.  Launches on `stream` and
// returns the launch's error (0 = ok).
int ax0_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                const void* tw_n, const void* tw, long long planes, long long m, int log2n,
                int log2c, int sign, float scale, void* stream) {
  const Ax0Args g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                  static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                  static_cast<const float2*>(tw_n), static_cast<const float2*>(tw), m, 0,
                  scale};
  return dispatch<false>(g, planes, log2n, log2c, sign, stream);
}

// The same over interleaved complex64 planes: (re, im) float32 pairs, 8-byte
// aligned.  The output may alias the input.
int ax0_fft_c64(const void* in, void* out, const void* tw_n, const void* tw, long long planes,
                long long m, int log2n, int log2c, int sign, float scale, void* stream) {
  const Ax0Args g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                  static_cast<float2*>(out), static_cast<const float2*>(tw_n),
                  static_cast<const float2*>(tw), m, 0, scale};
  return dispatch<true>(g, planes, log2n, log2c, sign, stream);
}

const char* ax0_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
