// Batched complex-to-complex FFT along axis -2 of [b, n, m] for composite
// lengths that are not powers of two: the m columns of each n x m plane are
// the batch.
//
// Replaces the composite range of the TPU kernel
// fft_wgpu_tpu/ops/pallas_fft.py::_fft_axis0_core (its pl.pallas_call over
// _kernel_ax0 with the split of _choose_general_split; ax0_fft.cu ports its
// pow2 range).  For n in 512 .. 16384, not a power of two, with a split
// into factors <= 256 (the JAX kernel's envelope), it computes for every
// column
//
//     X[k, c] = scale * sum_i x[i, c] * exp(sign * 2*pi*i * k*i / n)
//
// in natural order, planar float32 (re, im) in and out, with no transpose
// in device memory.  It is the plan's route for a composite axis -2 of a
// CUDA tensor, and, on the free view [..., n, Y*Z], for axes before it.
//
// Each column runs the mixed-radix Stockham passes of mixed_fft.cuh, planned
// on the host by ops/cuda_fft.py::_mixed_radix_plan (1080 = 9*5*3*8, at most
// 34 multiply-adds a point), as the row kernel gen_fft.cu does; the TPU
// kernel's two direct DFTs (n*(n1 + n2) multiply-adds a column) are gone.
//
// What bounds it: device memory, 16 bytes a point read and written (0.158 ms
// for 16 x 1080 x 1920 at 3.35 TB/s), and the access pattern: a column is
// strided by m.  A block takes a tile of TM neighbouring columns, T threads
// each, T from the passes' butterflies a thread (mixed_shape's rule), and
// holds the tile in shared memory, so that every access to device memory
// moves runs of TM contiguous floats of one row of the plane; TM is a
// multiple of 8 where 1024 threads and the shared memory allow it (8 at
// n = 1080), so every run covers whole 32-byte sectors.  Where two tiles
// fit in shared memory (n up to about 1800) the blocks are persistent and
// hold two: the next tile is fetched by cp.async, 16 bytes (four columns of
// a row) a copy where the rows allow it, while this one runs its passes, so
// the loads overlap the passes and no register holds a load.  There the
// tile is row-major (point k of column c at k*TM + c) and the lanes of a
// warp span its columns (column = thread % TM, thread / TM its index among
// the column's T threads, T not rounded to a warp), so a pass's accesses to
// consecutive points of the warp's columns hit distinct banks, and the last
// pass stores each column's outputs from registers straight to device
// memory with the scale folded in, runs of TM floats a row, as ax0_fft.cu's
// last pass does: no store phase and no second pass over shared memory.
// Elsewhere a block's columns are threadIdx.y, its tile column-major at an
// odd column stride so that the transposing accesses hit distinct banks,
// and the tile is moved by col_move.  Where a block
// holds fewer than 8 columns (n above about 2000), it takes one column, and
// a cluster of C = 4 or 8 blocks on neighbouring columns splits the load
// and store of its C columns by rows through distributed shared memory:
// block b moves rows [b*n/C, (b+1)*n/C) of all of them, so each run is C
// floats, and then transforms its own column.  Small blocks let several
// run on an SM, so one block's loads overlap another's passes.

// A generic prime pass (17..251) held in shared memory needs a thread per
// unit (generic_pass); where a plan's generic pass has more units than 1024
// threads (16383 = 43*3*127), the column streams instead: the first pass
// reads it from device memory at stride m and the last pass writes it there
// with the scale folded in, and there is no tile.  Columns past m (a ragged
// last tile) compute on zeros, or on the last column when streaming, and are
// not stored, so every thread reaches every barrier.  A block (a cluster)
// reads its whole tile before it stores, and tiles are disjoint, so the
// output may alias the input.

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

constexpr int kSmemMax = 232448;  // bytes of shared memory a block may hold
constexpr int kRootBytes = kGenericMaxP * static_cast<int>(sizeof(float2));

// A column of device memory at stride m, read by a streaming first pass.
struct ColIn {
  const float* r;
  const float* i;
  long long m;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const size_t g = static_cast<size_t>(k) * m;
    a = r[g];
    b = i[g];
  }
};

// A column of device memory at stride m, written by a streaming last pass
// with the scale folded in; nothing for a column past m.
struct ColOut {
  float* r;
  float* i;
  long long m;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid) return;
    const size_t g = static_cast<size_t>(k) * m;
    r[g] = a * scale;
    i[g] = b * scale;
  }
};

struct Ax0Args {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* tw;
  long long m;      // columns of a plane
  long long tiles;  // column tiles of a plane, C*TM columns each
  MixedPlan plan;
  int ld;           // floats between two columns of the tile (odd)
  int cols;         // columns of a pipelined tile (its row stride in floats)
  float scale;
};

// This thread's column: its place in the shared tile (threadIdx.y) of the
// buffer that starts `buf` floats into shared memory (the staged roots
// follow `nbuf` buffers), and for a streaming plan its column of device
// memory (`off`: the first point).
template <bool STREAM>
struct Ax0Col {
  const Ax0Args& g;
  size_t off;
  bool valid;
  int buf;
  int nbuf;
  __device__ __forceinline__ Shared shared() const {
    extern __shared__ float smem[];
    float* sr = smem + buf + threadIdx.y * g.ld;
    return Shared{sr, sr + blockDim.y * g.ld};
  }
  __device__ __forceinline__ float2* roots() const {
    extern __shared__ float smem[];
    return reinterpret_cast<float2*>(smem + nbuf * 2 * blockDim.y * g.ld);
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (STREAM) {
      return ColIn{g.in_re + off, g.in_im + off, g.m};
    } else {
      return shared();
    }
  }
  __device__ __forceinline__ auto dst() const {
    if constexpr (STREAM) {
      return ColOut{g.out_re + off, g.out_im + off, g.m, g.scale, valid};
    } else {
      return shared();
    }
  }
};

// Rows i, i + step, ... < i1 of one column between device memory (from
// point gi on, at stride m) and its shared column (sr, si): LOAD reads
// zeros for a column past m (in = false), the store skips it and folds the
// scale in.  A thread moves kTileBatch rows at a time, all loads before any
// store, so that many loads are in flight.
constexpr int kTileBatch = 8;

template <bool LOAD>
__device__ __forceinline__ void col_move(const Ax0Args& g, float* sr, float* si, bool in,
                                         size_t gi, int i, int i1, int step) {
  const size_t gstep = static_cast<size_t>(step) * g.m;
  for (; i < i1; i += kTileBatch * step, gi += kTileBatch * gstep) {
    float vr[kTileBatch], vi[kTileBatch];
#pragma unroll
    for (int u = 0; u < kTileBatch; ++u) {
      const bool row = i + u * step < i1;
      if constexpr (LOAD) {
        vr[u] = in && row ? g.in_re[gi + u * gstep] : 0.f;
        vi[u] = in && row ? g.in_im[gi + u * gstep] : 0.f;
      } else {
        vr[u] = row ? sr[i + u * step] : 0.f;
        vi[u] = row ? si[i + u * step] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kTileBatch; ++u) {
      if (i + u * step >= i1) break;
      if constexpr (LOAD) {
        sr[i + u * step] = vr[u];
        si[i + u * step] = vi[u];
      } else if (in) {
        g.out_re[gi + u * gstep] = vr[u] * g.scale;
        g.out_im[gi + u * gstep] = vi[u] * g.scale;
      }
    }
  }
}

// The cluster's tile between device memory and the shared columns of its
// blocks: this block moves rows [i0, i1) of the cluster's CT = C*TM columns
// (from column c0 of the plane at `base`), lanes along the columns, so each
// run is CT contiguous floats of a row.  Column c lives in block c / TM of
// the cluster at column c % TM.  CT divides the block's threads (C divides T).
// A block alone in its cluster moves its own columns through shared-memory
// pointers, not the cluster's generic ones.
template <bool LOAD>
__device__ __forceinline__ void cluster_move(const Ax0Args& g, cg::cluster_group& cluster,
                                             size_t base, long long c0, int i0, int i1) {
  extern __shared__ float smem[];
  const int TM = blockDim.y;
  const int C = static_cast<int>(cluster.num_blocks());
  const int CT = C * TM;
  const int flat = threadIdx.y * blockDim.x + threadIdx.x;
  const int step = blockDim.x * TM / CT;  // rows a sweep of the block covers
  const int c = flat % CT;
  const bool in = c0 + c < g.m;
  const size_t gi = base + static_cast<size_t>(i0 + flat / CT) * g.m + c;
  if (C == 1) {
    float* sr = smem + c * g.ld;
    col_move<LOAD>(g, sr, sr + TM * g.ld, in, gi, i0 + flat / CT, i1, step);
  } else {
    float* sr = cluster.map_shared_rank(smem, c / TM) + (c % TM) * g.ld;
    col_move<LOAD>(g, sr, sr + TM * g.ld, in, gi, i0 + flat / CT, i1, step);
  }
}

// Column c of a pipelined tile in shared memory, row-major: point k at
// k*cols + c of each plane.
struct TileShared {
  float* r;
  float* i;
  int cols;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k * cols];
    b = i[k * cols];
  }
  __device__ __forceinline__ void store(int k, float a, float b) const {
    r[k * cols] = a;
    i[k * cols] = b;
  }
};

// This thread's column of a pipelined tile (thread % cols; its index among
// the column's threads is thread / cols): the tile in buffer `buf` (floats
// into shared memory; the staged roots follow both buffers), and its
// column of device memory (`off`: the first point), written by the last
// pass.
struct Ax0Tile {
  const Ax0Args& g;
  size_t off;
  bool valid;
  int buf;
  __device__ __forceinline__ int2 lanes() const {
    return make_int2(static_cast<int>(blockDim.x) / g.cols,
                     static_cast<int>(threadIdx.x) / g.cols);
  }
  __device__ __forceinline__ TileShared shared() const {
    extern __shared__ float smem[];
    float* sr = smem + buf + threadIdx.x % g.cols;
    return TileShared{sr, sr + g.plan.n * g.cols, g.cols};
  }
  __device__ __forceinline__ float2* roots() const {
    extern __shared__ float smem[];
    return reinterpret_cast<float2*>(smem + 4 * g.plan.n * g.cols);
  }
  __device__ __forceinline__ TileShared src() const { return shared(); }
  __device__ __forceinline__ ColOut dst() const {
    return ColOut{g.out_re + off, g.out_im + off, g.m, g.scale, valid};
  }
};

// Tile t (cols columns; t counts the tiles of all planes) into the shared
// buffer `buf` by cp.async, so no register holds a load and every load of
// the tile is in flight at once; columns past m are zero-filled.  Each
// copy moves four columns of a row (16 bytes) where every row's run is
// 16-byte aligned (m a multiple of 4, both planes aligned), else one.
// Commits one pipeline group.
__device__ __forceinline__ void tile_fetch(const Ax0Args& g, float* buf, long long t, bool wide) {
  const int TM = g.cols;
  const int n = g.plan.n;
  const int rows = blockDim.x / TM;  // a sweep of the block: 4*rows rows when wide
  const long long c0 = (t % g.tiles) * TM;
  const size_t base = static_cast<size_t>(t / g.tiles) * n * g.m + c0;
  float* bi = buf + n * TM;
  if (wide) {
    const int W = TM / 4;  // 16-byte runs of a row
    const int cc = threadIdx.x % W * 4;
    const bool in = c0 + cc < g.m;
    const int step = 4 * rows;
    for (int i = threadIdx.x / W; i < n; i += step) {
      const size_t src = in ? base + static_cast<size_t>(i) * g.m + cc : 0;
      __pipeline_memcpy_async(&buf[i * TM + cc], &g.in_re[src], 16, in ? 0 : 16);
      __pipeline_memcpy_async(&bi[i * TM + cc], &g.in_im[src], 16, in ? 0 : 16);
    }
  } else {
    const int c = threadIdx.x % TM;
    const bool in = c0 + c < g.m;
    for (int i = threadIdx.x / TM; i < n; i += rows) {
      const size_t src = in ? base + static_cast<size_t>(i) * g.m + c : 0;
      __pipeline_memcpy_async(&buf[i * TM + c], &g.in_re[src], sizeof(float),
                              in ? 0 : sizeof(float));
      __pipeline_memcpy_async(&bi[i * TM + c], &g.in_im[src], sizeof(float),
                              in ? 0 : sizeof(float));
    }
  }
  __pipeline_commit();
}

// Persistent blocks over all tiles, two shared buffers: the tile after this
// one is fetched (cp.async) while this one runs its passes, the last of
// which stores it.  Every kernel of this file is named ax0_gen_fft_kernel,
// so that a profile counts them as one.
template <int SIGN>
__global__ void __launch_bounds__(kMixMaxThreads)
ax0_gen_fft_kernel(const __grid_constant__ Ax0Args g, long long tiles_all) {
  extern __shared__ float smem[];
  const int TM = g.cols;
  const int n = g.plan.n;
  const int tile = 2 * TM * n;
  const int c = threadIdx.x % TM;
  const bool wide = g.m % 4 == 0 && reinterpret_cast<size_t>(g.in_re) % 16 == 0 &&
                    reinterpret_cast<size_t>(g.in_im) % 16 == 0;
  long long t = blockIdx.x;
  tile_fetch(g, smem, t, wide);
  for (int cur = 0; t < tiles_all; t += gridDim.x, cur ^= 1) {
    if (t + gridDim.x < tiles_all) {
      tile_fetch(g, smem + (cur ^ 1) * tile, t + gridDim.x, wide);
    } else {
      __pipeline_commit();  // an empty group, so the wait below is for tile t
    }
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t is in buffer cur
    const long long c0 = (t % g.tiles) * TM;
    const bool valid = c0 + c < g.m;
    const size_t off = static_cast<size_t>(t / g.tiles) * n * g.m + (valid ? c0 + c : 0);
    mixed_fft<SIGN>(Ax0Tile{g, off, valid, cur * tile}, g.plan, g.tw, 1);
    __syncthreads();  // buffer cur is read before the fetch of tile t + 2*grid
  }
}

template <int SIGN, bool STREAM>
__global__ void __launch_bounds__(kMixMaxThreads)
ax0_gen_fft_kernel(const __grid_constant__ Ax0Args g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int n = g.plan.n;
  const long long cid = blockIdx.x / C;
  const long long plane = cid / g.tiles;
  const long long c0 = (cid % g.tiles) * C * blockDim.y;  // the cluster's first column
  const size_t base = static_cast<size_t>(plane) * n * g.m + c0;
  if constexpr (STREAM) {
    const long long col = c0 + b * blockDim.y + threadIdx.y;
    const bool valid = col < g.m;
    const size_t off = base + (valid ? col : g.m - 1) - c0;
    mixed_fft<SIGN>(Ax0Col<true>{g, off, valid, 0, 1}, g.plan, g.tw, 1);
  } else {
    const int i0 = static_cast<int>(static_cast<long long>(b) * n / C);
    const int i1 = static_cast<int>(static_cast<long long>(b + 1) * n / C);
    // a block alone in its cluster needs only its own barriers
    const auto sync = [&] { C > 1 ? cluster.sync() : __syncthreads(); };
    if (C > 1) cluster.sync();  // every block of the cluster runs before any writes a peer
    cluster_move<true>(g, cluster, base, c0, i0, i1);
    sync();  // every block's columns are in place
    mixed_fft<SIGN>(Ax0Col<false>{g, 0, true, 0, 1}, g.plan, g.tw, 1);
    sync();  // every block's columns are transformed
    cluster_move<false>(g, cluster, base, c0, i0, i1);
    if (C > 1) cluster.sync();  // no block exits while another reads its columns
  }
}

struct Ax0Shape {
  int threads;  // per column
  int cols;     // per block
  int cluster;  // blocks per cluster
  int smem;     // bytes of dynamic shared memory
  bool stream;  // a generic pass streams: no tile
  bool pipe;    // persistent blocks, two tiles in flight
};

// Threads of a column as mixed_shape gives them for a row (about 16 points
// a thread, every held generic pass in one round); a generic pass of more
// units than 1024 threads makes the plan stream.  Where two tiles of at
// least 8 columns fit 1024 threads and the shared memory, the tiles are
// pipelined: the lanes span the tile's columns, so a column's threads are
// rounded up to 4 (a warp's worth with 8 columns), not 32, and its columns
// as many as fit, at most 32, rounded down to a multiple of 8.  Elsewhere
// a column's threads are whole warps and its columns as many as 1024
// threads and the shared memory allow, at most 32, rounded down to a
// multiple of 8 where at least 8 fit (one tile a block).  Where fewer than
// 8 fit, one column a block in a cluster of 4 blocks (8 where a block takes
// more than 512 threads, so one block fills an SM): the shapes that measured
// fastest on an H100 at 2047, 4095 and 12288 (scripts/time_ax0_gen_shapes.py).
Ax0Shape ax0_shape(const MixedPlan& plan) {
  const int n = plan.n;
  int need = (n + 15) / 16;
  bool stream = false;
  for (int i = 0; i < plan.np; ++i) {
    const int r = plan.radix[i];
    if (mixed_small(r)) {
      const int per = mixed_hold(r);
      need = need > (n / r + per - 1) / per ? need : (n / r + per - 1) / per;
    } else if (generic_units(n, r) > kMixMaxThreads) {
      stream = true;
    } else {
      need = need > generic_units(n, r) ? need : generic_units(n, r);
    }
  }
  const int tile_col = 2 * n * static_cast<int>(sizeof(float));  // a pipelined tile's column
  int tp = (need + 3) / 4 * 4;
  tp = tp < kMixMaxThreads ? tp : kMixMaxThreads;
  int cp = kMixMaxThreads / tp;
  cp = cp < 32 ? cp : 32;
  cp = cp < (kSmemMax - kRootBytes) / (2 * tile_col) ? cp : (kSmemMax - kRootBytes) / (2 * tile_col);
  if (!stream && cp >= 8) {
    cp -= cp % 8;
    return Ax0Shape{tp, cp, 1, 2 * cp * tile_col + kRootBytes, false, true};
  }
  int T = (need + 31) / 32 * 32;
  if (T > kMixMaxThreads) T = kMixMaxThreads;
  const int per_col = 2 * (n | 1) * static_cast<int>(sizeof(float));
  int tm = kMixMaxThreads / T;
  tm = tm < 32 ? tm : 32;
  tm = tm < (kSmemMax - kRootBytes) / per_col ? tm : (kSmemMax - kRootBytes) / per_col;
  int C = 1;
  if (tm >= 8) {
    tm -= tm % 8;
  } else if (!stream) {
    tm = 1;
    C = T > 512 ? 8 : 4;
  }
  return Ax0Shape{T, tm, C, tm * per_col + kRootBytes, stream, false};
}

template <class Kernel>
cudaError_t set_smem(Kernel* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// One tile a block (a cluster), or streaming columns.
template <int SIGN, bool STREAM>
cudaError_t launch(const Ax0Args& g, const Ax0Shape& s, long long planes,
                   cudaStream_t stream) {
  void (*kernel)(Ax0Args) = ax0_gen_fft_kernel<SIGN, STREAM>;
  cudaError_t e = set_smem(kernel, s.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * g.tiles * s.cluster));
  cfg.blockDim = dim3(s.threads, s.cols);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// As many persistent blocks as fit on the card at once, at most one a tile.
template <int SIGN>
cudaError_t launch_pipe(const Ax0Args& g, const Ax0Shape& s, long long planes,
                        cudaStream_t stream) {
  void (*kernel)(Ax0Args, long long) = ax0_gen_fft_kernel<SIGN>;
  cudaError_t e = set_smem(kernel, s.smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.threads * s.cols,
                                                      s.smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles_all = planes * g.tiles;
  const long long grid = tiles_all < 1LL * sms * per_sm ? tiles_all : 1LL * sms * per_sm;
  kernel<<<static_cast<unsigned>(grid), s.threads * s.cols, s.smem, stream>>>(g, tiles_all);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms axis -2 of `planes` contiguous [n, m] planes, planar float32, by
// the plan radix[0..np) (product n, from _mixed_radix_plan).  tw holds n
// interleaved (cos, sin) float32 pairs of exp(sign*2pi*i*k/n), sign = -1 or
// +1.  Launches on `stream` and returns the launch's error (0 = ok).
int ax0_gen_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                    const void* tw, long long planes, long long m, int n,
                    const int* radix, int np, int sign, float scale,
                    void* stream) {
  Ax0Args g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
            static_cast<float*>(out_re), static_cast<float*>(out_im),
            static_cast<const float2*>(tw), m, 0, {}, n | 1, 0, scale};
  if (planes < 1 || m < 1 || n > 16384 || (sign != -1 && sign != 1) ||
      !mixed_plan_make(radix, np, n, &g.plan)) {
    return cudaErrorInvalidValue;
  }
  const Ax0Shape s = ax0_shape(g.plan);
  g.cols = s.cols;
  const long long ct = static_cast<long long>(s.cols) * s.cluster;
  g.tiles = (m + ct - 1) / ct;
  if (planes * g.tiles * s.cluster > 2147483647LL) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (s.stream) return sign < 0 ? launch<-1, true>(g, s, planes, st)
                                : launch<1, true>(g, s, planes, st);
  if (s.pipe) return sign < 0 ? launch_pipe<-1>(g, s, planes, st)
                              : launch_pipe<1>(g, s, planes, st);
  return sign < 0 ? launch<-1, false>(g, s, planes, st) : launch<1, false>(g, s, planes, st);
}

const char* ax0_gen_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
