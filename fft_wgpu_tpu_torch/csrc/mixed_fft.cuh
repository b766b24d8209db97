// Mixed-radix Stockham passes over a row in shared memory, for the
// composite-length kernels (gen_fft.cu, C2C rows; r2c_gen_fft.cu, R2C rows;
// ax0_gen_fft.cu, C2C columns) and, with the plan fixed at compile time
// (mixed_fft_fixed; plan_fft for the power-of-two lengths 2^6 .. 2^14 of
// the one compiled plan table, plan_radix), the power-of-two kernels: the
// chirp passes (chirp_fft.cu), the row kernel (rows_fft.cu), the whole-row
// kernel's per-block transform (big_fft.cu), the column kernel (ax0_fft.cu)
// and the R2C kernel's half-length transform (r2c_fft.cu), which hold each
// row in shared memory as interleaved (re, im) pairs with a pad pair after
// every 16 (PadShared).
//
// A transform of N points runs the passes of a plan, N = R_0 * R_1 * ...,
// made on the host by ops/cuda_fft.py::_mixed_radix_plan: hard-coded
// butterflies for the radices 2, 4, 8, 16 (8 as 2 x 4, 16 as 4 x 4), 3, 9
// (3 x 3), 5, 7, 11 and 13, and one generic pass for each prime from 17 to
// 251.  A row has at most two such primes (17 * 17 > 256, the envelope's
// largest factor), and the plan puts them first and last: the first pass
// reads device memory and the last writes it, so a generic pass never has
// to hold its outputs across a barrier (except the last pass of r2c_gen_fft's
// half-length transform, which stays in shared memory; see generic_pass).
//
// Pass R with NS = the product of the radices before it is a Stockham
// autosort step (R and N at run time, or fixed at compile time): butterfly j
// (0 <= j < N/R) reads x[j + k*N/R] for k < R, multiplies input k by the
// twiddle w^k, w = w_N^((j mod NS) * N/(NS*R)) (w^k as k - 1 products from
// one root of the table; a fixed plan's passes gather each w^k from a
// table of their own), takes an R-point DFT and writes
// output k to y[(j/NS)*NS*R + (j mod NS) + k*NS]; after the last pass the
// row is in natural order.  Twiddles come from the float32 table of the
// N*TWS roots of unity of the transform's sign (generated in float64 on the
// host): w_N^e is tw[e*TWS].  Butterfly constants are float32 pairs of
// |w|^2 nearest 1 (kRoot), the sign flips their imaginary parts; all arithmetic
// is float32 FMAs on the CUDA cores (TF32 would miss 1e-5 relative L2).
//
// One buffer per row, planar float32 (131 KB at N = 16383; a ping-pong pair
// would not fit): a pass that reads and writes shared memory reads all of
// its inputs into registers, synchronises, and then writes.  The host picks
// the threads of a row (threadIdx.x) so that a thread holds at most
// mixed_hold(R) butterflies of a small-radix pass, about 16 points; a block
// that holds several rows gives each threadIdx.y its own buffer.  Every
// thread of the block runs every pass, because passes synchronise the whole
// block.
//
// Shared-memory banks: a pass reads x[j + k*N/R], consecutive j on
// consecutive lanes, so its loads hit 32 banks.  Its stores are at stride R
// for NS = 1, which the plan gives only to odd radices (3, 5, 7, 9, ...,
// conflict-free) or to a generic prime; at NS > 1 a warp stores runs of NS
// consecutive words.

#pragma once

#include <cuda_runtime.h>

namespace fftk {

__host__ __device__ constexpr int min_int(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ void cmul(float& r, float& i, float2 w) {
  const float t = r * w.x - i * w.y;
  i = r * w.y + i * w.x;
  r = t;
}

// A row in shared memory, planar: the composite kernels' buffer.
struct Shared {
  float* r;
  float* i;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
  __device__ __forceinline__ void store(int k, float a, float b) const {
    r[k] = a;
    i[k] = b;
  }
};

// A row in device memory, planar, read by the first pass.  No __restrict__:
// the output may alias the input.
struct GlobalIn {
  const float* r;
  const float* i;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
};

// A row x of device memory times a table h, zero past n_in: the first pass
// of a transform with a multiply fused into its loads (the chirp passes,
// the spectral filter and the filter bank).
struct ProductIn {
  const float* xr;
  const float* xi;
  const float* hr;
  const float* hi;
  int n_in;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (k >= n_in) {
      a = b = 0.f;
      return;
    }
    const float x_r = xr[k], x_i = xi[k];
    const float h_r = __ldg(&hr[k]), h_i = __ldg(&hi[k]);
    a = x_r * h_r - x_i * h_i;
    b = x_r * h_i + x_i * h_r;
  }
};

constexpr int kMixMaxPasses = 16;
constexpr int kMixMaxThreads = 1024;
constexpr int kMixHoldPoints = 18;  // points a thread holds across a barrier
constexpr int kGenericSlots = 8;     // output pairs (q, p - q) of a generic unit
constexpr int kGenericMaxP = 256;    // entries of the staged w_p table

// A plan: N points, np radices in pass order.
struct MixedPlan {
  int n;
  int np;
  int radix[kMixMaxPasses];
};

__host__ __device__ inline bool mixed_small(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 9 ||
         r == 11 || r == 13 || r == 16;
}

// Butterflies a thread holds in a small-radix pass (about 16 points).
__host__ __device__ constexpr int mixed_hold(int r) {
  return kMixHoldPoints / r > 1 ? kMixHoldPoints / r : 1;
}

// Butterflies a thread holds in a pass of 1024 threads at N <= 16384.
__host__ __device__ constexpr int mixed_hold_wide(int r) {
  return (16 + r - 1) / r > mixed_hold(r) ? (16 + r - 1) / r : mixed_hold(r);
}

// Work units of a generic pass of prime p over N points: one butterfly and
// kGenericSlots output pairs each.
__host__ __device__ inline int generic_units(int n, int p) {
  const int slots = (p - 1) / 2 + 1;
  return n / p * ((slots + kGenericSlots - 1) / kGenericSlots);
}

// ---------------------------------------------------------------------- //
// butterflies
// ---------------------------------------------------------------------- //

// cos and sin of 2*pi*m/R for m < R, R in {3, 4, 5, 7, 8, 9, 11, 13, 16},
// from root_off<R>() on: of the float32 pairs within two ulps of the
// float64 root, the one whose |w|^2 is nearest 1 (ops/cuda_fft.py::
// butterfly_roots_np, which tests hold equal to this table).  The rounded
// pairs have |w|^2 - 1 down to -5.7e-8 (w_16), and every radix-16
// butterfly multiplies 8 of its 16 points by such constants: they cost the
// row kernel's forward-inverse round trip 5e-8 of its power at N = 4096.
__constant__ float2 kRoot[76] = {
    // R = 3
    {1.0f, 0.0f}, {-5.000001192e-01f, 8.660253286e-01f}, {-5.000001192e-01f, -8.660253286e-01f},
    // R = 4
    {1.0f, 0.0f}, {0.0f, 1.0f}, {-1.0f, 0.0f}, {0.0f, -1.0f},
    // R = 5
    {1.0f, 0.0f}, {3.090169430e-01f, 9.510565400e-01f}, {-8.090170026e-01f, 5.877852440e-01f},
    {-8.090170026e-01f, -5.877852440e-01f}, {3.090169430e-01f, -9.510565400e-01f},
    // R = 7
    {1.0f, 0.0f}, {6.234898567e-01f, 7.818314433e-01f}, {-2.225209624e-01f, 9.749279022e-01f},
    {-9.009688497e-01f, 4.338837862e-01f}, {-9.009688497e-01f, -4.338837862e-01f},
    {-2.225209624e-01f, -9.749279022e-01f}, {6.234898567e-01f, -7.818314433e-01f},
    // R = 8
    {1.0f, 0.0f}, {7.071067691e-01f, 7.071067691e-01f}, {0.0f, 1.0f},
    {-7.071067691e-01f, 7.071067691e-01f}, {-1.0f, 0.0f},
    {-7.071067691e-01f, -7.071067691e-01f}, {0.0f, -1.0f},
    {7.071067691e-01f, -7.071067691e-01f},
    // R = 9
    {1.0f, 0.0f}, {7.660443187e-01f, 6.427877545e-01f}, {1.736482084e-01f, 9.848077297e-01f},
    {-5.000001192e-01f, 8.660253286e-01f}, {-9.396926165e-01f, 3.420201540e-01f},
    {-9.396926165e-01f, -3.420201540e-01f}, {-5.000001192e-01f, -8.660253286e-01f},
    {1.736482084e-01f, -9.848077297e-01f}, {7.660443187e-01f, -6.427877545e-01f},
    // R = 11
    {1.0f, 0.0f}, {8.412535191e-01f, 5.406408310e-01f}, {4.154150784e-01f, 9.096319675e-01f},
    {-1.423148662e-01f, 9.898214340e-01f}, {-6.548607945e-01f, 7.557495236e-01f},
    {-9.594929814e-01f, 2.817325294e-01f}, {-9.594929814e-01f, -2.817325294e-01f},
    {-6.548607945e-01f, -7.557495236e-01f}, {-1.423148662e-01f, -9.898214340e-01f},
    {4.154150784e-01f, -9.096319675e-01f}, {8.412535191e-01f, -5.406408310e-01f},
    // R = 13
    {1.0f, 0.0f}, {8.854560256e-01f, 4.647231698e-01f}, {5.680647492e-01f, 8.229838610e-01f},
    {1.205366924e-01f, 9.927088618e-01f}, {-3.546049595e-01f, 9.350162148e-01f},
    {-7.485106587e-01f, 6.631227732e-01f}, {-9.709418416e-01f, 2.393156290e-01f},
    {-9.709418416e-01f, -2.393156290e-01f}, {-7.485106587e-01f, -6.631227732e-01f},
    {-3.546049595e-01f, -9.350162148e-01f}, {1.205366924e-01f, -9.927088618e-01f},
    {5.680647492e-01f, -8.229838610e-01f}, {8.854560256e-01f, -4.647231698e-01f},
    // R = 16
    {1.0f, 0.0f}, {9.238795638e-01f, 3.826833665e-01f}, {7.071067691e-01f, 7.071067691e-01f},
    {3.826833665e-01f, 9.238795638e-01f}, {0.0f, 1.0f}, {-3.826833665e-01f, 9.238795638e-01f},
    {-7.071067691e-01f, 7.071067691e-01f}, {-9.238795638e-01f, 3.826833665e-01f}, {-1.0f, 0.0f},
    {-9.238795638e-01f, -3.826833665e-01f}, {-7.071067691e-01f, -7.071067691e-01f},
    {-3.826833665e-01f, -9.238795638e-01f}, {0.0f, -1.0f},
    {3.826833665e-01f, -9.238795638e-01f}, {7.071067691e-01f, -7.071067691e-01f},
    {9.238795638e-01f, -3.826833665e-01f},
};

template <int R>
__device__ __forceinline__ constexpr int root_off() {
  return R == 3 ? 0 : R == 4 ? 3 : R == 5 ? 7 : R == 7 ? 12 : R == 8 ? 19
       : R == 9 ? 27 : R == 11 ? 36 : R == 13 ? 47 : 60;
}

// w_R^m = exp(SIGN * 2*pi*i * m/R); m is a constant after unrolling, so
// the constant bank feeds the FMAs directly.
template <int R, int SIGN>
__device__ __forceinline__ float wc(int m) {
  return kRoot[root_off<R>() + m % R].x;
}
template <int R, int SIGN>
__device__ __forceinline__ float ws(int m) {
  return SIGN * kRoot[root_off<R>() + m % R].y;
}

template <int R, int SIGN>
__device__ __forceinline__ void dft(float (&r)[R], float (&i)[R]);

template <int SIGN>
__device__ __forceinline__ void dft2s(float (&r)[2], float (&i)[2]) {
  const float ur = r[0] - r[1], ui = i[0] - i[1];
  r[0] += r[1];
  i[0] += i[1];
  r[1] = ur;
  i[1] = ui;
}

template <int SIGN>
__device__ __forceinline__ void dft4s(float (&r)[4], float (&i)[4]) {
  const float t0r = r[0] + r[2], t0i = i[0] + i[2];
  const float t1r = r[0] - r[2], t1i = i[0] - i[2];
  const float t2r = r[1] + r[3], t2i = i[1] + i[3];
  const float t3r = -SIGN * (i[1] - i[3]), t3i = SIGN * (r[1] - r[3]);
  r[0] = t0r + t2r; i[0] = t0i + t2i;
  r[1] = t1r + t3r; i[1] = t1i + t3i;
  r[2] = t0r - t2r; i[2] = t0i - t2i;
  r[3] = t1r - t3r; i[3] = t1i - t3i;
}

// Odd prime R: X[0] = sum x; for q = 1..H, with s_k = x_k + x_(R-k) and
// d_k = x_k - x_(R-k), A = x_0 + sum_k s_k cos(2pi kq/R) and
// B = sum_k d_k SIGN sin(2pi kq/R):  X[q] = A + iB, X[R-q] = A - iB.
template <int R, int SIGN>
__device__ __forceinline__ void dft_prime(float (&r)[R], float (&i)[R]) {
  constexpr int H = (R - 1) / 2;
  float sr[H], si[H], dr[H], di[H];
  float y0r = r[0], y0i = i[0];
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    sr[k - 1] = r[k] + r[R - k];
    si[k - 1] = i[k] + i[R - k];
    dr[k - 1] = r[k] - r[R - k];
    di[k - 1] = i[k] - i[R - k];
    y0r += sr[k - 1];
    y0i += si[k - 1];
  }
  const float x0r = r[0], x0i = i[0];
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float ar = x0r, ai = x0i, br = 0.f, bi = 0.f;
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      const float c = wc<R, SIGN>(k * q), s = ws<R, SIGN>(k * q);
      ar = fmaf(sr[k - 1], c, ar);
      ai = fmaf(si[k - 1], c, ai);
      br = fmaf(dr[k - 1], s, br);
      bi = fmaf(di[k - 1], s, bi);
    }
    r[q] = ar - bi;
    i[q] = ai + br;
    r[R - q] = ar + bi;
    i[R - q] = ai - br;
  }
  r[0] = y0r;
  i[0] = y0i;
}

// R = R1 * R2 as R2 DFTs of R1 points, the twiddles w_R^(n2*k1), then R1
// DFTs of R2 points: x[R2*n1 + n2] -> X[k1 + R1*k2].
template <int R1, int R2, int SIGN>
__device__ __forceinline__ void dft_split(float (&r)[R1 * R2], float (&i)[R1 * R2]) {
  constexpr int R = R1 * R2;
  float yr[R2][R1], yi[R2][R1];
#pragma unroll
  for (int n2 = 0; n2 < R2; ++n2) {
    float tr[R1], ti[R1];
#pragma unroll
    for (int n1 = 0; n1 < R1; ++n1) {
      tr[n1] = r[R2 * n1 + n2];
      ti[n1] = i[R2 * n1 + n2];
    }
    dft<R1, SIGN>(tr, ti);
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      yr[n2][k1] = tr[k1];
      yi[n2][k1] = ti[k1];
      if (n2 * k1 != 0) {
        const float2 w = make_float2(wc<R, SIGN>(n2 * k1), ws<R, SIGN>(n2 * k1));
        cmul(yr[n2][k1], yi[n2][k1], w);
      }
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < R1; ++k1) {
    float tr[R2], ti[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
      tr[n2] = yr[n2][k1];
      ti[n2] = yi[n2][k1];
    }
    dft<R2, SIGN>(tr, ti);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) {
      r[k1 + R1 * k2] = tr[k2];
      i[k1 + R1 * k2] = ti[k2];
    }
  }
}

template <int R, int SIGN>
__device__ __forceinline__ void dft(float (&r)[R], float (&i)[R]) {
  if constexpr (R == 2) {
    dft2s<SIGN>(r, i);
  } else if constexpr (R == 4) {
    dft4s<SIGN>(r, i);
  } else if constexpr (R == 8) {
    dft_split<2, 4, SIGN>(r, i);
  } else if constexpr (R == 9) {
    dft_split<3, 3, SIGN>(r, i);
  } else if constexpr (R == 16) {
    dft_split<4, 4, SIGN>(r, i);
  } else {
    static_assert(R == 3 || R == 5 || R == 7 || R == 11 || R == 13, "radix");
    dft_prime<R, SIGN>(r, i);
  }
}

// ---------------------------------------------------------------------- //
// passes
// ---------------------------------------------------------------------- //

// Where a pass runs: N points, NS = product of the radices before it,
// T threads of the row, this thread's index, the twiddle table's stride.
// A pass of radix R reads its twiddle w_N^((j mod NS) * N/(NS*R)) at
// tw[(j mod NS) * tw_step<R>()].
struct MixStep {
  int n;
  int ns;
  int T;
  int tid;
  int tws;
  static constexpr bool kFixed = false;
  template <int R>
  __device__ __forceinline__ int tw_step() const {
    return n / (ns * R) * tws;
  }
};

// The same with N and NS known at compile time (a plan fixed when the
// kernel is compiled: fixed_passes), so that the pass's strides, masks and
// trip counts fold into constants.  Its twiddles are the pass's own NS roots
// w_(NS*R)^e, e < NS, at stride 1; at NS = 1 it has none.
template <int N, int NS>
struct FixedStep {
  static constexpr int n = N;
  static constexpr int ns = NS;
  int T;
  int tid;
  static constexpr bool kFixed = true;
  template <int R>
  static __device__ __forceinline__ constexpr int tw_step() {
    return 1;
  }
};

// The barrier of a pass that reads and writes shared memory, between its
// reads and its writes: the block's, or the source's own where it has one
// (a source in the shared memory of other blocks of a cluster synchronises
// the cluster, fft2f_fft.cu).
template <class Src>
__device__ __forceinline__ auto pass_barrier(const Src& src, int) -> decltype(src.barrier()) {
  return src.barrier();
}
template <class Src>
__device__ __forceinline__ void pass_barrier(const Src&, long) {
  __syncthreads();
}

// A small-radix pass; BMAX butterflies a thread at most.  Step: MixStep,
// or FixedStep for a pass of a fixed plan.
template <int R, int BMAX, int SIGN, class Src, class Dst, class Step>
__device__ __forceinline__ void small_pass(const Src& src, const Dst& dst, const Step& a,
                                           const float2* __restrict__ tw) {
  const int M = a.n / R;
  const int step = a.template tw_step<R>();
  float ar[BMAX][R], ai[BMAX][R];
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    // A thread past the last butterfly computes the last one again and
    // stores nothing: no branch around the butterflies, whose outputs the
    // register allocator then keeps in registers across the barrier.
    const int j = min_int(a.tid + b * a.T, M - 1);
#pragma unroll
    for (int k = 0; k < R; ++k) src.load(j + k * M, ar[b][k], ai[b][k]);
    // A fixed pass (the power-of-two kernels) gathers each w^k from its
    // table of its own powers, [k - 1][e], consecutive lanes on
    // consecutive words: a chain of k - 1 float32 products from one root
    // multiplies that root's |w|^2 - 1 by k, and shrank the row kernel's
    // forward-inverse round trip by 5e-8 of its power at N = 4096.  A
    // run-time pass (the composite kernels) forms w^k = w^(k-1) * w from
    // one gathered root (w = 1 at j mod NS = 0): a gather of each w^k from
    // the N-point table costs an L1 wavefront a lane (B2c and B13 18-27%
    // slower) and left the composite round trip's power no closer to 1.
    // A fixed pass at NS = 1 has no twiddles.
    if constexpr (Step::kFixed) {
      if (a.ns > 1) {
#pragma unroll
        for (int k = 1; k < R; ++k) cmul(ar[b][k], ai[b][k], __ldg(&tw[(k - 1) * a.ns + j % a.ns]));
      }
    } else {
      const float2 w = __ldg(&tw[(j % a.ns) * step]);
      float2 wk = w;
#pragma unroll
      for (int k = 1; k < R; ++k) {
        cmul(ar[b][k], ai[b][k], wk);
        if (k + 1 < R) cmul(wk.x, wk.y, w);
      }
    }
    dft<R, SIGN>(ar[b], ai[b]);
  }
  // In place in shared memory: every read of the row precedes any write.
  if constexpr (Src::kShared && Dst::kShared) pass_barrier(src, 0);
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    const int j = a.tid + b * a.T;
    if (j < M) {
      const int jm = j % a.ns;
      const int d = (j - jm) * R + jm;
#pragma unroll
      for (int k = 0; k < R; ++k) dst.store(d + k * a.ns, ar[b][k], ai[b][k]);
    }
  }
  if constexpr (Dst::kShared) __syncthreads();
}

// The generic pass of a prime p (17..251).  A unit is butterfly j and the
// output pairs (q, p - q) for kGenericSlots consecutive q in 0..(p-1)/2
// (q = 0 gives X[0] alone): the thread reads each pair of inputs x_k,
// x_(p-k) once, forms s_k and d_k, and feeds them to the 4*kGenericSlots
// FMAs of its slots, so each load of an input feeds four FMAs and the
// cosine and sine sums of q and p - q are shared (p multiply-adds an
// output, not 4p).  Lanes take consecutive j of one slot group: the
// inputs are consecutive words, the roots w_p^(kq), staged in shared memory
// (`roots`, p entries, the transform's sign), one broadcast word.  The
// twiddles of a pass with NS > 1 are applied in place before it (the
// inputs are read once per slot group).  Streaming (first or last pass)
// the threads loop over the units; held (in place, both in shared memory)
// every thread takes at most one unit, which the host checks.
template <class Src, class Dst>
__device__ __forceinline__ void generic_pass(int p, const Src& src, const Dst& dst,
                                             const MixStep& a,
                                             const float2* __restrict__ tw,
                                             float2* roots) {
  constexpr bool kHeld = Src::kShared && Dst::kShared;
  const int M = a.n / p;
  const int H = (p - 1) / 2;
  const int units = generic_units(a.n, p);
  const int flat = threadIdx.y * blockDim.x + threadIdx.x;
  const int nflat = blockDim.x * blockDim.y;
  for (int m = flat; m < p; m += nflat) roots[m] = __ldg(&tw[m * M * a.tws]);
  if constexpr (Src::kShared) {
    if (a.ns > 1) {
      const int step = a.n / (a.ns * p) * a.tws;
      for (int x = a.tid; x < a.n; x += a.T) {
        const int k = x / M;
        const int e = (x - k * M) % a.ns * step;
        if (k != 0 && e != 0) {
          float re, im;
          src.load(x, re, im);
          cmul(re, im, __ldg(&tw[k * e]));
          src.store(x, re, im);
        }
      }
    }
  }
  __syncthreads();  // the roots (and the twiddled inputs) are in place
  for (int u0 = 0; u0 < units; u0 += a.T) {
    // Threads past the last unit skip the sums (unlike small_pass, a
    // generic pass can leave half its threads idle, which then yield the
    // issue slots).
    const int u = u0 + a.tid;
    const bool on = u < units;
    const int g = on ? u / M : 0;
    const int j = on ? u - g * M : 0;
    const int q0 = g * kGenericSlots;
    float x0r = 0.f, x0i = 0.f;
    float Ar[kGenericSlots], Ai[kGenericSlots], Br[kGenericSlots], Bi[kGenericSlots];
#pragma unroll
    for (int t = 0; t < kGenericSlots; ++t) Ar[t] = Ai[t] = Br[t] = Bi[t] = 0.f;
    if (on) {
      src.load(j, x0r, x0i);
      int e0 = 0;  // k*q0 mod p
      for (int k = 1; k <= H; ++k) {
        float ur, ui, vr, vi;
        src.load(j + k * M, ur, ui);
        src.load(j + (p - k) * M, vr, vi);
        const float sr = ur + vr, si = ui + vi, dr = ur - vr, di = ui - vi;
        e0 += q0;
        if (e0 >= p) e0 -= p;
        int e = e0;
#pragma unroll
        for (int t = 0; t < kGenericSlots; ++t) {
          if (t != 0) {  // k*(q0 + t) mod p
            e += k;
            if (e >= p) e -= p;
          }
          const float2 w = roots[e];
          Ar[t] = fmaf(sr, w.x, Ar[t]);
          Ai[t] = fmaf(si, w.x, Ai[t]);
          Br[t] = fmaf(dr, w.y, Br[t]);
          Bi[t] = fmaf(di, w.y, Bi[t]);
        }
      }
    }
    if constexpr (kHeld) __syncthreads();  // every read precedes any write
    if (on) {
      const int jm = j % a.ns;
      const int d = (j - jm) * p + jm;
#pragma unroll
      for (int t = 0; t < kGenericSlots; ++t) {
        const int q = q0 + t;
        if (q <= H) {
          const float ar = x0r + Ar[t], ai = x0i + Ai[t];
          dst.store(d + q * a.ns, ar - Bi[t], ai + Br[t]);
          if (q != 0) dst.store(d + (p - q) * a.ns, ar + Bi[t], ai - Br[t]);
        }
      }
    }
  }
  if constexpr (Dst::kShared) __syncthreads();
}

// A small-radix pass at mixed_hold(R) butterflies a thread, or where 1024
// threads cannot keep it there (large N) at mixed_hold_wide(R).
template <int R, int SIGN, class Src, class Dst>
__device__ __forceinline__ void small_dispatch(const Src& src, const Dst& dst,
                                               const MixStep& a,
                                               const float2* __restrict__ tw) {
  if constexpr (mixed_hold_wide(R) == mixed_hold(R)) {
    small_pass<R, mixed_hold(R), SIGN>(src, dst, a, tw);
  } else if (a.n / R <= mixed_hold(R) * a.T) {
    small_pass<R, mixed_hold(R), SIGN>(src, dst, a, tw);
  } else {
    small_pass<R, mixed_hold_wide(R), SIGN>(src, dst, a, tw);
  }
}

// One pass of radix R, dispatched to its butterflies.
template <int SIGN, class Src, class Dst>
__device__ __forceinline__ void mixed_pass(int R, const Src& src, const Dst& dst,
                                           const MixStep& a,
                                           const float2* __restrict__ tw,
                                           float2* roots) {
  switch (R) {
    case 2: small_dispatch<2, SIGN>(src, dst, a, tw); break;
    case 3: small_dispatch<3, SIGN>(src, dst, a, tw); break;
    case 4: small_dispatch<4, SIGN>(src, dst, a, tw); break;
    case 5: small_dispatch<5, SIGN>(src, dst, a, tw); break;
    case 7: small_dispatch<7, SIGN>(src, dst, a, tw); break;
    case 8: small_dispatch<8, SIGN>(src, dst, a, tw); break;
    case 9: small_dispatch<9, SIGN>(src, dst, a, tw); break;
    case 11: small_dispatch<11, SIGN>(src, dst, a, tw); break;
    case 13: small_dispatch<13, SIGN>(src, dst, a, tw); break;
    case 16: small_dispatch<16, SIGN>(src, dst, a, tw); break;
    default: generic_pass(R, src, dst, a, tw, roots); break;
  }
}

// The threads of a row and this thread's index among them: blockDim.x and
// threadIdx.x, unless the row's type says otherwise with a member lanes()
// (a block whose rows interleave across the lanes of a warp: ax0_fft.cu,
// ax0_gen_fft.cu's pipelined tiles).
template <class Row>
__device__ __forceinline__ auto row_lanes(const Row& row, int) -> decltype(row.lanes()) {
  return row.lanes();
}
template <class Row>
__device__ __forceinline__ int2 row_lanes(const Row&, long) {
  return make_int2(static_cast<int>(blockDim.x), static_cast<int>(threadIdx.x));
}

// Every pass of the plan: row.src() -> row.shared() -> ... -> row.dst().
// `row` builds each source, sink and buffer when a pass needs it (a kernel
// hands in accessors of its __grid_constant__ arguments), so that nothing
// but the pass index and NS stays live in registers across the passes;
// row.roots() is the block's kGenericMaxP staged w_p entries.  With dst in
// shared memory the last pass ends with a barrier, so the row is then in
// row.shared() for the whole block.
template <int SIGN, class Row>
__device__ __forceinline__ void mixed_fft(const Row& row, const MixedPlan& plan,
                                          const float2* __restrict__ tw, int tws) {
  const int2 l = row_lanes(row, 0);
  int ns = 1;
  for (int p = 0; p < plan.np; ++p) {
    const MixStep a{plan.n, ns, l.x, l.y, tws};
    const int R = plan.radix[p];
    if (p == 0) {
      mixed_pass<SIGN>(R, row.src(), row.shared(), a, tw, row.roots());
    } else if (p + 1 < plan.np) {
      mixed_pass<SIGN>(R, row.shared(), row.shared(), a, tw, row.roots());
    } else {
      mixed_pass<SIGN>(R, row.shared(), row.dst(), a, tw, row.roots());
    }
    ns *= R;
  }
}

// The passes of a plan fixed at compile time, radices R, RS... (2, 4, 8 or
// 16), each at mixed_hold(R) butterflies a thread (the launch shape of
// mixed_shape), src -> row.shared() -> ... -> row.dst() as in mixed_fft,
// with every pass's N and NS constants; the first pass at NS, so a caller
// may run a plan's passes in parts.  The table tw holds each pass's
// twiddles w_(NS*R)^(k*e), [k - 1][e] for 0 < k < R and e < NS, pass after
// pass from the first with NS > 1 (where the table begins, OFF = 0):
// consecutive lanes read consecutive roots, where a gather from the
// N-point table at stride k*N/(NS*R) touches a cache line a lane.  OFF:
// where this pass's roots begin.
template <int SIGN, int N, int NS, int OFF, int R, int... RS, class Src, class Row>
__device__ __forceinline__ void fixed_passes(const Src& src, const Row& row,
                                             const float2* __restrict__ tw) {
  static_assert(R == 2 || R == 4 || R == 8 || R == 16, "power-of-two radices only");
  const int2 l = row_lanes(row, 0);
  const FixedStep<N, NS> a{l.x, l.y};
  if constexpr (sizeof...(RS) == 0) {
    small_pass<R, mixed_hold(R), SIGN>(src, row.dst(), a, tw + OFF);
  } else {
    small_pass<R, mixed_hold(R), SIGN>(src, row.shared(), a, tw + OFF);
    fixed_passes<SIGN, N, NS * R, (NS > 1 ? OFF + NS * (R - 1) : OFF), RS...>(row.shared(), row,
                                                                               tw);
  }
}

// Every pass of the fixed plan RS (product N): row.src() -> ... -> row.dst().
template <int SIGN, int N, int... RS, class Row>
__device__ __forceinline__ void mixed_fft_fixed(const Row& row, const float2* __restrict__ tw) {
  fixed_passes<SIGN, N, 1, 0, RS...>(row.src(), row, tw);
}

// A row in shared memory: (re, im) pairs with one pad pair after every 16.
// A pass at NS = 1 (a plan's first, radix 16 or 8) stores a butterfly's R
// outputs at stride R across the lanes: unpadded, a half-warp's 8-byte
// stores hit 32/R pairs of banks (16-way conflicts at R = 16); padded, all
// 32 banks.  A half-warp's run of 16 consecutive points stays
// conflict-free.
__host__ __device__ constexpr int padded_len(int m) { return m + m / 16; }
__device__ __forceinline__ int padded(int k) { return k + (k >> 4); }

struct PadShared {
  float2* p;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const float2 v = p[padded(k)];
    a = v.x;
    b = v.y;
  }
  __device__ __forceinline__ void store(int k, float a, float b) const {
    p[padded(k)] = make_float2(a, b);
  }
};

// Two real frames a and b (b null: a zero plane) as nfft complex points
// a + i b, read by the first pass of the kernels that transform two frames
// at once (welch_acc_fft.cu, B16-B18; spec_fft.cu's B19): point j <
// nperseg less each plane's mean, times the window; zero past.
struct TwoFramesIn {
  const float* a;
  const float* b;
  const float* w;  // in shared memory, or the caller's
  int nperseg;
  float ma, mb;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int j, float& u, float& v) const {
    if (j >= nperseg) {
      u = v = 0.f;
      return;
    }
    const float wj = w[j];
    u = (a[j] - ma) * wj;
    v = b != nullptr ? (b[j] - mb) * wj : 0.f;
  }
};

// A segment's frame of a complex signal as nfft complex points, read by the
// first pass of spec_c2c_fft.cu (B22) and welch_acc_fft.cu's two-sided
// kind (B21): point j < nperseg is the signal's, less each plane's mean,
// times the window; zero past.  Planar (a null im: a zero plane, none of it
// read) or the complex64 signal as it lies.
template <bool IN_C64>
struct C2cFrameIn {
  const float* re;  // planar: the frame's first point of each plane
  const float* im;  // null: a zero plane
  const float2* z;  // complex64: the frame's first point
  const float* w;   // the window: in shared memory, or the caller's
  int nperseg;
  float mr, mi;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int j, float& a, float& b) const {
    if (j >= nperseg) {
      a = b = 0.f;
      return;
    }
    float u, v;
    if constexpr (IN_C64) {
      const float2 p = z[j];
      u = p.x;
      v = p.y;
    } else {
      u = re[j];
      v = im != nullptr ? im[j] : 0.f;
    }
    const float wj = w[j];
    a = (u - mr) * wj;
    b = (v - mi) * wj;
  }
};

// The launch shape of the row kernels (rows_fft.cu, B1; filt_fft.cu, B9)
// at n = 2^LOG2N: threads a row (16 points each), rows a block (one per
// threadIdx.y, at least 128 threads a block), and the blocks an SM that the
// launch bound asks registers for (up to 80 a thread for blocks of 128 and
// 256 threads, 64 above).
template <int LOG2N>
struct RowsShape {
  static constexpr int kThreads = (1 << LOG2N) / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kSmem = kRows * padded_len(1 << LOG2N) * static_cast<int>(sizeof(float2));
};

// A row in device memory, interleaved: read by the first pass.  No
// __restrict__: the output may alias the input.
struct C64In {
  const float2* p;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const float2 v = p[k];
    a = v.x;
    b = v.y;
  }
};

// A row in device memory, written by the last pass with the scale folded
// in; nothing for a row past the last.
struct C64Out {
  float2* p;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (valid) p[k] = make_float2(a * scale, b * scale);
  }
};

struct PlanarOut {
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

// The plan of each power of two m = 2^LOG2M, 2^6 .. 2^14, compiled into the
// kernels that include this header: radix i, 0 past the last pass.  It is
// ops/cuda_fft.py::_mixed_radix_plan(m) (16*8*8*8 at 8192; only the radices
// 16 and 8, so a thread holds 16 points in every pass at m/16 threads a
// row), and the host builds each pass's twiddle table from the same plan
// (_pass_roots_np; tests hold the two equal).
constexpr int kPlanMax = 4;
__host__ __device__ constexpr int plan_radix(int log2m, int i) {
  constexpr int plans[9][kPlanMax] = {{8, 8}, {16, 8}, {16, 16}, {8, 8, 8}, {16, 8, 8},
                                      {16, 16, 8}, {16, 16, 16}, {16, 8, 8, 8},
                                      {16, 16, 8, 8}};
  return plans[log2m - 6][i];
}

// The passes of m = 2^LOG2M's plan, row.src() -> ... -> row.dst().  With
// FIRST = 1, every pass but the first, row.shared() -> ... -> row.dst(), for
// a kernel that runs the first pass (radix plan_radix(LOG2M, 0) at NS = 1,
// no twiddles) itself into row.shared() (rows_t_fft.cu: its loads multiplied
// by the four-step's outer twiddle).
template <int SIGN, int LOG2M, int FIRST = 0, class Row>
__device__ __forceinline__ void plan_fft(const Row& row, const float2* __restrict__ tw) {
  static_assert(FIRST == 0 || FIRST == 1, "from the first pass or the second");
  constexpr int M = 1 << LOG2M;
  constexpr int r0 = plan_radix(LOG2M, 0), r1 = plan_radix(LOG2M, 1);
  constexpr int r2 = plan_radix(LOG2M, 2), r3 = plan_radix(LOG2M, 3);
  if constexpr (FIRST == 1) {
    if constexpr (r2 == 0) {
      fixed_passes<SIGN, M, r0, 0, r1>(row.shared(), row, tw);
    } else if constexpr (r3 == 0) {
      fixed_passes<SIGN, M, r0, 0, r1, r2>(row.shared(), row, tw);
    } else {
      fixed_passes<SIGN, M, r0, 0, r1, r2, r3>(row.shared(), row, tw);
    }
  } else if constexpr (r2 == 0) {
    mixed_fft_fixed<SIGN, M, r0, r1>(row, tw);
  } else if constexpr (r3 == 0) {
    mixed_fft_fixed<SIGN, M, r0, r1, r2>(row, tw);
  } else {
    mixed_fft_fixed<SIGN, M, r0, r1, r2, r3>(row, tw);
  }
}

// ---------------------------------------------------------------------- //
// host side: plan checks and launch shape
// ---------------------------------------------------------------------- //

// Copies radix[0..np) into *plan and checks it: 2 <= np <= kMixMaxPasses,
// product n, each radix a small one or 17..kGenericMaxP, generic radices
// first or last only.
inline bool mixed_plan_make(const int* radix, int np, int n, MixedPlan* plan) {
  if (radix == nullptr || np < 2 || np > kMixMaxPasses || n < 2) return false;
  plan->n = n;
  plan->np = np;
  long long prod = 1;
  for (int i = 0; i < np; ++i) {
    const int r = radix[i];
    const bool generic = !mixed_small(r);
    if (generic && (r < 17 || r > kGenericMaxP || (i != 0 && i != np - 1))) return false;
    plan->radix[i] = r;
    prod *= r;
    if (prod > n) return false;
  }
  return prod == n;
}

struct MixedShape {
  int threads;  // per row
  int rows;     // per block
  int smem;     // bytes of dynamic shared memory
};

// Threads of a row: enough that a thread holds about 16 points
// (mixed_hold butterflies of each small pass), and the units of the
// largest generic prime (the costliest pass, p/2 steps a unit) in one round
// where they fit 1024 threads; a held generic pass needs its units in one
// round.  At least 128 threads a block.  threads = 0: the plan cannot run
// (a held generic pass of more units than 1024 threads).
inline MixedShape mixed_shape(const MixedPlan& plan, bool held_last) {
  const int n = plan.n;
  int need = (n + 15) / 16;
  int pmax = 0;
  for (int i = 0; i < plan.np; ++i) {
    const int r = plan.radix[i];
    if (mixed_small(r)) {
      const int per = mixed_hold(r);
      need = need > (n / r + per - 1) / per ? need : (n / r + per - 1) / per;
    } else {
      pmax = pmax > r ? pmax : r;
      if (held_last && i == plan.np - 1) {
        if (generic_units(n, r) > kMixMaxThreads) return MixedShape{0, 0, 0};
        need = need > generic_units(n, r) ? need : generic_units(n, r);
      }
    }
  }
  const bool generic = pmax != 0;
  if (generic && generic_units(n, pmax) <= kMixMaxThreads) {
    need = need > generic_units(n, pmax) ? need : generic_units(n, pmax);
  }
  int T = (need + 31) / 32 * 32;
  if (T > kMixMaxThreads) T = kMixMaxThreads;
  const int rows = T >= 128 ? 1 : (128 + T - 1) / T;
  const int smem = rows * 2 * n * static_cast<int>(sizeof(float)) +
                   (generic ? kGenericMaxP * static_cast<int>(sizeof(float2)) : 0);
  return MixedShape{T, rows, smem};
}

}  // namespace fftk
