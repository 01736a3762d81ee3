// Banded LU forward/backward substitution on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rustpde_mpi_tpu/ops/pallas_banded.py
// `_kernel` (banded_solve_pallas, PallasBandedSolver) and the lax.scan
// recurrence of rustpde_mpi_tpu/ops/banded.py (BandedSolver, which also
// takes one factor set per lane).  For every lane column of b, with the
// factors of ops/banded.py::banded_lu_factor:
//
//   forward:   y_i = b_i - sum_{d=1..p} L[d-1, i] * y_{i-d}
//   backward:  x_i = (y_i - sum_{d=1..q} U[d, i] * x_{i+d}) / U[0, i]
//
// One thread per lane column marches the rows; grid.y runs the batch.  The
// wrapper (ops/banded_solve.py) passes b and x as strided (batch, n, lanes)
// views, so an axis-1 solve of a row-major field reads its rows in place
// (lane stride n: uncoalesced) instead of copying a transpose.  Factors are
// either one set, (p, n) and (q+1, n), read by every lane (flane = 0: each
// warp reads one address, a broadcast through the read-only cache), or one
// set per lane stored (p, n, L) and (q+1, n, L) (flane = 1, fl = L: the
// lanes of a warp read neighbouring addresses).  Per-lane factors take a
// factor batch stride fb: lane l of batch k reads set k * fb + l, so one
// launch solves the y-pencils of all ranks of a mesh, rank k holding
// eigenvalue lanes k * fb.. (the pencil-decomposed Poisson solve; fb = 0
// for a serial solve).  The last p (q) results of
// a lane stay in registers; neighbour terms are skipped by bounding d, never
// by clamped reads.  The rows are taken CH at a time, their b values and
// coefficients loaded before the chain that consumes them, so the loads
// overlap instead of each waiting in the dependent chain.
//
// Bound on the H100: bytes (b read and x written once, 16.7 MB a 1023^2 f64
// solve, plus 57 MB of per-lane factors for the Poisson solve: 5 and 22 us
// at 3.35 TB/s).  The kernel is limited by latency instead: 1023 lanes give
// 8 blocks of 128 threads for 132 SMs, each thread a chain of 2n dependent
// steps, the backward ones with an IEEE division (as both JAX paths divide
// by U[0, i]; no reciprocal).  A zero numerator takes the division's slow
// path, and the slowest lane sets a launch's time: a pencil's zero pad lane
// meets it on every row (+0.165 ms a launch on the meshed rbc1025 step), so
// solves on padded pencils (pad_zeros = 1) never divide a zero; the others
// keep the plain division, which the zero-safe one slows by about 1.5%.
// Batching solves into one launch and splitting the lanes finer are later
// work.
#include <cuda_runtime.h>

namespace rp {

constexpr int MAXB = 4;      // largest p and q the kernel takes
constexpr int CH = 8;        // rows loaded ahead of the chain
constexpr int NTHREADS = 128;

// the value unchanged, through a move the compiler cannot see through
__device__ __forceinline__ double opaque(double v) {
  asm("mov.f64 %0, %1;" : "=d"(v) : "d"(v));
  return v;
}
__device__ __forceinline__ float opaque(float v) {
  asm("mov.f32 %0, %1;" : "=f"(v) : "f"(v));
  return v;
}

template <typename T, bool PAD_ZEROS>
__global__ void __launch_bounds__(NTHREADS)
    banded_kernel(int n, int lanes, int p, int q, const T* __restrict__ lower,
                  const T* __restrict__ upper, int flane, long long fl,
                  long long fb,
                  const T* __restrict__ b, long long sb, long long sr,
                  long long sl, T* __restrict__ x, long long xb, long long xr,
                  long long xl) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const T* bp = b + (long long)blockIdx.y * sb + (long long)lane * sl;
  T* xp = x + (long long)blockIdx.y * xb + (long long)lane * xl;
  // factor element (d, i) of this lane: (d * n + i) * fp + fo
  const long long fp = flane ? fl : 1;
  const long long fo = flane ? (long long)blockIdx.y * fb + lane : 0;

  // forward substitution into x; c[d-1] holds y_{i-d}
  T c[MAXB];
#pragma unroll
  for (int d = 0; d < MAXB; ++d) c[d] = T(0);
  for (int i0 = 0; i0 < n; i0 += CH) {
    T bv[CH], lv[CH][MAXB];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int i = i0 + k;
      if (i < n) {
        bv[k] = bp[i * sr];
#pragma unroll
        for (int d = 1; d <= MAXB; ++d)
          if (d <= p && d <= i) lv[k][d - 1] = __ldg(lower + ((d - 1) * (long long)n + i) * fp + fo);
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int i = i0 + k;
      if (i < n) {
        T acc = bv[k];
#pragma unroll
        for (int d = 1; d <= MAXB; ++d)
          if (d <= p && d <= i) acc = acc - lv[k][d - 1] * c[d - 1];
#pragma unroll
        for (int d = MAXB - 1; d > 0; --d) c[d] = c[d - 1];
        c[0] = acc;
        xp[i * xr] = acc;
      }
    }
  }

  // backward substitution in place; c[d-1] holds x_{i+d}
#pragma unroll
  for (int d = 0; d < MAXB; ++d) c[d] = T(0);
  for (int i0 = n - 1; i0 >= 0; i0 -= CH) {
    T yv[CH], uv[CH][MAXB + 1];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int i = i0 - k;
      if (i >= 0) {
        yv[k] = xp[i * xr];
#pragma unroll
        for (int d = 0; d <= MAXB; ++d)
          if (d <= q && i + d < n) uv[k][d] = __ldg(upper + (d * (long long)n + i) * fp + fo);
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int i = i0 - k;
      if (i >= 0) {
        T acc = yv[k];
#pragma unroll
        for (int d = 1; d <= MAXB; ++d)
          if (d <= q && i + d < n) acc = acc - uv[k][d] * c[d - 1];
        if constexpr (PAD_ZEROS) {
          // divide a nonzero stand-in and keep the zero (0 / U[0, i] is zero
          // up to its sign); `opaque` keeps the compiler from folding the
          // stand-in back into a division of acc, and a branch instead
          // costs every row its overlap
          const T quo = opaque(acc == T(0) ? T(1) : acc) / uv[k][0];
          acc = acc == T(0) ? acc : quo;
        } else {
          acc = acc / uv[k][0];
        }
#pragma unroll
        for (int d = MAXB - 1; d > 0; --d) c[d] = c[d - 1];
        c[0] = acc;
        xp[i * xr] = acc;
      }
    }
  }
}

template <typename T>
int launch_banded(int nb, int n, int lanes, int p, int q, const void* lower,
                  const void* upper, int flane, long long fl, long long fb,
                  int pad_zeros, const void* b, long long sb, long long sr,
                  long long sl, void* x, long long xb, long long xr,
                  long long xl, cudaStream_t stream) {
  if (nb < 1 || nb > 65535 || n < 1 || lanes < 1 || p < 0 || p > MAXB ||
      q < 0 || q > MAXB || (flane != 0 && flane != 1) ||
      (pad_zeros != 0 && pad_zeros != 1) ||
      (flane && (fl < lanes || fb < 0 || (nb - 1) * fb + lanes > fl)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((lanes + NTHREADS - 1) / NTHREADS, nb, 1);
  auto kernel = pad_zeros ? banded_kernel<T, true> : banded_kernel<T, false>;
  kernel<<<grid, NTHREADS, 0, stream>>>(
      n, lanes, p, q, static_cast<const T*>(lower),
      static_cast<const T*>(upper), flane, fl, fb, static_cast<const T*>(b),
      sb, sr, sl, static_cast<T*>(x), xb, xr, xl);
  return (int)cudaGetLastError();
}

}  // namespace rp

extern "C" int rp_banded_solve_f64(int nb, int n, int lanes, int p, int q,
                                   const void* lower, const void* upper,
                                   int flane, long long fl, long long fb,
                                   int pad_zeros, const void* b, long long sb,
                                   long long sr, long long sl, void* x,
                                   long long xb, long long xr, long long xl,
                                   void* stream) {
  return rp::launch_banded<double>(nb, n, lanes, p, q, lower, upper, flane, fl,
                                   fb, pad_zeros, b, sb, sr, sl, x, xb, xr, xl,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int rp_banded_solve_f32(int nb, int n, int lanes, int p, int q,
                                   const void* lower, const void* upper,
                                   int flane, long long fl, long long fb,
                                   int pad_zeros, const void* b, long long sb,
                                   long long sr, long long sl, void* x,
                                   long long xb, long long xr, long long xl,
                                   void* stream) {
  return rp::launch_banded<float>(nb, n, lanes, p, q, lower, upper, flane, fl,
                                  fb, pad_zeros, b, sb, sr, sl, x, xb, xr, xl,
                                  static_cast<cudaStream_t>(stream));
}
