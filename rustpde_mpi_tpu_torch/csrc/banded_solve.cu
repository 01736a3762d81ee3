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
// b and x are strided (batch, n, lanes) views (grid.y runs the batch), so
// an axis-1 solve of a row-major field reads its rows in place, or
// (planes, batch, n, lanes) views (grid.z runs the planes, which share the
// factor sets): a complex right-hand side goes in as its real view, its
// real and imaginary parts two planes, so a pencil solve whose factor sets
// are offset by the rank (the batch entry) is one launch.  The factor
// offset of batch entry j is (j mod fper) * fb: an ensemble of K members
// stacks its members' pencils (K x ranks) into the batch, and every
// member's rank r reads rank r's factor sets, so K members are one launch
// as well (the JAX package's jax.vmap of the solve).
//
// Bound on the H100: bytes (b read and x written once, 16.7 MB a 1023^2
// f64 solve, plus the per-lane factors of the Poisson solve: 5 us and
// 15 us at 3.35 TB/s).  The recurrence is a chain of dependent rows, so
// what the design fights is latency:
//
// * Chains.  The Chebyshev operators couple rows of one parity only: the
//   odd-offset factor terms are zero in every lane.  The wrapper
//   (ops/banded_solve.py) finds that on the host when it builds the solve
//   and repacks the factors into "chain" layout: NSYS = 2 systems (even
//   and odd rows) of bandwidths PP = p/2 and QQ = q/2, each a chain of n/2
//   rows, one kernel instance for each PP, QQ in {1, 2}.  A band with odd
//   couplings keeps NSYS = 1 (one chain of n rows), widened to PP = QQ = 4
//   with zero terms.  Dropping a term whose coefficient is zero changes no
//   finite result.  The chain layout is [term][chain row k][system s]
//   [factor set], factor sets (lanes) innermost; chain row k of system s is
//   row s + NSYS * k; terms that reach outside the system are zero in it,
//   so the chains never test a bound.
// * Rows staged through shared memory.  A block owns a tile of TL lanes
//   (8, fewer when n is large) of one batch entry: 2 * TL chains, one
//   thread each, in warp 0.  Warps 1-3 copy: a ring of RING stages, filled
//   by cp.async and drained by cp.async.wait_group and one barrier a
//   stage, brings in the rows of b (RK chain rows of each system a stage)
//   and the factor terms of the rows the chains take next.  Each copy
//   thread works out its copies' offsets once (Copier), so a stage costs a
//   copy an add; issuing them is what the copy warps spend a stage on, in
//   step with the chains.  The whole column of the tile stays in shared
//   memory: b lands there, the forward pass overwrites it with y, and the
//   backward pass reads y there and writes x to device memory, so b is read
//   once and x written once.  The forward stages carry b and the lower
//   terms, the backward stages (rows descending) the upper terms and the
//   reciprocals.  One factor set for every lane is copied once a stage per
//   block, per-lane factors TL sets at a time.
// * Coalesced copies in both orientations.  Lane stride 1 (axis-0
//   solves): a tile row of TL lanes is contiguous and the tile is stored
//   row by row.  Row stride 1 (axis-1 solves): a lane's rows are
//   contiguous and the tile is stored lane by lane, with a lane stride of
//   16 bytes past a multiple of 128 so that the chains' reads fall in
//   distinct banks.  The copies are 16 bytes where the wrapper proved that
//   every copied run starts on 16 bytes (pointer and strides), else one
//   element.  A partial vector at the ragged edge is zero-filled.
// * The chain.  A stage's rows are read from shared memory into registers
//   first, then the chain runs through them with the far terms subtracted
//   first, so that only the newest value's multiply-subtract waits on the
//   previous row.  The division by U[0, i] (as in both JAX paths) is the
//   correctly rounded quotient from a reciprocal rounded on the host and
//   one FMA correction: three dependent operations, none of which branches
//   on the value, where the IEEE division's sequence of ten waited on a
//   reciprocal refinement and a range check every row, and a zero
//   numerator (a pencil's zero pad lane) took its slow path.
//
// At the rbc1025 shapes (1023 lanes, or 4 x 256 on the meshed route) a
// solve is 128 blocks of one wave on 132 SMs; a block holds 64-66 KB of
// column and a 64 KB ring (per-lane factors; 8 KB for one set).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace rp {
namespace banded {

constexpr int MAXB = 4;        // largest p and q the kernel takes
constexpr int RING = 8;        // stages in the ring
constexpr int NTHREADS = 128;  // warp 0: the chains; warps 1-3: the copies
constexpr int NCOPY = NTHREADS - 32;
constexpr int MAX_TILE = 8;    // widest tile of lanes
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use

// RK, the chain rows of each system a stage brings, by the number of
// systems NSYS
template <int NSYS>
struct Path;
template <>
struct Path<2> {
  static constexpr int RK = 16;
};
template <>
struct Path<1> {
  static constexpr int RK = 8;
};

struct Args {
  const void* low;  // lower terms d = 1..pp, [pp][nk][NSYS][fl]
  const void* upp;  // upper terms d = 0..qq, then 1 / u_0: [qq + 2][nk][NSYS][fl]
  const void* b;
  void* x;
  long long sb, sr, sl, xb, xr, xl;  // strides of b and x (batch, row, lane)
  long long sp, xp;                  // plane strides of b and x
  long long fl, fb, fper;            // factor sets, factor batch stride and period
  int n, lanes, nk;
  int tls;        // log2 of the tile's lanes
  int flane;      // 1: one factor set per lane
  int rowfast;    // 1: row stride 1, the tile stored lane by lane
  int vec;        // 1: 16-byte copies of b
  int ld;         // lane stride of the tile (rowfast)
  int tile_elems; // elements before the ring
  int slot_elems; // elements of a ring slot
};

// One copy thread's share of every stage, worked out once: for each of its
// copies the offsets within a stage, so that a stage costs each copy an add
// and a cp.async.  A stage is RC rows of b (forward stages only: into the
// tile) and the factor terms of RK chain rows of each system (into the ring
// slot), PP lower terms going forward, QQ + 1 upper terms and the
// reciprocals going back.  Copy m of thread c is element (or 16-byte
// vector) c + m * NCOPY of the stage.
template <typename T, int NSYS, int PP, int QQ>
struct Copier {
  static constexpr int RK = Path<NSYS>::RK, RC = NSYS * RK;
  static constexpr int ES = (int)sizeof(T), V = 16 / ES;
  static constexpr int NB = (MAX_TILE * RC + NCOPY - 1) / NCOPY;
  static constexpr int NL = (PP * RK * NSYS * MAX_TILE + NCOPY - 1) / NCOPY;
  static constexpr int NU = ((QQ + 2) * RK * NSYS * MAX_TILE + NCOPY - 1) / NCOPY;
  long long bsrc[NB];  // b: source offset from the stage's first row
  int bdst[NB];        // tile offset from the stage's first row
  int brow[NB];        // row within the stage
  int bel[NB];         // elements (0: no copy)
  long long lsrc[NL], usrc[NU];  // factors: source offset, -1 past the end
  long long fstep;               // factor source advance a chain row

  __device__ __forceinline__ void init(const Args& a, int c, int tl, int ntl, long long fo) {
    const int per = a.rowfast ? (a.vec ? RC / V : RC) : (a.vec ? (ntl + V - 1) / V : ntl);
    const int total = a.rowfast ? ntl * per : RC * per;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      const int e = c + m * NCOPY;
      bel[m] = 0;
      if (e < total) {
        const int major = e / per, minor = e - major * per;
        if (a.rowfast) {  // major: lane, minor: row (vector)
          const int rr = a.vec ? minor * V : minor;
          bsrc[m] = major * a.sl + rr * a.sr;
          bdst[m] = major * a.ld + rr;
          brow[m] = rr;
          bel[m] = a.vec ? V : 1;
        } else {  // major: row, minor: lane (vector)
          const int ll = a.vec ? minor * V : minor;
          bsrc[m] = major * a.sr + ll * a.sl;
          bdst[m] = major * tl + ll;
          brow[m] = major;
          bel[m] = a.vec ? min(V, ntl - ll) : 1;
        }
      }
    }
    const int tfs = a.flane ? a.tls : 0;
    const int tlf = 1 << tfs;
    fstep = (long long)NSYS * a.fl;
    auto factor = [&](int e, int nt) -> long long {
      if (e >= (nt * RK * NSYS) << tfs) return -1;
      const int lf = e & (tlf - 1);
      const int rest = e >> tfs;
      const int t = rest / (RK * NSYS);
      const int ks = rest - t * (RK * NSYS);
      if (fo + lf >= a.fl) return -1;  // a ragged tile's lanes past the factors' end
      return ((long long)t * a.nk * NSYS + ks) * a.fl + fo + lf;
    };
#pragma unroll
    for (int m = 0; m < NL; ++m) lsrc[m] = factor(c + m * NCOPY, PP);
#pragma unroll
    for (int m = 0; m < NU; ++m) usrc[m] = factor(c + m * NCOPY, QQ + 2);
  }

  // Copy thread c's part of stage j: on a forward stage (j < nc) the b rows
  // of chunk j and the lower terms of chunk j, on a backward stage the upper
  // terms and the reciprocals of chunk nst - 1 - j, into ring slot j % RING;
  // a slot element with no source (past the factors' end) is zero-filled.
  __device__ __forceinline__ void issue(const Args& a, int j, int nc, int c, T* tile, T* ring,
                                        const T* bl, int tl) const {
    T* slot = ring + (j % RING) * a.slot_elems + c;
    if (j < nc) {
      const int r0 = j * RC;
      const int rows = min(RC, a.n - r0);
      const T* src = bl + (long long)r0 * a.sr;
      T* dst = tile + r0 * (a.rowfast ? 1 : tl);
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (bel[m] && brow[m] < rows) {
          if (a.vec)
            cp_async<16>(dst + bdst[m], src + bsrc[m],
                         (a.rowfast ? min(V, rows - brow[m]) : bel[m]) * ES);
          else
            cp_async<ES>(dst + bdst[m], src + bsrc[m], ES);
        }
      }
      const T* f = static_cast<const T*>(a.low) + (long long)j * RK * fstep;
#pragma unroll
      for (int m = 0; m < NL; ++m)
        if (c + m * NCOPY < (PP * RK * NSYS) << (a.flane ? a.tls : 0))
          cp_async<ES>(slot + m * NCOPY, lsrc[m] < 0 ? f : f + lsrc[m], lsrc[m] < 0 ? 0 : ES);
    } else {
      const T* f = static_cast<const T*>(a.upp) + (long long)(2 * nc - 1 - j) * RK * fstep;
#pragma unroll
      for (int m = 0; m < NU; ++m)
        if (c + m * NCOPY < ((QQ + 2) * RK * NSYS) << (a.flane ? a.tls : 0))
          cp_async<ES>(slot + m * NCOPY, usrc[m] < 0 ? f : f + usrc[m], usrc[m] < 0 ? 0 : ES);
    }
  }
};

// Forward chain rows k0.. of one stage: y_k = b_k - sum_d l_d[k] y_{k-d},
// d = 1..PP, in place in the tile column `col` (chain row k at col[k * cs]);
// c[d-1] holds y_{k-d}.  fs: this chain's first factor of the slot, chain
// row kk of term t at fs[(t * RK + kk) * fk].  The stage's rows are read
// into registers first, then the chain runs through them.
template <typename T, int NSYS, int PP, int B, bool FULL>
__device__ __forceinline__ void forward(T (&c)[B], T* col, int cs, const T* fs, int fk, int k0,
                                        int ns) {
  constexpr int RK = Path<NSYS>::RK;
  T yv[RK], lv[RK][PP];
#pragma unroll
  for (int kk = 0; kk < RK; ++kk) {
    if (FULL || k0 + kk < ns) {
      yv[kk] = col[(k0 + kk) * cs];
#pragma unroll
      for (int d = 1; d <= PP; ++d) lv[kk][d - 1] = fs[((d - 1) * RK + kk) * fk];
    }
  }
#pragma unroll
  for (int kk = 0; kk < RK; ++kk) {
    if (FULL || k0 + kk < ns) {
      T acc = yv[kk];
#pragma unroll
      for (int d = PP; d >= 1; --d) acc = acc - lv[kk][d - 1] * c[d - 1];  // the newest last
#pragma unroll
      for (int d = B - 1; d > 0; --d) c[d] = c[d - 1];
      c[0] = acc;
      col[(k0 + kk) * cs] = acc;
    }
  }
}

// Backward chain rows k0 + RK - 1 down to k0: x_k = (y_k - sum_d u_d[k]
// x_{k+d}) / u_0[k], d = 1..QQ, y read from the tile, x written to
// xcol[k * xs]; c[d-1] holds x_{k+d}.  The quotient is the correctly
// rounded one, from the reciprocal r = 1 / u_0 (term QQ + 1, rounded on the
// host): q = acc * r is within an ulp of it, and q + r * (acc - u_0 * q),
// the remainder exact in an FMA, rounds to it (Markstein) wherever no
// intermediate leaves the normal range.  No comparison or branch waits on
// acc, and a zero acc gives a zero in three multiply-adds.
template <typename T, int NSYS, int QQ, int B, bool FULL>
__device__ __forceinline__ void backward(T (&c)[B], const T* col, int cs, T* xcol, long long xs,
                                         const T* fs, int fk, int k0, int ns) {
  constexpr int RK = Path<NSYS>::RK;
  T yv[RK], uv[RK][QQ + 2];
#pragma unroll
  for (int kk = RK - 1; kk >= 0; --kk) {
    if (FULL || k0 + kk < ns) {
      yv[kk] = col[(k0 + kk) * cs];
#pragma unroll
      for (int d = 0; d <= QQ + 1; ++d) uv[kk][d] = fs[(d * RK + kk) * fk];
    }
  }
#pragma unroll
  for (int kk = RK - 1; kk >= 0; --kk) {
    if (FULL || k0 + kk < ns) {
      T acc = yv[kk];
#pragma unroll
      for (int d = QQ; d >= 1; --d) acc = acc - uv[kk][d] * c[d - 1];  // the newest last
      const T r = uv[kk][QQ + 1];
      const T q = acc * r;
      acc = fma(fma(-uv[kk][0], q, acc), r, q);
#pragma unroll
      for (int d = B - 1; d > 0; --d) c[d] = c[d - 1];
      c[0] = acc;
      xcol[(k0 + kk) * xs] = acc;
    }
  }
}

// PP, QQ: the chain bandwidths (>= 1; upp holds QQ + 2 terms, the last the
// reciprocals of the first).
template <typename T, int NSYS, int PP, int QQ>
__global__ void __launch_bounds__(NTHREADS, 1) banded_kernel(const Args a) {
  constexpr int RK = Path<NSYS>::RK;
  constexpr int B = PP > QQ ? PP : QQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* ring = tile + a.tile_elems;
  const int tl = 1 << a.tls;
  const int l0 = blockIdx.x * tl;
  const int ntl = min(tl, a.lanes - l0);
  const long long bi = blockIdx.y;
  const long long pl = blockIdx.z;  // the plane: the same factor sets in every one
  // the factor sets of batch entry bi mod fper (no division for one member)
  const long long fo = a.flane ? (bi < a.fper ? bi : bi % a.fper) * a.fb + l0 : 0;
  const int nc = ((a.n + NSYS - 1) / NSYS + RK - 1) / RK;  // stages of each pass
  const int nst = 2 * nc;
  const int tid = threadIdx.x;

  if (tid >= 32) {  // the copies
    const T* bl = static_cast<const T*>(a.b) + pl * a.sp + bi * a.sb + (long long)l0 * a.sl;
    Copier<T, NSYS, PP, QQ> cp;
    cp.init(a, tid - 32, tl, ntl, fo);
    for (int j = 0; j < RING - 1; ++j) {
      if (j < nst) cp.issue(a, j, nc, tid - 32, tile, ring, bl, tl);
      cp_async_commit();
    }
    for (int j = 0; j < nst; ++j) {
      cp_async_wait<RING - 2>();  // this thread's copies of stage j
      __syncthreads();            // everyone's; stage j - 1's slot is free
      if (j + RING - 1 < nst) cp.issue(a, j + RING - 1, nc, tid - 32, tile, ring, bl, tl);
      cp_async_commit();
    }
    return;
  }

  // the chains: thread tid runs system s of lane l0 + ll
  const int s = tid >> a.tls, ll = tid & (tl - 1);
  const bool chain = s < NSYS && ll < ntl;
  const int ns = (a.n - s + NSYS - 1) / NSYS;  // rows of this chain
  const int cs = NSYS * (a.rowfast ? 1 : tl);
  T* col = tile + (a.rowfast ? ll * a.ld + s : s * tl + ll);
  T* xcol = static_cast<T*>(a.x) + pl * a.xp + bi * a.xb + (long long)(l0 + ll) * a.xl +
            (long long)s * a.xr;
  const long long xs = NSYS * a.xr;
  const int tlf = a.flane ? tl : 1;
  const int fk = NSYS * tlf;
  const int fofs = s * tlf + (a.flane ? ll : 0);
  T c[B];
#pragma unroll
  for (int d = 0; d < B; ++d) c[d] = T(0);
  for (int j = 0; j < nst; ++j) {
    __syncthreads();
    if (!chain) continue;
    const T* fs = ring + (j % RING) * a.slot_elems + fofs;
    if (j < nc) {
      const int k0 = j * RK;
      if (k0 + RK <= ns)
        forward<T, NSYS, PP, B, true>(c, col, cs, fs, fk, k0, ns);
      else
        forward<T, NSYS, PP, B, false>(c, col, cs, fs, fk, k0, ns);
    } else {
      if (j == nc) {
#pragma unroll
        for (int d = 0; d < B; ++d) c[d] = T(0);
      }
      const int k0 = (nst - 1 - j) * RK;
      if (k0 + RK <= ns)
        backward<T, NSYS, QQ, B, true>(c, col, cs, xcol, xs, fs, fk, k0, ns);
      else
        backward<T, NSYS, QQ, B, false>(c, col, cs, xcol, xs, fs, fk, k0, ns);
    }
  }
}

template <typename T, int NSYS, int PP, int QQ>
static int launch_one(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t attr = smem_attribute(banded_kernel<T, NSYS, PP, QQ>, SMEM_LIMIT, done);
  if (attr != cudaSuccess) return (int)attr;
  banded_kernel<T, NSYS, PP, QQ><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// nsys: 2 for the parity-split chains, 1 for one chain a lane; pp, qq: the
// chain bandwidths, 1 or 2 on the parity path (an instance each), 4 and 4
// on the general one (terms past the band are zero); upp holds qq + 2
// terms, the last the reciprocals of the first; tl: lanes of a tile (1, 2,
// 4 or 8); vec: 16-byte copies of b (the wrapper proved the alignment;
// checked again here); planes: a second batch level (grid.z) of strides sp
// and xp whose every plane reads the same factor sets (the real and
// imaginary parts of a complex pencil, whose lanes' factor sets are offset
// by the rank's batch entry, not by the part); fper: batch entry j reads
// the factor sets of entry j mod fper (the ranks of each member).
template <typename T>
static int launch(int nb, int n, int lanes, int nsys, int pp, int qq, int tl, int vec,
                  const void* low, const void* upp, int flane, long long fl, long long fb, int nk,
                  const void* b, long long sb, long long sr, long long sl, void* x, long long xb,
                  long long xr, long long xl, int planes, long long sp, long long xp,
                  int fper, cudaStream_t stream) {
  constexpr long long ES = sizeof(T);
  const int tls = tl == 1 ? 0 : tl == 2 ? 1 : tl == 4 ? 2 : tl == MAX_TILE ? 3 : -1;
  const int rk = nsys == 2 ? Path<2>::RK : Path<1>::RK;
  const bool bands = nsys == 2 ? pp >= 1 && pp <= MAXB / 2 && qq >= 1 && qq <= MAXB / 2
                               : pp == MAXB && qq == MAXB;
  if (nb < 1 || nb > 65535 || planes < 1 || planes > 65535 || n < 1 || lanes < 1 || (nsys != 1 && nsys != 2) || tls < 0 ||
      !bands || (vec != 0 && vec != 1) ||
      (flane != 0 && flane != 1) || fl < 1 || (!flane && fl != 1) ||
      fper < 1 || (flane && (fb < 0 || ((long long)(nb < fper ? nb : fper) - 1) * fb + lanes > fl)) ||
      (long long)nk < ((n + nsys - 1) / nsys + rk - 1) / (long long)rk * rk)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.low = low;
  a.upp = upp;
  a.b = b;
  a.x = x;
  a.sb = sb, a.sr = sr, a.sl = sl, a.xb = xb, a.xr = xr, a.xl = xl;
  a.sp = sp, a.xp = xp;
  a.fl = fl, a.fb = fb, a.fper = fper;
  a.n = n, a.lanes = lanes, a.nk = nk;
  a.tls = tls, a.flane = flane, a.vec = vec;
  a.rowfast = sr == 1 && sl != 1;
  // lane stride of a lane-by-lane tile: 16 bytes past a multiple of 128
  a.ld = a.rowfast ? (int)(((n * ES + 127) / 128 * 128 + 16) / ES) : tl;
  const long long per16 = 16 / ES;
  const long long tile = (a.rowfast ? (long long)tl * a.ld : (long long)n * tl);
  const long long tile_elems = (tile + per16 - 1) / per16 * per16;
  const long long terms = pp > qq + 2 ? pp : qq + 2;
  const long long slot = terms * rk * nsys * (flane ? tl : 1);
  const long long smem = (tile_elems + RING * slot) * ES;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  a.tile_elems = (int)tile_elems;
  a.slot_elems = (int)slot;
  if (vec) {
    const bool ok = reinterpret_cast<uintptr_t>(b) % 16 == 0 && (nb == 1 || sb * ES % 16 == 0) &&
                    (planes == 1 || sp * ES % 16 == 0) &&
                    (a.rowfast ? sl * ES % 16 == 0
                               : sl == 1 && sr * ES % 16 == 0 && tl * ES % 16 == 0);
    if (!ok) return (int)cudaErrorMisalignedAddress;
  }
  const dim3 grid((lanes + tl - 1) / tl, nb, planes);
  if (nsys == 1) return launch_one<T, 1, MAXB, MAXB>(a, grid, (int)smem, stream);
  if (pp == 1)
    return qq == 1 ? launch_one<T, 2, 1, 1>(a, grid, (int)smem, stream)
                   : launch_one<T, 2, 1, 2>(a, grid, (int)smem, stream);
  return qq == 1 ? launch_one<T, 2, 2, 1>(a, grid, (int)smem, stream)
                 : launch_one<T, 2, 2, 2>(a, grid, (int)smem, stream);
}

}  // namespace banded
}  // namespace rp

extern "C" int rp_banded_solve_f64(int nb, int n, int lanes, int nsys, int pp, int qq, int tl,
                                   int vec, const void* low, const void* upp, int flane,
                                   long long fl, long long fb, int nk, const void* b,
                                   long long sb, long long sr, long long sl, void* x,
                                   long long xb, long long xr, long long xl, int planes,
                                   long long sp, long long xp, int fper, void* stream) {
  return rp::banded::launch<double>(nb, n, lanes, nsys, pp, qq, tl, vec, low, upp, flane, fl, fb,
                                    nk, b, sb, sr, sl, x, xb, xr, xl, planes, sp, xp, fper,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int rp_banded_solve_f32(int nb, int n, int lanes, int nsys, int pp, int qq, int tl,
                                   int vec, const void* low, const void* upp, int flane,
                                   long long fl, long long fb, int nk, const void* b,
                                   long long sb, long long sr, long long sl, void* x,
                                   long long xb, long long xr, long long xl, int planes,
                                   long long sp, long long xp, int fper, void* stream) {
  return rp::banded::launch<float>(nb, n, lanes, nsys, pp, qq, tl, vec, low, upp, flane, fl, fb,
                                   nk, b, sb, sr, sl, x, xb, xr, xl, planes, sp, xp, fper,
                                   static_cast<cudaStream_t>(stream));
}
