// Tiled GEMM core shared by the fused kernels (fused_stage.cu, fused_conv.cu):
// f64 tensor-core tiles fed by a multi-stage cp.async pipeline, for Hopper
// (sm_90a).
//
// Replaces the tile loops inside the Pallas TPU kernels
// rustpde_mpi_tpu/ops/pallas_step.py `_stage_kernel` and
// rustpde_mpi_tpu/ops/pallas_conv.py `_conv_kernel`; the two kernels built
// on it say which parts of those they take over.
//
// Bound on the H100: operations.  Every product of the fused route is a
// ~1023^3 f64 GEMM (2.1 GFLOP on 16-25 MB), so the roof is the FP64
// tensor-core rate, 67 TFLOP/s (33.5 without tensor cores).  f64 has no
// wgmma; the only way to that rate is the warp-level DMMA, here
// `mma.sync.aligned.m16n8k8.row.col.f64` (PTX ISA 7.8, sm_90; chosen over
// the m16n8k4 and m16n8k16 shapes by time on the card).
//
// Design:
//
// * Block tile: 64 x 64 of 4 warps (2 x 2), two blocks an SM; each warp
//   owns a 32 x 32 tile of 2 x 4 m16n8 accumulator fragments (4 doubles a
//   thread each).  A 1023^2 output is 256 blocks of 64 x 64: two blocks an
//   SM on 132 SMs is one wave of 8 warps an SM, where 128 x 128 tiles (64
//   blocks) would leave half the card idle.  Outputs with 1025 or 683 rows
//   or columns quantize worse (1025^2 is 289 blocks on 264 slots; 683^2 is
//   121, one 4-warp block an SM).  128 x 64 blocks of 8 warps (4 x 2), one
//   an SM, were measured against it at the step's shapes and were slower
//   per step (PERF.md).
// * Pipeline: a ring of 3 stages in dynamic shared memory (above 48 KB,
//   set per kernel by cudaFuncSetAttribute), each stage one depth step
//   (32 deep; 16 for the dual kernel, whose stage holds two operand pairs),
//   filled by cp.async and drained by cp.async.wait_group.  The next
//   step's copies are issued between the DMMAs of the current one, so they
//   issue in the tensor pipe's shadow.  A warp's fragments are
//   double-buffered in registers: the next warp step (8 deep) is loaded
//   while the current one multiplies, with one barrier a stage, placed
//   where the stage it frees has been read out.  The depth steps of every
//   term of an output run through one ring, so a term boundary does not
//   drain it.
// * Copy width: the extents of the step are odd (1021-1025), and a row of
//   1023 doubles is 8184 bytes, so most rows do not start on 16 bytes; TMA
//   (16-byte global strides) and 16-byte cp.async do not apply to them.
//   An operand is copied 8 bytes (one element) at a time with cp.async.ca,
//   or 16 bytes at a time with cp.async.cg where the host has proved that
//   every row starts on 16 bytes (base pointer and leading dimension; the
//   `vec` flags, set by ops/_build.py).  The wrappers pad the leading
//   dimension of their operator constants and scratch, so only the step's
//   own state (odd rows) takes the 8-byte path.  The width is a template
//   parameter, one kernel a combination.  The ragged edge uses the
//   zero-fill form (src-size below the copy size, 0 past the edge): the
//   depth tail, rows >= M and columns >= N read as zero, and no operand is
//   padded with zeros in memory.
// * Bank conflicts: the A tile is stored [BM][BK + 4] and the B tile
//   [BK][BN + 4] (in elements).  A DMMA fragment load of a half-warp reads
//   A[g][t] (g, t < 4), i.e. words g * (BK + 4) + t, and B[t][g], words
//   t * (BN + 4) + g; BK + 4 and BN + 4 are 4 (mod 16), so the 16 8-byte
//   words fall in 16 distinct bank pairs: conflict-free.
//
// f32 has no tensor-core path (TF32 stays off): the float instantiation runs
// the same pipeline and fragment layout with SIMT FFMA from shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

namespace rp {

// The deepest ring (at most 4 stages) of stage_bytes-sized f64 stages that
// leaves room for blocks_per_sm blocks on an SM (228 KB of shared memory, of
// which each resident block reserves 1 KB).
constexpr int ring_depth(int stage_bytes, int blocks_per_sm) {
  return (233472 / blocks_per_sm - 1024) / stage_bytes < 4
             ? (233472 / blocks_per_sm - 1024) / stage_bytes
             : 4;
}

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int BK_, int BLOCKS_PER_SM_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int MMA_K = 8;  // depth of one DMMA (m16n8k8)
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NJ = WN / 8;  // m16n8 fragments of a warp
  static constexpr int NTHREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BLOCKS_PER_SM = BLOCKS_PER_SM_;
  static constexpr int LDA = BK + 4, LDB = BN + 4;  // padded smem rows
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  // ring depths with one and with two operand pairs a stage
  static constexpr int RING1 = ring_depth((A_ELEMS + B_ELEMS) * 8, BLOCKS_PER_SM);
  static constexpr int RING2 = ring_depth(2 * (A_ELEMS + B_ELEMS) * 8, BLOCKS_PER_SM);
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % MMA_K == 0, "warp tile");
};

// The generic GEMM's block tile: depth step 32, a ring of 3 stages (105 KB
// in f64).
using GemmTile = Tile<64, 64, 2, 2, 32, 2>;
// The dual kernel's (two operand pairs a stage): depth step 16, a ring of 3
// stages (111 KB).
using DualTile = Tile<64, 64, 2, 2, 16, 2>;

// -- cp.async ----------------------------------------------------------------

// No "memory" clobber: the copies write a stage nobody reads until the wait
// and the barrier below (which carry one), so the compiler stays free to
// hoist the current stage's fragment loads past them.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's copies into a ROWS x COLS shared tile (leading dimension
// LDS), V elements a cp.async, one depth step after another.  Thread x owns
// columns [c, c + V) of tile rows r, r + RSTEP, ... (c = V * (x % CPR),
// r = x / CPR).  It is set up once per operand (init); then a copy costs a
// row test and an address, and a depth step moves a pointer (next).  The
// depth runs along the tile's columns (DEPTH_COLS: A, M x K) or its rows
// (B, K x N).  Elements outside the source's nr x nc are zero-filled
// (src-size below the copy size; no byte past the edge is read).
template <typename T, int ROWS, int COLS, int LDS, int NTHREADS, int V, bool DEPTH_COLS>
struct Copier {
  static constexpr int CPR = COLS / V;          // copies a tile row
  static constexpr int RSTEP = NTHREADS / CPR;  // tile rows between a thread's copies
  static constexpr int N = ROWS / RSTEP;        // copies a thread makes a step
  static_assert(COLS % V == 0 && NTHREADS % CPR == 0 && ROWS % RSTEP == 0, "copy layout");
  const T* p;       // source of copy 0 at the current step
  ptrdiff_t rstep;  // source distance between consecutive copies
  ptrdiff_t kstep;  // source advance a depth step
  int rows, cols;   // valid source rows and columns from copy 0's on
  int dst;          // offset of copy 0 in the tile

  // The tile at (r0, c0) of the row-major src (nr x nc, leading dimension ld).
  __device__ __forceinline__ void init(const T* src, int ld, int nr, int nc, int r0, int c0) {
    const int r = threadIdx.x / CPR, c = (threadIdx.x % CPR) * V;
    p = src + (ptrdiff_t)(r0 + r) * ld + (c0 + c);
    rstep = (ptrdiff_t)RSTEP * ld;
    kstep = DEPTH_COLS ? (ptrdiff_t)COLS : (ptrdiff_t)ROWS * ld;
    rows = nr - (r0 + r);
    cols = nc - (c0 + c);
    dst = r * LDS + c;
  }
  __device__ __forceinline__ void next() {
    p += kstep;
    if (DEPTH_COLS)
      cols -= COLS;
    else
      rows -= ROWS;
  }
  // Copy i of the current step; `shift` moves the source (a second operand
  // of the same shape and leading dimension).
  __device__ __forceinline__ void copy(T* tile, int i, ptrdiff_t shift = 0) const {
    const int cv = cols < 0 ? 0 : (cols > V ? V : cols);
    const int bytes = i * RSTEP < rows ? cv * (int)sizeof(T) : 0;
    cp_async<V * (int)sizeof(T)>(tile + dst + i * RSTEP * LDS, p + shift + i * rstep, bytes);
  }
};

// The A (BM x BK) and B (BK x BN) copiers of tile C: 16 bytes a copy where
// every row of the operand starts on 16 bytes (VA, VB), else one element
// (8 bytes in f64).
template <typename T, class C, bool VA, bool VB>
struct Copiers {
  static constexpr int WIDE = 16 / (int)sizeof(T);
  using A = Copier<T, C::BM, C::BK, C::LDA, C::NTHREADS, VA ? WIDE : 1, true>;
  using B = Copier<T, C::BK, C::BN, C::LDB, C::NTHREADS, VB ? WIDE : 1, false>;
};

// Call copy(c) for copies [d * NCOPY / ND, (d + 1) * NCOPY / ND): before
// the d-th of ND products, so NCOPY copies spread evenly over them.
template <int NCOPY, int ND, class Copy>
__device__ __forceinline__ void copies_before(int d, Copy&& copy) {
#pragma unroll
  for (int c = d * NCOPY / ND; c < (d + 1) * NCOPY / ND; ++c) copy(c);
}

// The main loop: ntiles depth steps through a ring of STAGES shared stages
// of STAGE elements, each multiplied in STEPS warp steps of ND_STEP
// products (DMMAs) a warp.
//
// * prod: issue_all(stage) / issue(stage, c) put the copies of its current
//   depth step (NCOPY a thread) into a stage, next() moves it a step on;
// * load(f, stage, s): fragment buffer f (0 or 1) <- warp step s of a stage;
// * mma(f, s, hook): the products of step s from buffer f, hook(d) called
//   before the d-th.
//
// Fragments are double-buffered: step s + 1 (or the next stage's step 0)
// is loaded while step s multiplies.  The next depth step's copies go out
// between the products of steps 0 .. STEPS-2, then one wait and one barrier
// a stage, placed before the last step, when every warp has read the
// stage that the following iteration refills -- or, when the products read
// shared memory themselves (LATE_READS, the f32 SIMT tile), after the last
// step.  Every thread of the block runs it.
template <int STAGES, int STAGE, int STEPS, int ND_STEP, int NCOPY, bool LATE_READS, typename T,
          class Producer, class Load, class Mma>
__device__ __forceinline__ void mainloop(T* sm, int ntiles, Producer& prod, Load&& load,
                                         Mma&& mma) {
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(STEPS >= 2 && STEPS % 2 == 0, "an even number of warp steps a stage");
  constexpr int ND = (STEPS - 1) * ND_STEP;  // products the copies spread over
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      prod.issue_all(sm + s * STAGE);
      prod.next();
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  load(0, sm, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const T* cur = sm + (kt % STAGES) * STAGE;
    const T* nxt = sm + ((kt + 1) % STAGES) * STAGE;
    T* fill = sm + ((kt + STAGES - 1) % STAGES) * STAGE;
    const bool live = kt + STAGES - 1 < ntiles;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (s + 1 < STEPS)
        load((s + 1) & 1, cur, s + 1);
      else
        load(0, nxt, 0);
      mma(s & 1, s, [&](int d) {
        if (s + 1 < STEPS && live)
          copies_before<NCOPY, ND>(s * ND_STEP + d, [&](int c) { prod.issue(fill, c); });
      });
      if (s + (LATE_READS ? 1 : 2) == STEPS) {
        cp_async_commit();
        if (live) prod.next();
        cp_async_wait<STAGES - 2>();  // depth step kt + 1 has landed ...
        __syncthreads();              // ... for everyone; stage kt is read out
      }
    }
  }
  cp_async_wait<0>();
}

// -- warp tiles --------------------------------------------------------------

// Accumulator fragment (m16n8, 4 per thread): element q of frag[i][j] sits
// at row 16 i + g + 8 (q / 2), column 8 j + 2 t + q % 2 of the warp tile,
// g = lane / 4, t = lane % 4.
template <typename T, class C>
using Frag = T[C::MI][C::NJ][4];

// One m16n8k8 DMMA: a[2 s + h] holds A[g + 8 h][t + 4 s], b[s] holds
// B[t + 4 s][g] (g = lane / 4, t = lane % 4, s < 2).
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A warp's operand fragments for one warp step (C::MMA_K of depth at kk of
// a stage) and its products acc += A[wm0:+WM, kk:+MMA_K] @ B[kk:+MMA_K,
// wn0:+WN], on the f64 tensor cores (conflict-free loads, see above);
// hook(d) is called before the d-th of the MI * NJ products.
template <typename T, class C>
struct Frags;

template <class C>
struct Frags<double, C> {
  static constexpr bool LATE_READS = false;  // the products read registers only
  double a[C::MI][4], b[C::NJ][2];

  __device__ __forceinline__ void load(const double* As, const double* Bs, int wm0, int wn0,
                                       int kk) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][2 * s + h] = As[(wm0 + 16 * i + g + 8 * h) * C::LDA + kk + t + 4 * s];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s) b[j][s] = Bs[(kk + t + 4 * s) * C::LDB + wn0 + 8 * j + g];
  }
  template <class Hook>
  __device__ __forceinline__ void mma(Frag<double, C>& acc, Hook&& hook) const {
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        hook(i * C::NJ + j);
        dmma(acc[i][j], a[i], b[j]);
      }
  }
};

// The f32 instantiation: the same fragment positions, SIMT FFMA straight
// from shared memory (its "fragments" are the stage's addresses).
template <class C>
struct Frags<float, C> {
  static constexpr bool LATE_READS = true;
  const float* As;
  const float* Bs;
  int wm0, wn0, kk;

  __device__ __forceinline__ void load(const float* as, const float* bs, int wm, int wn, int k) {
    As = as;
    Bs = bs;
    wm0 = wm;
    wn0 = wn;
    kk = k;
  }
  template <class Hook>
  __device__ __forceinline__ void mma(Frag<float, C>& acc, Hook&& hook) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        hook(i * C::NJ + j);
#pragma unroll
        for (int k = kk; k < kk + C::MMA_K; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][j][q] = __fmaf_rn(As[(wm0 + 16 * i + g + 8 * (q >> 1)) * C::LDA + k],
                                     Bs[k * C::LDB + wn0 + 8 * j + 2 * t + (q & 1)],
                                     acc[i][j][q]);
      }
  }
};

template <typename T, class C>
__device__ __forceinline__ void zero(Frag<T, C>& acc) {
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = T(0);
}

// Calls f(q-th element's row, column, i, j, q) for every accumulator element
// of this thread, in block-tile coordinates.
template <class C, class F>
__device__ __forceinline__ void for_each_elem(F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(wm0 + 16 * i + g + 8 * (q >> 1), wn0 + 8 * j + 2 * t + (q & 1), i, j, q);
}

// This warp's tile origin in the block tile.
template <class C>
__device__ __forceinline__ void warp_origin(int& wm0, int& wn0) {
  const int warp = threadIdx.x >> 5;
  wm0 = (warp / C::WARPS_N) * C::WM;
  wn0 = (warp % C::WARPS_N) * C::WN;
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB a launch
// needs it) and prefer the largest shared-memory carve-out, so that
// BLOCKS_PER_SM blocks fit an SM.  The attributes live in the current
// device's context, so they are set once per device: bit d of `done` (one
// word per kernel) says they are set on device d (devices past 63 set them
// on every launch).
template <class Kernel>
inline cudaError_t smem_attribute(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace rp
