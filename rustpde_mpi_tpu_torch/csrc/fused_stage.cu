// Fused implicit stage of the Navier step on Hopper (sm_90a), and the
// generic multi-term GEMM it is made of.
//
// Replaces the Pallas TPU kernel rustpde_mpi_tpu/ops/pallas_step.py
// `_stage_kernel` (FusedStage._pallas_call).  One stage computes
//
//   o = mask * B0 @ ((sum_t L_t @ x_t @ R_t^T) * dinv @ B1^T + const)
//
// with each bracketed piece optional.  The TPU kernel carries the L_t @ x_t
// sums across a sequential grid axis in VMEM; Hopper blocks run in no
// order, so the wrapper (ops/fused_step.py) runs the stage as 2-4 launches
// of the one generic kernel below:
//
//   1. Y_t = L_t @ x_t for all terms (blockIdx.z = term),
//   2. M = sum_t Y_t @ R_t^T with * dinv, + const, * mask in the epilogue,
//   3. M @ B1^T, and 4. B0 @ M * mask for the Poisson stage.
//
// The convection wrapper (ops/fused_conv.py) runs its plain GEMM launches
// through the same entry points, rp_gemm_f64/f32, from this library.
//
// Bound on the H100: operations.  At 1025^2 f64 a stage does 4.3-21.4 GFLOP
// on 33-117 MB of operands: 0.06-0.26 ms at the 67 TFLOP/s of the FP64
// tensor cores against 0.01-0.04 ms at the memory rate.  The tile is
// tile_gemm.cuh's: DMMA m16n8k8 warp tiles of 32 x 32 in 64 x 64 blocks,
// two an SM, fed by a 3-stage cp.async ring (32 deep a stage) with the
// copies issued between the DMMAs and the fragments double-buffered (the
// tile, warp and pipeline design, why it fits 1023^2 on 132 SMs, and the
// 8-byte copy rule for odd leading dimensions are described there).  The
// terms of an output run through one ring and one set of accumulators, so
// the term sum never leaves the registers, and the elementwise epilogue
// (* E + F, * mask, the zero fill to Mout x Nout) is applied to the
// accumulators before the single store.  Each launch instantiates the
// kernel for its copy widths (16-byte A and/or B).
#include "tile_gemm.cuh"

namespace rp {
// products summed by one output: the vely stage of a rotating model sums
// five (state, pressure gradient, buoyancy, convection, Coriolis)
constexpr int MAX_TERMS = 5;
constexpr int MAX_JOBS = 5;  // outputs of one launch (blockIdx.z): one a term
}  // namespace rp

// One output of one launch of the generic kernel (mirrored field for field
// by a ctypes.Structure in ops/_build.py):
//
//   C[0:M, 0:N]       = ((sum_t A[t] @ B[t]) * E + F) * mask
//   C[rest of Mout x Nout] = 0
//
// E, F and mask are optional (null); A[t] is M x K[t], B[t] is K[t] x N.
// Bit 2t of vec says that every row of A[t] starts on 16 bytes, bit 2t + 1
// the same of B[t]; those operands are copied 16 bytes at a time.
extern "C" {
struct RpJob {
  void* C;
  const void* E;
  const void* F;
  const void* mask;
  const void* A[rp::MAX_TERMS];
  const void* B[rp::MAX_TERMS];
  int M, N, Mout, Nout, nt;
  int K[rp::MAX_TERMS];
  int lda[rp::MAX_TERMS];
  int ldb[rp::MAX_TERMS];
  int ldc, lde, ldf, ldm;
  int vec;
};
}

namespace rp {

struct Jobs {
  RpJob job[MAX_JOBS];
};

// The copies of one output's depth steps, every term after another (the
// ring never drains at a term boundary).
template <typename T, class C, bool VA, bool VB>
struct JobProducer {
  using CA = typename Copiers<T, C, VA, VB>::A;
  using CB = typename Copiers<T, C, VA, VB>::B;
  static constexpr int NCOPY = CA::N + CB::N;  // a thread's copies a stage
  const RpJob& jb;
  int row0, col0;
  int t = 0, k = 0;  // term and depth of the current step
  CA a;
  CB b;

  __device__ __forceinline__ JobProducer(const RpJob& jb, int row0, int col0)
      : jb(jb), row0(row0), col0(col0) {
    start();
  }
  __device__ __forceinline__ void start() {
    a.init(static_cast<const T*>(jb.A[t]), jb.lda[t], jb.M, jb.K[t], row0, 0);
    b.init(static_cast<const T*>(jb.B[t]), jb.ldb[t], jb.K[t], jb.N, 0, col0);
  }
  __device__ __forceinline__ void next() {
    k += C::BK;
    if (k < jb.K[t]) {
      a.next();
      b.next();
    } else if (++t < jb.nt) {
      k = 0;
      start();
    }
  }
  __device__ __forceinline__ void issue(T* stage, int c) const {
    if (c < CA::N)
      a.copy(stage, c);
    else
      b.copy(stage + C::A_ELEMS, c - CA::N);
  }
  __device__ __forceinline__ void issue_all(T* stage) const {
#pragma unroll
    for (int c = 0; c < NCOPY; ++c) issue(stage, c);
  }
};

// VA / VB: every A[t] / B[t] of the launch has 16-byte rows (vec bits).
template <typename T, class C, bool VA, bool VB>
__global__ void __launch_bounds__(C::NTHREADS) gemm_jobs_kernel(const __grid_constant__ Jobs jobs) {
  const RpJob& jb = jobs.job[blockIdx.z];
  const int row0 = blockIdx.y * C::BM;
  const int col0 = blockIdx.x * C::BN;
  if (row0 >= jb.Mout || col0 >= jb.Nout) return;  // uniform per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Frag<T, C> acc;
  zero<T, C>(acc);
  if (row0 < jb.M && col0 < jb.N) {  // uniform per block
    int ntiles = 0;
    for (int t = 0; t < jb.nt; ++t) ntiles += (jb.K[t] + C::BK - 1) / C::BK;
    int wm0, wn0;
    warp_origin<C>(wm0, wn0);
    using P = JobProducer<T, C, VA, VB>;
    P prod(jb, row0, col0);
    Frags<T, C> f[2];
    mainloop<C::RING1, C::A_ELEMS + C::B_ELEMS, C::BK / C::MMA_K, C::MI * C::NJ, P::NCOPY,
             Frags<T, C>::LATE_READS>(
        sm, ntiles, prod,
        [&](int b, const T* st, int s) {
          f[b].load(st, st + C::A_ELEMS, wm0, wn0, s * C::MMA_K);
        },
        [&](int b, int, auto&& hook) { f[b].mma(acc, hook); });
  }
  T* out = static_cast<T*>(jb.C);
  const T* E = static_cast<const T*>(jb.E);
  const T* F = static_cast<const T*>(jb.F);
  const T* mask = static_cast<const T*>(jb.mask);
  for_each_elem<C>([&](int lr, int lc, int i, int j, int q) {
    const int r = row0 + lr, c = col0 + lc;
    if (r >= jb.Mout || c >= jb.Nout) return;
    T v = T(0);
    if (r < jb.M && c < jb.N) {
      v = acc[i][j][q];
      if (E) v *= E[(size_t)r * jb.lde + c];
      if (F) v += F[(size_t)r * jb.ldf + c];
      if (mask) v *= mask[(size_t)r * jb.ldm + c];
    }
    out[(size_t)r * jb.ldc + c] = v;
  });
}

template <typename T, bool VA, bool VB>
static int launch_kernel(const Jobs& p, dim3 grid, cudaStream_t stream) {
  using C = GemmTile;
  constexpr int smem = C::RING1 * (C::A_ELEMS + C::B_ELEMS) * (int)sizeof(T);
  static std::atomic<unsigned long long> done{0};
  const cudaError_t attr = smem_attribute(gemm_jobs_kernel<T, C, VA, VB>, smem, done);
  if (attr != cudaSuccess) return (int)attr;
  gemm_jobs_kernel<T, C, VA, VB><<<grid, C::NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch 1..MAX_JOBS independent outputs as blockIdx.z of one grid.  An
// operand is copied 16 bytes at a time when every A (or every B) of the
// launch allows it.
template <typename T>
int launch_jobs(const RpJob* jobs, int njobs, cudaStream_t stream) {
  if (njobs < 1 || njobs > MAX_JOBS) return (int)cudaErrorInvalidValue;
  Jobs p;
  int mo = 0, no = 0;
  bool va = true, vb = true;
  for (int z = 0; z < njobs; ++z) {
    const RpJob& jb = jobs[z];
    if (jb.nt < 1 || jb.nt > MAX_TERMS || jb.M > jb.Mout || jb.N > jb.Nout)
      return (int)cudaErrorInvalidValue;
    for (int t = 0; t < jb.nt; ++t) {
      if (jb.K[t] < 1) return (int)cudaErrorInvalidValue;
      va = va && ((jb.vec >> (2 * t)) & 1);
      vb = vb && ((jb.vec >> (2 * t + 1)) & 1);
    }
    p.job[z] = jb;
    mo = mo > jb.Mout ? mo : jb.Mout;
    no = no > jb.Nout ? no : jb.Nout;
  }
  const dim3 grid((no + GemmTile::BN - 1) / GemmTile::BN, (mo + GemmTile::BM - 1) / GemmTile::BM,
                  njobs);
  if (va)
    return vb ? launch_kernel<T, true, true>(p, grid, stream)
              : launch_kernel<T, true, false>(p, grid, stream);
  return vb ? launch_kernel<T, false, true>(p, grid, stream)
            : launch_kernel<T, false, false>(p, grid, stream);
}

}  // namespace rp

extern "C" int rp_gemm_f64(const RpJob* jobs, int njobs, void* stream) {
  return rp::launch_jobs<double>(jobs, njobs, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_gemm_f32(const RpJob* jobs, int njobs, void* stream) {
  return rp::launch_jobs<float>(jobs, njobs, static_cast<cudaStream_t>(stream));
}
