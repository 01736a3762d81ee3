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
// Members.  An ensemble of K states of one model (the JAX package's
// jax.vmap of the step over pallas_call) runs each launch once for all K:
// blockIdx.z also runs the member, and every operand of a job carries a
// member stride (elements; 0 for the operands the members share, the
// stage's constants L_t, R_t, dinv, B0, B1, const and mask).  A member's
// blocks run the tile loop of a one-member launch on its own operands, so
// each member's output equals its solo launch bit for bit.  A launch of
// several members runs gemm_jobs_kernel_members, which also takes the
// strides; a one-member launch runs gemm_jobs_kernel on the jobs alone,
// whose parameter stays as small as before the member axis (a larger one
// measured 0.27 us a launch slower on the H100, graph replays included:
// scripts/launch_times.py).
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
// Member m of a launch of K members reads every operand X at X + m * sX
// (sA[t], sB[t], sC, sE, sF, sM; 0: shared by the members).  Bit 2t of vec
// says that every row of A[t] starts on 16 bytes in every member, bit
// 2t + 1 the same of B[t]; those operands are copied 16 bytes at a time.
extern "C" {
struct RpJob {
  void* C;
  const void* E;
  const void* F;
  const void* mask;
  const void* A[rp::MAX_TERMS];
  const void* B[rp::MAX_TERMS];
  long long sA[rp::MAX_TERMS];
  long long sB[rp::MAX_TERMS];
  long long sC, sE, sF, sM;
  int M, N, Mout, Nout, nt;
  int K[rp::MAX_TERMS];
  int lda[rp::MAX_TERMS];
  int ldb[rp::MAX_TERMS];
  int ldc, lde, ldf, ldm;
  int vec;
};
}

namespace rp {

// One output as the kernel reads it: RpJob without the member strides (the
// parameter of a one-member launch stays 1080 bytes; a launch's parameter
// bytes are paid on every launch, graph replays included).
struct Job {
  void* C;
  const void* E;
  const void* F;
  const void* mask;
  const void* A[MAX_TERMS];
  const void* B[MAX_TERMS];
  int M, N, Mout, Nout, nt;
  int K[MAX_TERMS];
  int lda[MAX_TERMS];
  int ldb[MAX_TERMS];
  int ldc, lde, ldf, ldm;
  int vec;
};

struct Jobs {
  Job job[MAX_JOBS];
};

// The member strides of a launch of several members, by job.
struct Strides {
  long long a[MAX_JOBS][MAX_TERMS];
  long long b[MAX_JOBS][MAX_TERMS];
  long long c[MAX_JOBS], e[MAX_JOBS], f[MAX_JOBS], mask[MAX_JOBS];
};

// Member m's operand: x itself in a one-member launch (MEMBERS false).
template <bool MEMBERS, typename T>
__device__ __forceinline__ T* member(T* x, long long m, long long stride) {
  if constexpr (MEMBERS) return x ? x + m * stride : x;
  return x;
}

// The copies of one output's depth steps, every term after another (the
// ring never drains at a term boundary); member m's operands.
template <typename T, class C, bool VA, bool VB, bool MEMBERS>
struct JobProducer {
  using CA = typename Copiers<T, C, VA, VB>::A;
  using CB = typename Copiers<T, C, VA, VB>::B;
  static constexpr int NCOPY = CA::N + CB::N;  // a thread's copies a stage
  const Job& jb;
  const long long* sa;  // member strides of A[t], B[t] (MEMBERS only)
  const long long* sb;
  int row0, col0;
  long long m;       // the member
  int t = 0, k = 0;  // term and depth of the current step
  CA a;
  CB b;

  __device__ __forceinline__ JobProducer(const Job& jb, const long long* sa, const long long* sb,
                                         int row0, int col0, long long m)
      : jb(jb), sa(sa), sb(sb), row0(row0), col0(col0), m(m) {
    start();
  }
  __device__ __forceinline__ void start() {
    const T* at = static_cast<const T*>(jb.A[t]);
    const T* bt = static_cast<const T*>(jb.B[t]);
    if constexpr (MEMBERS) {
      at += m * sa[t];
      bt += m * sb[t];
    }
    a.init(at, jb.lda[t], jb.M, jb.K[t], row0, 0);
    b.init(bt, jb.ldb[t], jb.K[t], jb.N, 0, col0);
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

// One block of job jb for member m (job z of the launch; st: the launch's
// member strides, MEMBERS only).  VA / VB: every A[t] / B[t] of the launch
// has 16-byte rows (vec bits).
template <typename T, class C, bool VA, bool VB, bool MEMBERS>
__device__ __forceinline__ void gemm_block(const Job& jb, const Strides* st, int z, long long m) {
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
    using P = JobProducer<T, C, VA, VB, MEMBERS>;
    P prod(jb, MEMBERS ? st->a[z] : nullptr, MEMBERS ? st->b[z] : nullptr, row0, col0, m);
    Frags<T, C> f[2];
    mainloop<C::RING1, C::A_ELEMS + C::B_ELEMS, C::BK / C::MMA_K, C::MI * C::NJ, P::NCOPY,
             Frags<T, C>::LATE_READS>(
        sm, ntiles, prod,
        [&](int b, const T* stage, int s) {
          f[b].load(stage, stage + C::A_ELEMS, wm0, wn0, s * C::MMA_K);
        },
        [&](int b, int, auto&& hook) { f[b].mma(acc, hook); });
  }
  T* out = member<MEMBERS>(static_cast<T*>(jb.C), m, MEMBERS ? st->c[z] : 0);
  const T* E = member<MEMBERS>(static_cast<const T*>(jb.E), m, MEMBERS ? st->e[z] : 0);
  const T* F = member<MEMBERS>(static_cast<const T*>(jb.F), m, MEMBERS ? st->f[z] : 0);
  const T* mask = member<MEMBERS>(static_cast<const T*>(jb.mask), m, MEMBERS ? st->mask[z] : 0);
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

// One member: blockIdx.z = job.
template <typename T, class C, bool VA, bool VB>
__global__ void __launch_bounds__(C::NTHREADS) gemm_jobs_kernel(const __grid_constant__ Jobs jobs) {
  gemm_block<T, C, VA, VB, false>(jobs.job[blockIdx.z], nullptr, blockIdx.z, 0);
}

// Several members: blockIdx.z = member * njobs + job.
template <typename T, class C, bool VA, bool VB>
__global__ void __launch_bounds__(C::NTHREADS)
    gemm_jobs_kernel_members(const __grid_constant__ Jobs jobs,
                             const __grid_constant__ Strides st, int njobs) {
  const int z = blockIdx.z % njobs;
  gemm_block<T, C, VA, VB, true>(jobs.job[z], &st, z, blockIdx.z / njobs);
}

template <typename T, bool VA, bool VB>
static int launch_kernel(const Jobs& p, const Strides& st, int njobs, int members, dim3 grid,
                         cudaStream_t stream) {
  using C = GemmTile;
  constexpr int smem = C::RING1 * (C::A_ELEMS + C::B_ELEMS) * (int)sizeof(T);
  static std::atomic<unsigned long long> done{0}, done_members{0};
  cudaError_t attr;
  if (members == 1) {
    attr = smem_attribute(gemm_jobs_kernel<T, C, VA, VB>, smem, done);
    if (attr != cudaSuccess) return (int)attr;
    gemm_jobs_kernel<T, C, VA, VB><<<grid, C::NTHREADS, smem, stream>>>(p);
  } else {
    attr = smem_attribute(gemm_jobs_kernel_members<T, C, VA, VB>, smem, done_members);
    if (attr != cudaSuccess) return (int)attr;
    gemm_jobs_kernel_members<T, C, VA, VB><<<grid, C::NTHREADS, smem, stream>>>(p, st, njobs);
  }
  return (int)cudaGetLastError();
}

// Launch 1..MAX_JOBS independent outputs for each of `members` members as
// blockIdx.z of one grid.  An operand is copied 16 bytes at a time when
// every A (or every B) of the launch allows it.
template <typename T>
int launch_jobs(const RpJob* jobs, int njobs, int members, cudaStream_t stream) {
  if (njobs < 1 || njobs > MAX_JOBS || members < 1 || (long long)njobs * members > 65535)
    return (int)cudaErrorInvalidValue;
  Jobs p;
  Strides st = {};
  int mo = 0, no = 0;
  bool va = true, vb = true;
  for (int z = 0; z < njobs; ++z) {
    const RpJob& jb = jobs[z];
    if (jb.nt < 1 || jb.nt > MAX_TERMS || jb.M > jb.Mout || jb.N > jb.Nout)
      return (int)cudaErrorInvalidValue;
    Job& o = p.job[z];
    o.C = jb.C, o.E = jb.E, o.F = jb.F, o.mask = jb.mask;
    o.M = jb.M, o.N = jb.N, o.Mout = jb.Mout, o.Nout = jb.Nout, o.nt = jb.nt;
    o.ldc = jb.ldc, o.lde = jb.lde, o.ldf = jb.ldf, o.ldm = jb.ldm, o.vec = jb.vec;
    for (int t = 0; t < MAX_TERMS; ++t) {
      o.A[t] = jb.A[t], o.B[t] = jb.B[t];
      o.K[t] = jb.K[t], o.lda[t] = jb.lda[t], o.ldb[t] = jb.ldb[t];
      st.a[z][t] = jb.sA[t], st.b[z][t] = jb.sB[t];
    }
    st.c[z] = jb.sC, st.e[z] = jb.sE, st.f[z] = jb.sF, st.mask[z] = jb.sM;
    for (int t = 0; t < jb.nt; ++t) {
      if (jb.K[t] < 1) return (int)cudaErrorInvalidValue;
      va = va && ((jb.vec >> (2 * t)) & 1);
      vb = vb && ((jb.vec >> (2 * t + 1)) & 1);
    }
    mo = mo > jb.Mout ? mo : jb.Mout;
    no = no > jb.Nout ? no : jb.Nout;
  }
  const dim3 grid((no + GemmTile::BN - 1) / GemmTile::BN, (mo + GemmTile::BM - 1) / GemmTile::BM,
                  njobs * members);
  if (va)
    return vb ? launch_kernel<T, true, true>(p, st, njobs, members, grid, stream)
              : launch_kernel<T, true, false>(p, st, njobs, members, grid, stream);
  return vb ? launch_kernel<T, false, true>(p, st, njobs, members, grid, stream)
            : launch_kernel<T, false, false>(p, st, njobs, members, grid, stream);
}

}  // namespace rp

extern "C" int rp_gemm_f64(const RpJob* jobs, int njobs, int members, void* stream) {
  return rp::launch_jobs<double>(jobs, njobs, members, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_gemm_f32(const RpJob* jobs, int njobs, int members, void* stream) {
  return rp::launch_jobs<float>(jobs, njobs, members, static_cast<cudaStream_t>(stream));
}
