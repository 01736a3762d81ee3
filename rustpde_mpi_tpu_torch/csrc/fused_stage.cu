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
// Bound on the H100: operations.  At 1025^2 f64 a stage does 4.3-17.2 GFLOP
// on 33-117 MB of operands (0.06-0.26 ms at the FP64 peak against
// 0.01-0.04 ms at the memory rate).  f64 has no wgmma, so the tile loop
// issues DFMA from shared memory (64 x 64 tiles, 4 x 4 per thread).  The
// term sum and the elementwise epilogue never leave the block, which
// removes the separate add/scale passes of the plain chain.  Tensor-core
// f64 (mma.sync m8n8k4), TMA and a deeper pipeline are later work.
#include "tile_gemm.cuh"

namespace rp {
constexpr int MAX_TERMS = 4;  // products summed by one output
constexpr int MAX_JOBS = 4;   // outputs of one launch (blockIdx.z)
}  // namespace rp

// One output of one launch of the generic kernel (mirrored field for field
// by a ctypes.Structure in ops/_build.py):
//
//   C[0:M, 0:N]       = ((sum_t A[t] @ B[t]) * E + F) * mask
//   C[rest of Mout x Nout] = 0
//
// E, F and mask are optional (null); A[t] is M x K[t], B[t] is K[t] x N.
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
};
}

namespace rp {

struct Jobs {
  RpJob job[MAX_JOBS];
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) gemm_jobs_kernel(Jobs jobs) {
  const RpJob& jb = jobs.job[blockIdx.z];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  if (row0 >= jb.Mout || col0 >= jb.Nout) return;  // uniform per block
  __shared__ Tiles<T> sm;
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  if (row0 < jb.M && col0 < jb.N) {  // uniform per block
    for (int t = 0; t < jb.nt; ++t)
      tile_mma<T>(sm, acc, static_cast<const T*>(jb.A[t]), jb.lda[t],
                  static_cast<const T*>(jb.B[t]), jb.ldb[t], jb.M, jb.N,
                  jb.K[t], row0, col0);
  }
  T* C = static_cast<T*>(jb.C);
  const T* E = static_cast<const T*>(jb.E);
  const T* F = static_cast<const T*>(jb.F);
  const T* mask = static_cast<const T*>(jb.mask);
  const int tx = threadIdx.x % TDIM;
  const int ty = threadIdx.x / TDIM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TDIM * i;
    if (r >= jb.Mout) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + TDIM * j;
      if (c >= jb.Nout) continue;
      T v = T(0);
      if (r < jb.M && c < jb.N) {
        v = acc[i][j];
        if (E) v *= E[(size_t)r * jb.lde + c];
        if (F) v += F[(size_t)r * jb.ldf + c];
        if (mask) v *= mask[(size_t)r * jb.ldm + c];
      }
      C[(size_t)r * jb.ldc + c] = v;
    }
  }
}

// Launch 1..MAX_JOBS independent outputs as blockIdx.z of one grid.
template <typename T>
int launch_jobs(const RpJob* jobs, int njobs, cudaStream_t stream) {
  if (njobs < 1 || njobs > MAX_JOBS) return (int)cudaErrorInvalidValue;
  Jobs p;
  int mo = 0, no = 0;
  for (int z = 0; z < njobs; ++z) {
    const RpJob& jb = jobs[z];
    if (jb.nt < 1 || jb.nt > MAX_TERMS || jb.M > jb.Mout || jb.N > jb.Nout)
      return (int)cudaErrorInvalidValue;
    p.job[z] = jb;
    mo = mo > jb.Mout ? mo : jb.Mout;
    no = no > jb.Nout ? no : jb.Nout;
  }
  dim3 grid((no + BN - 1) / BN, (mo + BM - 1) / BM, njobs);
  gemm_jobs_kernel<T><<<grid, NTHREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rp

extern "C" int rp_gemm_f64(const RpJob* jobs, int njobs, void* stream) {
  return rp::launch_jobs<double>(jobs, njobs, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_gemm_f32(const RpJob* jobs, int njobs, void* stream) {
  return rp::launch_jobs<float>(jobs, njobs, static_cast<cudaStream_t>(stream));
}
