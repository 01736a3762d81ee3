// Fused convection chain of the Navier step on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rustpde_mpi_tpu/ops/pallas_conv.py
// `_conv_kernel` (FusedConv._pallas_call).  For one convected field vhat:
//
//   dvdx  = Gx1 @ vhat @ Gy0^T          dvdy = Gx0 @ vhat @ Gy1^T
//   total = ux * (dvdx + bcdx) + uy * (dvdy + bcdy)     (bc terms optional)
//   out   = Fx @ total @ Fy^T, only the 2/3-rule kept block, zero elsewhere
//
// The TPU kernel accumulates the y-syntheses over a sequential grid axis in
// VMEM.  Here the wrapper (ops/fused_conv.py) runs four launches, of which
// 1, 3 and 4 go to the generic GEMM of fused_stage.cu (rp_gemm_f64/f32):
//
//   1. A1 = Gx1 @ vhat, A0 = Gx0 @ vhat   (one grid, blockIdx.z, shared B)
//   2. conv_dual_kernel: two accumulators per output tile, A1 @ Gy0^T and
//      A0 @ Gy1^T, and only `total` is written — dvdx/dvdy never reach
//      device memory, which is what the TPU kernel's fusion is for;
//   3. T = total @ Fy^T (kept columns only),
//   4. out = Fx @ T (kept rows only), zero-filling the dead rows and
//      columns of the spectral array in the same epilogue.
//
// Bound on the H100: operations.  At 1025^2 f64 one chain does 11.0 GFLOP
// on 78-95 MB of operands: 0.16 ms at the FP64 peak against 0.03 ms at the
// memory rate.  f64 has no wgmma, so the tiles are DFMA loops from shared
// memory (tile_gemm.cuh); tensor-core f64 (mma.sync m8n8k4), TMA and fusing
// launches 3-4 are later work.
#include "tile_gemm.cuh"

namespace rp {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    conv_dual_kernel(int n0, int n1, int k, const T* __restrict__ a1,
                     const T* __restrict__ a0, int lda,
                     const T* __restrict__ g0t, const T* __restrict__ g1t,
                     int ldg, const T* __restrict__ ux,
                     const T* __restrict__ uy, const T* __restrict__ bcdx,
                     const T* __restrict__ bcdy, int ldu, T* __restrict__ out,
                     int ldo) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  __shared__ Tiles<T> sm;
  T px[TM][TN], py[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) px[i][j] = py[i][j] = T(0);
  tile_mma<T>(sm, px, a1, lda, g0t, ldg, n0, n1, k, row0, col0);
  tile_mma<T>(sm, py, a0, lda, g1t, ldg, n0, n1, k, row0, col0);
  const int tx = threadIdx.x % TDIM;
  const int ty = threadIdx.x / TDIM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TDIM * i;
    if (r >= n0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + TDIM * j;
      if (c >= n1) continue;
      const size_t u = (size_t)r * ldu + c;
      T dx = px[i][j], dy = py[i][j];
      if (bcdx) {
        dx += bcdx[u];
        dy += bcdy[u];
      }
      out[(size_t)r * ldo + c] = ux[u] * dx + uy[u] * dy;
    }
  }
}

template <typename T>
int launch_dual(int n0, int n1, int k, const void* a1, const void* a0, int lda,
                const void* g0t, const void* g1t, int ldg, const void* ux,
                const void* uy, const void* bcdx, const void* bcdy, int ldu,
                void* out, int ldo, cudaStream_t stream) {
  if (n0 < 1 || n1 < 1 || k < 1 || (bcdx == nullptr) != (bcdy == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n1 + BN - 1) / BN, (n0 + BM - 1) / BM, 1);
  conv_dual_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      n0, n1, k, static_cast<const T*>(a1), static_cast<const T*>(a0), lda,
      static_cast<const T*>(g0t), static_cast<const T*>(g1t), ldg,
      static_cast<const T*>(ux), static_cast<const T*>(uy),
      static_cast<const T*>(bcdx), static_cast<const T*>(bcdy), ldu,
      static_cast<T*>(out), ldo);
  return (int)cudaGetLastError();
}

}  // namespace rp

extern "C" int rp_conv_dual_f64(int n0, int n1, int k, const void* a1,
                                const void* a0, int lda, const void* g0t,
                                const void* g1t, int ldg, const void* ux,
                                const void* uy, const void* bcdx,
                                const void* bcdy, int ldu, void* out, int ldo,
                                void* stream) {
  return rp::launch_dual<double>(n0, n1, k, a1, a0, lda, g0t, g1t, ldg, ux, uy,
                                 bcdx, bcdy, ldu, out, ldo,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int rp_conv_dual_f32(int n0, int n1, int k, const void* a1,
                                const void* a0, int lda, const void* g0t,
                                const void* g1t, int ldg, const void* ux,
                                const void* uy, const void* bcdx,
                                const void* bcdy, int ldu, void* out, int ldo,
                                void* stream) {
  return rp::launch_dual<float>(n0, n1, k, a1, a0, lda, g0t, g1t, ldg, ux, uy,
                                bcdx, bcdy, ldu, out, ldo,
                                static_cast<cudaStream_t>(stream));
}
