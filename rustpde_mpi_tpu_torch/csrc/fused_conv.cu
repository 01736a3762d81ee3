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
//   2. conv_dual_kernel: two accumulator sets per output tile, A1 @ Gy0^T
//      and A0 @ Gy1^T, and only `total` is written -- dvdx/dvdy never reach
//      device memory, which is what the TPU kernel's fusion is for;
//   3. T = total @ Fy^T (kept columns only),
//   4. out = Fx @ T (kept rows only), zero-filling the dead rows and
//      columns of the spectral array in the same epilogue.
//
// Bound on the H100: operations.  At 1025^2 f64 one chain does 11.0 GFLOP
// on 78-95 MB of operands: 0.16 ms at the 67 TFLOP/s of the FP64 tensor
// cores against 0.03 ms at the memory rate.  conv_dual_kernel runs
// tile_gemm.cuh's core (DMMA m16n8k8 warp tiles fed by a cp.async ring,
// copies between the DMMAs, double-buffered fragments; the tile, warp and
// pipeline design, why it fits 1023^2 on 132 SMs, and the 8-byte copy rule
// for odd leading dimensions are described there) with two accumulator
// sets over one depth loop: a ring stage holds the A1, A0, Gy0^T and Gy1^T
// tiles of one depth step (16 deep), so both products share the stage's
// waits and barrier, its warp steps alternate between the two products,
// and the ux * (...) + uy * (...) epilogue stays in registers.  Two sets
// of 32 x 32 warp accumulators are 64 doubles a thread; the ring is 3
// stages deep (111 KB with 64 x 64 blocks, two blocks an SM).  Its output
// is 1025 x 1025: 289 blocks of 64 x 64 on 264 slots (two waves).
//
// Members.  An ensemble of K states of one model runs each of the four
// launches once for all K (the JAX package's jax.vmap over pallas_call):
// launches 1, 3 and 4 through the generic GEMM's member strides, launch 2
// with the member on blockIdx.z, the per-member operands (A1, A0, ux, uy,
// the output) at a member stride and the shared ones (Gy0^T, Gy1^T and the
// BC gradients) read by every member.  A member's blocks run a one-member
// launch's tile loop, so its output equals its solo launch bit for bit.
// At 129^2 with K = 32 the dual output is 9 blocks a member, 288 on 264
// slots (two waves).
#include <type_traits>

#include "tile_gemm.cuh"

namespace rp {

// The copies of the dual kernel's depth steps: A1, Gy0^T, then A0, Gy1^T,
// into a stage laid out [A1 | A0 | Gy0^T | Gy1^T].  A0 and Gy1^T share the
// shape and leading dimension of A1 and Gy0^T, so one copier each serves
// both, shifted by the distance between the two operands.
template <typename T, class C, bool VA, bool VG>
struct DualProducer {
  using CA = typename Copiers<T, C, VA, VG>::A;
  using CG = typename Copiers<T, C, VA, VG>::B;
  static constexpr int HALF = CA::N + CG::N;  // a thread's copies of one product
  CA a;           // A1
  CG g;           // Gy0^T
  ptrdiff_t da;   // A0 - A1
  ptrdiff_t dg;   // Gy1^T - Gy0^T

  __device__ __forceinline__ void next() {
    a.next();
    g.next();
  }
  __device__ __forceinline__ void issue(T* stage, int c) const {
    if (c < CA::N)
      a.copy(stage, c);
    else if (c < HALF)
      g.copy(stage + 2 * C::A_ELEMS, c - CA::N);
    else if (c < HALF + CA::N)
      a.copy(stage + C::A_ELEMS, c - HALF, da);
    else
      g.copy(stage + 2 * C::A_ELEMS + C::B_ELEMS, c - HALF - CA::N, dg);
  }
  __device__ __forceinline__ void issue_all(T* stage) const {
#pragma unroll
    for (int c = 0; c < 2 * HALF; ++c) issue(stage, c);
  }
};

// out[0:n0, 0:n1] = ux * (a1 @ g0t + bcdx) + uy * (a0 @ g1t + bcdy); a1, a0
// are n0 x k (leading dimension lda), g0t, g1t k x n1 (ldg), the
// elementwise operands n0 x n1 (ldu).  VA: every row of a1 and a0 starts on
// 16 bytes; VG: the same of g0t and g1t.  Member blockIdx.z reads a1, a0 at
// member stride sa, ux, uy at su and writes out at so.
template <typename T, class C, bool VA, bool VG>
__global__ void __launch_bounds__(C::NTHREADS)
    conv_dual_kernel(int n0, int n1, int k, const T* __restrict__ a1,
                     const T* __restrict__ a0, int lda,
                     const T* __restrict__ g0t, const T* __restrict__ g1t,
                     int ldg, const T* __restrict__ ux,
                     const T* __restrict__ uy, const T* __restrict__ bcdx,
                     const T* __restrict__ bcdy, int ldu, T* __restrict__ out,
                     int ldo, long long sa, long long su, long long so) {
  const int row0 = blockIdx.y * C::BM;
  const int col0 = blockIdx.x * C::BN;
  const long long m = blockIdx.z;
  a1 += m * sa;
  a0 += m * sa;
  ux += m * su;
  uy += m * su;
  out += m * so;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Frag<T, C> px, py;
  zero<T, C>(px);
  zero<T, C>(py);
  int wm0, wn0;
  warp_origin<C>(wm0, wn0);
  using P = DualProducer<T, C, VA, VG>;
  P prod;
  prod.a.init(a1, lda, n0, k, row0, 0);
  prod.g.init(g0t, ldg, k, n1, 0, col0);
  prod.da = a0 - a1;
  prod.dg = g1t - g0t;
  // warp step s: product s % 2 (px: A1 @ Gy0^T, py: A0 @ Gy1^T) over depth
  // group s / 2 of the stage
  Frags<T, C> f[2];
  mainloop<C::RING2, 2 * (C::A_ELEMS + C::B_ELEMS), 2 * C::BK / C::MMA_K, C::MI * C::NJ,
           2 * P::HALF, Frags<T, C>::LATE_READS>(
      sm, (k + C::BK - 1) / C::BK, prod,
      [&](int b, const T* st, int s) {
        const int y = s % 2;
        f[b].load(st + y * C::A_ELEMS, st + 2 * C::A_ELEMS + y * C::B_ELEMS, wm0, wn0,
                  s / 2 * C::MMA_K);
      },
      [&](int b, int s, auto&& hook) { f[b].mma(s % 2 ? py : px, hook); });
  for_each_elem<C>([&](int lr, int lc, int i, int j, int q) {
    const int r = row0 + lr, c = col0 + lc;
    if (r >= n0 || c >= n1) return;
    const size_t u = (size_t)r * ldu + c;
    T dx = px[i][j][q], dy = py[i][j][q];
    if (bcdx) {
      dx += bcdx[u];
      dy += bcdy[u];
    }
    out[(size_t)r * ldo + c] = ux[u] * dx + uy[u] * dy;
  });
}

template <typename T, bool VA, bool VG>
static int launch_kernel(int n0, int n1, int k, const T* a1, const T* a0, int lda, const T* g0t,
                         const T* g1t, int ldg, const T* ux, const T* uy, const T* bcdx,
                         const T* bcdy, int ldu, T* out, int ldo, int members, long long sa,
                         long long su, long long so, cudaStream_t stream) {
  using C = DualTile;
  constexpr int smem = C::RING2 * 2 * (C::A_ELEMS + C::B_ELEMS) * (int)sizeof(T);
  static std::atomic<unsigned long long> done{0};
  const cudaError_t attr = smem_attribute(conv_dual_kernel<T, C, VA, VG>, smem, done);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((n1 + C::BN - 1) / C::BN, (n0 + C::BM - 1) / C::BM, members);
  conv_dual_kernel<T, C, VA, VG><<<grid, C::NTHREADS, smem, stream>>>(
      n0, n1, k, a1, a0, lda, g0t, g1t, ldg, ux, uy, bcdx, bcdy, ldu, out, ldo, sa, su, so);
  return (int)cudaGetLastError();
}

// The dual launch for `members` members; vec bit 0: every row of a1 and a0
// starts on 16 bytes (in every member), bit 1: the same of g0t and g1t.
template <typename T>
int launch_dual(int n0, int n1, int k, const void* a1, const void* a0, int lda,
                const void* g0t, const void* g1t, int ldg, const void* ux,
                const void* uy, const void* bcdx, const void* bcdy, int ldu,
                void* out, int ldo, int vec, int members, long long sa, long long su,
                long long so, cudaStream_t stream) {
  if (n0 < 1 || n1 < 1 || k < 1 || (bcdx == nullptr) != (bcdy == nullptr) || members < 1 ||
      members > 65535 || (members > 1 && (sa < 1 || su < 1 || so < 1)))
    return (int)cudaErrorInvalidValue;
  const bool va = vec & 1, vg = (vec >> 1) & 1;
  auto run = [&](auto kernel_va, auto kernel_vg) {
    return launch_kernel<T, decltype(kernel_va)::value, decltype(kernel_vg)::value>(
        n0, n1, k, static_cast<const T*>(a1), static_cast<const T*>(a0), lda,
        static_cast<const T*>(g0t), static_cast<const T*>(g1t), ldg,
        static_cast<const T*>(ux), static_cast<const T*>(uy),
        static_cast<const T*>(bcdx), static_cast<const T*>(bcdy), ldu,
        static_cast<T*>(out), ldo, members, sa, su, so, stream);
  };
  using Y = std::true_type;
  using N = std::false_type;
  if (va) return vg ? run(Y{}, Y{}) : run(Y{}, N{});
  return vg ? run(N{}, Y{}) : run(N{}, N{});
}

}  // namespace rp

extern "C" int rp_conv_dual_f64(int n0, int n1, int k, const void* a1,
                                const void* a0, int lda, const void* g0t,
                                const void* g1t, int ldg, const void* ux,
                                const void* uy, const void* bcdx,
                                const void* bcdy, int ldu, void* out, int ldo,
                                int vec, int members, long long sa, long long su,
                                long long so, void* stream) {
  return rp::launch_dual<double>(n0, n1, k, a1, a0, lda, g0t, g1t, ldg, ux, uy,
                                 bcdx, bcdy, ldu, out, ldo, vec, members, sa, su, so,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int rp_conv_dual_f32(int n0, int n1, int k, const void* a1,
                                const void* a0, int lda, const void* g0t,
                                const void* g1t, int ldg, const void* ux,
                                const void* uy, const void* bcdx,
                                const void* bcdy, int ldu, void* out, int ldo,
                                int vec, int members, long long sa, long long su,
                                long long so, void* stream) {
  return rp::launch_dual<float>(n0, n1, k, a1, a0, lda, g0t, g1t, ldg, ux, uy,
                                bcdx, bcdy, ldu, out, ldo, vec, members, sa, su, so,
                                static_cast<cudaStream_t>(stream));
}
