// Pencil transpose of a rank-stacked field on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rustpde_mpi_tpu/parallel/decomp.py
// `_ring_transpose_kernel` (entry `_ring_transpose_pallas`): the x <-> y
// pencil flip of a field split over P ranks, which the TPU runs as the
// local diagonal copy plus P-1 remote-copy shift steps between chips.  Here
// the P ranks of a mesh live on one card as the leading dimension of one
// stacked tensor (rustpde_mpi_tpu_torch/parallel/mesh.py):
//
//   x-pencil  X[s, k, j], shape (P, P*c, w): rank s holds columns s*w.. of
//             the padded (P*c, P*w) field;
//   y-pencil  Y[r, i, l], shape (P, c, P*w): rank r holds rows r*c.. .
//
//   x -> y:   Y[r, i, s*w + j] = X[s, r*c + i, j]
//   y -> x:   the inverse.
//
// On one device the ring's shift order carries no meaning, so the P^2
// chunks (s, r) go in one launch.  Chunk (s, r) is c rows of w elements that
// are contiguous in both layouts.  The grid is (row vectors, rows, chunks):
// a block of 32 x 8 threads moves 8 row segments of 32 vectors, so a warp
// reads and writes 32 neighbouring vectors on both sides and no thread
// divides an index.  Each thread moves 16 bytes (a double2 or float4) when
// w, both tensors' row and rank strides and both base pointers allow it,
// else one element.  The row and rank strides are the stacked tensors' own,
// passed by the wrapper (rustpde_mpi_tpu_torch/ops/ring_transpose.py); the
// unit element stride is checked there.
//
// Members.  An ensemble of K states of one model flips all K members'
// pencils in one launch (the JAX package's jax.vmap of the flip): the grid's
// z runs member and chunk, m * P^2 + s * P + r, and member m's pencils sit
// at member strides xsm (x-pencil) and ysm (y-pencil) in the stacked
// (K, P, ...) tensors (both 0 for one member).
//
// The element type T is double or float for a real field and double2 or
// float2 for a complex one (complex128, complex64): the index math counts
// elements of T, so a complex pencil needs no extra axis.
//
// Bound on the H100: bytes.  Every element is read once and written once,
// 2 * P^2 * c * w * sizeof(T): 16.8 MB for a 1024^2 f64 field, 5.0 us at
// 3.35 TB/s; no arithmetic beyond the index math.  The design keeps every
// access coalesced, 16 bytes a thread where the shape allows, with
// 2048 blocks of 256 threads at 1024^2 so that every SM keeps loads in
// flight.  Ragged widths (w odd in f64: 1025 padded to 1028 over 4 ranks
// gives w = 257) take 8-byte accesses, still coalesced, and leave at most
// 31 of a row's last 32 threads idle.
#include <cuda_runtime.h>
#include <stdint.h>

namespace rp {

constexpr int RT_TX = 32;  // vectors of a row segment a block moves
constexpr int RT_TY = 8;   // row segments a block moves

// MEMBERS: several members, member m's pencils at m * xsm / m * ysm (z =
// m * P^2 + chunk); the one-member instance keeps the index math of a
// kernel without members (one division more a thread measured 28% slower
// on the 8-byte path on the H100, a branch on the strides 10%:
// scripts/launch_times.py).
template <typename T, typename V, bool X2Y, bool MEMBERS>
__global__ void __launch_bounds__(RT_TX * RT_TY)
    ring_transpose_kernel(int P, int c, int w, int wv, long long xs0,
                          long long xs1, long long ys0, long long ys1,
                          long long xsm, long long ysm,
                          const T* __restrict__ in, T* __restrict__ out) {
  const int kv = blockIdx.x * RT_TX + threadIdx.x;  // vector within the row
  const int i = blockIdx.y * RT_TY + threadIdx.y;   // row within the chunk
  if (kv >= wv || i >= c) return;
  int chunk = blockIdx.z;
  if constexpr (MEMBERS) {
    const int m = chunk / (P * P);
    chunk -= m * P * P;
    in += m * (X2Y ? xsm : ysm);
    out += m * (X2Y ? ysm : xsm);
  }
  const int s = chunk / P;  // x-pencil rank (column block)
  const int r = chunk % P;  // y-pencil rank (row block)
  const int k = kv * (int)(sizeof(V) / sizeof(T));
  const long long xoff = s * xs0 + (long long)(r * c + i) * xs1 + k;
  const long long yoff = r * ys0 + (long long)i * ys1 + (long long)s * w + k;
  const V* src = reinterpret_cast<const V*>(in + (X2Y ? xoff : yoff));
  V* dst = reinterpret_cast<V*>(out + (X2Y ? yoff : xoff));
  *dst = __ldg(src);
}

template <typename T, typename V>
void launch_kernel(int P, int c, int w, long long xs0, long long xs1,
                   long long ys0, long long ys1, int members, long long xsm,
                   long long ysm, const T* in, T* out, int x_to_y,
                   cudaStream_t stream) {
  const int wv = w / (int)(sizeof(V) / sizeof(T));
  dim3 block(RT_TX, RT_TY, 1);
  dim3 grid((wv + RT_TX - 1) / RT_TX, (c + RT_TY - 1) / RT_TY, P * P * members);
  const bool many = members > 1;
  if (x_to_y && many)
    ring_transpose_kernel<T, V, true, true><<<grid, block, 0, stream>>>(
        P, c, w, wv, xs0, xs1, ys0, ys1, xsm, ysm, in, out);
  else if (x_to_y)
    ring_transpose_kernel<T, V, true, false><<<grid, block, 0, stream>>>(
        P, c, w, wv, xs0, xs1, ys0, ys1, xsm, ysm, in, out);
  else if (many)
    ring_transpose_kernel<T, V, false, true><<<grid, block, 0, stream>>>(
        P, c, w, wv, xs0, xs1, ys0, ys1, xsm, ysm, in, out);
  else
    ring_transpose_kernel<T, V, false, false><<<grid, block, 0, stream>>>(
        P, c, w, wv, xs0, xs1, ys0, ys1, xsm, ysm, in, out);
}

template <typename T, typename V>
int launch_ring(int P, int c, int w, long long xs0, long long xs1,
                long long ys0, long long ys1, const void* in, void* out,
                int x_to_y, int members, long long xsm, long long ysm,
                cudaStream_t stream) {
  constexpr int NV = (int)(sizeof(V) / sizeof(T));
  if (P < 1 || members < 1 || (long long)P * P * members > 65535 || c < 1 ||
      (c + RT_TY - 1) / RT_TY > 65535 ||
      w < 1 || xs1 < w || ys1 < (long long)P * w ||
      xs0 < (long long)P * c * xs1 || ys0 < (long long)c * ys1 ||
      (members > 1 && (xsm < (long long)P * xs0 || ysm < (long long)P * ys0)) ||
      (x_to_y != 0 && x_to_y != 1))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      w % NV == 0 && xs0 % NV == 0 && xs1 % NV == 0 && ys0 % NV == 0 &&
      ys1 % NV == 0 && xsm % NV == 0 && ysm % NV == 0 &&
      reinterpret_cast<uintptr_t>(in) % sizeof(V) == 0 &&
      reinterpret_cast<uintptr_t>(out) % sizeof(V) == 0;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (aligned)
    launch_kernel<T, V>(P, c, w, xs0, xs1, ys0, ys1, members, xsm, ysm, src, dst, x_to_y,
                        stream);
  else
    launch_kernel<T, T>(P, c, w, xs0, xs1, ys0, ys1, members, xsm, ysm, src, dst, x_to_y,
                        stream);
  return (int)cudaGetLastError();
}

}  // namespace rp

extern "C" int rp_ring_transpose_f64(int P, int c, int w, long long xs0,
                                     long long xs1, long long ys0,
                                     long long ys1, const void* in, void* out,
                                     int x_to_y, int members, long long xsm,
                                     long long ysm, void* stream) {
  return rp::launch_ring<double, double2>(P, c, w, xs0, xs1, ys0, ys1, in,
                                          out, x_to_y, members, xsm, ysm,
                                          static_cast<cudaStream_t>(stream));
}

// Complex pencils (the periodic cell's spectral state): a complex element is
// the unit the permutation moves, its real and imaginary parts together.
// complex128 moves one 16-byte double2 a thread; complex64 two float2
// elements as one float4 where the alignment allows it, else one float2.
extern "C" int rp_ring_transpose_c128(int P, int c, int w, long long xs0,
                                      long long xs1, long long ys0,
                                      long long ys1, const void* in, void* out,
                                      int x_to_y, int members, long long xsm,
                                      long long ysm, void* stream) {
  return rp::launch_ring<double2, double2>(P, c, w, xs0, xs1, ys0, ys1, in,
                                           out, x_to_y, members, xsm, ysm,
                                           static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_transpose_c64(int P, int c, int w, long long xs0,
                                     long long xs1, long long ys0,
                                     long long ys1, const void* in, void* out,
                                     int x_to_y, int members, long long xsm,
                                     long long ysm, void* stream) {
  return rp::launch_ring<float2, float4>(P, c, w, xs0, xs1, ys0, ys1, in,
                                         out, x_to_y, members, xsm, ysm,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_transpose_f32(int P, int c, int w, long long xs0,
                                     long long xs1, long long ys0,
                                     long long ys1, const void* in, void* out,
                                     int x_to_y, int members, long long xsm,
                                     long long ysm, void* stream) {
  return rp::launch_ring<float, float4>(P, c, w, xs0, xs1, ys0, ys1, in,
                                        out, x_to_y, members, xsm, ysm,
                                        static_cast<cudaStream_t>(stream));
}
