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
// An ensemble of K states flips all K members' pencils in one launch (the
// JAX package's jax.vmap of the flip): member m's pencils sit at member
// strides xsm and ysm of the stacked (K, P, ...) tensors.  On one device the
// ring's shift order carries no meaning, so all K * P^2 chunks (m, s, r)
// go in one launch.  Chunk (m, s, r) is c rows of w elements that are
// contiguous in both layouts.  The element is float64, float32, complex128
// or complex64: the flip moves bytes, so the kernel copies words of 4, 8
// or 16 bytes through integer registers, bit for bit.
//
// Bound on the H100: bytes.  Every element is read once and written once,
// 2 * K * P^2 * c * w * sizeof(T): a 1028^2 f64 field is 16.9 MB, 5.0 us
// at 3.35 TB/s; no arithmetic beyond the index math.
//
// The first design (a grid of (row vectors / 32, rows / 8, K * P^2) blocks
// of 32 x 8 threads, one vector a thread) lost against its bound in four
// ways: at ragged widths most of its lanes idled (c = w = 33, the 129^2
// pencils over 4 ranks, kept 42.5% of the launched threads busy); a thread
// had one load in flight, so a cold-L2 flip streamed ~1.3 TB/s (a meshed
// rbc1025 step's 37 flips 0.4587-0.4697 ms against a 0.1861 ms bound,
// level with PyTorch's .contiguous() of the permuted view at 0.4766); the
// member level divided the chunk index by P^2 in every thread (0.2306 ms a
// step at ensemble129 K = 32 against .contiguous()'s 0.1941); and one
// 16-byte test decided for a whole launch (all numbers: NVIDIA H100 80GB
// HBM3, 700 W, PERF.md section 6).
//
// This design:
//  * every lane busy: the launch's K * P^2 * c * w elements (in words) are
//    one flat range in the x-pencil's order (m, s, r, i, j); a block of 256
//    threads takes a tile of 256 * RT_UNROLL words, and neighbouring
//    threads take neighbouring words, so loads and stores stay coalesced
//    along the rows of both layouts and only the launch's last tile is
//    ragged;
//  * bytes in flight: each thread issues its RT_UNROLL loads before its
//    first store;
//  * no division: the flat index splits into (row, word) and the row into
//    (chunk, row in chunk) by two multiply-highs with magic constants the
//    wrapper computes (rustpde_mpi_tpu_torch/ops/ring_transpose.py
//    `fast_divmod`, as CUTLASS's FastDivmod), and the chunk into (m, s, r)
//    by shifts for P = 1, 2, 4, 8 (a generic instance divides);
//  * the widest word (16, 8 or 4 bytes) that the row width, every stride
//    and both base pointers allow, chosen by the wrapper for each launch.
// Offsets are 32-bit: a launch whose tensors span 2^31 words or more is
// refused (cudaErrorInvalidValue).
//
// Measured (scripts/flip_times.py, NVIDIA H100 80GB HBM3, 700 W; the first
// design's times in brackets): a meshed rbc1025 step's 37 flips 0.4326-
// 0.4335 ms with the L2 flushed by a write (0.4672-0.4682; .contiguous()
// 0.4723-0.4729) and 0.1819-0.1820 back to back (0.1901-0.1904);
// ensemble129 K = 32 0.1355-0.1362 back to back (0.2060-0.2061;
// .contiguous() 0.1465-0.1469); rbc1025 K = 2 0.3086-0.3105 (0.4127-
// 0.4133; 0.3591-0.3596).  With the L2 flushed every copy, this one and
// .contiguous() alike, stays near 2.3x the bound: the flush leaves the L2
// full of dirty lines to write back, and flushed by a read the same flips
// still take 0.3667-0.3673 ms.  Of the builds measured, 2 loads a thread
// was ~5% faster back to back at rbc1025 and ensemble129 but ~10% slower at
// rbc1025 K = 2 and 3-10% slower cold, 8 ~4% slower back to back; a grid of
// 8 blocks an SM striding over the tiles gained nothing; evict-first loads
// (__ldcs, __ldlu) lost 6-30% back to back; streaming stores (__stcs) won
// only at rbc1025 K = 2 back to back (0.2955-0.2970 against 0.3177-0.3206),
// whose 68 MB outgrow the L2.  So the kernel keeps 4 loads, one tile a
// block and plain accesses.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RT_UNROLL
// words a thread loads before its first store; a macro so that
// scripts/flip_times.py can time other builds of it
#define RT_UNROLL 4
#endif

namespace rp {

constexpr int RT_THREADS = 256;

// A divisor d and its magic pair: q = d == 1 ? n : umulhi(n, mul) >> shr
// is n / d for every n < 2^31.
struct FastDiv {
  unsigned d, mul, shr;
};

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

// The parameter block of a launch: strides and widths in words.
struct FlipArgs {
  const void* in;
  void* out;
  unsigned n;    // words the launch moves
  unsigned p;    // ranks (read by the generic instance)
  FastDiv wv;    // words of a chunk row
  FastDiv c;     // rows of a chunk
  int xs0, xs1, xsm, ys0, ys1, ysm;
};

template <int BYTES> struct Word;
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// PT > 0: P known at compile time, a power of two; 0: the generic instance.
template <int BYTES, bool X2Y, int PT>
__global__ void __launch_bounds__(RT_THREADS) ring_transpose_kernel(const FlipArgs a) {
  using W = typename Word<BYTES>::type;
  const W* __restrict__ in = static_cast<const W*>(a.in);
  W* __restrict__ out = static_cast<W*>(a.out);
  constexpr int LG = PT == 8 ? 3 : PT == 4 ? 2 : PT == 2 ? 1 : 0;
  const unsigned first = blockIdx.x * (RT_THREADS * RT_UNROLL) + threadIdx.x;
  W v[RT_UNROLL];
  int dst[RT_UNROLL];
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u) {
    const unsigned g = first + u * RT_THREADS;
    if (g < a.n) {
      const unsigned q = fast_div(g, a.wv);  // row over (m, s, r, i)
      const int j = (int)(g - q * a.wv.d);
      const unsigned t = fast_div(q, a.c);   // chunk over (m, s, r)
      const int i = (int)(q - t * a.c.d);
      int r, s, m;
      if constexpr (PT > 0) {
        r = (int)(t & (PT - 1));
        s = (int)((t >> LG) & (PT - 1));
        m = (int)(t >> (2 * LG));
      } else {
        const unsigned ms = t / a.p;
        r = (int)(t - ms * a.p);
        m = (int)(ms / a.p);
        s = (int)(ms - (unsigned)m * a.p);
      }
      const int xo = m * a.xsm + s * a.xs0 + (r * (int)a.c.d + i) * a.xs1 + j;
      const int yo = m * a.ysm + r * a.ys0 + i * a.ys1 + s * (int)a.wv.d + j;
      v[u] = __ldg(in + (X2Y ? xo : yo));
      dst[u] = X2Y ? yo : xo;
    }
  }
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u)
    if (first + u * RT_THREADS < a.n) out[dst[u]] = v[u];
}

template <int BYTES, bool X2Y>
void launch_p(const FlipArgs& a, int blocks, cudaStream_t stream) {
  switch (a.p) {
    case 1: ring_transpose_kernel<BYTES, X2Y, 1><<<blocks, RT_THREADS, 0, stream>>>(a); break;
    case 2: ring_transpose_kernel<BYTES, X2Y, 2><<<blocks, RT_THREADS, 0, stream>>>(a); break;
    case 4: ring_transpose_kernel<BYTES, X2Y, 4><<<blocks, RT_THREADS, 0, stream>>>(a); break;
    case 8: ring_transpose_kernel<BYTES, X2Y, 8><<<blocks, RT_THREADS, 0, stream>>>(a); break;
    default: ring_transpose_kernel<BYTES, X2Y, 0><<<blocks, RT_THREADS, 0, stream>>>(a);
  }
}

template <int BYTES>
void launch_bytes(const FlipArgs& a, int x_to_y, int blocks, cudaStream_t stream) {
  if (x_to_y)
    launch_p<BYTES, true>(a, blocks, stream);
  else
    launch_p<BYTES, false>(a, blocks, stream);
}

// The largest word offset a tensor of these extents and strides reaches.
inline long long span(long long k, long long sm, long long p, long long s0, long long rows,
                      long long s1, long long cols) {
  return (k - 1) * sm + (p - 1) * s0 + (rows - 1) * s1 + cols - 1;
}

// Strides and widths come in elements of ELEM bytes; `word` is the copy
// width in bytes (4, 8 or 16, a multiple of ELEM) that the wrapper checked
// the row width, every stride and both base pointers to allow; `mul_*` and
// `shr_*` are the magic pairs of w / (word / ELEM) and of c.
template <int ELEM>
int launch_ring(int P, int c, int w, long long xs0, long long xs1, long long ys0, long long ys1,
                const void* in, void* out, int x_to_y, int members, long long xsm,
                long long ysm, int word, long long mul_w, int shr_w, long long mul_c,
                int shr_c, cudaStream_t stream) {
  if (P < 1 || members < 1 || c < 1 || w < 1 || xs1 < w || ys1 < (long long)P * w ||
      xs0 < (long long)P * c * xs1 || ys0 < (long long)c * ys1 ||
      (members > 1 && (xsm < (long long)P * xs0 || ysm < (long long)P * ys0)) ||
      (x_to_y != 0 && x_to_y != 1) || word % ELEM || (word != 4 && word != 8 && word != 16))
    return (int)cudaErrorInvalidValue;
  const long long nv = word / ELEM;
  if (w % nv || xs0 % nv || xs1 % nv || ys0 % nv || ys1 % nv || xsm % nv || ysm % nv ||
      reinterpret_cast<uintptr_t>(in) % word || reinterpret_cast<uintptr_t>(out) % word)
    return (int)cudaErrorInvalidValue;
  const long long wv = w / nv;
  const long long n = (long long)members * P * P * c * wv;
  const long long lim = 1LL << 31;
  if (n >= lim || span(members, xsm / nv, P, xs0 / nv, (long long)P * c, xs1 / nv, wv) >= lim ||
      span(members, ysm / nv, P, ys0 / nv, c, ys1 / nv, P * wv) >= lim || mul_w < 0 ||
      mul_w >= (1LL << 32) || mul_c < 0 || mul_c >= (1LL << 32) || shr_w < 0 || shr_w > 31 ||
      shr_c < 0 || shr_c > 31)
    return (int)cudaErrorInvalidValue;
  FlipArgs a;
  a.in = in;
  a.out = out;
  a.n = (unsigned)n;
  a.p = (unsigned)P;
  a.wv = {(unsigned)wv, (unsigned)mul_w, (unsigned)shr_w};
  a.c = {(unsigned)c, (unsigned)mul_c, (unsigned)shr_c};
  a.xs0 = (int)(xs0 / nv);
  a.xs1 = (int)(xs1 / nv);
  a.xsm = members > 1 ? (int)(xsm / nv) : 0;
  a.ys0 = (int)(ys0 / nv);
  a.ys1 = (int)(ys1 / nv);
  a.ysm = members > 1 ? (int)(ysm / nv) : 0;
  const long long blocks = (n + RT_THREADS * RT_UNROLL - 1) / (RT_THREADS * RT_UNROLL);
  if (word == 4)
    launch_bytes<4>(a, x_to_y, (int)blocks, stream);
  else if (word == 8)
    launch_bytes<8>(a, x_to_y, (int)blocks, stream);
  else
    launch_bytes<16>(a, x_to_y, (int)blocks, stream);
  return (int)cudaGetLastError();
}

}  // namespace rp

// One entry a dtype; they differ only in the element size.  A complex
// element (the periodic cell's spectral pencils) is the unit of the
// permutation, its real and imaginary parts together.

extern "C" int rp_ring_transpose_f64(int P, int c, int w, long long xs0, long long xs1,
                                      long long ys0, long long ys1, const void* in, void* out,
                                      int x_to_y, int members, long long xsm, long long ysm,
                                      int word, long long mul_w, int shr_w, long long mul_c,
                                      int shr_c, void* stream) {
  return rp::launch_ring<8>(P, c, w, xs0, xs1, ys0, ys1, in, out, x_to_y, members, xsm, ysm,
                            word, mul_w, shr_w, mul_c, shr_c, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_transpose_f32(int P, int c, int w, long long xs0, long long xs1,
                                      long long ys0, long long ys1, const void* in, void* out,
                                      int x_to_y, int members, long long xsm, long long ysm,
                                      int word, long long mul_w, int shr_w, long long mul_c,
                                      int shr_c, void* stream) {
  return rp::launch_ring<4>(P, c, w, xs0, xs1, ys0, ys1, in, out, x_to_y, members, xsm, ysm,
                            word, mul_w, shr_w, mul_c, shr_c, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_transpose_c128(int P, int c, int w, long long xs0, long long xs1,
                                      long long ys0, long long ys1, const void* in, void* out,
                                      int x_to_y, int members, long long xsm, long long ysm,
                                      int word, long long mul_w, int shr_w, long long mul_c,
                                      int shr_c, void* stream) {
  return rp::launch_ring<16>(P, c, w, xs0, xs1, ys0, ys1, in, out, x_to_y, members, xsm, ysm,
                            word, mul_w, shr_w, mul_c, shr_c, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_transpose_c64(int P, int c, int w, long long xs0, long long xs1,
                                      long long ys0, long long ys1, const void* in, void* out,
                                      int x_to_y, int members, long long xsm, long long ysm,
                                      int word, long long mul_w, int shr_w, long long mul_c,
                                      int shr_c, void* stream) {
  return rp::launch_ring<8>(P, c, w, xs0, xs1, ys0, ys1, in, out, x_to_y, members, xsm, ysm,
                            word, mul_w, shr_w, mul_c, shr_c, static_cast<cudaStream_t>(stream));
}
