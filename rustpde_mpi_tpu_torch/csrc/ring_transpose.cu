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
#include <string.h>

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

// ---------------------------------------------------------------------------
// The flip's remote form: a mesh whose ranks span processes.
//
// Replaces the part of the Pallas TPU kernel rustpde_mpi_tpu/parallel/
// decomp.py `_ring_transpose_kernel` that crosses devices: there each ring
// step pushes one chunk into the destination device's output slab at the
// sender's slot (`pltpu.make_async_remote_copy`), with paired send and
// receive semaphores.  Here a process holds PL = P / nproc consecutive
// ranks of the mesh (first rank g0), stacked as the one-device kernel's
// pencils are, and every process owns one receive slab a (shape, dtype,
// direction) of flip, allocated by rp_slab_alloc below with cudaMalloc
// (an IPC handle names a whole allocation, never a block of PyTorch's
// caching allocator) and mapped into every peer with
// cudaIpcOpenMemHandle.  The slab holds the flip's output for the
// process's ranks in the output layout; `dst[t]` is destination rank t's
// block in its process's slab as mapped in this process.
//
//   x -> y:   dst[t][m, i, (g0 + lr)*w + j]     = X[m, lr, t*c + i, j]
//   y -> x:   dst[t][m, (g0 + lr)*c + i, j]     = Y[m, lr, i, t*w + j]
//
// for every local rank lr and destination rank t, local or remote alike:
// chunks between local ranks go straight into this process's own slab.
// On one card shared by the processes the pushes stay in its memory; with
// a card a process they go over NVLink to the peer card.
//
// Completion without a spinning kernel.  Processes that share a card run
// in separate contexts, which the card time-slices, so a kernel that spun
// on a flag could hold the card while the peer it waits for cannot run.
// The handshake is made of the CUDA driver API's stream memory operations
// (cuStreamWaitValue32 / cuStreamWriteValue32, reached through
// cudaGetDriverEntryPoint so that no link flag changes), which wait in the
// card's front end, not on its SMs.  Every slab ends with two flag arrays,
// one flag a process (the TPU kernel's receive and send semaphores):
//   ready[q]   1: process q's chunks for this flip are in my slab;
//   credit[q]  1: my chunks may go into process q's slab (q consumed the
//              last ones).
// A flip on process p is, on its stream:
//   wait credit[q] == 1, set credit[q] = 0   (each peer q, local flags)
//   push kernel                              (all chunks, all ranks)
//   write 1 into q's ready[p]                (each peer, after a fence)
//   wait ready[q] == 1                       (each peer, local flags)
//   copy-out kernel: slab -> a fresh output  (so the flip never aliases
//                                             the slab)
//   set ready[q] = 0, write 1 into q's credit[p]
// The values are the same on every call, so a CUDA graph that captured
// the sequence replays it unchanged (an epoch baked into a captured wait
// would not advance), and a sender never overwrites a slab its receiver
// is still reading.  Each wait is on this process's own memory; the
// writes go to the peers' (a stream write is preceded by a memory fence,
// so the chunks are visible before the flag that announces them).
//
// Bound on the H100: bytes.  The push reads and writes each element once
// and the copy-out reads and writes it once more, 4 * elements * size;
// across cards the (P - PL) / P remote share of the push goes over NVLink
// (450 GB/s each way).  The push kernel is the one-device kernel's design
// (one flat range of words, RT_UNROLL loads in flight a thread, the
// indices split by multiply-highs); the copy-out is a flat word copy.
//
// Measured (chip_smoke.py phase 37, NVIDIA H100 80GB HBM3, 700 W): on one
// card a flip of a meshed rbc1025 step's pencil, 16.8 MB with the copy-out
// against a 0.0050 ms bound, takes 0.30-0.49 ms back to back (a captured
// graph of flips every process replays together) on 2 processes x 2
// ranks and 0.99-1.02 ms on 4 x 1, where the library's copy_ of the same
// chunks, with no handshake, takes 0.012 and 0.006.  With the L2 flushed
// a 2 x 2 flip's window is either 0.028 ms or 0.14-0.36 ms: the flip's own
// work is small and the rest is waiting on the peers.  Why it waits (the
// card switching between the processes' contexts is the likely cause) is
// not measured.  With one process a card (four cards) the same flip takes
// 0.074-0.100 ms beside NCCL's all_to_all_single at 0.018-0.038.
// ---------------------------------------------------------------------------

#define RT_MAX_RANKS 64
#define RT_MAX_PROCS 16
// the bytes of an IPC handle the wrapper passes (ops/ring_transpose.py)
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "an IPC handle is 64 bytes");

// Mirror of rustpde_mpi_tpu_torch/ops/ring_transpose.py `RpPush`: one flip
// of a spanning mesh.  Strides and extents in elements.
struct RpPush {
  const void* in;                      // this process's pencils ([K,] PL, ...)
  void* slab;                          // this process's receive slab
  void* out;                           // the flip's output (as large as the slab)
  void* dst[RT_MAX_RANKS];             // destination rank t's block, as mapped here
  unsigned* ready;                     // this slab's ready flags, one a process
  unsigned* credit;                    // this slab's credit flags, one a process
  unsigned* ready_peer[RT_MAX_PROCS];  // process q's ready flag of this process
  unsigned* credit_peer[RT_MAX_PROCS]; // process q's credit flag of this process
  long long is0, is1, ism;             // input rank, row and member strides
  long long d1, dsm;                   // destination row and member strides
  long long out_elems;                 // elements of the slab's data (the copy-out)
  long long mul_w, mul_c, mul_p, mul_l;  // magic pairs of w / (word / elem), c, P, PL
  int shr_w, shr_c, shr_p, shr_l;
  int P, PL, g0, c, w, members, x_to_y, word, nproc, me;
};

namespace rp {

struct PushArgs {
  const void* in;
  void* dst[RT_MAX_RANKS];
  unsigned n;  // words the launch moves
  FastDiv wv, c, p, pl;
  int g0;
  int is0, is1, ism, d1, dsm;
};

template <int BYTES, bool X2Y>
__global__ void __launch_bounds__(RT_THREADS) ring_push_kernel(const PushArgs a) {
  using W = typename Word<BYTES>::type;
  const W* __restrict__ in = static_cast<const W*>(a.in);
  const unsigned first = blockIdx.x * (RT_THREADS * RT_UNROLL) + threadIdx.x;
  W v[RT_UNROLL];
  W* dst[RT_UNROLL];
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u) {
    const unsigned g = first + u * RT_THREADS;
    if (g < a.n) {
      // the flat range in the source's order (m, lr, t, i, j)
      const unsigned q = fast_div(g, a.wv);
      const int j = (int)(g - q * a.wv.d);
      const unsigned k = fast_div(q, a.c);
      const int i = (int)(q - k * a.c.d);
      const unsigned ml = fast_div(k, a.p);
      const int t = (int)(k - ml * a.p.d);
      const unsigned m = fast_div(ml, a.pl);
      const int lr = (int)(ml - m * a.pl.d);
      const int cc = (int)a.c.d, ww = (int)a.wv.d;
      int src, off;
      if constexpr (X2Y) {
        src = (int)m * a.ism + lr * a.is0 + (t * cc + i) * a.is1 + j;
        off = (int)m * a.dsm + i * a.d1 + (a.g0 + lr) * ww + j;
      } else {
        src = (int)m * a.ism + lr * a.is0 + i * a.is1 + t * ww + j;
        off = (int)m * a.dsm + ((a.g0 + lr) * cc + i) * a.d1 + j;
      }
      v[u] = __ldg(in + src);
      dst[u] = static_cast<W*>(a.dst[t]) + off;
    }
  }
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u)
    if (first + u * RT_THREADS < a.n) *dst[u] = v[u];
}

template <int BYTES>
__global__ void __launch_bounds__(RT_THREADS) word_copy_kernel(const void* __restrict__ src,
                                                               void* __restrict__ dst,
                                                               unsigned n) {
  using W = typename Word<BYTES>::type;
  const W* __restrict__ s = static_cast<const W*>(src);
  W* __restrict__ d = static_cast<W*>(dst);
  const unsigned first = blockIdx.x * (RT_THREADS * RT_UNROLL) + threadIdx.x;
  W v[RT_UNROLL];
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u)
    if (first + u * RT_THREADS < n) v[u] = __ldg(s + first + u * RT_THREADS);
#pragma unroll
  for (int u = 0; u < RT_UNROLL; ++u)
    if (first + u * RT_THREADS < n) d[first + u * RT_THREADS] = v[u];
}

// The CUDA driver API's stream memory operations (CUresult is an int-sized enum,
// CUstream is cudaStream_t, CUdeviceptr an unsigned 64-bit address).
typedef int (*StreamValue32Fn)(cudaStream_t, unsigned long long, unsigned, unsigned);
constexpr unsigned WAIT_VALUE_EQ = 0x1;      // CU_STREAM_WAIT_VALUE_EQ
constexpr unsigned WRITE_VALUE_DEFAULT = 0;  // CU_STREAM_WRITE_VALUE_DEFAULT: fenced

static StreamValue32Fn g_wait = nullptr, g_write = nullptr;

static cudaError_t entry(const char* name, StreamValue32Fn* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &status);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess) return e;
  if (status != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
  *fn = reinterpret_cast<StreamValue32Fn>(p);
  return cudaSuccess;
}

static cudaError_t memops() {
  if (g_wait && g_write) return cudaSuccess;
  cudaError_t e = entry("cuStreamWaitValue32", &g_wait);
  if (e == cudaSuccess) e = entry("cuStreamWriteValue32", &g_write);
  return e;
}

// A driver error as a runtime one: the wrapper only tests for non-zero;
// 999 (cudaErrorUnknown) keeps the two enums apart.
static int wait_eq(cudaStream_t s, unsigned* flag, unsigned value) {
  return g_wait(s, reinterpret_cast<unsigned long long>(flag), value, WAIT_VALUE_EQ) ? 999 : 0;
}

static int write_value(cudaStream_t s, unsigned* flag, unsigned value) {
  return g_write(s, reinterpret_cast<unsigned long long>(flag), value, WRITE_VALUE_DEFAULT) ? 999
                                                                                            : 0;
}

static bool fits(long long mul, int shr) { return mul >= 0 && mul < (1LL << 32) && shr >= 0 && shr <= 31; }

template <int ELEM>
int launch_push(const RpPush* f, cudaStream_t stream) {
  if (f == nullptr || f->P < 1 || f->PL < 1 || f->P % f->PL || f->P > RT_MAX_RANKS ||
      f->nproc != f->P / f->PL || f->nproc > RT_MAX_PROCS || f->me < 0 || f->me >= f->nproc ||
      f->g0 != f->me * f->PL || f->c < 1 || f->w < 1 || f->members < 1 ||
      (f->x_to_y != 0 && f->x_to_y != 1) || f->word % ELEM ||
      (f->word != 4 && f->word != 8 && f->word != 16) ||
      !fits(f->mul_w, f->shr_w) || !fits(f->mul_c, f->shr_c) || !fits(f->mul_p, f->shr_p) ||
      !fits(f->mul_l, f->shr_l))
    return (int)cudaErrorInvalidValue;
  const long long nv = f->word / ELEM;
  if (f->w % nv || f->is0 % nv || f->is1 % nv || f->ism % nv || f->d1 % nv || f->dsm % nv ||
      reinterpret_cast<uintptr_t>(f->in) % f->word)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < f->P; ++t)
    if (f->dst[t] == nullptr || reinterpret_cast<uintptr_t>(f->dst[t]) % f->word)
      return (int)cudaErrorInvalidValue;
  const long long wv = f->w / nv;
  const long long n = (long long)f->members * f->PL * f->P * f->c * wv;
  const long long lim = 1LL << 31;
  const long long rows_in = f->x_to_y ? (long long)f->P * f->c : f->c;
  const long long cols_in = f->x_to_y ? wv : (long long)f->P * wv;
  const long long rows_out = f->x_to_y ? f->c : (long long)f->P * f->c;
  const long long cols_out = f->x_to_y ? (long long)f->P * wv : wv;
  if (n >= lim ||
      span(f->members, f->ism / nv, f->PL, f->is0 / nv, rows_in, f->is1 / nv, cols_in) >= lim ||
      span(f->members, f->dsm / nv, 1, 0, rows_out, f->d1 / nv, cols_out) >= lim ||
      f->out_elems < 1 || f->out_elems * ELEM >= lim * 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = memops();
  if (e != cudaSuccess) return (int)e;
  PushArgs a;
  a.in = f->in;
  for (int t = 0; t < RT_MAX_RANKS; ++t) a.dst[t] = t < f->P ? f->dst[t] : nullptr;
  a.n = (unsigned)n;
  a.wv = {(unsigned)wv, (unsigned)f->mul_w, (unsigned)f->shr_w};
  a.c = {(unsigned)f->c, (unsigned)f->mul_c, (unsigned)f->shr_c};
  a.p = {(unsigned)f->P, (unsigned)f->mul_p, (unsigned)f->shr_p};
  a.pl = {(unsigned)f->PL, (unsigned)f->mul_l, (unsigned)f->shr_l};
  a.g0 = f->g0;
  a.is0 = (int)(f->is0 / nv);
  a.is1 = (int)(f->is1 / nv);
  a.ism = f->members > 1 ? (int)(f->ism / nv) : 0;
  a.d1 = (int)(f->d1 / nv);
  a.dsm = f->members > 1 ? (int)(f->dsm / nv) : 0;
  int rc = 0;
  // the slots of every peer's slab are free
  for (int q = 0; q < f->nproc && !rc; ++q)
    if (q != f->me) {
      rc = wait_eq(stream, f->credit + q, 1);
      if (!rc) rc = write_value(stream, f->credit + q, 0);
    }
  if (rc) return rc;
  const int blocks = (int)((n + RT_THREADS * RT_UNROLL - 1) / (RT_THREADS * RT_UNROLL));
  if (f->word == 4)
    f->x_to_y ? ring_push_kernel<4, true><<<blocks, RT_THREADS, 0, stream>>>(a)
              : ring_push_kernel<4, false><<<blocks, RT_THREADS, 0, stream>>>(a);
  else if (f->word == 8)
    f->x_to_y ? ring_push_kernel<8, true><<<blocks, RT_THREADS, 0, stream>>>(a)
              : ring_push_kernel<8, false><<<blocks, RT_THREADS, 0, stream>>>(a);
  else
    f->x_to_y ? ring_push_kernel<16, true><<<blocks, RT_THREADS, 0, stream>>>(a)
              : ring_push_kernel<16, false><<<blocks, RT_THREADS, 0, stream>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // announce the chunks, then wait for every peer's
  for (int q = 0; q < f->nproc && !rc; ++q)
    if (q != f->me) rc = write_value(stream, f->ready_peer[q], 1);
  for (int q = 0; q < f->nproc && !rc; ++q)
    if (q != f->me) rc = wait_eq(stream, f->ready + q, 1);
  if (rc) return rc;
  // the copy-out: the widest word both pointers and the size allow
  const long long bytes = f->out_elems * ELEM;
  const uintptr_t align = reinterpret_cast<uintptr_t>(f->slab) | reinterpret_cast<uintptr_t>(f->out) |
                          (uintptr_t)bytes;
  const int cw = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : 4;
  const unsigned cn = (unsigned)(bytes / cw);
  const int cblocks = (int)((cn + RT_THREADS * RT_UNROLL - 1) / (RT_THREADS * RT_UNROLL));
  if (cw == 16)
    word_copy_kernel<16><<<cblocks, RT_THREADS, 0, stream>>>(f->slab, f->out, cn);
  else if (cw == 8)
    word_copy_kernel<8><<<cblocks, RT_THREADS, 0, stream>>>(f->slab, f->out, cn);
  else
    word_copy_kernel<4><<<cblocks, RT_THREADS, 0, stream>>>(f->slab, f->out, cn);
  rc = (int)cudaGetLastError();
  // the slab is consumed: clear the ready flags, hand the peers their credit
  for (int q = 0; q < f->nproc && !rc; ++q)
    if (q != f->me) {
      rc = write_value(stream, f->ready + q, 0);
      if (!rc) rc = write_value(stream, f->credit_peer[q], 1);
    }
  return rc;
}

}  // namespace rp

// One entry a dtype, as the one-device flip's; they differ in the element size.

extern "C" int rp_ring_push_f64(const RpPush* f, void* stream) {
  return rp::launch_push<8>(f, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_push_f32(const RpPush* f, void* stream) {
  return rp::launch_push<4>(f, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_push_c128(const RpPush* f, void* stream) {
  return rp::launch_push<16>(f, static_cast<cudaStream_t>(stream));
}

extern "C" int rp_ring_push_c64(const RpPush* f, void* stream) {
  return rp::launch_push<8>(f, static_cast<cudaStream_t>(stream));
}

// The receive slabs.  A slab is `data_bytes` (a multiple of 256) of data
// and then the flags: ready[RT_MAX_PROCS], credit[RT_MAX_PROCS], unsigned.
// It starts with every ready flag 0 and every credit 1 (every peer's slot
// free); the call returns when that is on the card, so the handle may go
// to the peers at once.

extern "C" int rp_slab_alloc(long long data_bytes, void** ptr, void* handle) {
  if (data_bytes < 0 || data_bytes % 256 || ptr == nullptr || handle == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t flags = 2 * RT_MAX_PROCS * sizeof(unsigned);
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, (size_t)data_bytes + flags);
  if (e != cudaSuccess) return (int)e;
  unsigned init[2 * RT_MAX_PROCS];
  for (int q = 0; q < RT_MAX_PROCS; ++q) {
    init[q] = 0;
    init[RT_MAX_PROCS + q] = 1;
  }
  e = cudaMemset(p, 0, (size_t)data_bytes);
  if (e == cudaSuccess)
    e = cudaMemcpy(static_cast<char*>(p) + data_bytes, init, flags, cudaMemcpyHostToDevice);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), p);
  if (e != cudaSuccess) {
    cudaFree(p);
    return (int)e;
  }
  *ptr = p;
  return 0;
}

extern "C" int rp_slab_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" int rp_ipc_open(const void* handle, void** ptr) {
  if (handle == nullptr || ptr == nullptr) return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int rp_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

