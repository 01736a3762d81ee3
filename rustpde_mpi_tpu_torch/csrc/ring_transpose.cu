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
// cudaIpcOpenMemHandle.  A slab holds two buffers, each the flip's output
// for the process's ranks in the output layout, then its control words.
// Destination rank t's chunk from local rank lr lands, for every member m,
//
//   x -> y:   [m, t - q*PL, i, (g0 + lr)*w + j]     = X[m, lr, t*c + i, j]
//   y -> x:   [m, t - q*PL, (g0 + lr)*c + i, j]     = Y[m, lr, i, t*w + j]
//
// in buffer (epoch & 1) of process q's slab when t is a peer's rank, and
// straight in the flip's output when t is one of this process's: only
// the peers' chunks make a second pass, from the slab into the output (so
// the returned tensor is fresh and never aliases a slab).
//
// Where a flip's time went in the first design (chip_smoke.py phase 37's
// split, PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W; a meshed
// rbc1025 step's 37 flips of one process, a captured graph every process
// replays together).  That design waited for a credit (the peer had
// copied the last flip out of the one buffer), pushed, wrote and waited
// for the ready flags, copied out, and cleared and handed back the flags:
// 6 stream memory operations a peer and 2 launches a flip, two
// cross-process dependencies.  On one card shared by 2 processes x 2
// ranks the push alone took 0.13 ms a step, the copy-out alone 0.09-0.19,
// the handshake alone (its memory operations, no kernel) 1.39-1.52, and
// the whole flip 11.32-11.67: the parts summed to a seventh of the whole.
// The timeline of a graph of flips (a one-thread kernel stamping the
// card's global timer between the operations) showed why: the processes'
// contexts never ran at once; each ran its operations until a wait found
// its flag unset, and ~140 us passed before the other context's next
// operation ran, twice a flip (the ready wait on one process, the credit
// wait on the other).  With no kernel between the waits the same
// handshakes switched in ~20 us.  On 4 x 1 every flip cost ~4 such
// switches (0.65 ms).  With a card a process (four cards) nothing waits
// on a switch: the push took 0.32 ms a step, the copy-out 0.13, the
// handshake alone 2.46-2.51 of the whole 2.79-2.87; per flip its 18
// stream memory operations took ~65 of ~70 us, ~3.5 us each, serialized
// in the card's front end.
//
// So this design attacks the waits.  No kernel spins on a flag: where
// processes share a card their contexts time-slice it, and a spinning
// kernel would hold the card from the peer it waits for.
//  * One cross-process dependency a flip.  The two buffers make the
//    credit unnecessary: a sender writes flip e into buffer e & 1, whose
//    last reader was the receiver's flip e - 2, and the sender's flip e - 1
//    waited for the receiver's signal of flip e - 1, which the receiver
//    sends only after its flip e - 2 ended.  So a process that takes the
//    card completes a flip and pushes the next before it waits again: one
//    context switch a flip back to back where there were two (inside a
//    step, where compute sits between the flips, it was one already).
//  * Flags as semaphores, epochs on the card.  ready[q] in the receiver's
//    control words counts process q's pushes not yet consumed: the
//    sender's push launch adds 1 (the last of its blocks to finish, after
//    a system-scope fence, so every block's chunks are visible first), the
//    receiver waits until it is >= 1 and its copy-out subtracts 1.  The
//    waits compare with the constant 1, so a captured graph replays them
//    unchanged; the buffer comes from the slab's epoch, which the last
//    block of the copy-out advances on the card, so no replay goes stale.
//  * Two launches a flip, the push (and its signal) and the copy-out (and
//    the release), with the peers' waits between them as one
//    cuStreamBatchMemOp (reached through cudaGetDriverEntryPoint, no link
//    flag), which waits in the card's front end, so a waiting process
//    holds no SM.  3 stream operations a flip where there were 2 + 6 a
//    peer: on four cards the 18 serialized memory operations are gone.
//    A form that waits inside one launch (push, signal, spin, copy-out)
//    was measured beside it on four cards (scripts/span_flip_times.py,
//    PERF.md section 6): a step's flips 0.69-0.73 ms against this form's
//    0.79-0.82 back to back (NCCL's 0.80-1.16, median 0.91, in the same
//    call), and alike cold (1.09-1.41 and 1.11-1.70 with the L2 flushed).
//    So the one form serves every layout; a spin
//    would need a cooperative launch and a timeout, and a card shared by
//    processes or streams could starve it.
// The flag protocol, step for step, is modelled in plain Python and its
// schedules drawn by hypothesis in tests/test_torch_remote_protocol.py
// (no buffer written before its owner read it, no deadlock, every output
// the plain flip), for 2, 3 and 4 processes over replayed graphs.
//
// Bound on the H100: bytes.  A flip reads its input once and writes its
// output once, 2 * elements * size over 3.35 TB/s; across cards the
// (P - PL) / P remote share goes over NVLink (450 GB/s each way).  This
// design moves that plus the peers' chunks' second pass (slab -> output).
//
// Measured (same card): with a card a process a step's flips take
// 0.79-0.82 ms back to back (scripts/span_flip_times.py; the first design
// 3.15 in chip_smoke.py phase 37; NCCL's all_to_all_single 0.80-1.16 in
// the same call); back to back on a shared card 6.3 ms on
// 2 x 2 and 18 on 4 x 1 (11.5 and 38), each a context switch a flip.
//
// The cross-host form.  CUDA IPC maps memory of one machine only, and no
// card here can write another host's memory (no GPUDirect RDMA, no
// NVSHMEM), so the chunks for a process on another host (bit q of
// RpPush::remote) pass through host memory, as the JAX package's DCN
// traffic passes through its hosts:
//  * the push writes them, unchanged, through dst[t]: for such a rank that
//    is this process's staging for q, pinned host memory the card maps
//    (rp_host_alloc), laid out as q's slab with its two buffers, so the
//    kernel's body and its epoch offset serve it as they serve a slab;
//    its signal raises this process's own ready[q] (ready_peer[q] points
//    there), which the copy-out's release consumes as it does a same-host
//    peer's;
//  * the exchange (PUSH_EXCHANGE): a 4-byte copy of the slab's epoch into
//    a pinned word, then csrc/host_exchange.cpp's hx_exchange as a host
//    function on the stream (cudaLaunchHostFunc), which sends the staging
//    buffer that word names and receives the peers' runs into pinned
//    memory; both are graph nodes, so a captured step stays one replay;
//  * the copy-in (PUSH_COPY_IN, copy_in_kernel below) reads the epoch on
//    the card and scatters the received runs into buffer epoch & 1 of this
//    slab, where the copy-out reads them with the same-host peers' chunks;
//  * the front-end wait covers the same-host peers alone; stream order
//    puts the exchange and the copy-in before it.
// The copy-in is a launch of its own rather than a copy-out that reads
// the other-host peers from a base pointer of their own: that would widen
// the parameter block every remote flip passes (the launch cost the
// one-launch form of this note measured), and a captured cudaMemcpyAsync of
// fixed addresses cannot follow the epoch.  Its bound: the bytes for the
// other host, each way, over the card's measured pinned-copy rates
// (chip_smoke.py phase 40: 54.9 GB/s out, 52.9 in on the H100 below).
//
// Measured (chip_smoke.py phase 40, NVIDIA H100 80GB HBM3, 700 W; 2
// processes x 2 ranks on one card declared on two hosts): meshed rbc1025
// 99.2-99.3 ms/step against the one-process mesh's 3.25; a step's 37 flips
// 93-96 ms, of which the exchange 73.5 warm (83 cold), the push 1.7-3.1,
// the copy-in 2.9-4.0, the copy-out 0.1-0.3: the loopback socket's
// ~1 GB/s each way sets it.  The bound of those flips 1.47 ms.
// ---------------------------------------------------------------------------

#include <cuda.h>

#define RT_MAX_RANKS 64
#define RT_MAX_PROCS 16
// the bytes of an IPC handle the wrapper passes (ops/ring_transpose.py)
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "an IPC handle is 64 bytes");
// a slab's control words, after its two buffers: ready[RT_MAX_PROCS], then
// the epoch and the launches' arrive and leave counts; the wrapper passes
// their addresses, the allocation zeroes them
#define RT_CTL_BYTES 256

// Mirror of rustpde_mpi_tpu_torch/ops/_build.py `RpPush`: one flip of a
// spanning mesh.  Strides and extents in elements.
struct RpPush {
  const void* in;                      // this process's pencils ([K,] PL, ...)
  void* out;                           // the flip's output, the slab's layout
  const void* slab;                    // this process's receive slab (buffer 0)
  void* dst[RT_MAX_RANKS];             // rank t's block: buffer 0 of its slab as mapped
                                       // here (a peer's rank), or of out (this process's)
  unsigned* ctl;                       // this slab's control words
  unsigned* ready_peer[RT_MAX_PROCS];  // process q's ready semaphore of this process
  long long buf_bytes;                 // bytes from a slab's buffer 0 to its buffer 1
  long long is0, is1, ism;             // input rank, row and member strides
  long long d1, dsm, blk;              // output row, member and rank-block strides
  long long mul_w, mul_c, mul_p, mul_l, mul_r;  // magic pairs of w / (word / elem), c,
                                                // P, PL and the peers' ranks P - PL
  int shr_w, shr_c, shr_p, shr_l, shr_r;
  int P, PL, g0, c, w, members, x_to_y, word, nproc, me;
  int parts;  // the parts this call issues (PUSH_* bits; a flip issues all)
  // peers on other hosts (csrc/host_exchange.cpp), all null/0 where none:
  void* hx_fn;        // the exchange's host function, hx_exchange
  void* hx_plan;      // its argument, the slab's plan
  void* hx_epoch;     // pinned int32 the slab's epoch is copied into first
  void* recv;         // the received chunks, wire order, as mapped here
  long long remote;   // bit q: process q lies on another host
};

namespace rp {

// The parts of a flip (RpPush::parts), in their order: the push, its
// signal to the peers (the push launch), the wait for theirs (the front
// end), the copy-out of their chunks and the release (the semaphores
// consumed, the epoch advanced; the copy-out launch).  A flip issues them
// all; chip_smoke.py's split times them apart.
// Where peers lie on other hosts the exchange (the epoch's copy and the
// host function) and the copy-in come between the signal and the wait.
constexpr int PUSH_DATA = 1, PUSH_SIGNAL = 2, PUSH_WAIT = 4, PUSH_COPY = 8, PUSH_RELEASE = 16;
constexpr int PUSH_EXCHANGE = 32, PUSH_COPY_IN = 64;
constexpr int PUSH_ALL = 127;

// control words (unsigned) of a slab
constexpr int CTL_EPOCH = RT_MAX_PROCS, CTL_ARRIVE = RT_MAX_PROCS + 1,
              CTL_LEAVE = RT_MAX_PROCS + 2;
static_assert((RT_MAX_PROCS + 3) * sizeof(unsigned) <= RT_CTL_BYTES, "control words fit");

struct PushArgs {
  const void* in;
  void* out;
  const void* slab;
  void* dst[RT_MAX_RANKS];
  unsigned* ctl;
  unsigned* ready_peer[RT_MAX_PROCS];
  unsigned n;      // words the push moves
  unsigned ncopy;  // words the copy-out moves (the peers' chunks)
  unsigned buf;    // words from a slab's buffer 0 to its buffer 1
  FastDiv wv, c, p, pl, r;
  int g0, nproc, me, parts;
  int is0, is1, ism, d1, dsm, blk;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

// The last block of a launch to pass this point (count at ctl[which]):
// true on its thread 0, which resets the count.  With RELEASE, every
// block's writes before the call are visible (system scope) to what that
// thread does after it: each block's count is a release, the last one's
// an acquire.
template <bool RELEASE>
__device__ __forceinline__ bool last_block(unsigned* ctl, int which) {
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    if (RELEASE) fence_acq_rel_sys();
    last = atomicAdd(ctl + which, 1u) == gridDim.x - 1;
    if (last) {
      ctl[which] = 0;
      if (RELEASE) fence_acq_rel_sys();
    }
  }
  return last;
}

template <int BYTES, bool X2Y>
__global__ void __launch_bounds__(RT_THREADS) ring_push_kernel(const PushArgs a) {
  using W = typename Word<BYTES>::type;
  const W* __restrict__ in = static_cast<const W*>(a.in);
  W* __restrict__ out = static_cast<W*>(a.out);
  const W* slab = static_cast<const W*>(a.slab);
  const unsigned epoch = *(volatile unsigned*)(a.ctl + CTL_EPOCH);
  const unsigned boff = (epoch & 1u) * a.buf;
  const int cc = (int)a.c.d, ww = (int)a.wv.d, pl = (int)a.pl.d;
  constexpr unsigned TILE = RT_THREADS * RT_UNROLL;
  if (a.parts & PUSH_DATA) {
    for (unsigned first = blockIdx.x * TILE + threadIdx.x; first < a.n; first += gridDim.x * TILE) {
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
          int src, off;
          if constexpr (X2Y) {
            src = (int)m * a.ism + lr * a.is0 + (t * cc + i) * a.is1 + j;
            off = (int)m * a.dsm + i * a.d1 + (a.g0 + lr) * ww + j;
          } else {
            src = (int)m * a.ism + lr * a.is0 + i * a.is1 + t * ww + j;
            off = (int)m * a.dsm + ((a.g0 + lr) * cc + i) * a.d1 + j;
          }
          // a peer's rank: this flip's buffer of its slab
          if ((unsigned)(t - a.g0) >= (unsigned)pl) off += (int)boff;
          v[u] = __ldg(in + src);
          dst[u] = static_cast<W*>(a.dst[t]) + off;
        }
      }
#pragma unroll
      for (int u = 0; u < RT_UNROLL; ++u)
        if (first + u * RT_THREADS < a.n) *dst[u] = v[u];
    }
  }
  if (a.parts & PUSH_SIGNAL) {
    if (last_block<true>(a.ctl, CTL_ARRIVE))
      for (int q = 0; q < a.nproc; ++q)
        if (q != a.me) atomicAdd_system(a.ready_peer[q], 1u);
  }
  if (a.parts & PUSH_COPY) {
    // the peers' chunks, in the output's order (m, lt, peer rank, i, j);
    // the slab is read past L1, which may hold a line of an older flip
    for (unsigned first = blockIdx.x * TILE + threadIdx.x; first < a.ncopy;
         first += gridDim.x * TILE) {
      W v[RT_UNROLL];
      int dst[RT_UNROLL];
#pragma unroll
      for (int u = 0; u < RT_UNROLL; ++u) {
        const unsigned g = first + u * RT_THREADS;
        if (g < a.ncopy) {
          const unsigned q = fast_div(g, a.wv);
          const int j = (int)(g - q * a.wv.d);
          const unsigned k = fast_div(q, a.c);
          const int i = (int)(q - k * a.c.d);
          const unsigned ml = fast_div(k, a.r);
          const int sr = (int)(k - ml * a.r.d);
          const unsigned m = fast_div(ml, a.pl);
          const int lt = (int)(ml - m * a.pl.d);
          const int s = sr < a.g0 ? sr : sr + pl;
          int off = (int)m * a.dsm + lt * a.blk;
          off += X2Y ? i * a.d1 + s * ww + j : (s * cc + i) * a.d1 + j;
          v[u] = __ldcg(slab + boff + off);
          dst[u] = off;
        }
      }
#pragma unroll
      for (int u = 0; u < RT_UNROLL; ++u)
        if (first + u * RT_THREADS < a.ncopy) out[dst[u]] = v[u];
    }
  }
  if (a.parts & PUSH_RELEASE) {
    // the count only orders this launch's blocks: no data crosses here
    if (last_block<false>(a.ctl, CTL_LEAVE)) {
      for (int q = 0; q < a.nproc; ++q)
        if (q != a.me) atomicAdd_system(a.ctl + q, 0xffffffffu);  // one push consumed
      *(volatile unsigned*)(a.ctl + CTL_EPOCH) = epoch + 1u;
    }
  }
}

typedef CUresult (*BatchMemOpFn)(CUstream, unsigned int, CUstreamBatchMemOpParams*, unsigned int);
static BatchMemOpFn g_batch = nullptr;

static cudaError_t memops() {
  if (g_batch) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t e =
      cudaGetDriverEntryPointByVersion("cuStreamBatchMemOp", &p, 12000, cudaEnableDefault, &status);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuStreamBatchMemOp", &p, cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess) return e;
  if (status != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
  g_batch = reinterpret_cast<BatchMemOpFn>(p);
  return cudaSuccess;
}

// Every same-host peer's wait, ready[q] >= 1, as one batch of stream
// memory operations (the comparison is cyclic: (int)(ready - 1) >= 0); a
// peer on another host (bit q of `remote`) raised nothing here, its
// chunks come by the exchange earlier in the stream.  A failed batch
// comes back as 999 (cudaErrorUnknown): the wrapper tests for non-zero.
static int wait_peers(cudaStream_t s, unsigned* ctl, int nproc, int me, long long remote) {
  CUstreamBatchMemOpParams ops[RT_MAX_PROCS];
  memset(ops, 0, sizeof(ops));
  int n = 0;
  for (int q = 0; q < nproc; ++q)
    if (q != me && !((remote >> q) & 1)) {
      ops[n].waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_32;
      ops[n].waitValue.address = reinterpret_cast<CUdeviceptr>(ctl + q);
      ops[n].waitValue.value = 1;
      ops[n].waitValue.flags = CU_STREAM_WAIT_VALUE_GEQ;
      ++n;
    }
  if (n == 0) return 0;
  return g_batch(reinterpret_cast<CUstream>(s), n, ops, 0) == CUDA_SUCCESS ? 0 : 999;
}

// The copy-in: the chunks the exchange received from the other-host peers
// (wire order: peer k, then its runs along (m, lt, r), then the run's
// words) into buffer epoch & 1 of this process's slab, where the copy-out
// reads them as it reads a same-host peer's pushed chunks.  The epoch is
// read on the card, so a captured graph replays it unchanged.  The
// received words lie in mapped pinned host memory that the host wrote
// since the last replay: they are read past every cache (ld.global.cv).
struct CopyInArgs {
  const void* recv;
  void* slab;
  const unsigned* ctl;
  unsigned buf;   // words from a slab's buffer 0 to its buffer 1
  unsigned n;     // words, every peer's
  unsigned wire;  // words from one peer
  unsigned run;   // words a run
  unsigned nr;    // runs along r (c for x -> y, 1 for y -> x)
  unsigned pl;
  int dsm, blk, d1;            // the slab's member, rank-block and row strides, words
  int base[RT_MAX_PROCS];      // peer k's first run in a buffer, words
};

template <int BYTES>
__global__ void __launch_bounds__(RT_THREADS) copy_in_kernel(const CopyInArgs a) {
  using W = typename Word<BYTES>::type;
  const unsigned epoch = *(volatile const unsigned*)(a.ctl + CTL_EPOCH);
  W* slab = static_cast<W*>(a.slab) + (epoch & 1u) * a.buf;
  const W* recv = static_cast<const W*>(a.recv);
  for (unsigned g = blockIdx.x * RT_THREADS + threadIdx.x; g < a.n; g += gridDim.x * RT_THREADS) {
    const unsigned k = g / a.wire, rem = g - k * a.wire;
    const unsigned run = rem / a.run, e = rem - run * a.run;
    const unsigned ml = run / a.nr, r = run - ml * a.nr;
    const unsigned m = ml / a.pl, lt = ml - m * a.pl;
    slab[a.base[k] + (int)m * a.dsm + (int)lt * a.blk + (int)r * a.d1 + (int)e] =
        __ldcv(recv + g);
  }
}

static int launch_copy_in(int word, const CopyInArgs& a, cudaStream_t stream) {
  long long blocks = ((long long)a.n + RT_THREADS - 1) / RT_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (word == 4)
    copy_in_kernel<4><<<(int)blocks, RT_THREADS, 0, stream>>>(a);
  else if (word == 8)
    copy_in_kernel<8><<<(int)blocks, RT_THREADS, 0, stream>>>(a);
  else
    copy_in_kernel<16><<<(int)blocks, RT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

static bool fits(long long mul, int shr) { return mul >= 0 && mul < (1LL << 32) && shr >= 0 && shr <= 31; }

template <int BYTES, bool X2Y>
static int launch_kernel(const PushArgs& a, unsigned words, cudaStream_t stream) {
  long long blocks = ((long long)words + RT_THREADS * RT_UNROLL - 1) / (RT_THREADS * RT_UNROLL);
  if (blocks < 1) blocks = 1;
  ring_push_kernel<BYTES, X2Y><<<(int)blocks, RT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BYTES>
static int launch_bytes_push(const PushArgs& a, bool x_to_y, unsigned words, cudaStream_t stream) {
  return x_to_y ? launch_kernel<BYTES, true>(a, words, stream)
                : launch_kernel<BYTES, false>(a, words, stream);
}

static int launch_word(int word, const PushArgs& a, bool x_to_y, unsigned words,
                       cudaStream_t stream) {
  if (word == 4) return launch_bytes_push<4>(a, x_to_y, words, stream);
  if (word == 8) return launch_bytes_push<8>(a, x_to_y, words, stream);
  return launch_bytes_push<16>(a, x_to_y, words, stream);
}

template <int ELEM>
int launch_push(const RpPush* f, cudaStream_t stream) {
  if (f == nullptr || f->P < 1 || f->PL < 1 || f->P % f->PL || f->P > RT_MAX_RANKS ||
      f->nproc != f->P / f->PL || f->nproc < 2 || f->nproc > RT_MAX_PROCS || f->me < 0 ||
      f->me >= f->nproc || f->g0 != f->me * f->PL || f->c < 1 || f->w < 1 || f->members < 1 ||
      (f->x_to_y != 0 && f->x_to_y != 1) || f->parts < 0 || f->parts > PUSH_ALL || f->word % ELEM ||
      (f->word != 4 && f->word != 8 && f->word != 16) || !fits(f->mul_w, f->shr_w) ||
      !fits(f->mul_c, f->shr_c) || !fits(f->mul_p, f->shr_p) || !fits(f->mul_l, f->shr_l) ||
      !fits(f->mul_r, f->shr_r) || f->ctl == nullptr || f->slab == nullptr || f->out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long nv = f->word / ELEM;
  if (f->w % nv || f->is0 % nv || f->is1 % nv || f->ism % nv || f->d1 % nv || f->dsm % nv ||
      f->blk % nv || f->buf_bytes % f->word || reinterpret_cast<uintptr_t>(f->in) % f->word ||
      reinterpret_cast<uintptr_t>(f->out) % f->word ||
      reinterpret_cast<uintptr_t>(f->slab) % f->word)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < f->P; ++t)
    if (f->dst[t] == nullptr || reinterpret_cast<uintptr_t>(f->dst[t]) % f->word)
      return (int)cudaErrorInvalidValue;
  for (int q = 0; q < f->nproc; ++q)
    if (q != f->me && f->ready_peer[q] == nullptr) return (int)cudaErrorInvalidValue;
  // peers on other hosts: the exchange's function, plan and epoch word and
  // the received chunks, all or none; never this process, never past nproc
  const bool hx = f->remote != 0;
  if ((f->remote >> f->me) & 1 || f->remote < 0 || (f->remote >> f->nproc) != 0 ||
      hx != (f->hx_fn != nullptr) || hx != (f->hx_plan != nullptr) ||
      hx != (f->hx_epoch != nullptr) || hx != (f->recv != nullptr) ||
      reinterpret_cast<uintptr_t>(f->recv) % f->word)
    return (int)cudaErrorInvalidValue;
  const long long wv = f->w / nv;
  const long long n = (long long)f->members * f->PL * f->P * f->c * wv;
  const long long ncopy = (long long)f->members * f->PL * (f->P - f->PL) * f->c * wv;
  const long long lim = 1LL << 31;
  const long long rows_in = f->x_to_y ? (long long)f->P * f->c : f->c;
  const long long cols_in = f->x_to_y ? wv : (long long)f->P * wv;
  const long long rows_out = f->x_to_y ? f->c : (long long)f->P * f->c;
  const long long cols_out = f->x_to_y ? (long long)f->P * wv : wv;
  if (n >= lim ||
      span(f->members, f->ism / nv, f->PL, f->is0 / nv, rows_in, f->is1 / nv, cols_in) >= lim ||
      f->blk < rows_out * f->d1 || f->d1 < cols_out * nv ||
      (f->members > 1 && f->dsm < f->PL * f->blk) ||
      f->buf_bytes / f->word + span(f->members, f->dsm / nv, f->PL, f->blk / nv, rows_out,
                                    f->d1 / nv, cols_out) >= lim)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = memops();
  if (e != cudaSuccess) return (int)e;
  PushArgs a;
  a.in = f->in;
  a.out = f->out;
  a.slab = f->slab;
  for (int t = 0; t < RT_MAX_RANKS; ++t) a.dst[t] = t < f->P ? f->dst[t] : nullptr;
  a.ctl = f->ctl;
  for (int q = 0; q < RT_MAX_PROCS; ++q)
    a.ready_peer[q] = q < f->nproc ? f->ready_peer[q] : nullptr;
  a.n = (unsigned)n;
  a.ncopy = (unsigned)ncopy;
  a.buf = (unsigned)(f->buf_bytes / f->word);
  a.wv = {(unsigned)wv, (unsigned)f->mul_w, (unsigned)f->shr_w};
  a.c = {(unsigned)f->c, (unsigned)f->mul_c, (unsigned)f->shr_c};
  a.p = {(unsigned)f->P, (unsigned)f->mul_p, (unsigned)f->shr_p};
  a.pl = {(unsigned)f->PL, (unsigned)f->mul_l, (unsigned)f->shr_l};
  a.r = {(unsigned)(f->P - f->PL), (unsigned)f->mul_r, (unsigned)f->shr_r};
  a.g0 = f->g0;
  a.nproc = f->nproc;
  a.me = f->me;
  a.is0 = (int)(f->is0 / nv);
  a.is1 = (int)(f->is1 / nv);
  a.ism = f->members > 1 ? (int)(f->ism / nv) : 0;
  a.d1 = (int)(f->d1 / nv);
  a.dsm = f->members > 1 ? (int)(f->dsm / nv) : 0;
  a.blk = (int)(f->blk / nv);
  const bool x2y = f->x_to_y != 0;
  const int parts = f->parts;
  // the push and its signal, the peers' waits in the card's front end,
  // the copy-out and the release
  int rc = 0;
  if (parts & (PUSH_DATA | PUSH_SIGNAL)) {
    a.parts = parts & (PUSH_DATA | PUSH_SIGNAL);
    rc = launch_word(f->word, a, x2y, (parts & PUSH_DATA) ? a.n : 0, stream);
  }
  if (hx && !rc && (parts & PUSH_EXCHANGE)) {
    // the epoch names the staging buffer the push wrote: the host function
    // reads its copy, then sends and receives
    rc = (int)cudaMemcpyAsync(f->hx_epoch, f->ctl + CTL_EPOCH, sizeof(unsigned),
                              cudaMemcpyDeviceToHost, stream);
    if (!rc) rc = (int)cudaLaunchHostFunc(stream, reinterpret_cast<cudaHostFn_t>(f->hx_fn),
                                          f->hx_plan);
  }
  if (hx && !rc && (parts & PUSH_COPY_IN)) {
    CopyInArgs ci;
    memset(&ci, 0, sizeof(ci));
    const bool x2y_run = f->x_to_y != 0;
    const long long run = x2y_run ? (long long)f->PL * wv : (long long)f->PL * f->c * wv;
    const long long nr = x2y_run ? f->c : 1;
    const long long wire = (long long)f->members * f->PL * nr * run;
    int k = 0;
    for (int q = 0; q < f->nproc; ++q)
      if ((f->remote >> q) & 1)
        ci.base[k++] = (int)(x2y_run ? (long long)q * f->PL * wv : (long long)q * f->PL * f->c * wv);
    if (!x2y_run && f->d1 != f->w) return (int)cudaErrorInvalidValue;  // a block a run
    ci.recv = f->recv;
    ci.slab = const_cast<void*>(f->slab);
    ci.ctl = f->ctl;
    ci.buf = a.buf;
    ci.n = (unsigned)(k * wire);
    ci.wire = (unsigned)wire;
    ci.run = (unsigned)run;
    ci.nr = (unsigned)nr;
    ci.pl = (unsigned)f->PL;
    ci.dsm = a.dsm;
    ci.blk = a.blk;
    ci.d1 = a.d1;
    rc = launch_copy_in(f->word, ci, stream);
  }
  if (!rc && (parts & PUSH_WAIT)) rc = wait_peers(stream, f->ctl, f->nproc, f->me, f->remote);
  if (!rc && (parts & (PUSH_COPY | PUSH_RELEASE))) {
    a.parts = parts & (PUSH_COPY | PUSH_RELEASE);
    rc = launch_word(f->word, a, x2y, (parts & PUSH_COPY) ? a.ncopy : 0, stream);
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

// The receive slabs.  A slab is two buffers of `data_bytes` (a multiple
// of 256) and then RT_CTL_BYTES of control words, all zero at the start
// (no push pending, epoch 0); the call returns when that is on the card,
// so the handle may go to the peers at once.

extern "C" int rp_slab_alloc(long long data_bytes, void** ptr, void* handle) {
  if (data_bytes < 0 || data_bytes % 256 || ptr == nullptr || handle == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)data_bytes + RT_CTL_BYTES;
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(p, 0, bytes);
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

// Pinned host memory the card maps (an other-host peer's staging, the
// received chunks and the epoch's copy): `bytes` zeroed, its host address
// and the card's address of it.
extern "C" int rp_host_alloc(long long bytes, void** host, void** dev) {
  if (bytes <= 0 || host == nullptr || dev == nullptr) return (int)cudaErrorInvalidValue;
  void* h = nullptr;
  cudaError_t e = cudaHostAlloc(&h, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  memset(h, 0, (size_t)bytes);
  void* d = nullptr;
  e = cudaHostGetDevicePointer(&d, h, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(h);
    return (int)e;
  }
  *host = h;
  *dev = d;
  return 0;
}

extern "C" int rp_host_free(void* host) { return (int)cudaFreeHost(host); }

// A timeline mark: one thread writes the card's global timer (ns) into
// stamps[index] when the stream reaches it (chip_smoke.py's split of a
// remote flip, between the operations of a captured flip).
__global__ void stamp_kernel(unsigned long long* stamps, int index) {
  stamps[index] = rp::global_ns();
}

extern "C" int rp_stamp(void* stamps, int index, void* stream) {
  if (stamps == nullptr || index < 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(stamps), index);
  return (int)cudaGetLastError();
}
