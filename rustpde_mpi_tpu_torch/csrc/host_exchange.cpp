// The remote pencil flip across hosts: its socket exchange, on the host.
//
// Part of the port of the Pallas TPU kernel rustpde_mpi_tpu/parallel/
// decomp.py `_ring_transpose_kernel` (its remote copies between chips,
// `pltpu.make_async_remote_copy`), whose card side is csrc/ring_transpose.cu
// `ring_push_kernel`.  Within a host a remote flip pushes each chunk card to
// card through CUDA IPC.  No card can write another host's memory (no
// GPUDirect RDMA, no NVSHMEM), so the chunks for a process on another host
// go card -> pinned host memory -> TCP -> pinned host memory -> card, as
// the JAX package's DCN traffic passes through its hosts:
//
//  1. the push launch writes them, as it writes a same-host peer's slab,
//     into this process's staging for that peer: pinned host memory
//     (cudaHostAllocMapped) laid out as the peer's receive slab, two
//     buffers, the flip's epoch naming the buffer;
//  2. the card copies the slab's epoch into a pinned word, and then
//     hx_exchange below runs as a host function on the stream
//     (cudaLaunchHostFunc): it sends this process's runs of each
//     other-host peer's staging and receives theirs into pinned receive
//     memory, in the wire order (m, lt, r) of the runs;
//  3. the copy-in launch (ring_transpose.cu `copy_in_kernel`) reads the
//     epoch on the card and scatters the received runs into buffer
//     epoch & 1 of this process's slab, where the copy-out reads every
//     peer's chunks.
// So a chunk runner captures the exchange into the step's graph as a host
// node like any other operation, and the step stays one graph replay.
//
// This file includes no CUDA header and makes no CUDA call (CUDA forbids
// them inside a host function).  ops/_build.py builds it with nvcc on the
// card and with the system C++ compiler where there is none, so the CPU
// tests drive the very exchange the card runs (on the CPU the port calls
// hx_run itself, between host tensors).
//
// The wire: for each exchange, to each peer, a 24-byte header (magic, the
// slab's key, the plan's exchange count) and then the runs; a header that
// differs from the one expected fails the exchange (the processes ran
// different flips).  Runs are fixed by the plan: along (m, lt, r),
// count0 x count1 x count2 runs of run_bytes at base + m*stride0 +
// lt*stride1 + r*stride2 of the staging buffer; x -> y sends a run a row
// of each destination rank's block (PL*w elements), y -> x a run a block.
//
// Things it does about what can go wrong:
//  * no send-before-receive deadlock: every socket is non-blocking and one
//    poll() loop interleaves the sends and receives to every peer, so two
//    processes that each send megabytes never stall on full socket
//    buffers;
//  * a peer that is gone must not wedge the process: the host function
//    holds CUDA's callback thread, so the exchange waits in poll() slices
//    of at most HX_SLICE_MS, and ends on its deadline (the seconds
//    *timeout_s points at, multihost.set_sync_timeout's, read at each
//    exchange), on a peer's closed connection, or on hx_abort (the ring's
//    release_waits, which the resilient runner's DispatchHang calls), which
//    also shuts the sockets down; a failure is kept (hx_error) and fails
//    every later exchange of the links at once, and the caller discards
//    what the stream computed after it (the stream runs on with stale
//    chunks, as after a release of the IPC waits);
//  * SIGPIPE is never raised (MSG_NOSIGNAL).
//
// Bound: the remote bytes over the link.  Each process sends its wire
// bytes to each other-host peer and receives as many; the card's share is
// two passes over PCIe (the push's writes into the mapped staging, the
// copy-in's reads of the mapped receive memory) at the measured pinned-copy
// rate; between two processes of one machine the link is the loopback
// socket.
#include <poll.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <fcntl.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#define HX_MAX_PEERS 16  // RT_MAX_PROCS of csrc/ring_transpose.cu
#define HX_SLICE_MS 50   // the longest poll() between checks of a release
#define HX_IOV 64        // runs one sendmsg() hands the kernel

namespace {

constexpr uint32_t HX_MAGIC = 0x31465848u;  // "HXF1"

// Error codes of hx_run (0: the exchange completed).
enum { HX_OK = 0, HX_EFAILED = 1, HX_ERELEASED = 2, HX_EDEADLINE = 3, HX_EPEER = 4,
       HX_EDESYNC = 5, HX_EARGS = 6 };

struct Links {
  int nproc, me;
  int fd[HX_MAX_PEERS];             // a connected socket to process q, or -1
  const double* timeout_s;          // the deadline of an exchange, seconds
  std::atomic<int> released;
  std::atomic<int> failed;          // the first failure's code, 0 while none
  char error[256];
};

struct Header {
  uint32_t magic, key;
  uint64_t seq;
  uint64_t bytes;
};
static_assert(sizeof(Header) == 24, "a header is 24 bytes");

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

void shut_all(Links* l) {
  for (int q = 0; q < l->nproc; ++q)
    if (l->fd[q] >= 0) shutdown(l->fd[q], SHUT_RDWR);
}

// Keep the first failure, shut every socket down (so the peers' exchanges
// fail at once too) and return the failure's code.
int fail(Links* l, int code, const char* what, int q) {
  int expected = 0;
  if (l->failed.compare_exchange_strong(expected, -1)) {
    snprintf(l->error, sizeof(l->error), "%s (process %d, peer %d)", what, l->me, q);
    l->failed.store(code);
    shut_all(l);
  }
  return code;
}

}  // namespace

// Mirror of rustpde_mpi_tpu_torch/ops/host_exchange.py `HxPlan`: one
// (shape, dtype, direction) of flip of a ring whose peers include
// processes on other hosts.  Addresses are host addresses.
struct HxPlan {
  void* links;                     // hx_open's links of the ring
  void* epoch;                     // int32: the flip's epoch, copied from the card
  void* send[HX_MAX_PEERS];        // staging buffer 0 for peer k
  void* recv[HX_MAX_PEERS];        // where peer k's runs land, wire_bytes
  long long buf_bytes;             // staging buffer 0 -> buffer 1
  long long base;                  // staging start -> this process's first run
  long long run_bytes;             // bytes a run
  long long stride0, stride1, stride2;  // bytes between runs along (m, lt, r)
  long long wire_bytes;            // bytes each way to each peer
  long long seq;                   // exchanges made with this plan
  int count0, count1, count2;      // runs along (m, lt, r)
  int npeer;                       // other-host peers
  int peer[HX_MAX_PEERS];          // process of peer k
  int key;                         // the slab's key, alike on every process
};

namespace {

struct Side {
  // send: the header, then the runs from (run, off); recv: the header,
  // then wire_bytes
  size_t hsent = 0, run = 0, off = 0, hgot = 0, got = 0;
  Header out, in;
};

int exchange(HxPlan* p) {
  Links* l = static_cast<Links*>(p->links);
  if (l == nullptr || p->npeer < 1 || p->npeer > HX_MAX_PEERS || p->run_bytes < 0 ||
      p->count0 < 0 || p->count1 < 0 || p->count2 < 0)
    return HX_EARGS;
  if (l->failed.load() != 0) return HX_EFAILED;
  if (l->released.load()) return fail(l, HX_ERELEASED, "the exchange was released", -1);
  const double timeout = l->timeout_s != nullptr ? *l->timeout_s : 0.0;
  const double deadline = timeout > 0.0 ? now_s() + timeout : 1e300;
  const int epoch = *static_cast<volatile int*>(p->epoch);
  const size_t nrun = (size_t)p->count0 * p->count1 * p->count2;
  const size_t wire = (size_t)p->wire_bytes;
  if (nrun * (size_t)p->run_bytes != wire) return HX_EARGS;
  Side side[HX_MAX_PEERS];
  for (int k = 0; k < p->npeer; ++k) {
    const int q = p->peer[k];
    if (q < 0 || q >= l->nproc || l->fd[q] < 0) return fail(l, HX_EARGS, "no link", q);
    side[k].out = {HX_MAGIC, (uint32_t)p->key, (uint64_t)p->seq, (uint64_t)wire};
  }
  p->seq += 1;
  const size_t hb = sizeof(Header);
  for (;;) {
    pollfd fds[HX_MAX_PEERS];
    int idx[HX_MAX_PEERS];
    int n = 0;
    for (int k = 0; k < p->npeer; ++k) {
      Side& s = side[k];
      const bool sending = s.hsent < hb || s.run < nrun;
      const bool receiving = s.hgot < hb || s.got < wire;
      if (!sending && !receiving) continue;
      fds[n] = {l->fd[p->peer[k]], (short)((sending ? POLLOUT : 0) | (receiving ? POLLIN : 0)),
                0};
      idx[n++] = k;
    }
    if (n == 0) return HX_OK;
    if (l->released.load()) return fail(l, HX_ERELEASED, "the exchange was released", -1);
    const double left = deadline - now_s();
    if (left <= 0.0) return fail(l, HX_EDEADLINE, "the exchange passed its deadline", -1);
    const int wait_ms = left * 1e3 < HX_SLICE_MS ? (int)(left * 1e3) + 1 : HX_SLICE_MS;
    const int rc = poll(fds, n, wait_ms);
    if (rc < 0) {
      if (errno == EINTR) continue;
      return fail(l, HX_EPEER, "poll failed", -1);
    }
    if (l->released.load()) return fail(l, HX_ERELEASED, "the exchange was released", -1);
    for (int i = 0; i < n; ++i) {
      const int k = idx[i], q = p->peer[k], fd = fds[i].fd;
      Side& s = side[k];
      const short ev = fds[i].revents;
      if (ev & POLLNVAL) return fail(l, HX_EPEER, "a closed socket", q);
      if (ev & (POLLIN | POLLHUP | POLLERR)) {
        if (s.hgot < hb || s.got < wire) {
          char* dst = s.hgot < hb ? reinterpret_cast<char*>(&s.in) + s.hgot
                                  : static_cast<char*>(p->recv[k]) + s.got;
          const size_t want = s.hgot < hb ? hb - s.hgot : wire - s.got;
          const ssize_t got = recv(fd, dst, want, 0);
          if (got == 0) return fail(l, HX_EPEER, "the peer closed its connection", q);
          if (got < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
            return fail(l, HX_EPEER, "a receive failed", q);
          if (got > 0) {
            if (s.hgot < hb) {
              s.hgot += (size_t)got;
              if (s.hgot == hb && (s.in.magic != HX_MAGIC || s.in.key != s.out.key ||
                                   s.in.seq != s.out.seq || s.in.bytes != s.out.bytes))
                return fail(l, HX_EDESYNC, "the peer's flip differs from this one", q);
            } else {
              s.got += (size_t)got;
            }
          }
        } else {
          return fail(l, HX_EPEER, "the peer's connection broke", q);
        }
      }
      if ((ev & POLLOUT) && (s.hsent < hb || s.run < nrun)) {
        iovec iov[HX_IOV];
        int m = 0;
        if (s.hsent < hb)
          iov[m++] = {reinterpret_cast<char*>(&s.out) + s.hsent, hb - s.hsent};
        const char* buf = static_cast<const char*>(p->send[k]) +
                          (size_t)(epoch & 1) * (size_t)p->buf_bytes + p->base;
        size_t r = s.run, off = s.off;
        for (; m < HX_IOV && r < nrun; ++r, off = 0) {
          const size_t i2 = r % p->count2, t = r / p->count2;
          const size_t i1 = t % p->count1, i0 = t / p->count1;
          const char* at = buf + i0 * p->stride0 + i1 * p->stride1 + i2 * p->stride2;
          iov[m++] = {const_cast<char*>(at) + off, (size_t)p->run_bytes - off};
        }
        msghdr msg;
        memset(&msg, 0, sizeof(msg));
        msg.msg_iov = iov;
        msg.msg_iovlen = m;
        const ssize_t sent = sendmsg(fd, &msg, MSG_NOSIGNAL | MSG_DONTWAIT);
        if (sent < 0) {
          if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
            return fail(l, HX_EPEER, "a send failed", q);
          continue;
        }
        size_t left_sent = (size_t)sent;
        if (s.hsent < hb) {
          const size_t h = left_sent < hb - s.hsent ? left_sent : hb - s.hsent;
          s.hsent += h;
          left_sent -= h;
        }
        while (left_sent > 0 && s.run < nrun) {
          const size_t rest = (size_t)p->run_bytes - s.off;
          if (left_sent >= rest) {
            left_sent -= rest;
            s.run += 1;
            s.off = 0;
          } else {
            s.off += left_sent;
            left_sent = 0;
          }
        }
      }
    }
  }
}

}  // namespace

// The links of one ring: `fds[q]` a connected stream socket to process q
// (the links take it over), -1 where there is none; `timeout_s` the
// address of the exchange's deadline in seconds (0 or less: none).
extern "C" void* hx_open(int nproc, int me, const int* fds, const double* timeout_s) {
  if (nproc < 1 || nproc > HX_MAX_PEERS || me < 0 || me >= nproc || fds == nullptr) return nullptr;
  Links* l = new Links();
  l->nproc = nproc;
  l->me = me;
  l->timeout_s = timeout_s;
  l->released.store(0);
  l->failed.store(0);
  l->error[0] = 0;
  for (int q = 0; q < HX_MAX_PEERS; ++q) l->fd[q] = q < nproc ? fds[q] : -1;
  for (int q = 0; q < nproc; ++q) {
    if (l->fd[q] < 0) continue;
    const int flags = fcntl(l->fd[q], F_GETFL, 0);
    fcntl(l->fd[q], F_SETFL, flags | O_NONBLOCK);
    const int one = 1;
    setsockopt(l->fd[q], IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return l;
}

// One exchange of `plan` (the host function's body; the CPU path calls it
// itself): 0 when every peer's runs arrived, else the failure's code,
// which hx_error then describes.
extern "C" int hx_run(void* plan) {
  return plan == nullptr ? HX_EARGS : exchange(static_cast<HxPlan*>(plan));
}

// The host function a captured flip launches (cudaLaunchHostFunc's
// signature): hx_run, its failure kept in the links (hx_error).
extern "C" void hx_exchange(void* plan) { hx_run(plan); }

// Let a stalled exchange go and fail every later one at once: the ring's
// release (any thread may call it, an exchange in flight included).
extern "C" int hx_abort(void* links) {
  Links* l = static_cast<Links*>(links);
  if (l == nullptr) return HX_EARGS;
  l->released.store(1);
  shut_all(l);
  return 0;
}

// The links' failure: 0 while none, else its code, and its text in `buf`.
extern "C" int hx_error(void* links, char* buf, int n) {
  Links* l = static_cast<Links*>(links);
  if (l == nullptr) return HX_EARGS;
  int code = l->failed.load();
  if (code == 0 && l->released.load()) code = HX_ERELEASED;
  if (buf != nullptr && n > 0) {
    if (code > 0 && l->error[0])
      snprintf(buf, (size_t)n, "%s", l->error);
    else if (code == HX_ERELEASED)
      snprintf(buf, (size_t)n, "the exchange was released (process %d)", l->me);
    else
      buf[0] = 0;
  }
  return code < 0 ? 0 : code;
}

// Close the sockets and free the links (no exchange may run on them).
extern "C" int hx_close(void* links) {
  Links* l = static_cast<Links*>(links);
  if (l == nullptr) return HX_EARGS;
  for (int q = 0; q < l->nproc; ++q)
    if (l->fd[q] >= 0) close(l->fd[q]);
  delete l;
  return 0;
}
