// libtpudcn — the native host data plane (btl/sm + btl/tcp + bml/r2 +
// the pml matching fast path, in C++).
//
// The port's own copy of the reference's native/src/dcn.cc: the wire,
// the TdcnMsg/TdcnStats layouts and the tdcn_* C surface are the
// reference's, unchanged, so a port process and a reference process
// meet on one wire.  ompi_tpu_torch/native.py builds it at first use
// into build/ompi_tpu_torch/libtpudcn.so; ompi_tpu_torch/dcn/native.py
// drives it.
//
// ≈ the reference's opal/mca/btl/{tcp,sm} + bml/r2 byte movers and the
// hot half of pml/ob1's matching engine (SURVEY.md §2.2/§2.3: the
// native-required rows — "shared-memory & TCP transports", progress
// engine, request engine).  The Python side keeps the CONTROL plane
// (MCA selection, rendezvous policy, communicator bookkeeping, ULFM
// decisions); every byte and every matching decision on the critical
// path happens here, so a blocked receiver sleeps in C on a condition
// variable and is woken by the C receiver thread — zero Python (and
// zero GIL) between wire and wakeup.
//
// Transports per peer (chosen by host identity, as bml/r2 does):
//   * same host  — one shared-memory SPSC byte ring per direction
//     (8-byte-aligned length-prefixed records, chunked streaming for
//     payloads larger than the ring, futex doorbell wakeups): the
//     mmap FIFO of the reference's btl/sm without its per-frame
//     socket syscalls;
//   * cross host — framed TCP with eager/rendezvous (RTS/CTS/FRAG)
//     exactly like the Python transport, but framed/parsed natively.
//
// Delivery classes (the `kind` byte):
//   COLL — (cid, seq, src)-keyed one-shot slots; tdcn_recv_coll blocks
//          on the slot's condvar (the DCN collective schedules);
//   P2P  — the native matching engine: per-(cid, dst-rank) posted /
//          unexpected queues, ANY_SOURCE/ANY_TAG wildcards, strict
//          arrival-order (non-overtaking) matching; local (same
//          process) sends enter the same queues as handle references
//          so wildcard matching is total-ordered across local+remote;
//   PY   — JSON-enveloped frames for the Python dispatcher thread
//          (heartbeats, ULFM gossip/revoke, OSC RMA envelopes, and
//          any communicator whose pml is interposed by monitoring /
//          vprotocol — full compatibility, lower priority).
//
// Cited reference behaviors: lazy connect on first send
// (mca_btl_tcp_add_procs), receiver-thread delivery (the libevent
// progress loop), eager↔rendezvous switch with CTS flow control
// (pml/ob1 over btl_tcp), single-copy shared-memory rings (btl/sm +
// smsc), per-peer transport scheduling (bml/r2).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <malloc.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------
// wire format
// ---------------------------------------------------------------------

enum FrameType : uint8_t {
  FT_EAGER = 0,
  FT_RTS = 1,
  FT_CTS = 2,
  FT_FRAG = 3,
  FT_SETUP = 4,  // announces the sender's shm ring (same-host peers)
};

enum FrameKind : uint8_t { FK_COLL = 0, FK_P2P = 1, FK_PY = 2 };

static const uint32_t TDCN_MAGIC = 0x7444434eu;  // "tDCN"

#pragma pack(push, 1)
struct WireHdr {
  uint32_t magic;
  uint8_t type;
  uint8_t kind;
  uint8_t dtype_len;  // <= 15
  uint8_t ndim;       // <= 8
  int32_t src, dst, tag;
  int32_t from_proc;  // sender's engine index (peer bookkeeping)
  int64_t seq;        // coll sequence / rendezvous xid
  uint64_t off;       // FRAG payload offset
  uint64_t total;     // full payload bytes (RTS/FRAG reassembly)
  uint64_t nbytes;    // payload bytes IN THIS FRAME
  uint64_t order;     // ring-path ordered-delivery tag (streaming send
                      // engine): nonzero on records whose DELIVERY must
                      // respect per-peer issue order even though the
                      // sender thread interleaves their FRAGs
  uint16_t cid_len;
  uint16_t pad;
  uint32_t meta_len;
};
#pragma pack(pop)

static_assert(sizeof(WireHdr) == 72, "wire header is 72 bytes");

// Causal-tracing wire context (ompi_tpu_torch/trace/causal.py): a compact
// versioned tuple [v, comm, op, seq, hop] stamped per collective
// frame when `--mca trace_causal 1` is armed.  On this plane it rides
// the frame's META region (the same vehicle as the device-plane
// window descriptor), so WireHdr stays frozen at 72 bytes and a
// DISABLED run's frames are byte-identical to a build without causal
// tracing — the zero-wire-bytes contract.  The field table below is
// the C mirror of trace/causal.py:CTX_FIELDS; tpucheck's
// wire-ctx-drift pass holds both sides equal, append-only, with the
// v1 prefix frozen (the TDCN_STAT_NAMES contract applied to the
// wire context).
#define TDCN_TRACE_CTX_VERSION 1
static const char *TDCN_TRACE_CTX_FIELDS =
    "v,comm,op,"
    "seq,hop";

// The C <-> Python message record (ctypes mirror in dcn/native.py).
#pragma pack(push, 1)
struct TdcnMsg {
  int32_t kind, src, dst, tag;
  int64_t seq;
  uint64_t pyhandle;  // nonzero: payload lives in the Python table
  void *data;         // malloc'd payload (caller frees via tdcn_free)
  uint64_t nbytes;
  int64_t count;  // element count for pyhandle messages (status)
  char dtype[16];
  int32_t ndim;
  int64_t shape[8];
  char cid[128];
  void *meta;  // malloc'd JSON bytes or NULL
  uint32_t meta_len;
};
#pragma pack(pop)

// ---------------------------------------------------------------------
// small utilities
// ---------------------------------------------------------------------

static int futex_wait(std::atomic<uint32_t> *addr, uint32_t expect,
                      const struct timespec *ts) {
  return (int)syscall(SYS_futex, (uint32_t *)addr, FUTEX_WAIT, expect, ts,
                      nullptr, 0);
}

static int futex_wake(std::atomic<uint32_t> *addr, int n) {
  return (int)syscall(SYS_futex, (uint32_t *)addr, FUTEX_WAKE, n, nullptr,
                      nullptr, 0);
}

static uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Timed cv wait that stays TSan-visible.  libstdc++'s steady-clock
// wait_for compiles to pthread_cond_clockwait, which gcc-10's libtsan
// does NOT intercept — TSan then misses the unlock inside the wait
// and reports phantom double-locks/inversions/races on everything the
// mutex guards.  Under -fsanitize=thread, wait on the system clock
// instead (pthread_cond_timedwait, intercepted); elsewhere keep the
// monotonic wait (immune to wall-clock jumps).
template <class Pred>
static bool cv_wait_for(std::condition_variable &cv,
                        std::unique_lock<std::mutex> &lk, double seconds,
                        Pred pred) {
#if defined(__SANITIZE_THREAD__)
  return cv.wait_until(
      lk,
      std::chrono::system_clock::now() +
          std::chrono::duration_cast<std::chrono::system_clock::duration>(
              std::chrono::duration<double>(seconds)),
      pred);
#else
  return cv.wait_for(lk, std::chrono::duration<double>(seconds), pred);
#endif
}

// ---------------------------------------------------------------------
// transport telemetry (the native half of ompi_tpu_torch/metrics/)
// ---------------------------------------------------------------------
//
// ≈ the reference's SPC counters (ompi_spc.c) applied to the transport
// plane the Python tracer cannot see: every counter is one relaxed
// atomic on the hot path, no syscalls, no locks.  The block is
// versioned (slot 0) so the Python ctypes reader can validate layout,
// and cache-line-aligned so the counters never false-share with the
// engine's mutex-protected state.  Readers (tdcn_stats) copy the live
// words — monotone but not mutually consistent, which is all a
// telemetry snapshot needs.

#define TDCN_STATS_VERSION 1

enum TdcnStatIdx {
  TS_VERSION = 0,        // layout version stamp (TDCN_STATS_VERSION)
  TS_DOORBELLS,          // futex doorbell rings (tx ring + completion wakeups)
  TS_STALL_NS,           // total send-side stall ns (ring + CTS + rndv slot)
  TS_RING_STALL_NS,      // ns blocked in ShmRing::reserve on backpressure
  TS_RING_STALLS,        // reserve() calls that could not satisfy first try
  TS_RING_HWM,           // tx ring occupancy high-water (bytes)
  TS_CTS_WAIT_NS,        // ns between RTS sent and CTS granted (tcp rndv)
  TS_CTS_WAITS,          // rendezvous sends that waited for CTS
  TS_RNDV_DEPTH,         // inbound rendezvous transfers in flight (gauge)
  TS_RNDV_HWM,           // high-water of TS_RNDV_DEPTH
  TS_SLOT_WAITS,         // inbound RTS that blocked on a full rndv slot table
  TS_EAGER_MSGS,         // single-frame sends (ring records + tcp eager)
  TS_EAGER_BYTES,
  TS_CHUNKED_MSGS,       // ring chunked-streaming transfers (RTS + FRAGs)
  TS_CHUNKED_BYTES,
  TS_RNDV_MSGS,          // tcp rendezvous transfers (RTS/CTS/FRAG)
  TS_RNDV_BYTES,
  TS_DELIVERED,          // complete inbound messages handed to matching
  TS_UNEXPECTED_HWM,     // unexpected-queue depth high-water (one cid+dst)
  // -- robustness tail (appended; version stays 1 — append-only) ------
  TS_RECONNECTS,         // peer connections re-established after death
  TS_RETRY_DIALS,        // backoff dial attempts beyond the first
  TS_RETRY_SENDS,        // sends retried after invalidating a dead peer
  TS_DEADLINE_EXPIRED,   // blocking waits that ran out their dcn_*_timeout
  TS_INJECTED_FAULTS,    // faults the faultsim plane injected (this plane)
  // -- elastic-recovery tail (appended; version stays 1) --------------
  TS_DEDUP_DROPS,        // duplicate frames dropped by the rx seq filter
  TS_RESPAWNS,           // peers restored by replace() after a respawn
                         // (bumped Python-side via the _py_stats merge —
                         // the slot exists so the name table stays the
                         // single source of schema truth)
  // -- streaming-send-engine tail (appended; version stays 1) ---------
  TS_DOORBELLS_SUPPRESSED,  // futex wakes skipped: no waiter was parked
                            // (TS_DOORBELLS + this = every publish)
  TS_STREAM_MSGS,        // messages routed through the pipelined sender
  TS_STREAM_BYTES,
  TS_STREAM_DEPTH,       // gauge: in-flight stream descriptors (all peers)
  TS_STREAM_DEPTH_HWM,
  TS_STREAM_INFLIGHT,    // gauge: queued-unsent stream bytes (all peers)
  TS_STREAM_INFLIGHT_HWM,
  TS_CHUNK_SHRINKS,      // adaptive chunk halvings under ring stall
  TS_SENDER_YIELDS,      // full-ring turns yielded to other peers' work
  TS_ENQUEUE_WAITS,      // enqueues that blocked on dcn_inflight_limit
  // -- dispatch-floor tail (appended; version stays 1) ----------------
  TS_COLL_FASTPATH_OPS,  // collectives served entirely by the C path
  TS_SCHED_CACHE_HITS,   // compiled-schedule cache hits (tdcn_coll_plan)
  TS_SCHED_CACHE_MISSES, // ... and compiles (misses)
  TS_RECV_INTO_PLACED,   // receives landed straight in a posted buffer
                         // (in-place eager memcpy or streamed RTS fill)
  // -- sharded-modex tail (appended; version stays 1) -----------------
  TS_ADDR_INSTALLS,      // peer addresses installed eagerly (bulk
                         // tdcn_set_addresses slots + replace updates)
  TS_ADDR_LAZY,          // peer addresses resolved lazily on first use
                         // (the AddressTable callback / C resolver)
  // -- device-plane tail (appended; version stays 1) ------------------
  // The device-resident zero-copy DCN plane lives in Python
  // (the reference's dcn/device.py; the port has no device plane) and maintains these through its own
  // metrics provider; the C block carries zeroed slots so
  // TDCN_STAT_NAMES stays the single source of schema truth
  // (abidrift: stat-names-drift).
  TS_DEVICE_SENDS,
  TS_DEVICE_RECVS,
  TS_DEVICE_BYTES_PLACED,
  TS_DEVICE_DMA_WAITS,
  TS_DEVICE_DMA_WAIT_NS,
  TS_DEVICE_ARB_DEVICE,
  TS_DEVICE_ARB_HOST,
  TS_DEVICE_FALLBACKS,
  TS_DEVICE_WINDOW_RECLAIMED,  // windows force-retired on a peer-
                               // failure mark (RTS-to-consume leak
                               // edge; Python-side provider)
  // -- plane-health tail (appended; version stays 1) ------------------
  // Per-(peer, plane) failover state machine (Python-side provider,
  // the reference's dcn/device.py PlaneHealth); zeroed slots here keep
  // TDCN_STAT_NAMES the single source of schema truth.
  TS_PLANE_DEMOTIONS,    // peers demoted off a plane on strike-out
  TS_PLANE_PROMOTIONS,   // peers promoted back after a heal probe
  TS_PLANE_HEAL_PROBES,  // probe sends routed through a demoted plane
  // -- serving-plane tail (appended; version stays 1) -----------------
  // tpud overload/concurrency counters (Python-side provider in the
  // daemon process, the reference's serve/daemon.py); zeroed slots here keep
  // TDCN_STAT_NAMES the single source of schema truth.
  TS_JOBS_CONCURRENT_HWM,   // gang-concurrency high-water (max-merge)
  TS_JOBS_SHED,             // submits 429-shed by admission control
  TS_JOBS_DEADLINE_EXPIRED, // jobs revoked by serve_job_deadline_s
  TS_JOBS_RETRIED,          // jobs re-enqueued by the repair retry budget
  // -- hang-diagnosis tail (appended; version stays 1) ----------------
  // Mesh-doctor capture counters (Python-side provider,
  // ompi_tpu_torch/trace/waitgraph.py); zeroed slots here keep
  // TDCN_STAT_NAMES the single source of schema truth.
  TS_HANG_SNAPSHOTS,     // blocked-state snapshots taken (per rank)
  TS_HANG_REPORTS,       // wait-graph reports solved/classified
  TS_COUNT
};

// index order above MUST match this list — the self-describing name
// table the Python side (ompi_tpu_torch/metrics/core.py) reads once
static const char *TDCN_STAT_NAMES =
    "version,doorbells,stall_ns,ring_stall_ns,ring_stalls,ring_hwm,"
    "cts_wait_ns,cts_waits,rndv_depth,rndv_hwm,slot_waits,"
    "eager_msgs,eager_bytes,chunked_msgs,chunked_bytes,"
    "rndv_msgs,rndv_bytes,delivered,unexpected_hwm,"
    "reconnects,retry_dials,retry_sends,deadline_expired,injected_faults,"
    "dedup_drops,respawns,"
    "doorbells_suppressed,stream_msgs,stream_bytes,"
    "stream_depth,stream_depth_hwm,stream_inflight,stream_inflight_hwm,"
    "chunk_shrinks,sender_yields,enqueue_waits,"
    "coll_fastpath_ops,sched_cache_hits,sched_cache_misses,"
    "recv_into_placed,addr_installs,addr_lazy_resolved,"
    "device_sends,device_recvs,device_bytes_placed,"
    "device_dma_waits,device_dma_wait_ns,"
    "device_arb_device,device_arb_host,device_fallbacks,"
    "device_window_reclaimed,"
    "plane_demotions,plane_promotions,plane_heal_probes,"
    "jobs_concurrent_hwm,jobs_shed,jobs_deadline_expired,jobs_retried,"
    "hang_snapshots,hang_reports";

struct alignas(64) TdcnStats {
  std::atomic<uint64_t> v[TS_COUNT];
  TdcnStats() {
    for (int i = 0; i < TS_COUNT; i++)
      v[i].store(0, std::memory_order_relaxed);
    v[TS_VERSION].store(TDCN_STATS_VERSION, std::memory_order_relaxed);
  }
  void add(int idx, uint64_t n) {
    v[idx].fetch_add(n, std::memory_order_relaxed);
  }
  void gauge(int idx, uint64_t n) {
    v[idx].store(n, std::memory_order_relaxed);
  }
  void hwm(int idx, uint64_t n) {
    uint64_t cur = v[idx].load(std::memory_order_relaxed);
    while (cur < n &&
           !v[idx].compare_exchange_weak(cur, n, std::memory_order_relaxed)) {
    }
  }
};

// ---------------------------------------------------------------------
// hang diagnosis: blocked-wait registry (the native half of
// ompi_tpu_torch/trace/waitgraph.py)
// ---------------------------------------------------------------------
//
// Every C-side wait the Python planes cannot see — CTS grants, ring
// backpressure, parked coll slots — registers itself here WHILE
// blocked, so tdcn_waitinfo can mirror the engine's per-peer wait
// state out on demand (≈ ORTE's report-state-on-timeout, applied to
// the transport).  The registry is strictly cold-path: CTS and coll
// waits register only once they are already in a condvar wait, and
// ring reserve registers inside its first-failed-pass branch — the
// happy path touches neither the gate nor the lock.  g_hang_diag
// (tdcn_hang_diag, the hang_diag_enable MCA var) short-circuits
// registration entirely when diagnosis is off.  Entries are keyed by
// a token the waiter removes on every exit path, and carry the owning
// engine as an opaque filter key so co-hosted engines (tpud) stay
// separable.  g_hang_mu is a leaf lock: begin/end callers may hold
// eng->mu or cts_mu, the reader resolves addresses only AFTER
// releasing it.
static std::atomic<uint32_t> g_hang_diag{1};

enum HangWaitKind { HW_CTS = 0, HW_RING = 1, HW_COLL = 2 };
static const char *HANG_KIND_NAMES[] = {"cts", "ring", "coll_recv"};

struct HangWait {
  int kind = 0;
  std::string addr;  // awaited peer's composite address ("" if n/a)
  int peer = -1;     // awaited ROOT proc index (-1: resolve from addr)
  std::string cid;
  int64_t seq = 0;
  uint64_t t0 = 0;   // now_ns() at registration (monotonic)
  void *eng = nullptr;
};

static std::mutex g_hang_mu;
static std::map<uint64_t, HangWait> g_hang_waits;
static uint64_t g_hang_next = 1;

static uint64_t hang_wait_begin(void *eng, int kind, const char *addr,
                                int peer, const char *cid, int64_t seq) {
  if (!g_hang_diag.load(std::memory_order_relaxed) || !eng) return 0;
  std::lock_guard<std::mutex> g(g_hang_mu);
  uint64_t tok = g_hang_next++;
  HangWait &w = g_hang_waits[tok];
  w.kind = kind;
  w.addr = addr ? addr : "";
  w.peer = peer;
  w.cid = cid ? cid : "";
  w.seq = seq;
  w.t0 = now_ns();
  w.eng = eng;
  return tok;
}

static void hang_wait_end(uint64_t tok) {
  if (!tok) return;
  std::lock_guard<std::mutex> g(g_hang_mu);
  g_hang_waits.erase(tok);
}

// ---------------------------------------------------------------------
// fault injection (the native leg of ompi_tpu_torch/faultsim)
// ---------------------------------------------------------------------
//
// Armed per process via tdcn_fault_set (the Python fault plane maps
// its seeded plan's ring rules onto these knobs at engine creation).
// Disabled cost is one relaxed load + branch per ring record — the
// zero-hot-path-cost contract the faultsim subsystem documents.  The
// event counter lives HERE (ring writes never reach Python), so ring
// rules are scheduled by count (every/at), not by hashed probability.
static std::atomic<uint32_t> g_fault_armed{0};
static std::atomic<uint64_t> g_fault_stall_ns{0};
static std::atomic<uint64_t> g_fault_stall_every{1};
static std::atomic<int64_t> g_fault_fail_at{-1};
static std::atomic<uint64_t> g_fault_events{0};
// connection-kill knob for the tcp send path (connkill:at=N rules —
// the native twin of the Python transport's _kill_peer site): the Nth
// non-control send finds its socket severed and exercises the
// redial+resend round.  Own event counter: send events never reach
// Python on this plane.
static std::atomic<int64_t> g_fault_conn_at{-1};
static std::atomic<uint64_t> g_fault_conn_events{0};
// wire-duplicate knob (dup:at=N rules on the native plane): the Nth
// seq-carrying eager tcp send is transmitted TWICE with the same
// (nonce, seq) — a genuine wire duplicate the receiver's dedup
// watermark must absorb exactly-once, including across a failure-
// mark/clear cycle (the watermark-continuity contract).
static std::atomic<int64_t> g_fault_dup_at{-1};
static std::atomic<uint64_t> g_fault_dup_events{0};
// receive-path delay knob (delay:ms=..;site=recv rules): injected
// latency at the blocking-receive entry (tdcn_precv — the native pml
// AND the C-ABI shim's MPI_Recv path).  Disabled cost: one relaxed
// load per receive.
static std::atomic<uint32_t> g_fault_recv_armed{0};
static std::atomic<uint64_t> g_fault_recv_ns{0};
static std::atomic<uint64_t> g_fault_recv_every{1};
static std::atomic<uint64_t> g_fault_recv_events{0};

static bool recv_exact(int fd, void *buf, size_t n) {
  char *p = (char *)buf;
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= (size_t)r;
  }
  return true;
}

static bool send_all(int fd, const void *buf, size_t n) {
  const char *p = (const char *)buf;
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= (size_t)r;
  }
  return true;
}

static bool writev_all(int fd, struct iovec *iov, int cnt) {
  while (cnt) {
    ssize_t r = ::writev(fd, iov, cnt);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t left = (size_t)r;
    while (cnt && left >= iov->iov_len) {
      left -= iov->iov_len;
      ++iov;
      --cnt;
    }
    if (cnt && left) {
      iov->iov_base = (char *)iov->iov_base + left;
      iov->iov_len -= left;
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// shared-memory SPSC ring (one per direction per same-host peer pair)
// ---------------------------------------------------------------------
//
// Layout: [Ctrl][data bytes].  Records are 8-aligned:
//   u64 len | WireHdr | cid | dtype | shape | meta | payload
// Producer owns head, consumer owns tail (both monotonic byte counts).
// A record never wraps: if it would, the producer writes a PAD record
// (len with high bit set = skip to ring start).  The doorbell is a
// separate per-RECEIVER shm word every sender bumps (futex wake); the
// receiver's poll thread futex-waits on it.

struct ShmCtrl {
  std::atomic<uint64_t> head;  // producer cursor
  std::atomic<uint64_t> tail;  // consumer cursor
  // consumer→producer space doorbell: a backpressured producer parks
  // on `space_seq` (futex) instead of burning a core in sched_yield —
  // on a 2-core box that spin DIRECTLY starves the consumer it is
  // waiting for, the mechanism behind the windowed osu_bw collapse.
  // `prod_waiting` is the Dekker flag: the consumer pays one relaxed
  // load per record while nobody waits, and only bumps/wakes when a
  // producer declared itself parked (store-load ordering via seq_cst
  // fences on both sides; a 2 ms futex timeout backstops any race).
  std::atomic<uint32_t> space_seq;
  std::atomic<uint32_t> prod_waiting;
  char pad[40];
};

static const uint64_t PAD_BIT = 1ull << 63;

// Create a shared-memory name exclusively.  Every name this engine
// creates embeds its pid, so an existing one was left by a dead process
// that had the same pid (a SIGKILLed worker whose launcher never
// unlinked it; pids recycle): unlink it and create afresh.
static int shm_create_fresh(const char *nm) {
  int fd = shm_open(nm, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0 && errno == EEXIST) {
    shm_unlink(nm);
    fd = shm_open(nm, O_CREAT | O_EXCL | O_RDWR, 0600);
  }
  return fd;
}

struct ShmRing {
  ShmCtrl *ctrl = nullptr;
  uint8_t *data = nullptr;
  uint64_t size = 0;
  std::string name;
  int fd = -1;

  bool create(const std::string &nm, uint64_t sz) {
    name = nm;
    fd = shm_create_fresh(nm.c_str());
    if (fd < 0) return false;
    if (ftruncate(fd, (off_t)(sizeof(ShmCtrl) + sz)) != 0) return false;
    void *m = mmap(nullptr, sizeof(ShmCtrl) + sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    ctrl = (ShmCtrl *)m;
    data = (uint8_t *)m + sizeof(ShmCtrl);
    size = sz;
    ctrl->head.store(0, std::memory_order_relaxed);
    ctrl->tail.store(0, std::memory_order_relaxed);
    ctrl->space_seq.store(0, std::memory_order_relaxed);
    ctrl->prod_waiting.store(0, std::memory_order_relaxed);
    return true;
  }

  bool open_existing(const std::string &nm) {
    name = nm;
    fd = shm_open(nm.c_str(), O_RDWR, 0600);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    void *m = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    ctrl = (ShmCtrl *)m;
    data = (uint8_t *)m + sizeof(ShmCtrl);
    size = (uint64_t)st.st_size - sizeof(ShmCtrl);
    return true;
  }

  uint64_t free_space() const {
    return size - (ctrl->head.load(std::memory_order_relaxed) -
                   ctrl->tail.load(std::memory_order_acquire));
  }

  // One placement attempt for a record of `need` bytes (8-aligned,
  // u64 length prefix included).  On success returns the write
  // pointer and sets *rec_start; on backpressure returns nullptr
  // without waiting or accounting anything — the streaming sender's
  // yield-don't-spin primitive.
  uint8_t *try_reserve(uint64_t need, uint64_t *rec_start) {
    need = (need + 7) & ~7ull;
    uint64_t head = ctrl->head.load(std::memory_order_relaxed);
    uint64_t pos = head % size;
    uint64_t contig = size - pos;
    uint64_t want = need;
    bool pad = false;
    if (pos >= need &&
        head == ctrl->tail.load(std::memory_order_acquire)) {
      // ring is EMPTY: rebase to offset 0 via a PAD record so
      // steady-state request/reply traffic reuses the same (cache-
      // and TLB-warm) pages instead of marching cold through the
      // whole segment once per lap
      want = contig + need;
      pad = true;
    } else if (contig < need) {  // must pad to ring start first
      want = contig + need;
      pad = true;
    }
    if (size - (head - ctrl->tail.load(std::memory_order_acquire)) <
        want)
      return nullptr;
    if (pad) {
      *(uint64_t *)(data + pos) = PAD_BIT | contig;
      head += contig;
      pos = 0;
    }
    *rec_start = head;
    return data + pos;
  }

  // Park until the consumer frees space (or `wait_ns` elapses): declare
  // the producer parked, then futex-wait on the space doorbell the
  // consumer bumps after advancing tail.  Replaces the old sched_yield
  // storm — on small hosts that spin competed with the very consumer
  // it was waiting on.  `seen_tail` is the tail value the caller's
  // failed placement attempt observed: if tail has already moved past
  // it the wait is skipped (the Dekker pairing with wake_producer —
  // flag store → tail read here, tail store → flag read there — makes
  // a lost wakeup impossible; a 2 ms-scale timeout backstops anyway).
  void space_wait(uint64_t seen_tail, uint64_t wait_ns) {
    ctrl->prod_waiting.fetch_add(1, std::memory_order_seq_cst);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    uint32_t seen = ctrl->space_seq.load(std::memory_order_acquire);
    if (ctrl->tail.load(std::memory_order_acquire) == seen_tail) {
      struct timespec ts = {(time_t)(wait_ns / 1000000000ull),
                            (long)(wait_ns % 1000000000ull)};
      futex_wait(&ctrl->space_seq, seen, &ts);
    }
    ctrl->prod_waiting.fetch_sub(1, std::memory_order_relaxed);
  }

  // Consumer side of the space doorbell: call after advancing tail.
  // One relaxed load when no producer is parked.
  void wake_producer() {
    std::atomic_thread_fence(std::memory_order_seq_cst);
    if (ctrl->prod_waiting.load(std::memory_order_relaxed)) {
      ctrl->space_seq.fetch_add(1, std::memory_order_release);
      futex_wake(&ctrl->space_seq, 4);
    }
  }

  // Blocking reserve.  Returns the write pointer or nullptr on close
  // or deadline expiry (receiver stalled/dead — a dead consumer
  // freezes `tail`, and a rebase PAD can leave head a full lap above
  // it, so an unbounded wait here wedges the sender forever;
  // `timeout_ns` = 0 waits indefinitely, callers pass the
  // dcn_ring_timeout policy).  Single producer: only the sender's
  // per-peer lock holder calls this.  `stats` (optional) accounts
  // backpressure: a reserve that cannot be satisfied on its first
  // pass counts one ring stall and the full blocked duration — the
  // "per-chunk doorbell round-trips under backpressure" signal the
  // osu_bw collapse investigation needed.  The happy path touches no
  // clock and no stat.
  uint8_t *reserve(uint64_t need, uint64_t *rec_start,
                   std::atomic<bool> *closing, TdcnStats *stats = nullptr,
                   uint64_t timeout_ns = 0, void *hang_eng = nullptr,
                   const char *hang_addr = nullptr,
                   const std::atomic<bool> *consumer_failed = nullptr) {
    uint64_t spin = 0;
    uint64_t stall_t0 = 0;
    uint64_t give_up = 0;
    uint64_t hang_tok = 0;
    for (;;) {
      if (closing->load(std::memory_order_relaxed)) {
        hang_wait_end(hang_tok);
        return nullptr;
      }
      uint64_t tail0 = ctrl->tail.load(std::memory_order_acquire);
      uint8_t *w = try_reserve(need, rec_start);
      if (w) {
        if (stall_t0 && stats) {
          uint64_t d = now_ns() - stall_t0;
          stats->add(TS_RING_STALL_NS, d);
          stats->add(TS_STALL_NS, d);
        }
        hang_wait_end(hang_tok);
        return w;
      }
      if (!stall_t0) {
        stall_t0 = now_ns();
        if (stats) stats->add(TS_RING_STALLS, 1);
        if (timeout_ns) give_up = stall_t0 + timeout_ns;
        // first failed pass = already the backpressure cold path:
        // register the blocked wait for the mesh doctor
        hang_tok = hang_wait_begin(hang_eng, HW_RING, hang_addr, -1,
                                   nullptr, 0);
      } else if (give_up && now_ns() > give_up) {
        if (stats) {
          uint64_t d = now_ns() - stall_t0;
          stats->add(TS_RING_STALL_NS, d);
          stats->add(TS_STALL_NS, d);
          stats->add(TS_DEADLINE_EXPIRED, 1);
        }
        hang_wait_end(hang_tok);
        return nullptr;  // receiver wedged/dead: surface a send error
      }
      if (consumer_failed &&
          consumer_failed->load(std::memory_order_relaxed)) {
        // the consumer's proc is marked failed: a dead consumer never
        // frees space, so surface the send error now instead of at
        // the ring deadline (the caller escalates it ULFM-style)
        hang_wait_end(hang_tok);
        return nullptr;
      }
      if (++spin < 64) {
#if defined(__x86_64__)
        __builtin_ia32_pause();
#endif
      } else {
        // 2 ms backstop; the consumer's space doorbell wakes us sooner
        space_wait(tail0, 2000000ull);
      }
    }
  }

  void publish(uint64_t rec_start, uint64_t rec_len) {
    // release: record bytes visible before head moves
    ctrl->head.store(rec_start + ((rec_len + 7) & ~7ull),
                     std::memory_order_release);
  }

  void destroy(bool unlink_name) {
    // idempotent: close-then-destroy re-enters (tdcn_destroy after a
    // tdcn_close); a stale fd number may have been recycled by then
    if (ctrl) munmap((void *)ctrl, sizeof(ShmCtrl) + size);
    if (fd >= 0) close(fd);
    if (unlink_name && !name.empty()) shm_unlink(name.c_str());
    ctrl = nullptr;
    fd = -1;
    name.clear();
  }
};

// Doorbell segment: one futex word per receiver process (word[0]),
// plus a parked-waiter count (word[1]) every futex sleeper on word[0]
// increments before waiting.  Senders ALWAYS bump word[0] (one atomic
// — any waiter that loaded its `seen` value earlier now returns from
// futex_wait immediately), but pay the futex_wake SYSCALL only when a
// waiter is actually parked: under a windowed burst the consumer is
// busy draining, nobody is parked, and the per-record wake syscalls
// that serialized the old send path collapse into
// TS_DOORBELLS_SUPPRESSED bumps.
//
// word[1]'s top bit (kWakePending) says a wake is already in flight:
// the sender that pays the futex_wake sets it in the same atomic step
// that reads the count, and every sleeper clears it in the same atomic
// step that registers it (park()).  So a set bit means every sleeper
// now registered was parked before a futex_wake that followed its
// registration (a woken consumer the scheduler has not run yet), and
// the senders behind it skip the syscall too: the woken consumer
// drains their records with the rest.  word[3] = kPendingMagic marks a
// segment whose sleepers clear the bit; on any other segment (the
// reference engine's) a sender keeps the plain count rule.
struct Doorbell {
  static constexpr uint32_t kWakePending = 0x80000000u;
  static constexpr uint32_t kPendingMagic = 0x50454e44u;  // "PEND"
  std::atomic<uint32_t> *word = nullptr;
  std::atomic<uint32_t> *parked = nullptr;
  bool pending_ok = false;  // the segment's sleepers clear kWakePending
  std::string name;
  int fd = -1;

  bool create(const std::string &nm) {
    name = nm;
    fd = shm_create_fresh(nm.c_str());
    if (fd < 0) return false;
    if (ftruncate(fd, 4096) != 0) return false;
    void *m = mmap(nullptr, 4096, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    word = (std::atomic<uint32_t> *)m;
    parked = word + 1;
    word->store(0);
    parked->store(0);
    word[3].store(kPendingMagic, std::memory_order_release);
    pending_ok = true;
    return true;
  }

  bool open_existing(const std::string &nm) {
    name = nm;
    fd = shm_open(nm.c_str(), O_RDWR, 0600);
    if (fd < 0) return false;
    void *m = mmap(nullptr, 4096, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    word = (std::atomic<uint32_t> *)m;
    parked = word + 1;
    pending_ok = word[3].load(std::memory_order_acquire) == kPendingMagic;
    return true;
  }

  // A sleeper's registration before its futex_wait on word[0]: one
  // more parked, and no wake in flight that predates it.
  void park() {
    uint32_t old = parked->load(std::memory_order_relaxed);
    while (!parked->compare_exchange_weak(old, (old & ~kWakePending) + 1,
                                          std::memory_order_seq_cst))
      ;
  }

  void unpark() { parked->fetch_sub(1, std::memory_order_relaxed); }

  // `coalesce` off restores the unconditional wake (the
  // dcn_doorbell_coalesce escape hatch); `stats` may be null.
  void ring(TdcnStats *stats = nullptr, bool coalesce = true) {
    word->fetch_add(1, std::memory_order_release);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    bool wake;
    if (!coalesce) {
      wake = true;
    } else if (pending_ok) {
      uint32_t old = parked->fetch_or(kWakePending, std::memory_order_seq_cst);
      wake = (old & ~kWakePending) && !(old & kWakePending);
    } else {
      wake = parked->load(std::memory_order_relaxed) != 0;
    }
    if (wake) {
      if (stats) stats->add(TS_DOORBELLS, 1);
      // wake everyone: inline-progress waiters AND the backstop poller
      // race via try_lock; waking only one risks handing the frame to
      // the poller and paying a second thread handoff to the waiter
      futex_wake(word, 64);
    } else if (stats) {
      stats->add(TS_DOORBELLS_SUPPRESSED, 1);
    }
  }

  void destroy(bool unlink_name) {
    // idempotent, same rationale as ShmRing::destroy
    if (word) munmap((void *)word, 4096);
    if (fd >= 0) close(fd);
    if (unlink_name && !name.empty()) shm_unlink(name.c_str());
    word = nullptr;
    fd = -1;
    name.clear();
  }
};

// ---------------------------------------------------------------------
// engine data structures
// ---------------------------------------------------------------------

struct Env {
  uint8_t kind;
  int32_t src, dst, tag;
  int64_t seq;
  std::string cid;
  std::string dtype;
  int ndim = 0;
  int64_t shape[8] = {0};
  std::string meta;
};

struct OwnedMsg {
  Env env;
  void *data = nullptr;  // malloc'd — unless noown
  uint64_t nbytes = 0;
  uint64_t pyhandle = 0;  // nonzero: Python-side payload
  int64_t count = 0;      // element count when pyhandle != 0
  uint64_t arrival = 0;   // matching order stamp
  bool noown = false;     // data IS a posted coll destination buffer
                          // (coll recv_into placement): never freed
                          // by the engine, and the waiter that posted
                          // it skips its copy on pointer identity
};

struct PostedReq {
  uint64_t id;
  int32_t src, tag;  // -1 wildcards
  uint64_t order;
};

struct ReqState {
  std::atomic<bool> completed{false};
  bool cancelled = false;
  // in-place rendezvous placement (tdcn_post_recv_into): the receive
  // was posted WITH its destination buffer, so an in-order streaming
  // RTS can reserve the request and land its FRAGs straight in the
  // user buffer — no reassembly malloc, no delivery copy.  While
  // `in_fill` is set the request is matched-but-incomplete and can no
  // longer be cancelled.
  void *user_buf = nullptr;
  uint64_t user_cap = 0;
  bool in_fill = false;   // FRAGs land in user_buf (payload is the
                          // user's memory — never engine-freed)
  bool reserved = false;  // matched at RTS time (cancel refuses);
                          // set for buffered AND copy-path matches so
                          // the order gate advances at the MATCH, and
                          // a copy-path message in a stream chain
                          // cannot stall the in-place ones behind it
  OwnedMsg msg;
  std::condition_variable cv;
};

struct CidQueues {
  // keyed per destination rank
  std::unordered_map<int32_t, std::deque<OwnedMsg>> unexpected;
  std::unordered_map<int32_t, std::vector<PostedReq>> posted;
  // comm freed with receives still pending (MPI 3.7.3: they must
  // complete later): new unmatched arrivals are dropped, and the cid
  // is reclaimed when the last posted entry matches
  bool draining = false;

  bool posted_empty() const {
    for (auto &kv : posted)
      if (!kv.second.empty()) return false;
    return true;
  }
};

struct CollSlot {
  std::atomic<bool> ready{false};
  bool consumed = false;  // a waiter took the message (one-shot)
  OwnedMsg msg;
  std::condition_variable cv;
  int waiters = 0;
};

// One in-flight send owned by the streaming engine (the pipelined
// large-message path): `isend` enqueues a descriptor instead of
// holding the peer's send path for the whole message, and the
// engine's sender thread interleaves FRAG records from every queued
// descriptor round-robin.  `order` is the per-peer issue-order tag the
// receiver's delivery gate re-sequences completions with (round-robin
// chunking can finish a short message before an earlier long one).
struct Peer;

struct StreamDesc {
  Env env;
  Peer *owner = nullptr;          // the peer whose queue holds it (the
                                  // stream_mu/cv a waiter sleeps on)
  const uint8_t *data = nullptr;  // send source (owned or borrowed)
  uint8_t *owned = nullptr;       // engine-owned copy: freed at completion
  uint64_t nbytes = 0, sent = 0;
  int64_t xid = 0;
  uint64_t order = 0;
  bool rts_sent = false;
  bool eager = false;     // fits one record: emitted as ONE ordered
                          // eager record when its turn comes
  bool detached = false;  // no waiter — the engine deletes the
                          // descriptor (and frees `owned`) at
                          // completion; zero-copy isends are NOT
                          // detached: the MPI request's Wait/Test is
                          // the waiter, and the user buffer stays
                          // borrowed until it collects the descriptor
  bool done = false;
  int rc = 0;  // valid once done
};

struct Peer {
  std::string address;   // composite published address
  std::string host_id;   // same-host test
  std::string tcp_host;  // host:port
  std::string uds_name;  // abstract socket name (setup channel)
  std::string db_name;   // doorbell shm name
  int fd = -1;           // connected socket (tcp or uds)
  uint64_t epoch = 0;    // socket generation (bumped per redial)
  uint64_t tx_seq = 0;   // per-peer message seq for rx-side dedup
  uint64_t nonce = 0;    // 40-bit sender-lineage tag carried with the
                         // seq: rx dedup keys on (from_proc, nonce),
                         // so engines from different worlds (spawn)
                         // or incarnations sharing a proc index can
                         // never collide on one watermark
  bool same_host = false;
  // this address's proc is marked failed (tdcn_note_failed; cleared by
  // tdcn_clear_failed): ring writes and stream turns toward it give up
  // instead of waiting out the ring deadline on a consumer that is gone
  std::atomic<bool> marked_failed{false};
  ShmRing tx_ring;  // our ring toward this peer (created lazily)
  bool ring_announced = false;
  // lock-free "ring exists" hint for the isend fast path: set (under
  // send_mu) once ensure_ring announced the ring; a stale false just
  // routes one send through the locked slow path
  std::atomic<bool> ring_ready{false};
  Doorbell peer_db;  // peer's doorbell (mapped lazily)
  std::mutex send_mu;
  // sender-side rendezvous: xid -> CTS flag
  std::mutex cts_mu;
  std::condition_variable cts_cv;
  std::map<int64_t, bool> cts;
  // ---- streaming send engine (ring path) ----------------------------
  // stream_mu guards the descriptor queue and its accounting; ring
  // RECORD writes stay serialized by send_mu (the sender thread
  // try_locks it per turn, so a blocked direct sender never wedges
  // other peers' streams).  stream_cv wakes blocking senders waiting
  // for completion and enqueuers waiting under dcn_inflight_limit.
  std::mutex stream_mu;
  std::condition_variable stream_cv;
  std::deque<StreamDesc *> streams;
  uint64_t stream_inflight = 0;    // queued-unsent payload bytes
  uint64_t next_order = 1;         // ordered-delivery tag source
  size_t stream_rr = 0;            // round-robin cursor
  uint64_t chunk_now = 0;          // adaptive chunk (0 = engine knob)
  uint64_t chunk_ok = 0;           // consecutive stall-free chunks
  // ring-timeout watchdog base: written by enqueuers (stream_mu) and
  // the sender thread (send_mu), read lock-free by the watchdog —
  // atomic, not a plain word
  std::atomic<uint64_t> last_progress_ns{0};
  int cap_waiters = 0;             // enqueuers parked on inflight_limit
  bool stream_failed = false;      // poisoned: a descriptor timed out
};

// receiver-side in-flight rendezvous / chunked-ring reassembly
struct Reassembly {
  Env env;
  uint8_t *buf = nullptr;
  uint64_t total = 0;
  uint64_t received = 0;
  bool granted = false;   // holds a rndv slot
  uint64_t order = 0;     // nonzero: release through the per-sender
                          // ordered-delivery gate (ring streaming)
  uint16_t okey = 0;      // gate sub-key (sender-lineage nonce low
                          // bits): distinct senders sharing a proc
                          // index (join worlds) never share a gate
  uint64_t fill_rid = 0;   // nonzero: matched to a posted recv at RTS
                           // time — completed via the req, not the
                           // delivery queues
  bool fill_user = false;  // `buf` IS the user's posted buffer
                           // (in-place placement): never freed here
  bool dead = false;       // aborted coll recv_into: the waiter gave
                           // `buf` back to the caller — writers must
                           // drop the rest of the stream (set and
                           // read under rndv_mu)
  std::atomic<uint64_t> busy{0};  // a FRAG write into `buf` is in
                                  // flight (set under rndv_mu at
                                  // lookup, cleared after the write)
};

// receiver-side duplicate filter, one per sending proc: `low` is the
// contiguous delivered watermark (every seq <= low seen), `seen` the
// out-of-order tail.  A sender's redial+resend round (and injected
// wire duplicates) reuse the original seq, so a second arrival tests
// as a dup — the exactly-once contract across reconnects.
struct DedupSeen {
  uint64_t low = 0;
  std::set<uint64_t> seen;
  bool is_dup(uint64_t s) {
    if (s <= low || seen.count(s)) return true;
    seen.insert(s);
    while (seen.count(low + 1)) {
      seen.erase(low + 1);
      low++;
    }
    return false;
  }
};

struct CollCtx;

// lazy-modex resolver callback (tdcn_set_resolver): the Python
// AddressTable writes proc's address into the caller-provided buffer
// and returns its length (-1 = unresolvable).  Buffer-writing shape on
// purpose: a callback RETURNING a char* would hand back memory whose
// Python-side owner may be collected before the C caller reads it.
typedef int (*tdcn_resolve_fn)(int proc, char *out, int cap);

struct Engine {
  int proc = 0, nprocs = 0;
  std::string host_id;
  std::string address;
  std::vector<std::string> peer_addresses;
  // guards peer_addresses: bulk installs, one-slot installs, lazy
  // resolves AND the tdcn_send-path slot reads (lazy resolution means
  // installs happen mid-job from whichever thread sends first, so
  // readers copy the slot out under the lock — engine_resolve_addr)
  std::mutex addr_mu;
  std::unordered_map<std::string, Peer *> peers;  // by composite address
  std::mutex peers_mu;

  int64_t eager_limit = 4 << 20;
  int64_t frag_size = 8 << 20;
  uint64_t ring_bytes = 64ull << 20;
  // ---- streaming send engine knobs (dcn_chunk_bytes /
  // dcn_inflight_limit / dcn_doorbell_coalesce MCA vars) -------------
  // chunk_bytes: ring FRAG granularity AND the streaming threshold —
  // payloads above it leave the caller's thread via a descriptor and
  // stream cooperatively; at-or-below go as one direct eager record.
  std::atomic<uint64_t> chunk_bytes{512ull << 10};
  // inflight_limit: cap on queued-unsent stream bytes per peer; an
  // enqueue over it blocks (bounded by dcn_ring_timeout) — graceful
  // backpressure instead of unbounded buffering.  0 = unlimited.
  std::atomic<uint64_t> inflight_limit{32ull << 20};
  std::atomic<uint32_t> db_coalesce{1};
  // engine-wide stream gauges (TS_STREAM_DEPTH / TS_STREAM_INFLIGHT):
  // mutated under per-peer stream_mu but reported engine-wide
  std::atomic<uint64_t> stream_depth_now{0};
  std::atomic<uint64_t> stream_inflight_now{0};
  // collision-free xid source for chunked/rendezvous reassembly keys
  // (was now_ns() ^ proc<<56 — two same-nanosecond large sends to one
  // peer could collide and cross-corrupt reassembly); high byte still
  // carries the proc for log readability
  std::atomic<uint64_t> next_xid{1};
  // sender-thread wakeup: enqueues bump stream_gen and notify
  std::mutex sender_mu;
  std::condition_variable sender_cv;
  uint64_t stream_gen = 0;
  // ring-write deadline (dcn_ring_timeout; tdcn_set_ring_timeout):
  // bounds reserve() so a dead/wedged consumer surfaces as a send
  // error instead of an unbounded producer spin
  std::atomic<uint64_t> ring_timeout_ns{600ull * 1000000000ull};
  // (re)dial deadline (dcn_connect_timeout; tdcn_set_connect_timeout —
  // the ring-timeout hook's twin): bounds the exponential-backoff dial
  // loop, so a dead peer surfaces as a send error while a restarting
  // one heals
  std::atomic<uint64_t> connect_timeout_ns{30ull * 1000000000ull};
  int max_rndv = 4;

  int tcp_listen_fd = -1, uds_listen_fd = -1;
  std::string tcp_addr, uds_name, db_name;
  Doorbell my_db;

  // rx rings (one per announcing sender), guarded by rings_mu
  std::mutex rings_mu;
  std::vector<ShmRing *> rx_rings;
  std::atomic<uint32_t> db_seen{0};
  // arbitration between the poller thread and inline-progress waiters
  std::mutex consume_mu;
  std::atomic<int> waiters{0};  // inline-progress waiters present
  int spin_iters = 0;  // doorbell spin before futex (0 on small hosts:
                       // spinning starves the peer when cores are scarce)

  // ---- unified delivery state (one mutex; np is small) ----
  std::mutex mu;
  std::unordered_map<std::string, CidQueues> p2p;  // native-matched cids
  std::unordered_map<std::string, bool> py_cids;   // cids routed to PY queue
  std::map<std::tuple<std::string, int64_t, int32_t>, CollSlot *> coll;
  // posted coll-stream destination buffers (the coll recv_into
  // surface, the recorded C-fast-path edge): (cid, seq, src) → (buf, cap).
  // A matching inbound FK_COLL payload lands straight in the buffer
  // — socket reads target it, ring records memcpy once into it, and
  // a streaming/tcp RTS binds it as the reassembly target — instead
  // of staging through a malloc the waiter re-copies (the C
  // allgather's one-staging-copy-per-peer-block cost).  Reservation
  // POPS the entry under eng->mu; the waiter erases leftovers on
  // abort (the in-flight-fill-after-abort discipline mirrors the
  // p2p precv_into path: the consumer only ever writes the user
  // buffer, and the orphaned delivery is dropped via noown).
  struct CollInto {
    void *buf;
    uint64_t cap;
  };
  std::map<std::tuple<std::string, int64_t, int32_t>, CollInto> coll_into;
  // into-claims: a consumed posting's destination stays here from the
  // moment coll_into_reserve_locked pops it until the writer either
  // finished its write (ring memcpy / eager socket read) or inserted
  // the reassembly into eng->reasm (RTS paths) — the windows in which
  // the buffer can be written yet the waiter's abort-time reasm scan
  // cannot see it.  cctx_recv_into's abort path waits for the claim
  // to clear BEFORE scanning reasm, so it can never return (letting
  // the caller free the buffer) while an un-scannable write is still
  // in flight.  Guarded by eng->mu; into_cv broadcast on release.
  std::set<void *> into_busy;
  std::condition_variable into_cv;
  // per-op timing for C-fast-path collectives (the C fast path's observability
  // edge): indexed by CollKind; log2-µs histogram buckets matching
  // the Python plane's metrics.LAT_BUCKETS convention.  Relaxed
  // atomics, read by tdcn_coll_optime — the Python side merges the
  // rows into the straggler_<op> pvar/prom surfaces, which otherwise
  // only see merged SPC counts for C-served collectives.
  static const int OPTIME_KINDS = 5, OPTIME_BUCKETS = 16;
  struct CollOpTime {
    std::atomic<uint64_t> count{0}, total_ns{0}, max_ns{0};
    std::atomic<uint64_t> hist[16];
    CollOpTime() {
      for (auto &h : hist) h.store(0, std::memory_order_relaxed);
    }
  };
  CollOpTime coll_optime[5];
  std::unordered_map<uint64_t, ReqState *> reqs;
  uint64_t next_req = 1;
  uint64_t arrival = 1;
  std::deque<OwnedMsg> py_queue;  // PY-kind frames for the dispatcher
  std::condition_variable py_cv;
  std::vector<bool> failed;
  std::condition_variable fail_cv;  // broadcast on failure marks

  std::atomic<bool> closing{false};
  // live detached per-connection readers (sock_recv_entry): counted
  // at spawn, decremented at exit, so tdcn_destroy can wait for the
  // last one before freeing the Engine they read.  Their open fds are
  // tracked so close() can shutdown() them — an accept-side reader
  // otherwise blocks in recv until the REMOTE engine dies, leaking
  // the thread+fd on every engine close in a long-lived host (tpud)
  std::atomic<int> readers{0};
  std::mutex reader_mu;
  std::set<int> reader_fds;
  std::atomic<uint64_t> bytes_sent{0};
  TdcnStats stats;  // transport telemetry (tdcn_stats reads it)
  // rx duplicate filter, keyed by (sending proc, sender-lineage
  // nonce) — tcp eager frames with a nonzero seq in WireHdr.off.  The
  // nonce (fresh per sender Peer object) keeps distinct senders that
  // share a proc index (spawn worlds, respawned incarnations) on
  // separate watermarks; stale entries are pruned when a proc is
  // marked failed / restored
  std::mutex dedup_mu;
  std::map<std::pair<int32_t, uint64_t>, DedupSeen> rx_seen;
  // receiver-side ordered-delivery gates for the streaming engine
  // (under eng->mu): completed ring-path items from one sender are
  // released in their issue order even though round-robin chunking
  // can complete them out of order.  Keyed by sending proc; pruned
  // with the dedup watermarks when the proc's address changes (a new
  // incarnation restarts its order counter at 1).
  struct OrderGate {
    uint64_t next = 1;
    std::map<uint64_t, OwnedMsg> parked;
  };
  std::map<std::pair<int32_t, uint16_t>, OrderGate> order_gates;
  // inbound rendezvous flow control
  std::mutex rndv_mu;
  std::condition_variable rndv_cv;
  int rndv_active = 0;
  std::map<std::pair<int, int64_t>, Reassembly *> reasm;  // (from, xid)

  // ---- C coll fast path registry + lazy-modex resolver --------------
  // live CollCtx views (tdcn_coll_open/close register them): an
  // address change (replace() installing a reborn incarnation's
  // endpoint) invalidates their cached peers + evicts their compiled
  // plans, and tdcn_coll_revoke_cid finds them by comm cid
  std::mutex cctx_mu;
  std::set<CollCtx *> cctxs;
  // sharded native modex: consulted when a send names a proc whose
  // address slot is still empty (one Python-side KVS get, cached by
  // the install the wrapper performs)
  std::atomic<tdcn_resolve_fn> resolver{nullptr};

  std::vector<std::thread> threads;
};

// ---------------------------------------------------------------------
// frame serialization helpers
// ---------------------------------------------------------------------

static void fill_hdr(WireHdr *h, uint8_t type, const Env &e, int from_proc,
                     uint64_t off, uint64_t total, uint64_t nbytes) {
  memset(h, 0, sizeof(*h));
  h->magic = TDCN_MAGIC;
  h->type = type;
  h->kind = e.kind;
  h->dtype_len = (uint8_t)e.dtype.size();
  h->ndim = (uint8_t)e.ndim;
  h->src = e.src;
  h->dst = e.dst;
  h->tag = e.tag;
  h->from_proc = from_proc;
  h->seq = e.seq;
  h->off = off;
  h->total = total;
  h->nbytes = nbytes;
  h->cid_len = (uint16_t)e.cid.size();
  h->meta_len = (uint32_t)e.meta.size();
}

// bytes following the header, excluding payload
static size_t env_extra(const WireHdr &h) {
  return h.cid_len + h.dtype_len + (size_t)h.ndim * 8 + h.meta_len;
}

static void write_extra(uint8_t *p, const Env &e) {
  memcpy(p, e.cid.data(), e.cid.size());
  p += e.cid.size();
  memcpy(p, e.dtype.data(), e.dtype.size());
  p += e.dtype.size();
  memcpy(p, e.shape, (size_t)e.ndim * 8);
  p += (size_t)e.ndim * 8;
  memcpy(p, e.meta.data(), e.meta.size());
}

static void parse_extra(const WireHdr &h, const uint8_t *p, Env *e) {
  e->kind = h.kind;
  e->src = h.src;
  e->dst = h.dst;
  e->tag = h.tag;
  e->seq = h.seq;
  e->cid.assign((const char *)p, h.cid_len);
  p += h.cid_len;
  e->dtype.assign((const char *)p, h.dtype_len);
  p += h.dtype_len;
  e->ndim = h.ndim;
  memcpy(e->shape, p, (size_t)h.ndim * 8);
  p += (size_t)h.ndim * 8;
  e->meta.assign((const char *)p, h.meta_len);
}

// ---------------------------------------------------------------------
// delivery (engine mutex held)
// ---------------------------------------------------------------------

static void msg_into_tdcn(OwnedMsg &m, TdcnMsg *out) {
  memset(out, 0, sizeof(*out));
  out->kind = m.env.kind;
  out->src = m.env.src;
  out->dst = m.env.dst;
  out->tag = m.env.tag;
  out->seq = m.env.seq;
  out->pyhandle = m.pyhandle;
  out->data = m.data;
  out->nbytes = m.nbytes;
  out->count = m.count;
  snprintf(out->dtype, sizeof(out->dtype), "%s", m.env.dtype.c_str());
  out->ndim = m.env.ndim;
  memcpy(out->shape, m.env.shape, sizeof(out->shape));
  snprintf(out->cid, sizeof(out->cid), "%s", m.env.cid.c_str());
  if (!m.env.meta.empty()) {
    out->meta = malloc(m.env.meta.size());
    memcpy(out->meta, m.env.meta.data(), m.env.meta.size());
    out->meta_len = (uint32_t)m.env.meta.size();
  }
  m.data = nullptr;  // ownership moved
}

static bool env_match(const PostedReq &p, const OwnedMsg &m) {
  return (p.src == -1 || p.src == m.env.src) &&
         (p.tag == -1 || p.tag == m.env.tag);
}

// Wake inline-progress waiters (they futex-wait on OUR doorbell when
// not consuming); completions from any transport ring it.  Coalesced:
// the futex syscall is paid only when a waiter is actually parked.
static void wake_waiters(Engine *eng) {
  eng->my_db.ring(&eng->stats,
                  eng->db_coalesce.load(std::memory_order_relaxed) != 0);
}

// Reserve a posted coll-stream destination buffer for an inbound
// FK_COLL payload (eng->mu HELD).  Pops the posting — a posting only
// exists while no message for its key has arrived (the waiter checks
// slot readiness before posting), so at most one arrival can claim
// it; oversized payloads fall back to the staging path for the
// waiter's truncation handling.
static void *coll_into_reserve_locked(Engine *eng, const Env &e,
                                      uint64_t nbytes) {
  if (e.kind != FK_COLL || eng->coll_into.empty()) return nullptr;
  auto it = eng->coll_into.find(std::make_tuple(e.cid, e.seq, e.src));
  if (it == eng->coll_into.end() || nbytes > it->second.cap)
    return nullptr;
  void *buf = it->second.buf;
  eng->coll_into.erase(it);
  eng->into_busy.insert(buf);  // claimed until write done / reasm bound
  return buf;
}

// Release a reserved coll-into claim: the write into the buffer is
// complete (ring memcpy / eager socket read), or the reassembly that
// owns it is now in eng->reasm where the abort-time scan can reach
// it.  Must NOT be called holding rndv_mu (eng->mu never nests inside
// it).
static void coll_into_release(Engine *eng, void *buf) {
  if (!buf) return;
  std::lock_guard<std::mutex> g(eng->mu);
  eng->into_busy.erase(buf);
  eng->into_cv.notify_all();
}

// Deliver one complete inbound message.  Called with eng->mu HELD.
static void deliver_locked(Engine *eng, OwnedMsg &&m) {
  m.arrival = eng->arrival++;
  eng->stats.add(TS_DELIVERED, 1);
  if (m.env.kind == FK_COLL) {
    auto key = std::make_tuple(m.env.cid, m.env.seq, m.env.src);
    auto it = eng->coll.find(key);
    CollSlot *slot;
    if (it == eng->coll.end()) {
      slot = new CollSlot();
      eng->coll[key] = slot;
    } else {
      slot = it->second;
    }
    slot->msg = std::move(m);
    slot->ready = true;
    slot->cv.notify_all();
    wake_waiters(eng);
    return;
  }
  if (m.env.kind == FK_P2P) {
    auto pit = eng->py_cids.find(m.env.cid);
    if (pit == eng->py_cids.end()) {
      // native matching
      CidQueues &q = eng->p2p[m.env.cid];
      auto &plist = q.posted[m.env.dst];
      for (size_t i = 0; i < plist.size(); i++) {
        if (env_match(plist[i], m)) {
          uint64_t rid = plist[i].id;
          plist.erase(plist.begin() + i);
          bool reclaim = q.draining && q.posted_empty();
          std::string ckey = m.env.cid;  // m is moved below
          auto rit = eng->reqs.find(rid);
          if (rit != eng->reqs.end()) {
            rit->second->msg = std::move(m);
            rit->second->completed = true;
            rit->second->cv.notify_all();
          }
          if (reclaim) eng->p2p.erase(ckey);
          wake_waiters(eng);
          return;
        }
      }
      if (q.draining) {
        free(m.data);  // freed comm, no matching pending recv: drop
        return;
      }
      auto &uq = q.unexpected[m.env.dst];
      uq.push_back(std::move(m));
      eng->stats.hwm(TS_UNEXPECTED_HWM, uq.size());
      return;
    }
    // registered for Python delivery: fall through to PY queue
  }
  eng->py_queue.push_back(std::move(m));
  eng->py_cv.notify_one();
}

// Release a completed ring-path item through the sender's issue-order
// gate: deliver it (and any consecutively parked successors) when its
// order is next, park it otherwise.  Round-robin chunking completes
// short messages before earlier long ones; MPI's non-overtaking
// matching needs them re-sequenced.
static void deliver_ordered(Engine *eng, int from_proc, uint16_t okey,
                            uint64_t order, OwnedMsg &&m) {
  std::lock_guard<std::mutex> g(eng->mu);
  Engine::OrderGate &gt = eng->order_gates[{from_proc, okey}];
  if (order != gt.next) {
    gt.parked.emplace(order, std::move(m));
    return;
  }
  deliver_locked(eng, std::move(m));
  gt.next++;
  for (auto it = gt.parked.begin();
       it != gt.parked.end() && it->first == gt.next;
       it = gt.parked.erase(it)) {
    deliver_locked(eng, std::move(it->second));
    gt.next++;
  }
}

// ---------------------------------------------------------------------
// inbound frame processing (shared by socket loops and ring poller)
// ---------------------------------------------------------------------

// Try to reserve an in-place posted recv for an inbound ring-path P2P
// message (eng->mu HELD): when a posted receive carrying a buffer
// (tdcn_post_recv_into) with enough capacity matches — oldest first,
// MPI post order — it is erased from the posted list, marked in_fill,
// and its order-gate slot is consumed (the reservation IS the MPI
// match; completion may lag later deliveries, which MPI permits).
// Returns the rid and sets *buf_out, or 0 for the copy path.
static uint64_t fill_reserve_locked(Engine *eng, const Env &e,
                                    uint64_t total, uint64_t order,
                                    uint16_t okey, int from_proc,
                                    uint8_t **buf_out,
                                    bool allow_unbuffered) {
  *buf_out = nullptr;
  if (eng->py_cids.find(e.cid) != eng->py_cids.end()) return 0;
  Engine::OrderGate *gt = nullptr;
  if (order) {
    gt = &eng->order_gates[{from_proc, okey}];
    if (order != gt->next || !gt->parked.empty()) return 0;
  }
  auto qit = eng->p2p.find(e.cid);
  if (qit == eng->p2p.end() || qit->second.draining) return 0;
  auto pit = qit->second.posted.find(e.dst);
  if (pit == qit->second.posted.end()) return 0;
  auto &plist = pit->second;
  for (size_t i = 0; i < plist.size(); i++) {
    if ((plist[i].src != -1 && plist[i].src != e.src) ||
        (plist[i].tag != -1 && plist[i].tag != e.tag))
      continue;
    auto rit = eng->reqs.find(plist[i].id);
    if (rit == eng->reqs.end()) return 0;
    ReqState *st = rit->second;
    bool placed = st->user_buf && st->user_cap >= total;
    if (!placed && !allow_unbuffered)
      return 0;  // eager caller: the normal delivery path is
                 // equivalent (the frame is already complete)
    uint64_t rid = plist[i].id;
    // a buffer-less (or too-small — MPI truncation keeps the copy
    // path) match still RESERVES: the order-gate slot is consumed at
    // the MATCH, so a copy-path message in a stream chain cannot
    // stall the in-place placements queued behind it
    if (placed) {
      *buf_out = (uint8_t *)st->user_buf;
      st->in_fill = true;
      eng->stats.add(TS_RECV_INTO_PLACED, 1);
    }
    st->reserved = true;  // cancel now refuses (MPI: the reservation
                          // IS the match, and a matched receive is
                          // not cancellable)
    plist.erase(plist.begin() + i);
    if (gt) gt->next++;
    return rid;
  }
  return 0;
}

// Complete a reserved in-place request: the user buffer already holds
// the payload, so delivery is a request completion, not a copy.
static void fill_complete(Engine *eng, uint64_t rid, Env &&env,
                          uint8_t *buf, uint64_t nbytes) {
  std::lock_guard<std::mutex> g(eng->mu);
  eng->stats.add(TS_DELIVERED, 1);
  auto rit = eng->reqs.find(rid);
  if (rit != eng->reqs.end()) {
    ReqState *st = rit->second;
    st->msg.env = std::move(env);
    st->msg.data = buf;
    st->msg.nbytes = nbytes;
    st->msg.arrival = eng->arrival++;
    st->completed = true;
    st->cv.notify_all();
  }
  wake_waiters(eng);
}

static void finish_reassembly(Engine *eng, const WireHdr &h,
                              Reassembly *ra) {
  OwnedMsg m;
  m.env = std::move(ra->env);
  m.data = ra->buf;
  m.nbytes = ra->total;
  // coll recv_into: the buffer is the waiter's posted destination
  // (p2p fills complete via fill_rid below instead) — flag it so no
  // delivery/cleanup path ever frees it and the waiter skips its copy
  m.noown = ra->fill_user && !ra->fill_rid;
  if (m.noown) eng->stats.add(TS_RECV_INTO_PLACED, 1);
  bool granted = ra->granted;
  uint64_t order = ra->order;
  uint16_t okey = ra->okey;
  uint64_t fill_rid = ra->fill_rid;
  {
    std::lock_guard<std::mutex> g(eng->rndv_mu);
    eng->reasm.erase({h.from_proc, h.seq});
    if (granted) {
      eng->rndv_active--;
      eng->stats.gauge(TS_RNDV_DEPTH, (uint64_t)eng->rndv_active);
      eng->rndv_cv.notify_one();
    }
  }
  delete ra;
  if (fill_rid) {
    // in-place rendezvous: matched at RTS time (the order slot was
    // consumed there); the user buffer already holds the payload
    fill_complete(eng, fill_rid, std::move(m.env), (uint8_t *)m.data,
                  m.nbytes);
    return;
  }
  if (order) {  // ring streaming: re-sequence to sender issue order
    deliver_ordered(eng, h.from_proc, okey, order, std::move(m));
    return;
  }
  std::lock_guard<std::mutex> g(eng->mu);
  deliver_locked(eng, std::move(m));
}

static void process_frame(Engine *eng, const WireHdr &h, const uint8_t *extra,
                          const uint8_t *payload, int rx_fd) {
  Env e;
  parse_extra(h, extra, &e);
  switch (h.type) {
    case FT_EAGER: {
      // ring records only reach here (the socket loop handles its
      // eager frames inline).  A posted recv that carries a buffer
      // takes the in-place path: one memcpy ring → user buffer, no
      // intermediate allocation — the same placement the streaming
      // RTS path gets, applied to single-record messages.
      if (e.kind == FK_P2P && h.nbytes) {
        uint8_t *ubuf = nullptr;
        uint64_t rid = 0;
        {
          std::lock_guard<std::mutex> g(eng->mu);
          rid = fill_reserve_locked(eng, e, h.nbytes, h.order, h.pad,
                                    h.from_proc, &ubuf, false);
        }
        if (rid && ubuf) {
          memcpy(ubuf, payload, h.nbytes);
          fill_complete(eng, rid, std::move(e), ubuf, h.nbytes);
          return;
        }
      }
      // coll recv_into: a posted coll destination takes the ring
      // payload with ONE memcpy ring → user buffer (the staging
      // malloc + the waiter's re-copy both disappear); issue-order
      // gating is unchanged — placement and sequencing are
      // orthogonal (the gate releases the same slot either way)
      void *cbuf = nullptr;
      if (e.kind == FK_COLL && h.nbytes) {
        std::lock_guard<std::mutex> g(eng->mu);
        cbuf = coll_into_reserve_locked(eng, e, h.nbytes);
      }
      OwnedMsg m;
      m.env = std::move(e);
      m.nbytes = h.nbytes;
      if (cbuf) {
        memcpy(cbuf, payload, h.nbytes);
        coll_into_release(eng, cbuf);  // write complete: scannable now
        m.data = cbuf;
        m.noown = true;
        eng->stats.add(TS_RECV_INTO_PLACED, 1);
      } else if (h.nbytes) {
        m.data = malloc(h.nbytes);
        memcpy(m.data, payload, h.nbytes);
      }
      if (h.order) {  // queued behind a stream: keep issue order
        deliver_ordered(eng, h.from_proc, h.pad, h.order, std::move(m));
        return;
      }
      std::lock_guard<std::mutex> g(eng->mu);
      deliver_locked(eng, std::move(m));
      return;
    }
    case FT_CTS: {
      // sender side: release the waiting send.  Snapshot the peer set
      // first so cts_mu is never taken under peers_mu — the reverse
      // nesting exists on the send path (cts bookkeeping under
      // send_mu after get_peer), and holding both here completes a
      // lock-order cycle (TSan-reported).  Peer objects are stable:
      // they are only freed by tdcn_destroy after every reader (this
      // thread included) has exited.
      std::vector<Peer *> snapshot;
      {
        std::lock_guard<std::mutex> g(eng->peers_mu);
        snapshot.reserve(eng->peers.size());
        for (auto &kv : eng->peers) snapshot.push_back(kv.second);
      }
      for (Peer *p : snapshot) {
        std::lock_guard<std::mutex> g2(p->cts_mu);
        auto it = p->cts.find(h.seq);
        if (it != p->cts.end()) {
          it->second = true;
          p->cts_cv.notify_all();
          return;
        }
      }
      return;
    }
    case FT_RTS: {
      auto *ra = new Reassembly();
      ra->env = std::move(e);
      // the header seq is the reassembly xid; the TRUE envelope seq
      // was stashed in h.off by the sender
      ra->env.seq = (int64_t)h.off;
      ra->total = h.total;
      if (rx_fd < 0) {
        // ring path: no CTS, no slot — the sender's streaming engine
        // caps in-flight bytes (dcn_inflight_limit) and ring
        // backpressure is the flow control; the issue-order tag rides
        // the RTS so completion re-sequences through the gate
        ra->order = h.order;
        ra->okey = h.pad;
        // In-place rendezvous placement (the reference pml's recv
        // side): an IN-ORDER streaming RTS that finds a matching
        // posted recv with capacity reserves it and lands its FRAGs
        // straight in the user buffer — no reassembly malloc, no
        // delivery copy, and a windowed burst stops dragging a second
        // window-sized working set through the cache.  The match
        // consumes the order-gate slot NOW (this IS the MPI match;
        // completion may lag later deliveries, which MPI permits).
        if (h.order && ra->env.kind == FK_P2P) {
          uint8_t *ubuf = nullptr;
          std::lock_guard<std::mutex> g(eng->mu);
          ra->fill_rid = fill_reserve_locked(eng, ra->env, ra->total,
                                             h.order, h.pad,
                                             h.from_proc, &ubuf, true);
          if (ubuf) {
            ra->buf = ubuf;
            ra->fill_user = true;
          }
        }
        void *ccbuf = nullptr;
        if (!ra->buf && ra->env.kind == FK_COLL) {
          // coll recv_into, streaming leg: bind the posted coll
          // destination as the reassembly target — FRAGs stream
          // straight into the user buffer, no staging malloc
          std::lock_guard<std::mutex> g(eng->mu);
          ccbuf = coll_into_reserve_locked(eng, ra->env, ra->total);
          if (ccbuf) {
            ra->buf = (uint8_t *)ccbuf;
            ra->fill_user = true;
          }
        }
        if (!ra->buf)
          ra->buf = (uint8_t *)malloc(ra->total ? ra->total : 1);
        {
          std::lock_guard<std::mutex> g2(eng->rndv_mu);
          eng->reasm[{h.from_proc, h.seq}] = ra;
        }
        coll_into_release(eng, ccbuf);  // in reasm: scannable now
        return;
      }
      // tcp path: acquire an inbound-rndv slot (bounds ingress
      // memory), allocate only then, and grant CTS.  A posted coll
      // destination binds as the reassembly target FIRST (reserved
      // outside rndv_mu — eng->mu must not nest inside it): the user
      // buffer replaces the staging malloc and counts no engine
      // ingress memory, but the slot protocol is unchanged.
      void *ccbuf = nullptr;
      if (ra->env.kind == FK_COLL) {
        std::lock_guard<std::mutex> g(eng->mu);
        ccbuf = coll_into_reserve_locked(eng, ra->env, ra->total);
        if (ccbuf) {
          ra->buf = (uint8_t *)ccbuf;
          ra->fill_user = true;
        }
      }
      {
        // the into-claim spans this slot wait: no FRAG can target the
        // bound buffer until the CTS below, but an aborting waiter
        // must not return (and let the caller free it) while the
        // binding is invisible to its reasm scan.  Forward progress:
        // slots free as other transfers complete/abandon, and closing
        // breaks the wait.
        std::unique_lock<std::mutex> g(eng->rndv_mu);
        if (eng->rndv_active >= eng->max_rndv)
          eng->stats.add(TS_SLOT_WAITS, 1);  // sender's CTS delayed on
                                             // slot reclaim
        eng->rndv_cv.wait(g, [&] {
          return eng->rndv_active < eng->max_rndv ||
                 eng->closing.load(std::memory_order_relaxed);
        });
        if (eng->closing.load(std::memory_order_relaxed)) {
          delete ra;  // fill_user buf is the waiter's: nothing to free
          g.unlock();
          coll_into_release(eng, ccbuf);
          return;
        }
        eng->rndv_active++;
        eng->stats.gauge(TS_RNDV_DEPTH, (uint64_t)eng->rndv_active);
        eng->stats.hwm(TS_RNDV_HWM, (uint64_t)eng->rndv_active);
        ra->granted = true;
        if (!ra->buf)
          ra->buf = (uint8_t *)malloc(ra->total ? ra->total : 1);
        eng->reasm[{h.from_proc, h.seq}] = ra;
      }
      coll_into_release(eng, ccbuf);  // in reasm: scannable now
      // CTS rides the same socket back (rx connections are duplex)
      WireHdr cts;
      Env ce;
      ce.seq = h.seq;
      fill_hdr(&cts, FT_CTS, ce, eng->proc, 0, 0, 0);
      send_all(rx_fd, &cts, sizeof(cts));
      return;
    }
    case FT_FRAG: {  // ring path (socket FRAGs are handled inline in
                     // sock_recv_loop with a direct-to-buffer recv)
      Reassembly *ra = nullptr;
      {
        std::lock_guard<std::mutex> g(eng->rndv_mu);
        auto it = eng->reasm.find({h.from_proc, h.seq});
        if (it != eng->reasm.end()) {
          ra = it->second;
          if (ra->dead) {
            // aborted coll recv_into: the waiter returned an error
            // and the caller owns `buf` again — drop the transfer
            // (later FRAGs hit the unknown-transfer drop path)
            eng->reasm.erase(it);
            if (ra->granted) {
              eng->rndv_active--;
              eng->stats.gauge(TS_RNDV_DEPTH, (uint64_t)eng->rndv_active);
              eng->rndv_cv.notify_one();
            }
            delete ra;  // fill_user buf is the caller's: never freed
            return;
          }
          ra->busy.store(1, std::memory_order_relaxed);
        }
      }
      if (!ra) return;  // drop
      if (h.off + h.nbytes > ra->total) {
        ra->busy.store(0, std::memory_order_release);
        return;  // drop
      }
      memcpy(ra->buf + h.off, payload, h.nbytes);
      ra->received += h.nbytes;
      ra->busy.store(0, std::memory_order_release);
      if (ra->received >= ra->total) finish_reassembly(eng, h, ra);
      return;
    }
    default:
      return;
  }
}

// ---------------------------------------------------------------------
// socket receive loop
// ---------------------------------------------------------------------

// Sender connection died: drop its incomplete rendezvous transfers
// and return any slots they held (the C twin of the Python
// transport's _abandon) — a broken transfer must never leak a
// max_rndv slot, or a few severed connections would permanently
// starve every future CTS grant on this engine.
static void abandon_reassemblies(
    Engine *eng, const std::set<std::pair<int, int64_t>> &keys) {
  for (const auto &key : keys) {
    Reassembly *ra = nullptr;
    {
      std::lock_guard<std::mutex> g(eng->rndv_mu);
      auto it = eng->reasm.find(key);
      if (it == eng->reasm.end()) continue;
      ra = it->second;
      eng->reasm.erase(it);
      if (ra->granted) {
        eng->rndv_active--;
        eng->stats.gauge(TS_RNDV_DEPTH, (uint64_t)eng->rndv_active);
        eng->rndv_cv.notify_one();
      }
    }
    if (!ra->fill_user) free(ra->buf);  // in-place: the buffer is
                                        // the user's, never engine-owned
    delete ra;
  }
}

static void sock_recv_loop(Engine *eng, int fd) {
  std::vector<uint8_t> extra;
  // in-flight rendezvous transfers whose RTS arrived on THIS socket
  // (their FRAGs ride the same connection); abandoned if it dies
  std::set<std::pair<int, int64_t>> conn_keys;
  while (!eng->closing.load(std::memory_order_relaxed)) {
    WireHdr h;
    if (!recv_exact(fd, &h, sizeof(h))) break;
    if (h.magic != TDCN_MAGIC) break;
    size_t ex = env_extra(h);
    extra.resize(ex ? ex : 1);
    if (ex && !recv_exact(fd, extra.data(), ex)) break;
    if (h.type == FT_SETUP) {
      // same-host sender announced its tx ring: map it for polling
      std::string rname((const char *)extra.data(), h.cid_len);
      auto *ring = new ShmRing();
      if (ring->open_existing(rname)) {
        std::lock_guard<std::mutex> g(eng->rings_mu);
        eng->rx_rings.push_back(ring);
        eng->my_db.word->fetch_add(1, std::memory_order_release);
      } else {
        delete ring;
      }
      continue;
    }
    if (h.type == FT_EAGER) {
      // receive straight into the delivery buffer (single copy:
      // kernel -> destination, like the reference's btl recv path) —
      // or straight into a POSTED coll destination (coll recv_into:
      // kernel -> user buffer, zero staging).  The envelope parses
      // from `extra`, already read, so the posting lookup precedes
      // the payload read; a posting only exists while no message for
      // its key arrived, so a dedup-dropped duplicate can never have
      // claimed one (the authentic delivery consumed it first).
      Env e;
      parse_extra(h, extra.data(), &e);
      void *cbuf = nullptr;
      if (e.kind == FK_COLL && h.nbytes) {
        std::lock_guard<std::mutex> g(eng->mu);
        cbuf = coll_into_reserve_locked(eng, e, h.nbytes);
      }
      void *buf = cbuf ? cbuf : (h.nbytes ? malloc(h.nbytes) : nullptr);
      if (h.nbytes && !recv_exact(fd, buf, h.nbytes)) {
        coll_into_release(eng, cbuf);
        if (!cbuf) free(buf);
        break;
      }
      coll_into_release(eng, cbuf);  // socket read done: scannable now
      if (h.off) {
        // nonzero off on an eager frame = the sender's per-peer seq
        // (+ lineage nonce, see tcp_send_once): drop the duplicate a
        // redial+resend round (or an injected wire dup) can produce
        // — exactly-once across reconnects
        uint64_t xs = h.off & ((1ull << 40) - 1);
        uint64_t nonce = ((h.off >> 40) << 16) | h.pad;
        bool dup_frame;
        {
          std::lock_guard<std::mutex> g(eng->dedup_mu);
          dup_frame = eng->rx_seen[{h.from_proc, nonce}].is_dup(xs);
        }
        if (dup_frame) {
          eng->stats.add(TS_DEDUP_DROPS, 1);
          if (!cbuf) free(buf);
          continue;
        }
      }
      OwnedMsg m;
      m.env = std::move(e);
      m.data = buf;
      m.nbytes = h.nbytes;
      m.noown = cbuf != nullptr;
      if (cbuf) eng->stats.add(TS_RECV_INTO_PLACED, 1);
      std::lock_guard<std::mutex> g(eng->mu);
      deliver_locked(eng, std::move(m));
      continue;
    }
    if (h.type == FT_FRAG) {
      // stream straight into the reassembly buffer when it exists
      Reassembly *ra = nullptr;
      {
        std::lock_guard<std::mutex> g(eng->rndv_mu);
        auto it = eng->reasm.find({h.from_proc, h.seq});
        if (it != eng->reasm.end()) {
          ra = it->second;
          if (ra->dead) {
            // aborted coll recv_into: the caller owns `buf` again —
            // drop the transfer, drain this FRAG off the wire below
            eng->reasm.erase(it);
            if (ra->granted) {
              eng->rndv_active--;
              eng->stats.gauge(TS_RNDV_DEPTH, (uint64_t)eng->rndv_active);
              eng->rndv_cv.notify_one();
            }
            delete ra;  // fill_user buf is the caller's: never freed
            ra = nullptr;
          } else {
            ra->busy.store(1, std::memory_order_relaxed);
          }
        }
      }
      if (ra && h.off + h.nbytes <= ra->total) {
        bool ok = !h.nbytes || recv_exact(fd, ra->buf + h.off, h.nbytes);
        if (ok) ra->received += h.nbytes;
        ra->busy.store(0, std::memory_order_release);
        if (!ok) break;
        if (ra->received >= ra->total) {
          finish_reassembly(eng, h, ra);
          conn_keys.erase({h.from_proc, h.seq});
        }
      } else {
        if (ra) ra->busy.store(0, std::memory_order_release);
        // unknown transfer: drain and drop
        std::vector<uint8_t> sink(h.nbytes ? h.nbytes : 1);
        if (h.nbytes && !recv_exact(fd, sink.data(), h.nbytes)) break;
      }
      continue;
    }
    if (h.type == FT_RTS) conn_keys.insert({h.from_proc, h.seq});
    process_frame(eng, h, extra.data(), nullptr, fd);
  }
  // NOTE: fd is closed by sock_recv_entry (under reader_mu)
  abandon_reassemblies(eng, conn_keys);
}

// every detached reader goes through this pair: the count is bumped
// BEFORE the thread exists (no spawn→entry gap) and dropped as the
// thread's last touch of the Engine, so readers == 0 after close
// means no detached thread can dereference eng again.  The fd is
// erased and closed under reader_mu — the same lock close() holds
// while shutdown()ing — so a close-time shutdown can never hit a
// recycled descriptor number.
static void sock_recv_entry(Engine *eng, int fd) {
  sock_recv_loop(eng, fd);
  {
    std::lock_guard<std::mutex> g(eng->reader_mu);
    eng->reader_fds.erase(fd);
    close(fd);
  }
  eng->readers.fetch_sub(1, std::memory_order_release);
}

static void spawn_reader(Engine *eng, int fd) {
  {
    std::lock_guard<std::mutex> g(eng->reader_mu);
    eng->reader_fds.insert(fd);
  }
  eng->readers.fetch_add(1, std::memory_order_relaxed);
  std::thread(sock_recv_entry, eng, fd).detach();
}

static void accept_loop(Engine *eng, int lfd) {
  // poll + timeout: close() does NOT wake a blocked accept() on
  // Linux, so a pure-blocking accept thread would never join
  while (!eng->closing.load(std::memory_order_relaxed)) {
    struct pollfd pf = {lfd, POLLIN, 0};
    int pr = poll(&pf, 1, 100);
    if (pr < 0 && errno != EINTR) return;
    if (pr <= 0 || !(pf.revents & POLLIN)) continue;
    int fd = accept(lfd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR || errno == EAGAIN) continue;
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    spawn_reader(eng, fd);
  }
}

// ---------------------------------------------------------------------
// shm ring consume loop (one thread per engine)
// ---------------------------------------------------------------------

static void consume_ring(Engine *eng, ShmRing *r) {
  for (;;) {
    uint64_t head = r->ctrl->head.load(std::memory_order_acquire);
    uint64_t tail = r->ctrl->tail.load(std::memory_order_relaxed);
    if (tail == head) return;
    uint64_t pos = tail % r->size;
    uint64_t rec = *(uint64_t *)(r->data + pos);
    if (rec & PAD_BIT) {
      r->ctrl->tail.store(tail + (rec & ~PAD_BIT),
                          std::memory_order_release);
      r->wake_producer();
      continue;
    }
    const uint8_t *p = r->data + pos + 8;
    WireHdr h;
    memcpy(&h, p, sizeof(h));
    const uint8_t *extra = p + sizeof(h);
    const uint8_t *payload = extra + env_extra(h);
    process_frame(eng, h, extra, payload, -1);
    r->ctrl->tail.store(tail + ((rec + 7) & ~7ull),
                        std::memory_order_release);
    // space doorbell: a producer parked on ring backpressure (the
    // streaming sender's yield path) wakes as soon as bytes free up —
    // one relaxed load here while nobody waits
    r->wake_producer();
  }
}

// Drain every rx ring once (try-lock arbitrated between the poller
// thread and inline-progress waiters).  Returns true when any record
// was consumed.
static bool try_consume_rings(Engine *eng) {
  if (eng->closing.load(std::memory_order_relaxed)) return false;
  if (!eng->consume_mu.try_lock()) return false;
  bool any = false;
  {
    std::lock_guard<std::mutex> g(eng->rings_mu);
    for (ShmRing *r : eng->rx_rings) {
      if (!r->ctrl) continue;  // destroyed under rings_mu by close
      if (r->ctrl->head.load(std::memory_order_acquire) !=
          r->ctrl->tail.load(std::memory_order_relaxed)) {
        consume_ring(eng, r);
        any = true;
      }
    }
  }
  eng->consume_mu.unlock();
  return any;
}

// The blocked caller IS the progress engine (the reference's
// opal_progress discipline): consume rings inline, spin briefly on
// the doorbell, then futex-wait with a short timeout.  `done` is
// checked with eng->mu held via the caller's lock `g`.
template <typename Pred>
static bool progress_wait(Engine *eng, std::unique_lock<std::mutex> &g,
                          Pred done, double timeout_s) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout_s);
  struct WaiterMark {  // parks the backstop poller while we drive
    Engine *e;
    WaiterMark(Engine *e) : e(e) { e->waiters.fetch_add(1); }
    ~WaiterMark() { e->waiters.fetch_sub(1); }
  } mark(eng);
  while (!done()) {
    // Load the doorbell BEFORE dropping the lock and checking the
    // rings: any completion or ring publish that lands after this
    // load bumps the word, so the futex_wait below returns
    // immediately instead of stalling out its full timeout (the
    // lost-wakeup ordering: record seen -> check state -> wait(seen)).
    uint32_t seen = eng->my_db.word->load(std::memory_order_acquire);
    g.unlock();
    bool consumed = try_consume_rings(eng);
    if (!consumed) {
      bool changed =
          eng->my_db.word->load(std::memory_order_acquire) != seen;
      for (int i = 0; !changed && i < eng->spin_iters; i++) {
        if (eng->my_db.word->load(std::memory_order_acquire) != seen) {
          changed = true;
          break;
        }
#if defined(__x86_64__)
        __builtin_ia32_pause();
#endif
      }
      if (!changed) {
        struct timespec ts = {0, 2000000};  // 2 ms: deadline cadence
        eng->my_db.park();
        futex_wait(eng->my_db.word, seen, &ts);
        eng->my_db.unpark();
      }
    }
    g.lock();
    if (done()) return true;
    if (std::chrono::steady_clock::now() > deadline) return false;
  }
  return true;
}

static void ring_poll_loop(Engine *eng) {
  // Backstop consumer: inline-progress waiters normally drain the
  // rings themselves; this thread covers phases with no blocked
  // waiter (unexpected messages, PY-queue traffic).
  uint32_t seen = eng->my_db.word->load(std::memory_order_acquire);
  while (!eng->closing.load(std::memory_order_relaxed)) {
    if (eng->waiters.load(std::memory_order_relaxed) == 0 &&
        try_consume_rings(eng)) {
      seen = eng->my_db.word->load(std::memory_order_acquire);
      continue;
    }
    uint32_t now = eng->my_db.word->load(std::memory_order_acquire);
    if (now != seen &&
        eng->waiters.load(std::memory_order_relaxed) == 0) {
      seen = now;
      continue;
    }
    seen = now;
    if (eng->waiters.load(std::memory_order_relaxed) == 0) {
      // nobody else is listening: the poller is the one consumer a
      // publish must wake, so it registers as parked (senders pay the
      // futex_wake) and sleeps the long backstop quantum
      struct timespec ts = {0, 50000000};  // 50 ms: close() sensitivity
      eng->my_db.park();
      futex_wait(eng->my_db.word, seen, &ts);
      eng->my_db.unpark();
    } else {
      // an inline-progress waiter is driving: it parks itself when it
      // runs dry, so the poller sleeps UNREGISTERED — under a windowed
      // burst the consumer is busy, nobody is parked, and every
      // per-record futex_wake the old path paid becomes a suppressed
      // doorbell.  Short quantum: if the waiter exits mid-sleep the
      // poller resumes backstop duty within ~4 ms.
      struct timespec ts = {0, 4000000};
      futex_wait(eng->my_db.word, seen, &ts);
    }
    seen = eng->my_db.word->load(std::memory_order_acquire);
  }
}

// ---------------------------------------------------------------------
// address composition / peer setup
// ---------------------------------------------------------------------

// address: ntv:<host_id>|<tcp host:port>|<uds name>|<doorbell name>
static std::string compose_address(Engine *eng) {
  return "ntv:" + eng->host_id + "|" + eng->tcp_addr + "|" + eng->uds_name +
         "|" + eng->db_name;
}

static bool parse_address(const std::string &a, Peer *p) {
  if (a.rfind("ntv:", 0) != 0) return false;
  std::string rest = a.substr(4);
  size_t p1 = rest.find('|');
  size_t p2 = rest.find('|', p1 + 1);
  size_t p3 = rest.find('|', p2 + 1);
  if (p1 == std::string::npos || p2 == std::string::npos ||
      p3 == std::string::npos)
    return false;
  p->host_id = rest.substr(0, p1);
  p->tcp_host = rest.substr(p1 + 1, p2 - p1 - 1);
  p->uds_name = rest.substr(p2 + 1, p3 - p2 - 1);
  p->db_name = rest.substr(p3 + 1);
  return true;
}

static int connect_tcp(const std::string &hostport) {
  size_t c = hostport.rfind(':');
  if (c == std::string::npos) return -1;
  std::string host = hostport.substr(0, c);
  int port = atoi(hostport.c_str() + c + 1);
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct sockaddr_in sa;
  memset(&sa, 0, sizeof(sa));
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host.c_str(), &sa.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (connect(fd, (struct sockaddr *)&sa, sizeof(sa)) != 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

static int connect_uds(const std::string &name) {
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct sockaddr_un sa;
  memset(&sa, 0, sizeof(sa));
  sa.sun_family = AF_UNIX;
  sa.sun_path[0] = '\0';
  size_t n = name.size();
  if (n > sizeof(sa.sun_path) - 2) n = sizeof(sa.sun_path) - 2;
  memcpy(sa.sun_path + 1, name.data(), n);
  socklen_t len = (socklen_t)(offsetof(struct sockaddr_un, sun_path) + 1 + n);
  if (connect(fd, (struct sockaddr *)&sa, len) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

// one dial attempt on the peer's preferred wire (uds same-host, tcp
// otherwise)
static int dial_peer_once(Engine *eng, Peer *p) {
  (void)eng;
  int fd = -1;
  if (p->same_host && !p->uds_name.empty()) fd = connect_uds(p->uds_name);
  if (fd < 0) fd = connect_tcp(p->tcp_host);
  return fd;
}

// Dial under the connect deadline (tdcn_set_connect_timeout — the
// dcn_connect_timeout policy): exponential backoff between attempts,
// matching the Python transport's _dial_backoff.  Returns the fd or
// -1 once the deadline runs out / the engine closes.  Attempts beyond
// the first count TS_RETRY_DIALS.
static int dial_backoff(Engine *eng, Peer *p) {
  uint64_t tmo = eng->connect_timeout_ns.load(std::memory_order_relaxed);
  uint64_t give_up = tmo ? now_ns() + tmo : 0;
  uint64_t delay_ns = 50ull * 1000 * 1000;           // 50 ms base
  const uint64_t cap_ns = 1000ull * 1000 * 1000;     // 1 s cap
  for (;;) {
    if (eng->closing.load(std::memory_order_relaxed)) return -1;
    int fd = dial_peer_once(eng, p);
    if (fd >= 0) return fd;
    eng->stats.add(TS_RETRY_DIALS, 1);
    if (give_up && now_ns() + delay_ns > give_up) {
      eng->stats.add(TS_DEADLINE_EXPIRED, 1);
      return -1;
    }
    struct timespec ts = {(time_t)(delay_ns / 1000000000ull),
                          (long)(delay_ns % 1000000000ull)};
    nanosleep(&ts, nullptr);
    delay_ns = delay_ns * 2 < cap_ns ? delay_ns * 2 : cap_ns;
  }
}

// get-or-create the peer for a composite address; lazily connect with
// ONE attempt — heartbeats/gossip ride this path too, and a blocked
// backoff loop here would freeze the detector thread for the whole
// connect deadline.  Data sends that find fd < 0 (or lose it) run the
// backoff redial in engine_send_peer's retry round instead, where the
// control-frame exemption applies.
static Peer *get_peer(Engine *eng, const std::string &address) {
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    auto it = eng->peers.find(address);
    if (it != eng->peers.end()) return it->second;
  }
  Peer *p = new Peer();
  p->address = address;
  if (!parse_address(address, p)) {
    // plain host:port (mixed job with the Python tcp transport is NOT
    // supported across engines — addresses must be ntv:)
    p->tcp_host = address;
  }
  p->same_host = (!p->host_id.empty() && p->host_id == eng->host_id);
  // sender-lineage tag for rx dedup (splitmix-style scramble of the
  // creation time; 40 bits ride the wire — see tcp_send_once)
  p->nonce = ((now_ns() ^ ((uint64_t)(uintptr_t)p << 17)) *
              0x9E3779B97F4A7C15ull) >> 24 & ((1ull << 40) - 1);
  p->fd = dial_peer_once(eng, p);
  if (p->fd >= 0) p->epoch = 1;
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    auto it = eng->peers.find(address);
    if (it != eng->peers.end()) {  // raced: keep the first
      if (p->fd >= 0) close(p->fd);
      delete p;
      return it->second;
    }
    eng->peers[address] = p;
  }
  // our inbound CTS for rndv rides the SAME socket (duplex): spawn a
  // reader for it
  if (p->fd >= 0) spawn_reader(eng, dup(p->fd));
  return p;
}

// ---------------------------------------------------------------------
// send paths
// ---------------------------------------------------------------------

// consult the armed fault plan before a ring write; returns false
// when this write must FAIL (injected wedge — callers surface it as
// the usual send error, which Python escalates ULFM-style)
static bool fault_ring_ok(Engine *eng) {
  if (!g_fault_armed.load(std::memory_order_relaxed)) return true;
  uint64_t k = g_fault_events.fetch_add(1, std::memory_order_relaxed) + 1;
  uint64_t stall = g_fault_stall_ns.load(std::memory_order_relaxed);
  uint64_t every = g_fault_stall_every.load(std::memory_order_relaxed);
  if (stall && every && k % every == 0) {
    // injected backpressure: sleep AND account it as ring stall so the
    // metrics stall breakdown shows the simulated wedge
    eng->stats.add(TS_INJECTED_FAULTS, 1);
    eng->stats.add(TS_RING_STALLS, 1);
    eng->stats.add(TS_RING_STALL_NS, stall);
    eng->stats.add(TS_STALL_NS, stall);
    struct timespec ts = {(time_t)(stall / 1000000000ull),
                          (long)(stall % 1000000000ull)};
    nanosleep(&ts, nullptr);
  }
  int64_t fail_at = g_fault_fail_at.load(std::memory_order_relaxed);
  if (fail_at >= 0 && (int64_t)k == fail_at) {
    eng->stats.add(TS_INJECTED_FAULTS, 1);
    return false;
  }
  return true;
}

static int tcp_send_once(Engine *eng, Peer *p, Env &e, const void *data,
                         uint64_t nbytes, uint64_t xs);

// consult the armed wire-dup knob after a successful seq'd eager
// send: the matching event re-transmits the identical frame (same
// lineage nonce, same seq), handing the receiver a true wire
// duplicate its dedup watermark must absorb
static void fault_dup_check(Engine *eng, Peer *p, Env &e,
                            const void *data, uint64_t nbytes,
                            uint64_t xs) {
  if (!xs) return;  // only seq'd eager frames participate in dedup
  int64_t at = g_fault_dup_at.load(std::memory_order_relaxed);
  if (at < 0) return;
  uint64_t k =
      g_fault_dup_events.fetch_add(1, std::memory_order_relaxed) + 1;
  if ((int64_t)k == at) {
    eng->stats.add(TS_INJECTED_FAULTS, 1);
    tcp_send_once(eng, p, e, data, nbytes, xs);
  }
}

// consult the armed connkill knob before a tcp send: the matching
// event finds its socket severed in place, so the in-flight send
// fails and exercises the redial+resend round (the same contract as
// the Python transport's _kill_peer site)
static void fault_conn_check(Engine *eng, Peer *p) {
  int64_t at = g_fault_conn_at.load(std::memory_order_relaxed);
  if (at < 0) return;
  uint64_t k =
      g_fault_conn_events.fetch_add(1, std::memory_order_relaxed) + 1;
  if ((int64_t)k == at && p->fd >= 0) {
    eng->stats.add(TS_INJECTED_FAULTS, 1);
    shutdown(p->fd, SHUT_RDWR);
  }
}

// injected latency at the blocking-receive entry (tdcn_precv: the
// native pml recv AND the C-ABI shim's MPI_Recv ride it)
static void fault_recv_check(Engine *eng) {
  if (!g_fault_recv_armed.load(std::memory_order_relaxed)) return;
  uint64_t k =
      g_fault_recv_events.fetch_add(1, std::memory_order_relaxed) + 1;
  uint64_t every = g_fault_recv_every.load(std::memory_order_relaxed);
  uint64_t ns = g_fault_recv_ns.load(std::memory_order_relaxed);
  if (ns && every && k % every == 0) {
    eng->stats.add(TS_INJECTED_FAULTS, 1);
    struct timespec ts = {(time_t)(ns / 1000000000ull),
                          (long)(ns % 1000000000ull)};
    nanosleep(&ts, nullptr);
  }
}

// Fill + publish one reserved ring record, account occupancy, and
// ring the (coalesced) doorbell — the shared tail of both the
// blocking and the streaming sender's record writes.
static void ring_put_record(Engine *eng, Peer *p, uint8_t *w,
                            uint64_t rec_start, uint64_t need,
                            const WireHdr &h, const Env &e,
                            const void *payload) {
  *(uint64_t *)w = need;  // full record length (u64 prefix included)
  uint8_t *q = w + 8;
  memcpy(q, &h, sizeof(h));
  q += sizeof(h);
  write_extra(q, e);
  q += env_extra(h);
  if (h.nbytes) memcpy(q, payload, h.nbytes);
  p->tx_ring.publish(rec_start, need);
  // occupancy after publish: producer cursor minus the consumer's last
  // published tail — the high-water tells the perf rounds how close
  // the windowed burst came to the backpressure cliff
  eng->stats.hwm(TS_RING_HWM,
                 rec_start + ((need + 7) & ~7ull) -
                     p->tx_ring.ctrl->tail.load(std::memory_order_relaxed));
  p->peer_db.ring(&eng->stats,
                  eng->db_coalesce.load(std::memory_order_relaxed) != 0);
}

static bool send_record_ring(Engine *eng, Peer *p, const WireHdr &h,
                             const Env &e, const void *payload,
                             uint64_t timeout_ns, bool faultable) {
  // control frames are exempt from injection (the faultsim contract:
  // heartbeat/gossip traffic must not consume schedule events or be
  // failed by the plan — detection must stay deterministic)
  if (faultable && !fault_ring_ok(eng)) return false;
  uint64_t need = 8 + sizeof(WireHdr) + env_extra(h) + h.nbytes;
  uint64_t rec_start;
  uint8_t *w = p->tx_ring.reserve(need, &rec_start, &eng->closing,
                                  &eng->stats, timeout_ns, eng,
                                  p->address.c_str(), &p->marked_failed);
  if (!w) return false;
  ring_put_record(eng, p, w, rec_start, need, h, e, payload);
  return true;
}

// Non-blocking record placement for the streaming sender: 1 =
// published, 0 = ring backpressure (the caller's turn yields to other
// peers' work instead of spinning in reserve), -1 = injected
// failure / engine closing.  The fault plan is consulted only AFTER a
// successful placement so backpressure retries never consume schedule
// events (the per-record determinism faultsim documents).
static int try_send_record_ring(Engine *eng, Peer *p, const WireHdr &h,
                                const Env &e, const void *payload) {
  if (eng->closing.load(std::memory_order_relaxed)) return -1;
  uint64_t need = 8 + sizeof(WireHdr) + env_extra(h) + h.nbytes;
  uint64_t rec_start;
  uint8_t *w = p->tx_ring.try_reserve(need, &rec_start);
  if (!w) return 0;
  if (!fault_ring_ok(eng)) return -1;  // record never published
  ring_put_record(eng, p, w, rec_start, need, h, e, payload);
  return 1;
}

static bool ensure_ring(Engine *eng, Peer *p) {
  if (p->tx_ring.ctrl) return true;
  char nm[128];
  snprintf(nm, sizeof(nm), "/tdcn-%d-%d-%llx", getpid(), eng->proc,
           (unsigned long long)(uintptr_t)p & 0xffffff);
  if (!p->tx_ring.create(nm, eng->ring_bytes)) return false;
  if (!p->peer_db.open_existing(p->db_name)) {
    p->tx_ring.destroy(true);
    return false;
  }
  // announce over the socket; receiver maps it before any ring data
  // (socket send happens-before our first doorbell)
  WireHdr sh;
  Env se;
  se.kind = FK_COLL;
  se.cid = nm;
  fill_hdr(&sh, FT_SETUP, se, eng->proc, 0, 0, 0);
  if (!send_all(p->fd, &sh, sizeof(sh)) ||
      !send_all(p->fd, nm, strlen(nm))) {
    p->tx_ring.destroy(true);
    return false;
  }
  p->ring_announced = true;
  p->ring_ready.store(true, std::memory_order_release);
  return true;
}

// ---------------------------------------------------------------------
// streaming send engine (the pipelined large-message ring path)
// ---------------------------------------------------------------------
//
// A larger-than-chunk (or queued-behind-one) payload enqueues a
// StreamDesc instead of looping over FRAGs while holding p->send_mu
// for the whole message; the per-engine sender thread (sender_loop)
// services every peer's queue round-robin, one record per descriptor
// per pass, so 64 windowed 4 MiB sends stream cooperatively instead of
// head-of-line blocking each other.  A full ring ends the peer's turn
// (TS_SENDER_YIELDS) and the loop parks on the consumer's space
// doorbell instead of spinning against the consumer it waits for.
// Blocking sends ride the same queue (borrowed buffer + completion
// wait) whenever ordering requires it; the small-message direct path
// is untouched while the queue is empty.

static const uint64_t STREAM_CHUNK_MIN = 64ull << 10;

// effective FRAG granularity for one peer: the adaptive override when
// backpressure shrank it, else the dcn_chunk_bytes knob; always fits
// the ring with record headroom.  Mutated only by the sender thread
// under p->send_mu.
static uint64_t stream_chunk(Engine *eng, Peer *p) {
  uint64_t c = p->chunk_now
                   ? p->chunk_now
                   : eng->chunk_bytes.load(std::memory_order_relaxed);
  uint64_t cap =
      eng->ring_bytes / 2 > 4096 ? eng->ring_bytes / 2 - 4096 : 512;
  if (c > cap) c = cap;
  if (c < 4096) c = 4096;
  return c;
}

// Mark every queued descriptor failed (ring deadline expired, injected
// wedge, or engine close) and poison the peer's stream path — the
// Python side escalates the peer ULFM-style on the next rc, exactly
// like a failed direct send.  Caller holds NOTHING.
static void stream_fail_peer(Engine *eng, Peer *p, int rc) {
  // detached descriptors have no waiter — the engine owns their
  // memory.  Partition UNDER the lock: once `done` is published a
  // waiter (or tdcn_send_forget) may free the others concurrently.
  std::vector<StreamDesc *> reclaim;
  {
    std::lock_guard<std::mutex> sg(p->stream_mu);
    if (p->streams.empty()) return;
    std::deque<StreamDesc *> dead;
    dead.swap(p->streams);
    p->stream_failed = true;
    p->stream_rr = 0;
    eng->stream_inflight_now.fetch_sub(p->stream_inflight,
                                       std::memory_order_relaxed);
    p->stream_inflight = 0;
    eng->stream_depth_now.fetch_sub(dead.size(),
                                    std::memory_order_relaxed);
    eng->stats.gauge(TS_STREAM_DEPTH, eng->stream_depth_now.load(
                                          std::memory_order_relaxed));
    eng->stats.gauge(TS_STREAM_INFLIGHT,
                     eng->stream_inflight_now.load(
                         std::memory_order_relaxed));
    for (StreamDesc *d : dead) {
      d->rc = rc;
      if (d->detached) {
        reclaim.push_back(d);
      } else {
        d->done = true;
      }
    }
    p->stream_cv.notify_all();
  }
  for (StreamDesc *d : reclaim) {
    free(d->owned);
    delete d;
  }
}

// Service ONE record of descriptor `d` (p->send_mu HELD by the sender
// thread's turn).  Returns 2 = published the descriptor's final
// record, 1 = published a non-final record, 0 = ring backpressure,
// -1 = injected failure / closing.
static int stream_service_one(Engine *eng, Peer *p, StreamDesc *d) {
  if (d->eager) {
    // fits one record: emitted as ONE ordered eager record when its
    // turn comes — it queued only to keep issue order behind a stream
    WireHdr h;
    fill_hdr(&h, FT_EAGER, d->env, eng->proc, 0, d->nbytes, d->nbytes);
    h.order = d->order;
    h.pad = (uint16_t)(p->nonce & 0xFFFF);
    int rc = try_send_record_ring(eng, p, h, d->env, d->data);
    if (rc <= 0) return rc;
    d->sent = d->nbytes;
    eng->stats.add(TS_EAGER_MSGS, 1);
    eng->stats.add(TS_EAGER_BYTES, d->nbytes);
    return 2;
  }
  if (!d->rts_sent) {
    // RTS announces the transfer (no CTS — the in-flight cap plus ring
    // backpressure are the flow control); the issue-order tag rides it
    // so the receiver's gate re-sequences the completion.  h.seq
    // carries the reassembly xid; the TRUE envelope seq rides in h.off
    // (restored receiver-side), exactly like the old chunked path.
    Env rts_env = d->env;
    rts_env.seq = d->xid;
    WireHdr h;
    fill_hdr(&h, FT_RTS, rts_env, eng->proc, (uint64_t)d->env.seq,
             d->nbytes, 0);
    h.order = d->order;
    h.pad = (uint16_t)(p->nonce & 0xFFFF);
    int rc = try_send_record_ring(eng, p, h, rts_env, nullptr);
    if (rc <= 0) return rc;
    d->rts_sent = true;
    return 1;
  }
  uint64_t chunk = stream_chunk(eng, p);
  uint64_t left = d->nbytes - d->sent;
  uint64_t n = left < chunk ? left : chunk;
  Env fe;
  fe.kind = d->env.kind;
  fe.seq = d->xid;
  WireHdr fh;
  fill_hdr(&fh, FT_FRAG, fe, eng->proc, d->sent, d->nbytes, n);
  int rc = try_send_record_ring(eng, p, fh, fe, d->data + d->sent);
  if (rc <= 0) return rc;
  d->sent += n;
  return d->sent >= d->nbytes ? 2 : 1;
}

// One bounded service turn for a peer: round-robin across its queued
// descriptors, up to `burst` records, never blocking.  Returns records
// published; *blocked reports a turn ended on ring backpressure,
// *had_work that descriptors were queued at all.  Caller holds
// NOTHING.
static int stream_turn(Engine *eng, Peer *p, bool *blocked,
                       bool *had_work) {
  {
    std::lock_guard<std::mutex> sg(p->stream_mu);
    if (p->streams.empty()) return 0;
  }
  *had_work = true;
  std::unique_lock<std::mutex> g(p->send_mu, std::try_to_lock);
  if (!g.owns_lock()) return 0;  // a direct sender is driving this
                                 // peer; its release re-opens the turn
  int published = 0;
  const int burst = 8;
  bool rotated = false;
  while (published < burst) {
    StreamDesc *d;
    {
      std::lock_guard<std::mutex> sg(p->stream_mu);
      if (p->streams.empty()) break;
      if (p->stream_rr >= p->streams.size()) p->stream_rr = 0;
      d = p->streams[p->stream_rr];
    }
    // ring-aware flow control: never run the producer more than
    // dcn_inflight_limit bytes ahead of the consumer.  The consumer is
    // the bottleneck under a windowed burst — running further ahead
    // only drags the whole ring through the cache cold; a bounded
    // occupancy window keeps the transfer working set hot and the
    // stream servicing at the unwindowed rate.
    uint64_t occ_cap =
        eng->inflight_limit.load(std::memory_order_relaxed);
    if (occ_cap && p->tx_ring.ctrl) {
      uint64_t occ =
          p->tx_ring.ctrl->head.load(std::memory_order_relaxed) -
          p->tx_ring.ctrl->tail.load(std::memory_order_acquire);
      if (occ >= occ_cap) {
        *blocked = true;
        break;
      }
    }
    uint64_t before = d->sent;
    int rc = stream_service_one(eng, p, d);
    if (rc == 0) {
      *blocked = true;
      // adaptive chunk sizing: sustained backpressure shrinks the
      // FRAG granularity (once per blocked turn, floor 64 KiB) so
      // freed ring space becomes usable sooner and the consumer
      // interleaves at a finer quantum
      uint64_t cur = stream_chunk(eng, p);
      if (cur > STREAM_CHUNK_MIN) {
        p->chunk_now =
            cur / 2 > STREAM_CHUNK_MIN ? cur / 2 : STREAM_CHUNK_MIN;
        p->chunk_ok = 0;
        eng->stats.add(TS_CHUNK_SHRINKS, 1);
      }
      break;
    }
    if (rc < 0) {
      g.unlock();
      stream_fail_peer(eng, p, -1);
      return published;
    }
    published++;
    p->last_progress_ns.store(now_ns(), std::memory_order_relaxed);
    // stall-free progress grows the chunk back toward the knob
    if (p->chunk_now && ++p->chunk_ok >= 64) {
      uint64_t knob = eng->chunk_bytes.load(std::memory_order_relaxed);
      p->chunk_now *= 2;
      if (p->chunk_now >= knob) p->chunk_now = 0;  // knob restored
      p->chunk_ok = 0;
    }
    uint64_t sent_now = d->sent - before;
    bool complete = rc == 2;
    bool det = false, eager = false;
    uint64_t bytes = 0;
    uint8_t *owned = nullptr;
    {
      std::lock_guard<std::mutex> sg(p->stream_mu);
      // capture under the lock: tdcn_send_forget may flip `detached`
      // concurrently, and once `done` is published a waiter may free d
      det = d->detached;
      eager = d->eager;
      bytes = d->nbytes;
      owned = d->owned;
      if (sent_now) {
        p->stream_inflight -=
            sent_now <= p->stream_inflight ? sent_now : p->stream_inflight;
        eng->stream_inflight_now.fetch_sub(sent_now,
                                           std::memory_order_relaxed);
        eng->stats.gauge(TS_STREAM_INFLIGHT,
                         eng->stream_inflight_now.load(
                             std::memory_order_relaxed));
      }
      if (complete) {
        // only this thread removes; enqueuers only push_back, so the
        // cursor still names d
        p->streams.erase(p->streams.begin() + (long)p->stream_rr);
        if (p->stream_rr >= p->streams.size()) p->stream_rr = 0;
        rotated = true;
        eng->stream_depth_now.fetch_sub(1, std::memory_order_relaxed);
        eng->stats.gauge(TS_STREAM_DEPTH, eng->stream_depth_now.load(
                                              std::memory_order_relaxed));
        // counted before `done` is published: a stats read right after
        // the woken _send returns must already include this message
        if (!eager) {
          eng->stats.add(TS_CHUNKED_MSGS, 1);
          eng->stats.add(TS_CHUNKED_BYTES, bytes);
        }
        d->rc = 0;
        d->done = true;  // a blocking waiter may delete d from here on
      }
      if (complete || p->cap_waiters) p->stream_cv.notify_all();
    }
    if (complete) {
      if (det) {
        free(owned);
        delete d;
      }
    }
  }
  // round-robin at TURN granularity, not per record: a descriptor
  // keeps the cursor for one whole burst so the receiver reassembles
  // MB-scale sequential runs (per-record interleave thrashed its TLB
  // across the whole window's buffers), and every other in-flight
  // message still gets a turn every burst
  if (published && !rotated) {
    std::lock_guard<std::mutex> sg(p->stream_mu);
    if (p->streams.size() > 1)
      p->stream_rr = (p->stream_rr + 1) % p->streams.size();
  }
  return published;
}

// The per-engine sender progress thread: round-robin over every
// peer's stream queue; a full ring yields the peer's turn, and a
// whole pass with queued work but zero progress parks on the blocked
// consumer's space doorbell (accounted as ring stall) — never a
// sched_yield spin against the consumer it waits for.
static void sender_loop(Engine *eng) {
  uint64_t last_gen = 0;
  bool was_blocked = false;
  for (;;) {
    if (eng->closing.load(std::memory_order_relaxed)) break;
    std::vector<Peer *> ps;
    {
      std::lock_guard<std::mutex> g(eng->peers_mu);
      ps.reserve(eng->peers.size());
      for (auto &kv : eng->peers) ps.push_back(kv.second);
    }
    bool any_work = false;
    int progressed = 0;
    Peer *bp = nullptr;
    for (Peer *p : ps) {
      bool blocked = false, had_work = false;
      progressed += stream_turn(eng, p, &blocked, &had_work);
      any_work |= had_work;
      if (blocked) {
        bp = p;
        eng->stats.add(TS_SENDER_YIELDS, 1);
        // ring-timeout watchdog: a consumer that stopped draining
        // must surface as a send failure, not a wedged engine
        uint64_t tmo =
            eng->ring_timeout_ns.load(std::memory_order_relaxed);
        uint64_t prog =
            p->last_progress_ns.load(std::memory_order_relaxed);
        if (tmo && prog && now_ns() - prog > tmo) {
          eng->stats.add(TS_DEADLINE_EXPIRED, 1);
          stream_fail_peer(eng, p, -1);
        } else if (p->marked_failed.load(std::memory_order_relaxed)) {
          stream_fail_peer(eng, p, -1);  // its consumer is gone
        }
      }
    }
    if (progressed) {
      was_blocked = false;
      continue;
    }
    if (!any_work) {
      was_blocked = false;
      std::unique_lock<std::mutex> lk(eng->sender_mu);
      cv_wait_for(eng->sender_cv, lk, 0.05, [&] {
        return eng->stream_gen != last_gen ||
               eng->closing.load(std::memory_order_relaxed);
      });
      last_gen = eng->stream_gen;
      continue;
    }
    // queued work, zero progress: every ring is full (or a direct
    // sender owns send_mu).  Park bounded on the blocked consumer's
    // space doorbell and account the dead time as ring stall so the
    // stall-cause decomposition stays truthful.
    if (!was_blocked) {
      eng->stats.add(TS_RING_STALLS, 1);
      was_blocked = true;
    }
    uint64_t t0 = now_ns();
    if (bp && bp->tx_ring.ctrl) {
      bp->tx_ring.space_wait(
          bp->tx_ring.ctrl->tail.load(std::memory_order_acquire),
          2000000ull);
    } else {
      struct timespec ts = {0, 200000};  // 200 us: send_mu handoff
      nanosleep(&ts, nullptr);
    }
    uint64_t dns = now_ns() - t0;
    eng->stats.add(TS_RING_STALL_NS, dns);
    eng->stats.add(TS_STALL_NS, dns);
  }
  // drain at close: every remaining descriptor fails with the closed
  // rc so blocking waiters wake and detached buffers are reclaimed
  std::vector<Peer *> ps;
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    ps.reserve(eng->peers.size());
    for (auto &kv : eng->peers) ps.push_back(kv.second);
  }
  for (Peer *p : ps) stream_fail_peer(eng, p, -3);
}

// Enqueue one descriptor on a peer's stream queue.  p->send_mu AND
// p->stream_mu HELD (the caller's routing decision and the push must
// be one atomic step against the sender thread's queue-empty
// transitions).  Returns the descriptor, or nullptr when the engine
// is closing / the peer's stream path is poisoned.
static StreamDesc *stream_enqueue_locked(Engine *eng, Peer *p, Env &e,
                                         const uint8_t *data,
                                         uint8_t *owned, uint64_t nbytes,
                                         bool eager, bool detached) {
  if (p->stream_failed || eng->closing.load(std::memory_order_relaxed))
    return nullptr;
  StreamDesc *d = new StreamDesc();
  d->env = e;
  d->owner = p;
  d->data = data;
  d->owned = owned;
  d->nbytes = nbytes;
  d->detached = detached;
  d->eager = eager;
  d->order = p->next_order++;
  if (!eager) {
    // collision-free reassembly xid (was now_ns() ^ proc<<56, which
    // could collide for two same-nanosecond large sends to one peer
    // and cross-corrupt reassembly); the high byte still carries the
    // proc for log readability
    d->xid = (int64_t)(eng->next_xid.fetch_add(
                           1, std::memory_order_relaxed) |
                       ((uint64_t)(uint32_t)eng->proc << 56));
  }
  if (p->streams.empty())
    p->last_progress_ns.store(now_ns(), std::memory_order_relaxed);
  p->streams.push_back(d);
  p->stream_inflight += nbytes;
  eng->stats.add(TS_STREAM_MSGS, 1);
  eng->stats.add(TS_STREAM_BYTES, nbytes);
  uint64_t depth =
      eng->stream_depth_now.fetch_add(1, std::memory_order_relaxed) + 1;
  eng->stats.gauge(TS_STREAM_DEPTH, depth);
  eng->stats.hwm(TS_STREAM_DEPTH_HWM, depth);
  uint64_t infl = eng->stream_inflight_now.fetch_add(
                      nbytes, std::memory_order_relaxed) +
                  nbytes;
  eng->stats.gauge(TS_STREAM_INFLIGHT, infl);
  eng->stats.hwm(TS_STREAM_INFLIGHT_HWM, infl);
  return d;
}

// wake the sender thread after an enqueue (no locks held)
static void stream_kick(Engine *eng) {
  {
    std::lock_guard<std::mutex> lk(eng->sender_mu);
    eng->stream_gen++;
  }
  eng->sender_cv.notify_one();
}

// core send: route ring vs tcp, eager vs rndv (tcp) / chunked (ring)
static int engine_send_peer(Engine *eng, Peer *p, Env &e, const void *data,
                            uint64_t nbytes);

static int engine_send(Engine *eng, const std::string &address, Env &e,
                       const void *data, uint64_t nbytes) {
  Peer *p = get_peer(eng, address);
  return engine_send_peer(eng, p, e, data, nbytes);
}

static int tcp_send_once(Engine *eng, Peer *p, Env &e, const void *data,
                         uint64_t nbytes, uint64_t xs);

static int engine_send_peer(Engine *eng, Peer *p, Env &e, const void *data,
                            uint64_t nbytes) {
  if (!p) return -1;
  eng->bytes_sent.fetch_add(nbytes, std::memory_order_relaxed);

  // control frames: FK_PY, no cid, no payload (heartbeats / gossip /
  // revoke) — exempt from fault injection, retry, and redial backoff
  // so in-band failure detection stays prompt and deterministic
  bool ctrl = e.kind == FK_PY && e.cid.empty() && nbytes == 0;
  // ...and they must not QUEUE behind a data sender either: send_mu
  // can be held across a redial-backoff round (or a CTS wait), and a
  // detector thread blocked here would stall heartbeats to EVERY
  // peer for the whole connect deadline — false-positive detection
  // of the blocked sender.  try_lock: a busy send path just costs
  // one droppable control frame (heartbeats repeat, gossip is
  // redundant), and the two-strike + inbound-silence rules absorb it.
  std::unique_lock<std::mutex> g(p->send_mu, std::defer_lock);
  if (ctrl) {
    if (!g.try_lock()) return -1;
  } else {
    g.lock();
  }
  if (p->fd >= 0 && p->same_host && ensure_ring(eng, p)) {
    // ring writes are deadline-bounded (a frozen tail must surface as
    // an error, not an infinite producer spin).  Control frames get a
    // tiny bound instead — the failure detector's own traffic must
    // fail FAST into the in-band strike path when a peer's ring is
    // wedged, not block out the full data deadline; losing one is
    // harmless (heartbeats repeat, gossip is redundant)
    uint64_t ring_tmo =
        ctrl ? 2000000ull
             : eng->ring_timeout_ns.load(std::memory_order_relaxed);
    // routing: frames up to half the ring CAN go as one record, but a
    // record published from this thread while streams are queued
    // would overtake them (MPI non-overtaking), so the direct path is
    // taken only while the peer's stream queue is empty.  Control
    // frames are always direct: PY control traffic has no ordering
    // contract and must never queue behind a data stream.  Everything
    // else — larger-than-ring payloads, and any send that found
    // streams in flight — enqueues a descriptor and waits for the
    // sender thread's completion signal (borrowed buffer: the wait
    // keeps it alive).
    uint64_t limit = eng->ring_bytes / 2;
    bool fits = nbytes + sizeof(WireHdr) + 256 <= limit;
    bool small =
        fits && nbytes <= eng->chunk_bytes.load(std::memory_order_relaxed);
    StreamDesc *d = nullptr;
    if (!ctrl) {
      std::lock_guard<std::mutex> sg(p->stream_mu);
      if (p->stream_failed) return -1;  // poisoned lineage: escalate
      if (!(fits && p->streams.empty())) {
        d = stream_enqueue_locked(eng, p, e, (const uint8_t *)data,
                                  nullptr, nbytes, small, false);
        if (!d) return -1;
      }
    }
    if (d) {
      g.unlock();  // the sender thread needs send_mu to make progress
      stream_kick(eng);
      std::unique_lock<std::mutex> sl(p->stream_mu);
      p->stream_cv.wait(sl, [&] { return d->done; });
      int rc = d->rc;
      sl.unlock();
      delete d;
      return rc;
    }
    WireHdr h;
    fill_hdr(&h, FT_EAGER, e, eng->proc, 0, nbytes, nbytes);
    if (send_record_ring(eng, p, h, e, data, ring_tmo, !ctrl)) {
      eng->stats.add(TS_EAGER_MSGS, 1);
      eng->stats.add(TS_EAGER_BYTES, nbytes);
      return 0;
    }
    return -1;
  }

  // tcp path — one redial+resend round (the epoch-tagged self-healing
  // the Python tcp leg grew in the fault-plane PR): a send that fails
  // invalidates its epoch's socket, redials with backoff under the
  // connect deadline, and retries ONCE; only an unhealable failure
  // surfaces as rc=-1 for the Python side's ULFM escalation.  The
  // per-peer seq (carried in WireHdr.off on eager frames) lets the
  // receiver drop the one frame a retry can duplicate — exactly-once
  // across the reconnect.  Only EAGER frames consume a seq: the
  // receiver's contiguous watermark would stall forever on a seq
  // burned by a rendezvous transfer (whose RTS/FRAG frames never
  // carry it — an incomplete FRAG stream is simply not delivered, so
  // rndv needs no dedup).  send_mu serializes senders, so the epoch
  // is generation bookkeeping, not a race guard.
  uint64_t xs = (ctrl || (int64_t)nbytes > eng->eager_limit)
                    ? 0
                    : ++p->tx_seq;
  if (!ctrl) fault_conn_check(eng, p);
  for (int attempt = 0; attempt < 2; attempt++) {
    if (p->fd < 0) {
      if (ctrl || eng->closing.load(std::memory_order_relaxed)) return -1;
      int fd = dial_backoff(eng, p);
      if (fd < 0) return -1;  // connect deadline expired: unhealable
      p->fd = fd;
      p->epoch++;
      eng->stats.add(TS_RECONNECTS, 1);
      // duplex reader for CTS grants on the fresh socket
      spawn_reader(eng, dup(fd));
    }
    if (tcp_send_once(eng, p, e, data, nbytes, xs) == 0) {
      fault_dup_check(eng, p, e, data, nbytes, xs);
      return 0;
    }
    // connection-level failure: invalidate this epoch's socket; the
    // next pass redials (control traffic fails fast instead — the
    // detector's in-band strike path owns interpreting it)
    shutdown(p->fd, SHUT_RDWR);
    close(p->fd);
    p->fd = -1;
    if (ctrl || eng->closing.load(std::memory_order_relaxed)) return -1;
    if (attempt == 0) eng->stats.add(TS_RETRY_SENDS, 1);
  }
  return -1;
}

// Nonblocking send — the MPI_Isend fast path: enqueue on the
// streaming engine and return immediately.  Two modes:
//   copy != 0 — buffered: the engine owns a COPY and the send is
//     locally complete at enqueue (the Python chan_isend convenience
//     path, where the caller cannot pin the buffer);
//   copy == 0 — zero-copy: the caller's buffer is BORROWED until the
//     returned descriptor handle is collected through tdcn_send_wait/
//     tdcn_send_test (the MPI semantics: the buffer is off-limits
//     until MPI_Wait) — no third memcpy on the bandwidth path.
// Returns <0 on error, 0 when locally complete (direct record or
// buffered enqueue), or a positive descriptor handle (borrow mode).
// Falls back to the blocking path off-ring (tcp peers), where the
// windowed ring collapse this engine exists for cannot occur.
static int64_t engine_isend_peer(Engine *eng, Peer *p, Env &e,
                                 const void *data, uint64_t nbytes,
                                 int copy) {
  if (!p) return -1;
  if (!(p->fd >= 0 && p->same_host))
    return engine_send_peer(eng, p, e, data, nbytes);
  // backpressure-graceful admission (buffered mode only — a borrowed
  // buffer consumes no engine memory, and the caller's own Waitall is
  // its backpressure): over dcn_inflight_limit the enqueue BLOCKS
  // (bounded by dcn_ring_timeout) until the sender drains below the
  // cap — bounded buffering that degrades to the ring's service rate
  // instead of unbounded copy growth under a windowed burst
  uint64_t lim = eng->inflight_limit.load(std::memory_order_relaxed);
  if (copy && lim) {
    std::unique_lock<std::mutex> sl(p->stream_mu);
    if (p->stream_inflight + nbytes > lim && !p->streams.empty()) {
      eng->stats.add(TS_ENQUEUE_WAITS, 1);
      uint64_t tmo = eng->ring_timeout_ns.load(std::memory_order_relaxed);
      double secs = tmo ? (double)tmo / 1e9 : 3600.0;
      p->cap_waiters++;
      bool ok = cv_wait_for(p->stream_cv, sl, secs, [&] {
        return p->stream_inflight + nbytes <= lim ||
               p->streams.empty() || p->stream_failed ||
               eng->closing.load(std::memory_order_relaxed);
      });
      p->cap_waiters--;
      if (!ok) {
        eng->stats.add(TS_DEADLINE_EXPIRED, 1);
        return -1;
      }
      if (p->stream_failed ||
          eng->closing.load(std::memory_order_relaxed))
        return -1;
    }
  }
  // ring bring-up still needs send_mu (create + socket announce); once
  // the ring_ready hint is set, the detached path below never touches
  // the lock the sender thread's turns contend
  if (!p->ring_ready.load(std::memory_order_acquire)) {
    std::unique_lock<std::mutex> g(p->send_mu);
    if (!ensure_ring(eng, p)) {
      g.unlock();
      return engine_send_peer(eng, p, e, data, nbytes);
    }
  }
  eng->bytes_sent.fetch_add(nbytes, std::memory_order_relaxed);
  uint64_t limit = eng->ring_bytes / 2;
  bool fits = nbytes + sizeof(WireHdr) + 256 <= limit;
  bool small =
      fits && nbytes <= eng->chunk_bytes.load(std::memory_order_relaxed);
  if (small) {
    // small isend: direct record while the queue is empty (no copy,
    // no handoff — the latency path stays what it was).  The queue
    // state is PEEKED first so the buffered copy of a queued-behind
    // send happens before any lock (a memcpy under send_mu — the lock
    // the sender thread's turns contend — would stall the streaming
    // engine); the direct route re-checks under send_mu + stream_mu,
    // so the ordering decision stays atomic.
    uint8_t *owned = nullptr;
    bool peek_pending;
    {
      std::lock_guard<std::mutex> sg(p->stream_mu);
      if (p->stream_failed ||
          eng->closing.load(std::memory_order_relaxed))
        return -1;
      peek_pending = !p->streams.empty();
    }
    if (peek_pending && copy) {
      owned = (uint8_t *)malloc(nbytes ? nbytes : 1);
      if (!owned) return -1;
      memcpy(owned, data, nbytes);
    }
    std::unique_lock<std::mutex> g(p->send_mu);
    StreamDesc *d = nullptr;
    {
      std::lock_guard<std::mutex> sg(p->stream_mu);
      if (p->stream_failed ||
          eng->closing.load(std::memory_order_relaxed)) {
        free(owned);
        return -1;
      }
      if (!p->streams.empty()) {
        const uint8_t *src = (const uint8_t *)data;
        if (copy && !owned) {  // raced empty->pending: rare, copy here
          owned = (uint8_t *)malloc(nbytes ? nbytes : 1);
          if (!owned) return -1;
          memcpy(owned, data, nbytes);
        }
        if (copy) src = owned;
        d = stream_enqueue_locked(eng, p, e, src, owned, nbytes, true,
                                  copy != 0);
        if (!d) {
          free(owned);
          return -1;
        }
      }
    }
    if (!d) {
      free(owned);  // drained while we copied: direct record instead
      WireHdr h;
      fill_hdr(&h, FT_EAGER, e, eng->proc, 0, nbytes, nbytes);
      if (send_record_ring(eng, p, h, e, data,
                           eng->ring_timeout_ns.load(
                               std::memory_order_relaxed),
                           true)) {
        eng->stats.add(TS_EAGER_MSGS, 1);
        eng->stats.add(TS_EAGER_BYTES, nbytes);
        return 0;
      }
      return -1;
    }
    g.unlock();
    stream_kick(eng);
    return copy ? 0 : (int64_t)(uintptr_t)d;
  }
  // large isend: in buffered mode, copy OUTSIDE every lock (a
  // multi-MiB memcpy under send_mu would stall the sender thread's
  // turns); zero-copy mode borrows the caller's buffer outright.
  // Either way the enqueue takes stream_mu alone — the descriptor
  // queue is the ordering point, so the caller never contends the
  // record-write lock the sender thread holds during its turns.
  uint8_t *owned = nullptr;
  const uint8_t *src = (const uint8_t *)data;
  if (copy) {
    owned = (uint8_t *)malloc(nbytes ? nbytes : 1);
    if (!owned) return -1;
    memcpy(owned, data, nbytes);
    src = owned;
  }
  StreamDesc *d;
  {
    std::lock_guard<std::mutex> sg(p->stream_mu);
    d = (p->stream_failed ||
         eng->closing.load(std::memory_order_relaxed))
            ? nullptr
            : stream_enqueue_locked(eng, p, e, src, owned, nbytes, false,
                                    copy != 0);
    if (!d) {
      free(owned);
      return -1;
    }
  }
  stream_kick(eng);
  return copy ? 0 : (int64_t)(uintptr_t)d;
}

// one attempt at moving a message over the peer's tcp/uds socket;
// connection-level failures return -1 for the caller's retry round.
// `xs` rides WireHdr.off on eager frames (rx dedup key; rendezvous
// needs none — an incomplete FRAG stream is never delivered, and a
// retry restarts from a fresh RTS).
static int tcp_send_once(Engine *eng, Peer *p, Env &e, const void *data,
                         uint64_t nbytes, uint64_t xs) {
  if ((int64_t)nbytes <= eng->eager_limit) {
    WireHdr h;
    // seq'd frames pack (lineage nonce, seq) into off+pad: low 40
    // bits of off = seq, high 24 bits of off + pad = the 40-bit nonce
    uint64_t off = xs ? ((p->nonce >> 16) << 40) | xs : 0;
    fill_hdr(&h, FT_EAGER, e, eng->proc, off, nbytes, nbytes);
    if (xs) h.pad = (uint16_t)(p->nonce & 0xFFFF);
    std::vector<uint8_t> extra(env_extra(h));
    write_extra(extra.data(), e);
    struct iovec iov[3] = {
        {&h, sizeof(h)},
        {extra.data(), extra.size()},
        {(void *)data, (size_t)nbytes},
    };
    if (!writev_all(p->fd, iov, nbytes ? 3 : 2)) return -1;
    eng->stats.add(TS_EAGER_MSGS, 1);
    eng->stats.add(TS_EAGER_BYTES, nbytes);
    return 0;
  }
  // rendezvous
  int64_t xid = (int64_t)(now_ns() ^ ((uint64_t)eng->proc << 48));
  {
    std::lock_guard<std::mutex> g2(p->cts_mu);
    p->cts[xid] = false;
  }
  Env rts_env = e;
  rts_env.seq = xid;
  WireHdr h;
  fill_hdr(&h, FT_RTS, rts_env, eng->proc, (uint64_t)e.seq, nbytes, 0);
  std::vector<uint8_t> extra(env_extra(h));
  write_extra(extra.data(), rts_env);
  struct iovec iov[2] = {{&h, sizeof(h)}, {extra.data(), extra.size()}};
  if (!writev_all(p->fd, iov, 2)) return -1;
  {
    // the RTS→CTS round trip is dead time the sender cannot pipeline —
    // the "rendezvous serialization" suspect of the osu_bw collapse;
    // account every wait so the stall breakdown can apportion it
    uint64_t t0 = now_ns();
    // already the rendezvous dead-time path: register the blocked
    // CTS wait (identity = peer address + op stream) for the mesh
    // doctor before parking on the condvar
    uint64_t htok = hang_wait_begin(eng, HW_CTS, p->address.c_str(), -1,
                                    e.cid.c_str(), e.seq);
    std::unique_lock<std::mutex> g2(p->cts_mu);
    bool ok = cv_wait_for(p->cts_cv, g2, 600.0, [&] {
      // find, not operator[]: the predicate must not mutate the map
      // (an insert rebalances nodes the FT_CTS scan may be touching)
      auto it = p->cts.find(xid);
      return (it != p->cts.end() && it->second) ||
             eng->closing.load(std::memory_order_relaxed);
    });
    p->cts.erase(xid);
    hang_wait_end(htok);
    uint64_t d = now_ns() - t0;
    eng->stats.add(TS_CTS_WAIT_NS, d);
    eng->stats.add(TS_STALL_NS, d);
    eng->stats.add(TS_CTS_WAITS, 1);
    if (!ok || eng->closing.load(std::memory_order_relaxed)) return -1;
  }
  for (uint64_t off = 0; off < nbytes; off += (uint64_t)eng->frag_size) {
    uint64_t n = nbytes - off < (uint64_t)eng->frag_size
                     ? nbytes - off
                     : (uint64_t)eng->frag_size;
    Env fe;
    fe.kind = e.kind;
    fe.seq = xid;
    WireHdr fh;
    fill_hdr(&fh, FT_FRAG, fe, eng->proc, off, nbytes, n);
    struct iovec fiov[2] = {{&fh, sizeof(fh)},
                            {(void *)((const uint8_t *)data + off),
                             (size_t)n}};
    if (!writev_all(p->fd, fiov, 2)) return -1;
  }
  eng->stats.add(TS_RNDV_MSGS, 1);
  eng->stats.add(TS_RNDV_BYTES, nbytes);
  return 0;
}

// ---------------------------------------------------------------------
// C collective fast path (the dispatch-floor leg)
// ---------------------------------------------------------------------
//
// Collective schedules run ENTIRELY in C over the existing engine: the
// frames are ordinary FK_COLL eager/chunk/rndv records on a private
// per-communicator stream ("<cid>#cfp" — disjoint from the Python
// plane's str(cid) stream and the "<cid>#nbc<k>" NBC streams, so the
// two planes' seq counters can never desynchronize even when calls
// alternate between the C path and the embedded-Python fallback).
// Schedules mirror ompi_tpu_torch/dcn/collops.py EXACTLY — the linear
// process-ordered fold at index 0 (+ linear bcast) below the ring
// threshold, the ring reduce-scatter + allgather above it, with the
// identical chunk bounds and fold bracketing — so MPI_SUM results are
// bit-exact with the Python path at every size (the han-reproducible
// contract, now shared by both planes).
//
// The compiled-schedule cache (tdcn_coll_plan) is the libnbc analog
// (SURVEY §3.4): a plan — algorithm choice, chunk bounds, kernel
// binding, peer resolution — is compiled once per (kind, op, dtype,
// count, root) signature and replayed by tdcn_coll_start with zero
// per-call planning; MPI-4 persistent collectives (MPI_Allreduce_init
// + MPI_Start) ride it, and the blocking entry points share the same
// cache so their dispatch floor drops too.

// Wait for one coll-stream message (engine-internal; the C collective
// schedules ride it).  Same slot discipline as tdcn_recv_coll: 0 =
// delivered (payload moved into *out), 1 = timeout, -2 = watched proc
// failed, -3 = engine closing, -6 = comm revoked.  ``revoked`` /
// ``fail_members`` are the C fast path's ULFM interrupts (the Python
// plane's _check_revoked twin): a parked schedule receive wakes the
// moment tdcn_coll_revoke_cid poisons its comm or tdcn_note_failed
// marks ANY member — not just the watched src — instead of waiting
// out the ~600 s give-up.
static int coll_wait_msg(Engine *eng, const std::string &scid, int64_t seq,
                         int src, int fail_proc, double timeout_s,
                         OwnedMsg *out,
                         const std::atomic<int> *revoked = nullptr,
                         const std::vector<int> *fail_members = nullptr) {
  auto key = std::make_tuple(scid, seq, src);
  std::unique_lock<std::mutex> g(eng->mu);
  auto it = eng->coll.find(key);
  CollSlot *slot;
  if (it == eng->coll.end()) {
    slot = new CollSlot();
    eng->coll[key] = slot;
  } else {
    slot = it->second;
  }
  auto peer_failed = [&] {
    return fail_proc >= 0 && (size_t)fail_proc < eng->failed.size() &&
           eng->failed[fail_proc];
  };
  // extra abort causes (checked under eng->mu like peer_failed): the
  // comm's revoke flag and the comm's FULL member list against the
  // engine failure marks — a dead third member wedges the schedule
  // just as surely as a dead src
  auto aborted = [&]() -> int {
    if (revoked && revoked->load(std::memory_order_relaxed)) return -6;
    if (fail_members) {
      for (int fp : *fail_members)
        if (fp >= 0 && (size_t)fp < eng->failed.size() &&
            eng->failed[fp])
          return -2;
    }
    return 0;
  };
  slot->waiters++;
  // mesh doctor: the message is not here yet — register the parked
  // coll wait (the ready fast path above registers nothing).  The
  // awaited peer is the watched root proc; `src` rides the seq/cid
  // identity the Python solver keys edges on.
  uint64_t htok = slot->ready.load()
                      ? 0
                      : hang_wait_begin(eng, HW_COLL, nullptr,
                                        fail_proc, scid.c_str(), seq);
  bool ok = progress_wait(eng, g,
                          [&] {
                            return slot->ready.load() ||
                                   eng->closing.load(
                                       std::memory_order_relaxed) ||
                                   peer_failed() || aborted() != 0;
                          },
                          timeout_s);
  hang_wait_end(htok);
  slot->waiters--;
  if (!ok || !slot->ready.load() || slot->consumed) {
    int rc = 1;
    if (eng->closing.load(std::memory_order_relaxed)) rc = -3;
    else if (peer_failed())
      rc = -2;
    else if (int ab = aborted())
      rc = ab;
    if (slot->waiters == 0) {
      if (slot->consumed) {
        delete slot;
      } else if (!slot->ready.load()) {
        eng->coll.erase(key);
        delete slot;
      }
    }
    return rc;
  }
  *out = std::move(slot->msg);
  slot->consumed = true;
  eng->coll.erase(key);
  if (slot->waiters == 0) delete slot;
  return 0;
}

// -- op kernels ---------------------------------------------------------
// acc[i] = acc[i] OP in[i], elementwise — bit-exact with the numpy
// kernels the Python fold uses (IEEE add/mul; NaN-propagating max/min
// matching np.maximum/np.minimum).  Unsupported (op, dtype) combos
// resolve to a null kernel and the caller falls back to the
// embedded-Python path (derived datatypes, user ops, pair types,
// logical ops with numpy bool-cast semantics).

typedef void (*coll_kfn)(void *, const void *, int64_t);

template <class T>
static void k_sum(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++) x[i] = (T)(x[i] + y[i]);
}

template <class T>
static void k_prod(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++) x[i] = (T)(x[i] * y[i]);
}

// complex multiply, naive formula — what numpy's complex prod uses.
// `n` is in SCALAR components (2 per complex element) like every other
// kernel's count — the plan's kcount doubling applies uniformly.
template <class T>
static void k_cprod(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i + 1 < n; i += 2) {
    T re = x[i] * y[i] - x[i + 1] * y[i + 1];
    T im = x[i] * y[i + 1] + x[i + 1] * y[i];
    x[i] = re;
    x[i + 1] = im;
  }
}

// max/min keep NaN like np.maximum/np.minimum: any NaN operand wins
template <class T>
static void k_max(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++)
    x[i] = (x[i] > y[i] || x[i] != x[i]) ? x[i] : y[i];
}

template <class T>
static void k_min(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++)
    x[i] = (x[i] < y[i] || x[i] != x[i]) ? x[i] : y[i];
}

template <class T>
static void k_band(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++) x[i] = (T)(x[i] & y[i]);
}

template <class T>
static void k_bor(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++) x[i] = (T)(x[i] | y[i]);
}

template <class T>
static void k_bxor(void *a, const void *b, int64_t n) {
  T *x = (T *)a;
  const T *y = (const T *)b;
  for (int64_t i = 0; i < n; i++) x[i] = (T)(x[i] ^ y[i]);
}

// predefined contiguous datatype codes 1..27 (mpi.h order; the shim's
// fp_dt twin): element byte size, integral?, float?, complex?
struct CollDt {
  int size;
  int cls;  // 0 unsupported, 1 signed int, 2 unsigned int, 3 float,
            // 4 complex
};
static const CollDt coll_dt[28] = {
    {0, 0},  {1, 1}, {1, 1}, {1, 2}, {1, 2}, {2, 1}, {2, 2},
    {4, 1},  {4, 2}, {8, 1}, {8, 2}, {8, 1}, {8, 2}, {4, 3},
    {8, 3},  {0, 0}, {0, 0},  // MPI_C_BOOL: numpy bool add is logical
    {1, 1},  {2, 1}, {4, 1}, {8, 1}, {1, 2}, {2, 2}, {4, 2},
    {8, 2},  {8, 4}, {16, 4}, {4, 1}};

// op codes (mpi.h): 1 SUM, 2 MAX, 3 MIN, 4 PROD, 8 BAND, 9 BOR,
// 10 BXOR are C-served; everything else (logical ops, MAXLOC/MINLOC,
// REPLACE/NO_OP, user ops) falls back.
template <class T>
static coll_kfn pick_int_kernel(int opcode) {
  switch (opcode) {
    case 1: return k_sum<T>;
    case 2: return k_max<T>;
    case 3: return k_min<T>;
    case 4: return k_prod<T>;
    case 8: return k_band<T>;
    case 9: return k_bor<T>;
    case 10: return k_bxor<T>;
  }
  return nullptr;
}

template <class T>
static coll_kfn pick_float_kernel(int opcode) {
  switch (opcode) {
    case 1: return k_sum<T>;
    case 2: return k_max<T>;
    case 3: return k_min<T>;
    case 4: return k_prod<T>;
  }
  return nullptr;
}

static coll_kfn coll_kernel(int opcode, int dtcode) {
  if (dtcode < 1 || dtcode > 27) return nullptr;
  const CollDt &d = coll_dt[dtcode];
  switch (d.cls) {
    case 1:
      switch (d.size) {
        case 1: return pick_int_kernel<int8_t>(opcode);
        case 2: return pick_int_kernel<int16_t>(opcode);
        case 4: return pick_int_kernel<int32_t>(opcode);
        case 8: return pick_int_kernel<int64_t>(opcode);
      }
      return nullptr;
    case 2:
      switch (d.size) {
        case 1: return pick_int_kernel<uint8_t>(opcode);
        case 2: return pick_int_kernel<uint16_t>(opcode);
        case 4: return pick_int_kernel<uint32_t>(opcode);
        case 8: return pick_int_kernel<uint64_t>(opcode);
      }
      return nullptr;
    case 3:
      return d.size == 4 ? pick_float_kernel<float>(opcode)
                         : pick_float_kernel<double>(opcode);
    case 4:  // complex: componentwise SUM; naive-formula PROD
      if (opcode == 1)
        return d.size == 8 ? k_sum<float> : k_sum<double>;
      if (opcode == 4)
        return d.size == 8 ? k_cprod<float> : k_cprod<double>;
      return nullptr;
  }
  return nullptr;
}

// kind codes shared with the shim (and dcn_sanity.cc)
enum CollKind {
  CK_BARRIER = 0,
  CK_BCAST = 1,
  CK_REDUCE = 2,
  CK_ALLREDUCE = 3,
  CK_ALLGATHER = 4,
};

enum CollAlgo { CA_LINEAR = 0, CA_RING = 1 };

struct CollCtx;

// One compiled schedule: algorithm choice, chunk plan, kernel binding
// — everything per-call planning would otherwise recompute.  Replayed
// by tdcn_coll_start with the caller's buffers bound at start time
// (the cache key deliberately excludes buffer addresses so persistent
// requests and the blocking entry points share entries).
struct CollPlan {
  CollCtx *ctx = nullptr;
  int kind = 0, opcode = 0, dtcode = 0, root = 0, algo = CA_LINEAR;
  int64_t count = 0;
  uint64_t nbytes = 0;  // per-rank payload bytes
  int esize = 0;
  coll_kfn kfn = nullptr;
  // complex kernels fold component-wise: element count presented to
  // the kernel (2x for complex SUM)
  int64_t kcount = 0;
  std::vector<uint64_t> bounds;  // ring chunk bounds, in elements
};

struct CollCtx {
  Engine *eng = nullptr;
  std::string cid;  // private stream: "<comm cid>#cfp"
  int me = 0, nprocs = 0;
  std::vector<std::string> addrs;
  std::vector<Peer *> peers;   // resolved lazily (get_peer)
  std::vector<int> fail_idx;   // root-engine proc per member (-1 none)
  int64_t seq = 0;             // SPMD stream counter (same burn order
                               // on every member by MPI issue order)
  uint64_t ring_threshold = 64ull << 10;
  // ULFM interrupt (tdcn_coll_revoke_cid): parked schedule receives
  // wake immediately and the schedule aborts with -6
  std::atomic<int> revoked{0};
  std::mutex mu;  // plan cache + the addrs/peers slots (collective
                  // calls themselves are serialized per comm by MPI
                  // semantics, but engine_addr_changed writes the
                  // slots from the control plane during replace())
  // keyed (kind, op, dtype, count, root, RESOLVED algo): the algo
  // component keeps a forced/tuned/reproducible decision from being
  // shadowed by an earlier same-signature plan that resolved the
  // engine crossover differently
  std::map<std::tuple<int, int, int, int64_t, int, int>, CollPlan *>
      plans;
  // plans EVICTED by an address-change invalidation (replace(): the
  // schedule was compiled against the dead lineage).  They cannot be
  // freed — a persistent request may still hold the handle, and its
  // replay stays memory-safe because execution resolves peers through
  // the (refreshed) cctx at start time — so they park here until
  // tdcn_coll_close frees everything
  std::vector<CollPlan *> retired;
};

static Peer *cctx_peer(CollCtx *c, int p) {
  // slot reads under c->mu: engine_addr_changed (replace installing a
  // reborn endpoint) rewrites addrs[p]/peers[p] from the control
  // plane, so the execution-side resolution can no longer be
  // lock-free.  get_peer (which dials) runs OUTSIDE the lock; a
  // racing invalidation between the resolve and the install wins —
  // the stale Peer* is dropped and the next send re-resolves.
  std::string addr;
  {
    std::lock_guard<std::mutex> g(c->mu);
    if (c->peers[p]) return c->peers[p];
    addr = c->addrs[p];
  }
  Peer *pe = get_peer(c->eng, addr);
  std::lock_guard<std::mutex> g(c->mu);
  if (!c->peers[p] && addr == c->addrs[p]) c->peers[p] = pe;
  return c->peers[p] ? c->peers[p] : pe;
}

static int cctx_send(CollCtx *c, int dst, int64_t seq, const void *data,
                     uint64_t nbytes) {
  Env e;
  e.kind = FK_COLL;
  e.cid = c->cid;
  e.seq = seq;
  e.src = c->me;
  e.dst = 0;
  e.tag = 0;
  return engine_send_peer(c->eng, cctx_peer(c, dst), e, data, nbytes);
}

// Receive one schedule message.  A C collective that already moved
// frames cannot fall back mid-call, so timeouts retry — but not
// forever: ANY member's death breaks out via -2 (the full fail_idx
// list is watched, so a wedge behind a dead third member fails as
// fast as a dead src), a revoked comm breaks out via -6 the moment
// tdcn_coll_revoke_cid fires (the Python plane's _check_revoked
// mirrored into C), and a silent wedge (or an unwatched member, e.g.
// addresses that never resolved against the root table) gives up
// after ~600 s with -5, which the shim surfaces through the comm's
// errhandler — a loud failure instead of an untraceable infinite
// hang.
static int cctx_recv_msg(CollCtx *c, int64_t seq, int src, OwnedMsg *out) {
  for (int tries = 0; tries < 5; tries++) {
    int rc = coll_wait_msg(c->eng, c->cid, seq, src, c->fail_idx[src],
                           120.0, out, &c->revoked, &c->fail_idx);
    if (rc != 1) return rc;
  }
  c->eng->stats.add(TS_DEADLINE_EXPIRED, 1);
  return -5;
}

static int cctx_recv_into(CollCtx *c, int64_t seq, int src, void *dst,
                          uint64_t cap) {
  // The coll recv_into surface (the recorded C-fast-path edge): post the
  // destination buffer BEFORE waiting, so the inbound payload lands
  // straight in it — socket reads target it, ring records memcpy once
  // into it, streaming/tcp RTS binds it as the reassembly target —
  // and the one-staging-copy-per-peer-block the C allgather used to
  // pay disappears.  Posting is skipped when the message already
  // arrived (plain copy path handles it).
  Engine *eng = c->eng;
  bool posted = false;
  if (dst && cap) {
    std::lock_guard<std::mutex> g(eng->mu);
    auto key = std::make_tuple(c->cid, seq, (int32_t)src);
    auto it = eng->coll.find(key);
    if (it == eng->coll.end() || !it->second->ready.load()) {
      eng->coll_into[key] = Engine::CollInto{dst, cap};
      posted = true;
    }
  }
  OwnedMsg m;
  int rc = cctx_recv_msg(c, seq, src, &m);
  if (posted) {
    // withdraw a leftover posting (delivery consumed it on the
    // placement path; an abort leaves it behind)
    bool consumed;
    {
      std::lock_guard<std::mutex> g(eng->mu);
      consumed = eng->coll_into.erase(
                     std::make_tuple(c->cid, seq, (int32_t)src)) == 0;
    }
    if (rc != 0 && consumed) {
      // ABORTED (revoke / deadline / member failure) after the
      // posting was consumed: either a completed delivery (its
      // orphaned noown message sits in the queues, harmless) or an
      // in-flight RTS reservation whose FRAG stream targets the
      // caller's buffer.  The caller will treat `dst` as its own the
      // moment we return an error (MPI lets it free the buffer after
      // a failed collective), so the fill must be STOPPED first:
      // mark the reassembly dead — writers drop the remainder of the
      // stream — and wait out any single FRAG write already in
      // flight.  The wait is bounded by that one write: a stalled
      // sender mid-FRAG holds it until failure detection severs the
      // connection (recv_exact fails → abandon erases the entry),
      // the same failure/close break-out the reserved-precv
      // discipline documents.
      //
      // FIRST wait out any live into-claim on `dst`: the consumer
      // holds it across the windows the reasm scan below cannot see —
      // the eager socket read, the ring memcpy, and the RTS gap
      // between popping the posting and inserting the reassembly
      // (including the tcp rndv-slot wait).  Claims release on write
      // completion or reasm insertion, and a dead sender's socket
      // failure releases too, so this wait shares the scan's bound.
      {
        std::unique_lock<std::mutex> g(eng->mu);
        while (eng->into_busy.count(dst))
          eng->into_cv.wait_for(g, std::chrono::milliseconds(20));
      }
      for (;;) {
        bool live = false, writing = false;
        {
          std::lock_guard<std::mutex> g(eng->rndv_mu);
          // mark EVERY entry bound to dst (no first-match break): a
          // lingering dead reassembly from an earlier abort of a
          // reused buffer must not shadow a live binding — the
          // shadowed transfer would keep streaming into memory the
          // caller reclaims on return
          for (auto &kv : eng->reasm) {
            Reassembly *ra = kv.second;
            if (ra->buf == (uint8_t *)dst) {
              ra->dead = true;
              live = true;
              if (ra->busy.load(std::memory_order_acquire) != 0)
                writing = true;
            }
          }
        }
        if (!live || !writing) break;
        std::this_thread::sleep_for(std::chrono::microseconds(200));
      }
    }
  }
  if (rc != 0) return rc;
  if (m.noown && m.data == dst) return 0;  // placed: nothing to copy/free
  uint64_t n = m.nbytes < cap ? m.nbytes : cap;
  if (n && dst) memcpy(dst, m.data, n);
  if (!m.noown) free(m.data);
  return 0;
}

// -- schedule execution (the replay tdcn_coll_start drives) ------------

static int plan_linear_fold(CollCtx *c, CollPlan *pl, int root,
                            const void *sendbuf, void *recvbuf,
                            int64_t seq) {
  // process-ordered fold at `root`: contributions fold in ascending
  // member order — the deterministic bracketing collops.allreduce /
  // han.reduce document (bit-exact MPI_SUM contract)
  if (c->me != root)
    return cctx_send(c, root, seq, sendbuf, pl->nbytes);
  // MPI_IN_PLACE at a non-first root: the fold writes recvbuf from
  // member 0 upward, which would destroy the root's own (aliased)
  // contribution before its turn in the order — snapshot it first
  std::vector<uint8_t> own;
  const uint8_t *self_src = (const uint8_t *)sendbuf;
  if (root != 0 && sendbuf == recvbuf && pl->nbytes) {
    own.assign((const uint8_t *)sendbuf,
               (const uint8_t *)sendbuf + pl->nbytes);
    self_src = own.data();
  }
  for (int p = 0; p < c->nprocs; p++) {
    if (p == c->me) {
      if (p == 0) {
        if (recvbuf != self_src) memcpy(recvbuf, self_src, pl->nbytes);
      } else {
        pl->kfn(recvbuf, self_src, pl->kcount);
      }
      continue;
    }
    OwnedMsg m;
    int rc = cctx_recv_msg(c, seq, p, &m);
    if (rc != 0) return rc;
    if (m.nbytes < pl->nbytes) {
      free(m.data);
      return -4;  // short frame: schedule mismatch, surface loudly
    }
    if (p == 0) {
      memcpy(recvbuf, m.data, pl->nbytes);
    } else {
      pl->kfn(recvbuf, m.data, pl->kcount);
    }
    free(m.data);
  }
  return 0;
}

static int plan_ring_allreduce(CollCtx *c, CollPlan *pl,
                               const void *sendbuf, void *recvbuf) {
  // ring reduce-scatter + ring allgather, chunk bounds precompiled —
  // the exact schedule (and fold bracketing: got OP acc, commutative
  // ops only so the C acc-OP-got is bit-identical) of
  // collops._allreduce_ring
  int P = c->nprocs, me = c->me;
  int right = (me + 1) % P, left = (me - 1 + P) % P;
  uint8_t *acc = (uint8_t *)recvbuf;
  if (recvbuf != sendbuf) memcpy(recvbuf, sendbuf, pl->nbytes);
  int64_t seq0 = c->seq;
  c->seq += 2 * (P - 1);
  int es = pl->esize;
  auto off = [&](int i) { return pl->bounds[i] * (uint64_t)es; };
  auto len = [&](int i) {
    return (pl->bounds[i + 1] - pl->bounds[i]) * (uint64_t)es;
  };
  auto elems = [&](int i) {
    int64_t n = (int64_t)(pl->bounds[i + 1] - pl->bounds[i]);
    // complex kernels fold componentwise (2 scalars per element)
    return pl->kcount == pl->count ? n : 2 * n;
  };
  for (int s = 0; s < P - 1; s++) {
    int send_i = ((me - s) % P + P) % P;
    int recv_i = ((me - s - 1) % P + P) % P;
    int rc = cctx_send(c, right, seq0 + s, acc + off(send_i), len(send_i));
    if (rc != 0) return rc;
    OwnedMsg m;
    rc = cctx_recv_msg(c, seq0 + s, left, &m);
    if (rc != 0) return rc;
    if (m.nbytes < len(recv_i)) {
      free(m.data);
      return -4;
    }
    pl->kfn(acc + off(recv_i), m.data, elems(recv_i));
    free(m.data);
  }
  for (int s = 0; s < P - 1; s++) {
    int64_t seq = seq0 + (P - 1) + s;
    int send_i = ((me + 1 - s) % P + P) % P;
    int recv_i = ((me - s) % P + P) % P;
    int rc = cctx_send(c, right, seq, acc + off(send_i), len(send_i));
    if (rc != 0) return rc;
    rc = cctx_recv_into(c, seq, left, acc + off(recv_i), len(recv_i));
    if (rc != 0) return rc;
  }
  return 0;
}

static int plan_exec(CollCtx *c, CollPlan *pl, const void *sendbuf,
                     void *recvbuf) {
  Engine *eng = c->eng;
  int P = c->nprocs, me = c->me;
  if (P == 1) {
    if (pl->kind != CK_BARRIER && recvbuf && sendbuf &&
        recvbuf != sendbuf)
      memcpy(recvbuf, sendbuf, pl->nbytes);
    eng->stats.add(TS_COLL_FASTPATH_OPS, 1);
    return 0;
  }
  int rc = 0;
  switch (pl->kind) {
    case CK_BARRIER: {
      // linear fold + bcast of an empty token at index 0 — the same
      // 2-seq shape as the Python barrier's token allreduce
      int64_t sg = c->seq++, sb = c->seq++;
      if (me == 0) {
        for (int p = 1; p < P && rc == 0; p++)
          rc = cctx_recv_into(c, sg, p, nullptr, 0);
        for (int p = 1; p < P && rc == 0; p++)
          rc = cctx_send(c, p, sb, nullptr, 0);
      } else {
        rc = cctx_send(c, 0, sg, nullptr, 0);
        if (rc == 0) rc = cctx_recv_into(c, sb, 0, nullptr, 0);
      }
      break;
    }
    case CK_BCAST: {
      int64_t seq = c->seq++;
      if (me == pl->root) {
        for (int p = 0; p < P && rc == 0; p++)
          if (p != me) rc = cctx_send(c, p, seq, recvbuf, pl->nbytes);
      } else {
        rc = cctx_recv_into(c, seq, pl->root, recvbuf, pl->nbytes);
      }
      break;
    }
    case CK_REDUCE: {
      int64_t seq = c->seq++;
      rc = plan_linear_fold(c, pl, pl->root, sendbuf, recvbuf, seq);
      break;
    }
    case CK_ALLREDUCE: {
      if (pl->algo == CA_RING) {
        rc = plan_ring_allreduce(c, pl, sendbuf, recvbuf);
        break;
      }
      int64_t sg = c->seq++, sb = c->seq++;
      rc = plan_linear_fold(c, pl, 0, sendbuf, recvbuf, sg);
      if (rc == 0) {
        if (me == 0) {
          for (int p = 1; p < P && rc == 0; p++)
            rc = cctx_send(c, p, sb, recvbuf, pl->nbytes);
        } else {
          rc = cctx_recv_into(c, sb, 0, recvbuf, pl->nbytes);
        }
      }
      break;
    }
    case CK_ALLGATHER: {
      int64_t seq = c->seq++;
      uint8_t *out = (uint8_t *)recvbuf;
      if (out + (uint64_t)me * pl->nbytes != sendbuf)
        memcpy(out + (uint64_t)me * pl->nbytes, sendbuf, pl->nbytes);
      for (int p = 0; p < P && rc == 0; p++)
        if (p != me) rc = cctx_send(c, p, seq, sendbuf, pl->nbytes);
      for (int p = 0; p < P && rc == 0; p++)
        if (p != me)
          rc = cctx_recv_into(c, seq, p, out + (uint64_t)p * pl->nbytes,
                              pl->nbytes);
      break;
    }
    default:
      return -4;
  }
  if (rc == 0) eng->stats.add(TS_COLL_FASTPATH_OPS, 1);
  return rc;
}

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------

extern "C" {

static void prune_dedup(Engine *eng, int proc);

void *tdcn_create(int proc, int nprocs, const char *host_id,
                  int64_t eager_limit, int64_t frag_size,
                  uint64_t ring_bytes, int max_rndv) {
  Engine *eng = new Engine();
  eng->proc = proc;
  eng->nprocs = nprocs;
  eng->host_id = host_id ? host_id : "";
  if (eager_limit > 0) eng->eager_limit = eager_limit;
  if (frag_size > 0) eng->frag_size = frag_size;
  if (ring_bytes > 0) eng->ring_bytes = ring_bytes;
  if (max_rndv > 0) eng->max_rndv = max_rndv;
  eng->failed.assign((size_t)(nprocs > 0 ? nprocs : 1) + 64, false);
  long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
  eng->spin_iters = (ncpu > 2) ? 600 : 0;
  // recycle large payload buffers through the heap instead of per-
  // message mmap/munmap (glibc default M_MMAP_THRESHOLD is 128 KiB —
  // every big message would pay fresh page faults on both copies)
  mallopt(M_MMAP_THRESHOLD, 64 << 20);
  mallopt(M_TRIM_THRESHOLD, 128 << 20);

  // tcp listener
  eng->tcp_listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(eng->tcp_listen_fd, SOL_SOCKET, SO_REUSEADDR, &one,
             sizeof(one));
  struct sockaddr_in sa;
  memset(&sa, 0, sizeof(sa));
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (const char *h = getenv("TDCN_BIND")) inet_pton(AF_INET, h, &sa.sin_addr);
  bind(eng->tcp_listen_fd, (struct sockaddr *)&sa, sizeof(sa));
  listen(eng->tcp_listen_fd, 64);
  socklen_t slen = sizeof(sa);
  getsockname(eng->tcp_listen_fd, (struct sockaddr *)&sa, &slen);
  char tb[64];
  char ip[32];
  inet_ntop(AF_INET, &sa.sin_addr, ip, sizeof(ip));
  snprintf(tb, sizeof(tb), "%s:%d", ip, (int)ntohs(sa.sin_port));
  eng->tcp_addr = tb;

  // abstract uds listener (same-host setup channel)
  char un[96];
  snprintf(un, sizeof(un), "tdcn-%d-%d-%llx", getpid(), proc,
           (unsigned long long)now_ns() & 0xffffff);
  eng->uds_name = un;
  eng->uds_listen_fd = socket(AF_UNIX, SOCK_STREAM, 0);
  struct sockaddr_un ua;
  memset(&ua, 0, sizeof(ua));
  ua.sun_family = AF_UNIX;
  memcpy(ua.sun_path + 1, un, strlen(un));
  bind(eng->uds_listen_fd, (struct sockaddr *)&ua,
       (socklen_t)(offsetof(struct sockaddr_un, sun_path) + 1 + strlen(un)));
  listen(eng->uds_listen_fd, 64);

  // doorbell
  char db[96];
  snprintf(db, sizeof(db), "/tdcn-db-%d-%d", getpid(), proc);
  eng->db_name = db;
  if (!eng->my_db.create(db)) {
    // no doorbell, no engine: the ring poller would dereference it
    close(eng->tcp_listen_fd);
    close(eng->uds_listen_fd);
    delete eng;
    return nullptr;
  }

  eng->address = compose_address(eng);
  eng->threads.emplace_back(accept_loop, eng, eng->tcp_listen_fd);
  eng->threads.emplace_back(accept_loop, eng, eng->uds_listen_fd);
  eng->threads.emplace_back(ring_poll_loop, eng);
  eng->threads.emplace_back(sender_loop, eng);
  return eng;
}

const char *tdcn_address(void *h) {
  return ((Engine *)h)->address.c_str();
}

// One proc's address CHANGED (replace() installing a reborn
// incarnation's endpoint) — the one proof its old sender lineage is
// dead.  Prune the corpse's rx state and invalidate every registered
// C-coll view that resolved the dead address: cached Peer pointers
// reset (execution re-resolves at next start), compiled plans evict
// to the retired list (a repaired comm can't replay a schedule built
// against the dead lineage), and the view's own address slot is
// refreshed so re-resolution dials the reborn endpoint.
static void engine_addr_changed(Engine *eng, int p,
                                const std::string &old_addr,
                                const std::string &new_addr) {
  prune_dedup(eng, p);
  // NOTE: the corpse lineage's in-flight reassemblies are
  // deliberately NOT reclaimed here — a consumer thread may be
  // mid-memcpy into one with no lock held (the FRAG hot path),
  // so freeing from this control-plane thread would race it.
  // They are bounded garbage reclaimed at destroy; a recv that
  // was reserved-at-RTS by the dead stream stays matched (MPI:
  // cancel of a MATCHED receive fails, and elastic recovery
  // resumes on the fresh `.replaced` comm, not on the corpse's
  // half-streamed transfers — the same wedge semantics a
  // mid-stream sender death always had on the ring path).
  {
    // The reborn incarnation's issue-order counter restarts at 1:
    // drop the corpse lineage's ordered-delivery gates (any parked
    // payloads are fully-delivered messages the gate owns — freed
    // under eng->mu, the same lock every gate access holds)
    std::lock_guard<std::mutex> g(eng->mu);
    for (auto it = eng->order_gates.begin();
         it != eng->order_gates.end();) {
      if (it->first.first == (int32_t)p) {
        for (auto &pm : it->second.parked)
          if (pm.second.data) free(pm.second.data);
        it = eng->order_gates.erase(it);
      } else {
        ++it;
      }
    }
  }
  std::lock_guard<std::mutex> g(eng->cctx_mu);
  for (CollCtx *c : eng->cctxs) {
    std::lock_guard<std::mutex> cg(c->mu);
    bool member = false;
    for (int i = 0; i < c->nprocs; i++) {
      if (c->addrs[i] == old_addr) {
        c->addrs[i] = new_addr;
        c->peers[i] = nullptr;
        member = true;
      }
    }
    if (member && !c->plans.empty()) {
      for (auto &kv : c->plans) c->retired.push_back(kv.second);
      c->plans.clear();
    }
  }
}

int tdcn_set_addresses(void *h, const char *joined) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> ag(eng->addr_mu);
  std::vector<std::string> old;
  old.swap(eng->peer_addresses);
  std::string s(joined ? joined : "");
  size_t start = 0;
  while (start <= s.size()) {
    size_t nl = s.find('\n', start);
    if (nl == std::string::npos) {
      eng->peer_addresses.push_back(s.substr(start));
      break;
    }
    eng->peer_addresses.push_back(s.substr(start, nl - start));
    start = nl + 1;
  }
  // eager-install accounting (the sharded-modex boot signature): only
  // slots going empty→set or changing count, so re-pushing the same
  // table is free — TS_ADDR_INSTALLS at np=16 reads <= group size on
  // the sharded boot vs P−1 on the eager one
  for (size_t p = 0; p < eng->peer_addresses.size(); p++) {
    if ((int)p == eng->proc || eng->peer_addresses[p].empty()) continue;
    if (p >= old.size() || old[p] != eng->peer_addresses[p])
      eng->stats.add(TS_ADDR_INSTALLS, 1);
  }
  // an address CHANGE is the one proof a proc's old sender lineage is
  // dead (replace() installing a reborn incarnation's endpoint) — the
  // moment its stale dedup watermarks become garbage and can be
  // pruned without ever regressing a live lineage's watermark
  for (size_t p = 0; p < old.size() && p < eng->peer_addresses.size();
       p++) {
    if (!old[p].empty() && old[p] != eng->peer_addresses[p])
      engine_addr_changed(eng, (int)p, old[p], eng->peer_addresses[p]);
  }
  return 0;
}

// Install ONE peer's address (incremental modex: the lazy
// AddressTable resolving a cross-group peer on first send, and
// replace() refreshing a reborn incarnation's endpoint) — the full-
// table re-push is unnecessary and would collapse a sharded table's
// unresolved holes.  ``lazy`` only picks the counter: 1 = resolved on
// demand (TS_ADDR_LAZY), 0 = eager/replace install (TS_ADDR_INSTALLS).
int tdcn_set_address_one(void *h, int proc, const char *address,
                         int lazy) {
  Engine *eng = (Engine *)h;
  if (!eng || proc < 0 || proc >= eng->nprocs || !address) return -2;
  std::lock_guard<std::mutex> ag(eng->addr_mu);
  if ((size_t)proc >= eng->peer_addresses.size())
    eng->peer_addresses.resize(eng->nprocs);
  std::string old = eng->peer_addresses[proc];
  std::string neu(address);
  if (old == neu) return 0;
  eng->peer_addresses[proc] = neu;
  if (!neu.empty() && proc != eng->proc)
    eng->stats.add(lazy ? TS_ADDR_LAZY : TS_ADDR_INSTALLS, 1);
  if (!old.empty()) engine_addr_changed(eng, proc, old, neu);
  return 0;
}

// Arm the lazy-modex resolver (sharded native boot): a send naming a
// proc whose address slot is still empty consults the Python
// AddressTable through this callback instead of failing.  NULL
// disarms.
void tdcn_set_resolver(void *h, tdcn_resolve_fn fn) {
  Engine *eng = (Engine *)h;
  if (eng) eng->resolver.store(fn, std::memory_order_relaxed);
}

// Resolve-or-fail for an address slot (tdcn_send's lazy leg).  By
// VALUE, with the slot read under addr_mu: lazy resolution means
// installs now happen mid-job from whichever thread sends first, so
// another sender's lock-free slot read would race the writer's
// std::string assignment (torn read), and a returned pointer could
// dangle across a concurrent bulk re-push's swap.  Returns an empty
// string when unresolvable (the caller's send then fails like an
// empty address always did).
static std::string engine_resolve_addr(Engine *eng, int proc) {
  if (proc < 0 || proc >= eng->nprocs) return std::string();
  {
    std::lock_guard<std::mutex> g(eng->addr_mu);
    if ((size_t)proc < eng->peer_addresses.size() &&
        !eng->peer_addresses[proc].empty())
      return eng->peer_addresses[proc];
  }
  tdcn_resolve_fn fn = eng->resolver.load(std::memory_order_relaxed);
  if (!fn) return std::string();
  char buf[512];
  int n = fn(proc, buf, (int)sizeof(buf));
  if (n <= 0 || n >= (int)sizeof(buf)) return std::string();
  tdcn_set_address_one(eng, proc, buf, 1);
  std::lock_guard<std::mutex> g(eng->addr_mu);
  return (size_t)proc < eng->peer_addresses.size()
             ? eng->peer_addresses[proc]
             : std::string();
}

int tdcn_send_addr(void *h, const char *address, int kind, const char *cid,
                   int64_t seq, int src, int dst, int tag,
                   const char *dtype, int ndim, const int64_t *shape,
                   const void *meta, int meta_len, const void *data,
                   uint64_t nbytes) {
  if (ndim > 8) return -4;  // Env carries at most 8 dims
  Engine *eng = (Engine *)h;
  Env e;
  e.kind = (uint8_t)kind;
  e.cid = cid ? cid : "";
  e.seq = seq;
  e.src = src;
  e.dst = dst;
  e.tag = tag;
  e.dtype = dtype ? dtype : "";
  e.ndim = ndim;
  for (int i = 0; i < ndim && i < 8; i++) e.shape[i] = shape[i];
  if (meta && meta_len) e.meta.assign((const char *)meta, (size_t)meta_len);
  return engine_send(eng, address, e, data, nbytes);
}

int tdcn_send(void *h, int dst_proc, int kind, const char *cid, int64_t seq,
              int src, int dst, int tag, const char *dtype, int ndim,
              const int64_t *shape, const void *meta, int meta_len,
              const void *data, uint64_t nbytes) {
  Engine *eng = (Engine *)h;
  if (dst_proc < 0 || dst_proc >= eng->nprocs) return -2;
  // sharded native modex: an empty slot resolves through the armed
  // Python AddressTable callback on first send (one KVS get, cached
  // by the install) instead of failing; the slot is copied out under
  // addr_mu (installs race concurrent senders now)
  std::string addr = engine_resolve_addr(eng, dst_proc);
  return tdcn_send_addr(h, addr.c_str(), kind, cid,
                        seq, src, dst, tag, dtype, ndim, shape, meta,
                        meta_len, data, nbytes);
}

// loopback delivery without a wire hop (self-sends and local ranks)
int tdcn_send_local(void *h, int kind, const char *cid, int64_t seq, int src,
                    int dst, int tag, uint64_t pyhandle, int64_t count,
                    uint64_t nbytes) {
  Engine *eng = (Engine *)h;
  OwnedMsg m;
  m.env.kind = (uint8_t)kind;
  m.env.cid = cid ? cid : "";
  m.env.seq = seq;
  m.env.src = src;
  m.env.dst = dst;
  m.env.tag = tag;
  m.pyhandle = pyhandle;
  m.count = count;
  m.nbytes = nbytes;
  std::lock_guard<std::mutex> g(eng->mu);
  deliver_locked(eng, std::move(m));
  return 0;
}

// loopback delivery carrying BYTES (the buffered-eager copy happens
// here): consumable by both the C fast path and Python receivers —
// pyhandle messages can only be consumed Python-side, so mixed-plane
// comms (the C ABI's) must use this form for local ranks
int tdcn_send_local_data(void *h, int kind, const char *cid, int64_t seq,
                         int src, int dst, int tag, const char *dtype,
                         int ndim, const int64_t *shape, const void *data,
                         uint64_t nbytes) {
  if (ndim > 8) return -4;  // Env carries at most 8 dims
  Engine *eng = (Engine *)h;
  OwnedMsg m;
  m.env.kind = (uint8_t)kind;
  m.env.cid = cid ? cid : "";
  m.env.seq = seq;
  m.env.src = src;
  m.env.dst = dst;
  m.env.tag = tag;
  m.env.dtype = dtype ? dtype : "";
  m.env.ndim = ndim;
  for (int i = 0; i < ndim && i < 8; i++) m.env.shape[i] = shape[i];
  m.nbytes = nbytes;
  if (nbytes) {
    m.data = malloc(nbytes);
    memcpy(m.data, data, nbytes);
  }
  std::lock_guard<std::mutex> g(eng->mu);
  deliver_locked(eng, std::move(m));
  return 0;
}

int tdcn_recv_coll(void *h, const char *cid, int64_t seq, int src,
                   int fail_proc, double timeout_s, TdcnMsg *out) {
  // `src` keys the stream slot in the CALLER's index space (sub-comm
  // engines use sub-local indices); `fail_proc` is the ROOT engine
  // index to watch for failure (-1 = none, e.g. across spawn worlds).
  Engine *eng = (Engine *)h;
  OwnedMsg m;
  int rc = coll_wait_msg(eng, std::string(cid ? cid : ""), seq, src,
                         fail_proc, timeout_s, &m);
  if (rc != 0) return rc;
  msg_into_tdcn(m, out);
  return 0;
}

// -- C collective fast path ---------------------------------------------

// Open a per-communicator collective context: the member addresses
// (comm order), this process's member index, and the private stream
// ("<cid>#cfp") the C schedules run on.  `ring_threshold` mirrors the
// engine's DCN ring crossover so the C decision matches the Python
// plane's bit for bit.  Returns a handle (0 on failure).
uint64_t tdcn_coll_open(void *h, const char *cid, int me, int nprocs,
                        const char *const *addrs,
                        uint64_t ring_threshold) {
  Engine *eng = (Engine *)h;
  if (!cid || me < 0 || nprocs < 1 || me >= nprocs) return 0;
  CollCtx *c = new CollCtx();
  c->eng = eng;
  c->cid = std::string(cid) + "#cfp";
  c->me = me;
  c->nprocs = nprocs;
  if (ring_threshold) c->ring_threshold = ring_threshold;
  c->addrs.resize(nprocs);
  c->peers.assign(nprocs, nullptr);
  c->fail_idx.assign(nprocs, -1);
  {
    // fail-index mapping under addr_mu: lazy-modex installs mutate
    // peer_addresses from whichever thread sends first, so the slot
    // comparisons can no longer be lock-free
    std::lock_guard<std::mutex> ag(eng->addr_mu);
    for (int p = 0; p < nprocs; p++) {
      c->addrs[p] = addrs && addrs[p] ? addrs[p] : "";
      for (size_t q = 0; q < eng->peer_addresses.size(); q++) {
        if (!c->addrs[p].empty() &&
            eng->peer_addresses[q] == c->addrs[p]) {
          c->fail_idx[p] = (int)q;
          break;
        }
      }
    }
  }
  {
    // registry: address-change invalidation and revoke-by-cid find
    // live views here
    std::lock_guard<std::mutex> g(eng->cctx_mu);
    eng->cctxs.insert(c);
  }
  return (uint64_t)(uintptr_t)c;
}

void tdcn_coll_close(void *h, uint64_t cctx) {
  Engine *eng = (Engine *)h;
  CollCtx *c = (CollCtx *)(uintptr_t)cctx;
  if (!c) return;
  if (eng) {
    std::lock_guard<std::mutex> g(eng->cctx_mu);
    eng->cctxs.erase(c);
  }
  for (auto &kv : c->plans) delete kv.second;
  for (CollPlan *pl : c->retired) delete pl;
  delete c;
}

// Poison one comm's C fast path (ULFM revoke, the Python plane's rvk
// fan-out crossing into C): every registered CollCtx whose private
// stream belongs to ``cid`` wakes its parked schedule receives (-6)
// and refuses new schedules until closed.
void tdcn_coll_revoke_cid(void *h, const char *cid) {
  Engine *eng = (Engine *)h;
  if (!eng || !cid) return;
  std::string scid = std::string(cid) + "#cfp";
  bool hit = false;
  {
    std::lock_guard<std::mutex> g(eng->cctx_mu);
    for (CollCtx *c : eng->cctxs) {
      if (c->cid == scid) {
        c->revoked.store(1, std::memory_order_relaxed);
        hit = true;
      }
    }
  }
  if (!hit) return;
  std::lock_guard<std::mutex> g(eng->mu);
  for (auto &kv : eng->coll) kv.second->cv.notify_all();
  wake_waiters(eng);
}

// Compile-or-fetch a schedule for one call signature.  `algo` -1 lets
// the engine decide (the collops crossover: ring for >= ring_threshold
// commutative allreduce, linear otherwise); >= 0 forces the caller's
// choice (the coll/tuned decision a persistent init resolved through
// embedded Python ONCE).  Returns the plan handle, or 0 when the
// signature is not C-serviceable (caller falls back to the Python
// path).  Cache keyed (kind, op, dtype, count, root) — hits replay
// with zero planning (TS_SCHED_CACHE_HITS / _MISSES account it).
uint64_t tdcn_coll_plan(void *h, uint64_t cctx, int kind, int opcode,
                        int dtcode, int64_t count, int root, int algo) {
  Engine *eng = (Engine *)h;
  CollCtx *c = (CollCtx *)(uintptr_t)cctx;
  if (!c || count < 0) return 0;
  if (dtcode < 1 || dtcode > 27 || coll_dt[dtcode].cls == 0) return 0;
  if (kind < CK_BARRIER || kind > CK_ALLGATHER) return 0;
  if (root < 0 || root >= c->nprocs) return 0;
  // resolve the algorithm BEFORE the cache lookup (part of the key):
  // only allreduce has a ring variant; the caller's compiled decision
  // wins, else the collops crossover (every C-served op is
  // commutative, so the Python plane's commutativity gate is
  // satisfied by construction)
  uint64_t nbytes = (uint64_t)count * (uint64_t)coll_dt[dtcode].size;
  int ralgo = CA_LINEAR;
  if (kind == CK_ALLREDUCE)
    ralgo = algo >= 0 ? algo
                      : (nbytes >= c->ring_threshold && c->nprocs > 1
                             ? CA_RING
                             : CA_LINEAR);
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->plans.find({kind, opcode, dtcode, count, root, ralgo});
    if (it != c->plans.end()) {
      eng->stats.add(TS_SCHED_CACHE_HITS, 1);
      return (uint64_t)(uintptr_t)it->second;
    }
  }
  CollPlan *pl = new CollPlan();
  pl->ctx = c;
  pl->kind = kind;
  pl->opcode = opcode;
  pl->dtcode = dtcode;
  pl->count = count;
  pl->root = root;
  pl->esize = coll_dt[dtcode].size;
  pl->nbytes = (uint64_t)count * (uint64_t)pl->esize;
  pl->kcount = coll_dt[dtcode].cls == 4 ? 2 * count : count;
  if (kind == CK_REDUCE || kind == CK_ALLREDUCE) {
    pl->kfn = coll_kernel(opcode, dtcode);
    if (!pl->kfn) {
      delete pl;
      return 0;  // unsupported op x dtype: embedded-Python fallback
    }
  }
  if (kind == CK_ALLREDUCE) {
    pl->algo = ralgo;
    if (pl->algo == CA_RING) {
      // chunk plan (np.array_split bounds: sizes differ by <= 1)
      int P = c->nprocs;
      int64_t base = count / P, extra = count % P;
      pl->bounds.resize(P + 1);
      pl->bounds[0] = 0;
      for (int i = 0; i < P; i++)
        pl->bounds[i + 1] =
            pl->bounds[i] + (uint64_t)(base + (i < extra ? 1 : 0));
    }
  }
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->plans.find({kind, opcode, dtcode, count, root, ralgo});
  if (it != c->plans.end()) {  // raced compile: keep the first
    delete pl;
    eng->stats.add(TS_SCHED_CACHE_HITS, 1);
    return (uint64_t)(uintptr_t)it->second;
  }
  eng->stats.add(TS_SCHED_CACHE_MISSES, 1);
  c->plans[{kind, opcode, dtcode, count, root, ralgo}] = pl;
  return (uint64_t)(uintptr_t)pl;
}

// Replay one compiled schedule with the caller's buffers.  0 = done,
// -1 = transport failure (ULFM escalation path), -2 = watched member
// failed, -3 = engine closing, -4 = schedule mismatch.
int tdcn_coll_start(void *h, uint64_t plan, const void *sendbuf,
                    void *recvbuf) {
  (void)h;
  CollPlan *pl = (CollPlan *)(uintptr_t)plan;
  if (!pl || !pl->ctx) return -4;
  if (pl->ctx->revoked.load(std::memory_order_relaxed))
    return -6;  // revoked comm: refuse before any frame moves
  // per-op timing (the straggler merge's C rows): one clock pair per
  // C-served collective — two vdso calls against schedules that move
  // frames; below measurement noise on the np=1 dispatch floor too
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  int rc = plan_exec(pl->ctx, pl, sendbuf, recvbuf);
  if (rc == 0 && pl->kind >= 0 && pl->kind < Engine::OPTIME_KINDS) {
    clock_gettime(CLOCK_MONOTONIC, &t1);
    uint64_t ns = (uint64_t)(t1.tv_sec - t0.tv_sec) * 1000000000ull +
                  (uint64_t)(t1.tv_nsec - t0.tv_nsec);
    auto &ot = pl->ctx->eng->coll_optime[pl->kind];
    ot.count.fetch_add(1, std::memory_order_relaxed);
    ot.total_ns.fetch_add(ns, std::memory_order_relaxed);
    uint64_t cur = ot.max_ns.load(std::memory_order_relaxed);
    while (cur < ns && !ot.max_ns.compare_exchange_weak(
                           cur, ns, std::memory_order_relaxed)) {
    }
    // log2-µs bucket, upper-inclusive edges (metrics.lat_bucket twin)
    uint64_t us = ns / 1000;
    int b = 0;
    while (us > 1 && b < Engine::OPTIME_BUCKETS - 1) {
      us = (us + 1) >> 1;  // ceil halving == bit_length of (us-1)
      b++;
    }
    ot.hist[b].fetch_add(1, std::memory_order_relaxed);
  }
  return rc;
}

// Per-op timing rows for one C-served collective kind (CK_* index):
// out = [count, total_ns, max_ns, hist[16 log2-µs buckets]].  Returns
// the number of slots written (0 for an unknown kind / tiny buffer).
int tdcn_coll_optime(void *h, int kind, uint64_t *out, int max_n) {
  Engine *eng = (Engine *)h;
  if (kind < 0 || kind >= Engine::OPTIME_KINDS) return 0;
  int need = 3 + Engine::OPTIME_BUCKETS;
  if (max_n < need) return 0;
  auto &ot = eng->coll_optime[kind];
  out[0] = ot.count.load(std::memory_order_relaxed);
  out[1] = ot.total_ns.load(std::memory_order_relaxed);
  out[2] = ot.max_ns.load(std::memory_order_relaxed);
  for (int i = 0; i < Engine::OPTIME_BUCKETS; i++)
    out[3 + i] = ot.hist[i].load(std::memory_order_relaxed);
  return need;
}

// Post a receive that CARRIES its destination buffer: an in-order
// streaming RTS that matches it streams FRAGs straight into `buf`
// (in-place rendezvous placement — delivery then has data == buf and
// the consumer skips its copy).  buf = NULL degrades to the plain
// copy path; `cap` guards truncation (a too-small buffer falls back
// to a reassembly allocation so MPI truncation semantics survive).
uint64_t tdcn_post_recv_into(void *h, const char *cid, int dst, int src,
                             int tag, void *buf, uint64_t cap) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  CidQueues &q = eng->p2p[cid ? cid : ""];
  // match earliest unexpected first (arrival order)
  auto &uq = q.unexpected[dst];
  for (auto it = uq.begin(); it != uq.end(); ++it) {
    if ((src == -1 || src == it->env.src) &&
        (tag == -1 || tag == it->env.tag)) {
      uint64_t rid = eng->next_req++;
      ReqState *st = new ReqState();
      st->msg = std::move(*it);
      st->completed = true;
      uq.erase(it);
      eng->reqs[rid] = st;
      return rid;
    }
  }
  uint64_t rid = eng->next_req++;
  ReqState *st = new ReqState();
  st->user_buf = buf;
  st->user_cap = cap;
  eng->reqs[rid] = st;
  q.posted[dst].push_back(PostedReq{rid, src, tag, eng->arrival++});
  return rid;
}

uint64_t tdcn_post_recv(void *h, const char *cid, int dst, int src,
                        int tag) {
  return tdcn_post_recv_into(h, cid, dst, src, tag, nullptr, 0);
}

int tdcn_req_wait(void *h, uint64_t rid, double timeout_s, TdcnMsg *out) {
  Engine *eng = (Engine *)h;
  std::unique_lock<std::mutex> g(eng->mu);
  auto it = eng->reqs.find(rid);
  if (it == eng->reqs.end()) return -1;
  ReqState *st = it->second;
  bool ok = progress_wait(eng, g,
                          [&] {
                            return st->completed.load() ||
                                   eng->closing.load(
                                       std::memory_order_relaxed);
                          },
                          timeout_s);
  if (!ok || !st->completed)
    return eng->closing.load(std::memory_order_relaxed) ? -3 : 1;
  msg_into_tdcn(st->msg, out);
  eng->reqs.erase(rid);
  delete st;
  return 0;
}

int tdcn_req_test(void *h, uint64_t rid, TdcnMsg *out) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  auto it = eng->reqs.find(rid);
  if (it == eng->reqs.end()) return -1;
  if (!it->second->completed) return 1;
  msg_into_tdcn(it->second->msg, out);
  delete it->second;
  eng->reqs.erase(it);
  return 0;
}

int tdcn_req_peek(void *h, uint64_t rid, TdcnMsg *out) {
  // NON-destructive completion probe (MPI_Request_get_status): fills
  // the envelope fields only; the payload stays owned by the request
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  auto it = eng->reqs.find(rid);
  if (it == eng->reqs.end()) return -1;
  if (!it->second->completed.load()) return 1;
  OwnedMsg &m = it->second->msg;
  memset(out, 0, sizeof(*out));
  out->src = m.env.src;
  out->tag = m.env.tag;
  out->seq = m.env.seq;
  out->nbytes = m.nbytes;
  out->count = m.count;
  out->pyhandle = m.pyhandle;
  return 0;
}

int tdcn_req_cancel(void *h, uint64_t rid) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  auto it = eng->reqs.find(rid);
  if (it == eng->reqs.end()) return -1;
  if (it->second->completed) return 1;  // too late
  if (it->second->in_fill || it->second->reserved)
    return 1;  // matched at RTS: the transfer is already in flight
  // remove from every posted list it may sit in
  for (auto qit = eng->p2p.begin(); qit != eng->p2p.end();) {
    for (auto &pl : qit->second.posted) {
      auto &v = pl.second;
      for (size_t i = 0; i < v.size(); i++) {
        if (v[i].id == rid) {
          v.erase(v.begin() + i);
          break;
        }
      }
    }
    if (qit->second.draining && qit->second.posted_empty())
      qit = eng->p2p.erase(qit);
    else
      ++qit;
  }
  delete it->second;
  eng->reqs.erase(it);
  return 0;
}

int tdcn_probe(void *h, const char *cid, int dst, int src, int tag,
               TdcnMsg *out) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  auto qit = eng->p2p.find(cid ? cid : "");
  if (qit == eng->p2p.end()) return 1;
  auto uit = qit->second.unexpected.find(dst);
  if (uit == qit->second.unexpected.end()) return 1;
  for (auto &m : uit->second) {
    if ((src == -1 || src == m.env.src) && (tag == -1 || tag == m.env.tag)) {
      memset(out, 0, sizeof(*out));
      out->src = m.env.src;
      out->tag = m.env.tag;
      out->nbytes = m.nbytes;
      out->count = m.count;
      out->pyhandle = m.pyhandle;
      snprintf(out->dtype, sizeof(out->dtype), "%s", m.env.dtype.c_str());
      out->ndim = m.env.ndim;
      memcpy(out->shape, m.env.shape, sizeof(out->shape));
      return 0;
    }
  }
  return 1;
}

int tdcn_pending(void *h, const char *cid, int dst, int which) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  auto qit = eng->p2p.find(cid ? cid : "");
  if (qit == eng->p2p.end()) return 0;
  if (which == 0) {
    auto it = qit->second.unexpected.find(dst);
    return it == qit->second.unexpected.end() ? 0 : (int)it->second.size();
  }
  auto it = qit->second.posted.find(dst);
  return it == qit->second.posted.end() ? 0 : (int)it->second.size();
}

int tdcn_register_pycid(void *h, const char *cid) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  eng->py_cids[cid ? cid : ""] = true;
  // frames that raced into the native queues move to the PY queue
  auto qit = eng->p2p.find(cid ? cid : "");
  if (qit != eng->p2p.end()) {
    for (auto &kv : qit->second.unexpected)
      for (auto &m : kv.second) {
        eng->py_queue.push_back(std::move(m));
        eng->py_cv.notify_one();
      }
    eng->p2p.erase(qit);
  }
  return 0;
}

int tdcn_unregister_cid(void *h, const char *cid) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  eng->py_cids.erase(cid ? cid : "");
  auto qit = eng->p2p.find(cid ? cid : "");
  if (qit != eng->p2p.end()) {
    for (auto &kv : qit->second.unexpected)
      for (auto &m : kv.second) free(m.data);
    qit->second.unexpected.clear();
    if (qit->second.posted_empty()) {
      eng->p2p.erase(qit);
    } else {
      // pending receives survive the free (MPI 3.7.3): drain mode —
      // they complete when their messages arrive; the slot is
      // reclaimed on the last match (deliver_locked)
      qit->second.draining = true;
    }
  }
  return 0;
}

int tdcn_ctrl_next(void *h, double timeout_s, TdcnMsg *out) {
  Engine *eng = (Engine *)h;
  std::unique_lock<std::mutex> g(eng->mu);
  bool ok = cv_wait_for(eng->py_cv, g, timeout_s, [&] {
    return !eng->py_queue.empty() ||
           eng->closing.load(std::memory_order_relaxed);
  });
  if (!ok || eng->py_queue.empty())
    return eng->closing.load(std::memory_order_relaxed) ? -3 : 1;
  OwnedMsg m = std::move(eng->py_queue.front());
  eng->py_queue.pop_front();
  msg_into_tdcn(m, out);
  return 0;
}

// Prune every dedup watermark a proc's senders left behind (all
// lineage nonces).  Correctness does not depend on this — a reborn
// incarnation's Peer carries a FRESH nonce, so it can never collide
// with the corpse's state — it just bounds memory across recoveries.
// Call it ONLY when the proc's lineage is provably dead (its address
// changed, i.e. a new incarnation was installed): pruning on a mere
// failure mark, or on the mark's clear, REGRESSES the watermark of a
// still-alive sender (false-positive detection, injected connkill),
// and its next retry round would re-deliver an already-delivered
// frame — the exactly-once contract broken exactly when recovery is
// exercising it.
static void prune_dedup(Engine *eng, int proc) {
  std::lock_guard<std::mutex> g(eng->dedup_mu);
  for (auto it = eng->rx_seen.begin(); it != eng->rx_seen.end();) {
    if (it->first.first == proc)
      it = eng->rx_seen.erase(it);
    else
      ++it;
  }
}

// The contiguous delivered watermark for a sending proc (max over its
// lineage nonces; 0 = nothing seq'd delivered).  Introspection for
// recovery observability + the watermark-continuity tests.
uint64_t tdcn_rx_watermark(void *h, int proc) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->dedup_mu);
  uint64_t low = 0;
  for (auto &kv : eng->rx_seen)
    if (kv.first.first == proc && kv.second.low > low)
      low = kv.second.low;
  return low;
}

// Un-mark a failed proc (the replace() leg of elastic recovery: a
// respawned incarnation re-published its endpoint, so sends/recvs
// naming it must flow again).  Deliberately does NOT touch the rx
// dedup watermarks: the mark may have been a false positive and the
// same sender lineage may resend across the clear — the watermark is
// what keeps that resend exactly-once.  Stale lineages are pruned
// when the proc's ADDRESS changes (tdcn_set_addresses), the one
// signal that a new incarnation really replaced it.
// The peer object of `proc`'s current address, or nullptr (no address
// installed yet, or never dialed).  Takes addr_mu, then peers_mu.
static Peer *engine_peer_of(Engine *eng, int proc) {
  std::string addr;
  {
    std::lock_guard<std::mutex> ag(eng->addr_mu);
    if (proc < 0 || (size_t)proc >= eng->peer_addresses.size()) return nullptr;
    addr = eng->peer_addresses[proc];
  }
  std::lock_guard<std::mutex> g(eng->peers_mu);
  auto it = eng->peers.find(addr);
  return it == eng->peers.end() ? nullptr : it->second;
}

void tdcn_clear_failed(void *h, int proc) {
  Engine *eng = (Engine *)h;
  {
    std::lock_guard<std::mutex> g(eng->mu);
    if (proc >= 0 && (size_t)proc < eng->failed.size())
      eng->failed[proc] = false;
  }
  if (Peer *p = engine_peer_of(eng, proc))
    p->marked_failed.store(false, std::memory_order_relaxed);
}

void tdcn_note_failed(void *h, int proc) {
  Engine *eng = (Engine *)h;
  {
    std::lock_guard<std::mutex> g(eng->mu);
    if (proc >= 0 && (size_t)proc < eng->failed.size())
      eng->failed[proc] = true;
    // wake every waiter so failure-sensitive recvs re-check; inline-
    // progress waiters sleep on the doorbell futex, not the cvs
    for (auto &kv : eng->coll) kv.second->cv.notify_all();
    for (auto &kv : eng->reqs) kv.second->cv.notify_all();
    wake_waiters(eng);
  }
  // a sender blocked on the proc's full ring polls this flag at its
  // 2 ms backstop; its queued streams fail on the sender thread's turn
  if (Peer *p = engine_peer_of(eng, proc)) {
    p->marked_failed.store(true, std::memory_order_relaxed);
    stream_kick(eng);
  }
  // dedup watermarks survive the mark on purpose: a false-positive
  // detection (peer actually alive) followed by clear_failed must not
  // regress them, or the peer's next resend round re-delivers.  The
  // genuinely-dead incarnation's entries are pruned when replace()
  // installs its successor's address (tdcn_set_addresses).
}

// ---- channel fast path ----------------------------------------------
// A channel pins (peer, cid) once so the per-message call carries only
// scalars — the per-call cost of the C ABI crossing is what separated
// the Python transport's 80 µs floor from the native target.

struct Chan {
  Engine *eng;
  Peer *peer;
  std::string cid;
};

uint64_t tdcn_chan_open(void *h, const char *address, const char *cid) {
  Engine *eng = (Engine *)h;
  Peer *p = get_peer(eng, address ? address : "");
  if (!p) return 0;
  Chan *c = new Chan{eng, p, std::string(cid ? cid : "")};
  return (uint64_t)(uintptr_t)c;
}

void tdcn_chan_close(void *h, uint64_t chan) {
  (void)h;
  delete (Chan *)(uintptr_t)chan;  // the Peer it references stays
                                   // engine-owned
}

int tdcn_chan_send(void *h, uint64_t chan, int kind, int src, int dst,
                   int tag, const char *dtype, int ndim,
                   const int64_t *shape, const void *data,
                   uint64_t nbytes) {
  (void)h;
  if (ndim > 8) return -4;  // Env carries at most 8 dims
  Chan *c = (Chan *)(uintptr_t)chan;
  Env e;
  e.kind = (uint8_t)kind;
  e.cid = c->cid;
  e.seq = 0;
  e.src = src;
  e.dst = dst;
  e.tag = tag;
  e.dtype = dtype ? dtype : "";
  e.ndim = ndim;
  for (int i = 0; i < ndim && i < 8; i++) e.shape[i] = shape[i];
  return engine_send_peer(c->eng, c->peer, e, data, nbytes);
}

// Nonblocking 1-D isend — the MPI_Isend fast path: a larger-than-chunk
// payload enqueues a send descriptor on the streaming engine and
// returns immediately, so 64 windowed 4 MiB isends pipeline through
// the ring instead of serializing the caller behind 64 blocking
// backpressured transfers.  copy != 0: buffered (engine-owned copy,
// locally complete, returns 0).  copy == 0: zero-copy — the buffer is
// BORROWED and the returned positive handle must be collected via
// tdcn_send_wait / tdcn_send_test before the buffer is reused (the
// MPI_Wait contract).  Returns <0 on error.
int64_t tdcn_chan_isend1(void *h, uint64_t chan, int kind, int src,
                         int dst, int tag, const char *dtype,
                         int64_t nelems, const void *data,
                         uint64_t nbytes, int copy) {
  (void)h;
  Chan *c = (Chan *)(uintptr_t)chan;
  Env e;
  e.kind = (uint8_t)kind;
  e.cid = c->cid;
  e.seq = 0;
  e.src = src;
  e.dst = dst;
  e.tag = tag;
  e.dtype = dtype ? dtype : "";
  e.ndim = 1;
  e.shape[0] = nelems;
  return engine_isend_peer(c->eng, c->peer, e, data, nbytes, copy);
}

// Collect a zero-copy send descriptor (blocking, `timeout_s` bounded).
// Returns 0 = sent (descriptor freed), 1 = still in flight (call
// again), <0 = failed (descriptor freed; -1 peer failure, -3 engine
// closed).  After any terminal return the handle is dead and the
// borrowed buffer is the caller's again.
int tdcn_send_wait(void *h, int64_t sreq, double timeout_s) {
  (void)h;
  StreamDesc *d = (StreamDesc *)(uintptr_t)sreq;
  if (!d || !d->owner) return -2;
  Peer *p = d->owner;
  {
    std::unique_lock<std::mutex> sl(p->stream_mu);
    if (!cv_wait_for(p->stream_cv, sl, timeout_s,
                     [&] { return d->done; }))
      return 1;
  }
  int rc = d->rc;
  delete d;
  return rc;
}

// Nonblocking collect: 0 = sent (freed), 1 = in flight, <0 = failed
// (freed).
int tdcn_send_test(void *h, int64_t sreq) {
  (void)h;
  StreamDesc *d = (StreamDesc *)(uintptr_t)sreq;
  if (!d || !d->owner) return -2;
  {
    std::lock_guard<std::mutex> sl(d->owner->stream_mu);
    if (!d->done) return 1;
  }
  int rc = d->rc;
  delete d;
  return rc;
}

// Non-destructive completion probe (MPI_Request_get_status): 1 = done
// (the handle stays live — collect it with wait/test), 0 = in flight.
int tdcn_send_done(void *h, int64_t sreq) {
  (void)h;
  StreamDesc *d = (StreamDesc *)(uintptr_t)sreq;
  if (!d || !d->owner) return 0;
  std::lock_guard<std::mutex> sl(d->owner->stream_mu);
  return d->done ? 1 : 0;
}

// Abandon a zero-copy handle (MPI_Request_free on an active send):
// the engine completes the transfer in the background and deletes the
// descriptor itself — per MPI, the caller must not touch the buffer
// until it knows the send finished by other means.
void tdcn_send_forget(void *h, int64_t sreq) {
  (void)h;
  StreamDesc *d = (StreamDesc *)(uintptr_t)sreq;
  if (!d || !d->owner) return;
  Peer *p = d->owner;
  bool dead;
  {
    std::lock_guard<std::mutex> sl(p->stream_mu);
    dead = d->done;
    if (!dead) d->detached = true;  // sender thread reclaims it
  }
  if (dead) delete d;
}

int tdcn_chan_send1(void *h, uint64_t chan, int kind, int src, int dst,
                    int tag, const char *dtype, int64_t nelems,
                    const void *data, uint64_t nbytes) {
  // 1-D payload fast path: shape is (nelems,), no shape array to
  // marshal — the dominant case under MPI_Send/Recv
  (void)h;
  Chan *c = (Chan *)(uintptr_t)chan;
  Env e;
  e.kind = (uint8_t)kind;
  e.cid = c->cid;
  e.seq = 0;
  e.src = src;
  e.dst = dst;
  e.tag = tag;
  e.dtype = dtype ? dtype : "";
  e.ndim = 1;
  e.shape[0] = nelems;
  return engine_send_peer(c->eng, c->peer, e, data, nbytes);
}

// Shared body of tdcn_precv / tdcn_precv_into: match-or-post (the
// post CARRIES the destination buffer, so a racing in-order streaming
// RTS reserves it and lands FRAGs straight in the user buffer — no
// reassembly malloc, no delivery copy), then sleep on the request's
// condvar.  On delivery through the copy path the payload is moved
// into `buf` here (out->data == buf tells the caller nothing is left
// to copy or free); oversized payloads stay engine-owned so MPI
// truncation semantics survive at the caller.
static int precv_impl(Engine *eng, const char *cid, int dst, int src,
                      int tag, int fail_proc, double timeout_s, void *buf,
                      uint64_t cap, TdcnMsg *out) {
  fault_recv_check(eng);  // faultsim recv site (one relaxed load off)
  std::unique_lock<std::mutex> g(eng->mu);
  CidQueues &q = eng->p2p[cid ? cid : ""];
  auto &uq = q.unexpected[dst];
  for (auto it = uq.begin(); it != uq.end(); ++it) {
    if ((src == -1 || src == it->env.src) &&
        (tag == -1 || tag == it->env.tag)) {
      msg_into_tdcn(*it, out);
      uq.erase(it);
      g.unlock();  // the payload memcpy must not hold the engine lock
      if (buf && !out->pyhandle && out->data && out->nbytes <= cap) {
        if (out->nbytes) memcpy(buf, out->data, out->nbytes);
        free(out->data);
        out->data = buf;
      }
      return 0;
    }
  }
  uint64_t rid = eng->next_req++;
  ReqState *st = new ReqState();
  st->user_buf = buf;
  st->user_cap = cap;
  eng->reqs[rid] = st;
  q.posted[dst].push_back(PostedReq{rid, src, tag, eng->arrival++});
  auto failed = [&] {
    return fail_proc >= 0 && (size_t)fail_proc < eng->failed.size() &&
           eng->failed[fail_proc];
  };
  for (;;) {
    bool ok = progress_wait(eng, g,
                            [&] {
                              return st->completed.load() ||
                                     eng->closing.load(
                                         std::memory_order_relaxed) ||
                                     failed();
                            },
                            timeout_s);
    if (ok && st->completed) break;
    if (st->reserved && !eng->closing.load(std::memory_order_relaxed) &&
        !failed()) {
      // matched at RTS time (the MPI match happened and the sender's
      // order-gate slot was consumed there): the request can no
      // longer be withdrawn — a timeout-return here would orphan the
      // in-flight transfer, lose the message, and wedge the caller's
      // retry (and every ordered message queued behind it) forever —
      // the old copy-path stall.  Keep waiting; failure and close
      // still break out.
      continue;
    }
    int rc = 1;
    if (eng->closing.load(std::memory_order_relaxed)) rc = -3;
    else if (failed())
      rc = -2;
    // withdraw the posted entry (arrival order of others unchanged)
    auto &pl = q.posted[dst];
    for (size_t i = 0; i < pl.size(); i++) {
      if (pl[i].id == rid) {
        pl.erase(pl.begin() + i);
        break;
      }
    }
    // a reserved request was already erased from the posted list by
    // fill_reserve_locked; erasing the rid here makes the in-flight
    // transfer's eventual fill_complete a lookup miss (its payload is
    // dropped — the comm is failing anyway), and every ReqState access
    // goes through the reqs map, so the delete cannot race the
    // consumer thread (which only ever writes the user buffer)
    eng->reqs.erase(rid);
    delete st;
    return rc;
  }
  bool in_fill = st->in_fill;
  msg_into_tdcn(st->msg, out);
  eng->reqs.erase(rid);
  delete st;
  g.unlock();
  if (!in_fill && buf && !out->pyhandle && out->data &&
      out->nbytes <= cap) {
    if (out->nbytes) memcpy(buf, out->data, out->nbytes);
    free(out->data);
    out->data = buf;  // caller contract: nothing to copy, nothing to free
  }
  return 0;
}

int tdcn_precv(void *h, const char *cid, int dst, int src, int tag,
               int fail_proc, double timeout_s, TdcnMsg *out) {
  // blocking receive in ONE crossing: match-or-post, then sleep on the
  // request's condvar until the C receiver thread completes it (or the
  // watched root proc is marked failed / the engine closes)
  return precv_impl((Engine *)h, cid, dst, src, tag, fail_proc, timeout_s,
                    nullptr, 0, out);
}

// tdcn_precv with the destination buffer carried on the post: the
// MPI_Recv fast path stops taking the copy path when it races the
// sender's RTS — the receive side of the in-place placement
// story.  out->data == buf after return means the payload is already
// in place (no copy, no free); an oversized payload is returned
// engine-owned for the caller's truncation handling.
int tdcn_precv_into(void *h, const char *cid, int dst, int src, int tag,
                    int fail_proc, double timeout_s, void *buf,
                    uint64_t cap, TdcnMsg *out) {
  return precv_impl((Engine *)h, cid, dst, src, tag, fail_proc, timeout_s,
                    buf, cap, out);
}

int tdcn_is_failed(void *h, int proc) {
  Engine *eng = (Engine *)h;
  std::lock_guard<std::mutex> g(eng->mu);
  return (proc >= 0 && (size_t)proc < eng->failed.size() &&
          eng->failed[proc])
             ? 1
             : 0;
}

uint64_t tdcn_bytes_sent(void *h) {
  return ((Engine *)h)->bytes_sent.load(std::memory_order_relaxed);
}

// Copy the telemetry block into out[] (out[0] is the layout version).
// Relaxed loads: monotone per counter, not mutually consistent — the
// snapshot contract ompi_tpu_torch/metrics/ documents.  Returns the number
// of counters this build maintains; callers pass max_n = capacity.
int tdcn_stats(void *h, uint64_t *out, int max_n) {
  Engine *eng = (Engine *)h;
  int n = TS_COUNT < max_n ? TS_COUNT : max_n;
  for (int i = 0; i < n; i++)
    out[i] = eng->stats.v[i].load(std::memory_order_relaxed);
  return TS_COUNT;
}

// Self-describing index→name table (comma-separated, index order);
// lets the Python reader and C tools agree on layout without
// hardcoding, validated against out[0]'s version stamp.
const char *tdcn_stats_names(void) { return TDCN_STAT_NAMES; }

// Arm/disarm the hang-diagnosis wait registry (process-wide, mirrors
// the hang_diag_enable MCA var; default on — registration is strictly
// cold-path so a healthy run never reaches it).
void tdcn_hang_diag(int on) {
  g_hang_diag.store(on ? 1 : 0, std::memory_order_relaxed);
}

// Mirror this engine's registered blocked waits out as a JSON array —
// the introspection half of the mesh doctor (the TdcnStats snapshot
// discipline applied to wait state: copy the live entries, no
// quiescing).  Peer identity is resolved address→root-proc-index at
// snapshot time (the addr table can gain entries after the wait
// registered); unresolvable peers report -1 and the Python side keeps
// the composite address.  Returns bytes written (0 = no waits or no
// room); rows that do not fit in `cap` are dropped whole, never
// truncated mid-object.
int tdcn_waitinfo(void *h, char *out, int cap) {
  Engine *eng = (Engine *)h;
  if (!eng || !out || cap < 3) return 0;
  std::vector<HangWait> rows;
  {
    std::lock_guard<std::mutex> g(g_hang_mu);
    for (auto &kv : g_hang_waits)
      if (kv.second.eng == (void *)eng) rows.push_back(kv.second);
  }
  if (rows.empty()) return 0;
  uint64_t now = now_ns();
  std::string s = "[";
  for (const HangWait &w : rows) {
    int peer = w.peer;
    if (peer < 0 && !w.addr.empty()) {
      std::lock_guard<std::mutex> g(eng->addr_mu);
      for (size_t i = 0; i < eng->peer_addresses.size(); i++)
        if (eng->peer_addresses[i] == w.addr) {
          peer = (int)i;
          break;
        }
    }
    // cid strings are runtime-minted ("<cid>#cfp" etc.) but defend the
    // JSON anyway: drop quote/backslash/control bytes
    std::string cid;
    for (char c : w.cid)
      if (c >= 0x20 && c != '"' && c != '\\') cid.push_back(c);
    char buf[320];
    int n = snprintf(
        buf, sizeof(buf),
        "%s{\"site\":\"%s\",\"plane\":\"native\",\"peer\":%d,"
        "\"cid\":\"%s\",\"seq\":%lld,\"age_ns\":%llu}",
        s.size() > 1 ? "," : "", HANG_KIND_NAMES[w.kind], peer,
        cid.c_str(), (long long)w.seq,
        (unsigned long long)(now > w.t0 ? now - w.t0 : 0));
    if (n <= 0 || n >= (int)sizeof(buf)) continue;
    if ((int)(s.size() + n + 2) > cap) break;  // keep rows whole
    s += buf;
  }
  s += "]";
  if ((int)s.size() + 1 > cap || s.size() <= 2) return 0;
  memcpy(out, s.c_str(), s.size() + 1);
  return (int)s.size();
}

// Self-describing causal wire-context schema (version, then the
// comma-joined field table) — the Python side validates its
// CTX_VERSION/CTX_FIELDS against this at test time, the same
// single-source-of-truth read tdcn_stats_names serves for counters.
int tdcn_trace_ctx_version(void) { return TDCN_TRACE_CTX_VERSION; }
const char *tdcn_trace_ctx_fields(void) { return TDCN_TRACE_CTX_FIELDS; }

// Arm/disarm the native fault-injection knobs (process-wide; see
// fault_ring_ok).  stall_ns = injected backpressure per matching ring
// write, stall_every = apply to every Nth write, fail_at = fail the
// Nth write outright (-1 = never).  (0, anything, -1) disarms.  The
// event counter restarts on every call so schedules are reproducible.
void tdcn_fault_set(uint64_t stall_ns, uint64_t stall_every,
                    int64_t fail_at) {
  g_fault_stall_ns.store(stall_ns, std::memory_order_relaxed);
  g_fault_stall_every.store(stall_every ? stall_every : 1,
                            std::memory_order_relaxed);
  g_fault_fail_at.store(fail_at, std::memory_order_relaxed);
  g_fault_events.store(0, std::memory_order_relaxed);
  g_fault_armed.store(stall_ns || fail_at >= 0 ? 1 : 0,
                      std::memory_order_relaxed);
}

uint64_t tdcn_fault_events(void) {
  return g_fault_events.load(std::memory_order_relaxed);
}

// Arm/disarm the tcp-send connection-kill knob (connkill:at=N rules on
// the native plane): the Nth non-control send finds its cached socket
// severed and must heal through the redial round.  -1 disarms; the
// event counter restarts so schedules are reproducible.
void tdcn_fault_set_conn(int64_t connkill_at) {
  g_fault_conn_at.store(connkill_at, std::memory_order_relaxed);
  g_fault_conn_events.store(0, std::memory_order_relaxed);
}

// Arm/disarm the wire-duplicate knob (dup:at=N rules on the native
// plane): the Nth seq-carrying eager tcp send goes out twice — the
// receiver must deliver exactly once via its dedup watermark.  -1
// disarms; the event counter restarts so schedules are reproducible.
void tdcn_fault_set_dup(int64_t dup_at) {
  g_fault_dup_at.store(dup_at, std::memory_order_relaxed);
  g_fault_dup_events.store(0, std::memory_order_relaxed);
}

// Arm/disarm the blocking-receive delay knob (delay:ms=..;site=recv
// rules): every Nth tdcn_precv entry sleeps delay_ns — the injected
// latency covers the native pml fast path and the C-ABI shim's
// MPI_Recv, which both ride tdcn_precv.  delay_ns = 0 disarms.
void tdcn_fault_set_recv(uint64_t delay_ns, uint64_t every) {
  g_fault_recv_ns.store(delay_ns, std::memory_order_relaxed);
  g_fault_recv_every.store(every ? every : 1, std::memory_order_relaxed);
  g_fault_recv_events.store(0, std::memory_order_relaxed);
  g_fault_recv_armed.store(delay_ns ? 1 : 0, std::memory_order_relaxed);
}

// Sever a channel's cached peer connection in place (test/chaos
// injection: the next send fails and exercises the native redial) —
// the C twin of the Python transport's _kill_peer.  send_mu guards
// the fd lifecycle (the retry path closes + reassigns it), so the
// kill must hold it too or it could shutdown() a recycled descriptor
// belonging to something else entirely.
static void kill_peer_locked(Peer *p) {
  std::lock_guard<std::mutex> g(p->send_mu);
  if (p->fd >= 0) shutdown(p->fd, SHUT_RDWR);
}

void tdcn_chan_kill(void *h, uint64_t chan) {
  (void)h;
  Chan *c = (Chan *)(uintptr_t)chan;
  if (c && c->peer) kill_peer_locked(c->peer);
}

// Same, addressed by the peer's composite address (engine-level sends).
void tdcn_kill_peer(void *h, const char *address) {
  Engine *eng = (Engine *)h;
  Peer *p = nullptr;
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    auto it = eng->peers.find(address ? address : "");
    if (it != eng->peers.end()) p = it->second;
  }
  if (p) kill_peer_locked(p);
}

// Bound every ring write by `seconds` (the dcn_ring_timeout MCA var —
// the Python control plane forwards it after engine creation); expiry
// surfaces as a send error + TS_DEADLINE_EXPIRED.  <= 0 restores the
// unbounded pre-deadline behavior.
void tdcn_set_ring_timeout(void *h, double seconds) {
  Engine *eng = (Engine *)h;
  eng->ring_timeout_ns.store(
      seconds > 0 ? (uint64_t)(seconds * 1e9) : 0,
      std::memory_order_relaxed);
}

// Bound every (re)dial by `seconds` (the dcn_connect_timeout MCA var —
// the ring-timeout hook's twin); the exponential-backoff dial loop
// gives up and surfaces a send error once it expires.  <= 0 removes
// the bound (dial retries forever until close).
void tdcn_set_connect_timeout(void *h, double seconds) {
  Engine *eng = (Engine *)h;
  eng->connect_timeout_ns.store(
      seconds > 0 ? (uint64_t)(seconds * 1e9) : 0,
      std::memory_order_relaxed);
}

// Streaming-engine knobs (the dcn_chunk_bytes / dcn_inflight_limit /
// dcn_doorbell_coalesce MCA vars — the Python control plane forwards
// them after engine creation).  chunk_bytes = 0 keeps the built-in
// default; inflight_limit = 0 removes the per-peer cap on queued
// stream bytes; doorbell_coalesce = 0 restores the unconditional
// per-record futex wake (the escape hatch).
void tdcn_set_stream(void *h, uint64_t chunk_bytes,
                     uint64_t inflight_limit, int doorbell_coalesce) {
  Engine *eng = (Engine *)h;
  if (chunk_bytes)
    eng->chunk_bytes.store(chunk_bytes, std::memory_order_relaxed);
  eng->inflight_limit.store(inflight_limit, std::memory_order_relaxed);
  eng->db_coalesce.store(doorbell_coalesce ? 1 : 0,
                         std::memory_order_relaxed);
}

void tdcn_free(void *p) { free(p); }

void tdcn_close(void *h) {
  Engine *eng = (Engine *)h;
  // graceful stream drain (bounded): buffered isends accepted before
  // close must reach the wire — MPI_Finalize rides this path.  A
  // wedged consumer cannot extend the bound much: the sender watchdog
  // fails its descriptors on the ring deadline, emptying the queues.
  if (!eng->closing.load(std::memory_order_relaxed)) {
    for (int i = 0; i < 2000; i++) {  // <= ~2 s grace
      bool empty = true;
      {
        std::lock_guard<std::mutex> g(eng->peers_mu);
        for (auto &kv : eng->peers) {
          std::lock_guard<std::mutex> sg(kv.second->stream_mu);
          if (!kv.second->streams.empty()) {
            empty = false;
            break;
          }
        }
      }
      if (empty) break;
      struct timespec ts = {0, 1000000};
      nanosleep(&ts, nullptr);
    }
  }
  eng->closing.store(true, std::memory_order_relaxed);
  {
    // wake the sender thread so it runs its close-drain and exits
    std::lock_guard<std::mutex> lk(eng->sender_mu);
    eng->stream_gen++;
  }
  eng->sender_cv.notify_all();
  {
    std::lock_guard<std::mutex> g(eng->mu);
    for (auto &kv : eng->coll) kv.second->cv.notify_all();
    for (auto &kv : eng->reqs) kv.second->cv.notify_all();
    eng->py_cv.notify_all();
  }
  {
    std::lock_guard<std::mutex> g(eng->rndv_mu);
    eng->rndv_cv.notify_all();
  }
  eng->my_db.word->fetch_add(1, std::memory_order_release);
  futex_wake(eng->my_db.word, 64);
  {
    // same peers_mu→cts_mu discipline as the FT_CTS handler: snapshot
    // first, never hold both (the send path nests the other way)
    std::vector<Peer *> snapshot;
    {
      std::lock_guard<std::mutex> g(eng->peers_mu);
      snapshot.reserve(eng->peers.size());
      for (auto &kv : eng->peers) snapshot.push_back(kv.second);
    }
    for (Peer *p : snapshot) {
      std::lock_guard<std::mutex> g2(p->cts_mu);
      p->cts_cv.notify_all();
    }
  }
  // join the owned threads BEFORE tearing down the state they read
  // (accept loops poll with a timeout; the ring poller futex-waits
  // with a timeout — both re-check `closing` within ~100 ms)
  for (auto &t : eng->threads)
    if (t.joinable()) t.join();
  if (eng->tcp_listen_fd >= 0) close(eng->tcp_listen_fd);
  if (eng->uds_listen_fd >= 0) close(eng->uds_listen_fd);
  eng->tcp_listen_fd = eng->uds_listen_fd = -1;  // close is idempotent
                                                 // (tdcn_destroy re-enters)
  {
    // unblock the detached readers: an accept-side reader otherwise
    // sits in recv until the REMOTE engine closes its end.  Under
    // reader_mu, so no fd here can have been recycled (readers close
    // their fd under the same lock).
    std::lock_guard<std::mutex> g(eng->reader_mu);
    for (int rfd : eng->reader_fds) shutdown(rfd, SHUT_RDWR);
  }
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    for (auto &kv : eng->peers) {
      Peer *p = kv.second;
      if (p->fd >= 0) {
        shutdown(p->fd, SHUT_RDWR);
        close(p->fd);
        p->fd = -1;
      }
      p->tx_ring.destroy(true);
      p->peer_db.destroy(false);
    }
  }
  {
    // destroy AND drop the ring objects under rings_mu so a straggler
    // try_consume_rings sees an empty vector, not dangling ShmRing*
    std::lock_guard<std::mutex> g(eng->rings_mu);
    for (ShmRing *r : eng->rx_rings) {
      r->destroy(true);
      delete r;
    }
    eng->rx_rings.clear();
  }
  // The doorbell MAPPING stays alive (only the name is unlinked, so
  // /dev/shm is reclaimed): detached per-connection readers can still
  // deliver one straggler frame after close, and deliver_locked rings
  // my_db.word — an munmap here would turn that into a use-after-free
  // segfault at teardown.  Same rationale as leaking the Engine.
  if (!eng->my_db.name.empty()) shm_unlink(eng->my_db.name.c_str());
  if (eng->my_db.fd >= 0) close(eng->my_db.fd);
  eng->my_db.fd = -1;
  eng->my_db.name.clear();
  // NOTE: the Engine object is intentionally leaked at close (detached
  // per-connection recv threads may still be draining); process
  // teardown reclaims it.  tdcn_destroy below is the full-teardown
  // variant for hosts that outlive many engines (tpud, the sanitizer
  // soak): it waits for the reader count to drain and then frees.
}

// Full teardown: close, wait (bounded) for the detached readers to
// exit, then free every engine-owned allocation.  If a reader is
// still draining after the grace window the engine falls back to the
// documented close() behavior — leaked, never freed in use.
void tdcn_destroy(void *h) {
  Engine *eng = (Engine *)h;
  tdcn_close(h);
  for (int i = 0; i < 2000; i++) {  // <= ~2 s grace
    if (eng->readers.load(std::memory_order_acquire) == 0) break;
    struct timespec ts = {0, 1000000};
    nanosleep(&ts, nullptr);
  }
  if (eng->readers.load(std::memory_order_acquire) != 0) return;
  {
    std::lock_guard<std::mutex> g(eng->peers_mu);
    for (auto &kv : eng->peers) delete kv.second;
    eng->peers.clear();
  }
  {
    std::lock_guard<std::mutex> g(eng->mu);
    for (auto &kv : eng->coll) {
      // noown payloads are posted user buffers (coll recv_into) —
      // never engine-freed
      if (kv.second->msg.data && !kv.second->msg.noown)
        free(kv.second->msg.data);
      delete kv.second;
    }
    eng->coll.clear();
    eng->coll_into.clear();
    eng->into_busy.clear();  // readers drained: no claim can be live
    for (auto &kv : eng->reqs) {
      // an in-place-completed request's payload IS the user buffer
      if (kv.second->msg.data && !kv.second->in_fill)
        free(kv.second->msg.data);
      delete kv.second;
    }
    eng->reqs.clear();
    for (auto &kv : eng->p2p)
      for (auto &q : kv.second.unexpected)
        for (auto &m : q.second)
          if (m.data) free(m.data);
    eng->p2p.clear();
    for (auto &m : eng->py_queue)
      if (m.data) free(m.data);
    eng->py_queue.clear();
    for (auto &kv : eng->order_gates)
      for (auto &pm : kv.second.parked)
        if (pm.second.data) free(pm.second.data);
    eng->order_gates.clear();
  }
  {
    std::lock_guard<std::mutex> g(eng->rndv_mu);
    for (auto &kv : eng->reasm) {
      if (kv.second->buf && !kv.second->fill_user) free(kv.second->buf);
      delete kv.second;
    }
    eng->reasm.clear();
  }
  eng->my_db.destroy(false);
  delete eng;
}

}  // extern "C"
