// Standalone sanity/soak program for the port's engine (csrc/dcn.cc) —
// the target the sanitizer legs of `python -m ompi_tpu_torch check
// --sanitize` build and run, compiled together with dcn.cc under the
// leg's flags into one executable (no libtpudcn.so is loaded).
//
// Deliberately embeds NO Python: ASan/UBSan/TSan reports then point
// at pure dcn.cc behavior instead of CPython internals.  Coverage is
// the transport matrix the Python test suite drives through ctypes:
//
//   * same-host pair  → shm-ring records (eager + chunked)
//   * cross-"host" pair (distinct host ids) → framed tcp, eager and
//     RTS/CTS rendezvous with fragmentation
//   * the coll stream (tdcn_recv_coll slots) and the p2p matcher
//     (tdcn_post_recv/tdcn_req_wait), both directions
//   * concurrent senders on separate threads (the TSan leg's food)
//   * stats read-back and clean close
//
// Exit 0 on success; any check failure prints and exits nonzero.
// Sanitizer reports abort the process on their own (halt_on_error).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// extern "C" surface of the engine (kept in sync with dcn.cc — the
// port's abidrift pass checks these declarations' arity too)
#pragma pack(push, 1)
struct TdcnMsg {
  int32_t kind, src, dst, tag;
  int64_t seq;
  uint64_t pyhandle;
  void *data;
  uint64_t nbytes;
  int64_t count;
  char dtype[16];
  int32_t ndim;
  int64_t shape[8];
  char cid[128];
  void *meta;
  uint32_t meta_len;
};
#pragma pack(pop)

extern "C" {
extern void *tdcn_create(int, int, const char *, int64_t, int64_t,
                         uint64_t, int);
extern const char *tdcn_address(void *);
extern int tdcn_set_addresses(void *, const char *);
extern int tdcn_send(void *, int, int, const char *, int64_t, int, int, int,
                     const char *, int, const int64_t *, const void *, int,
                     const void *, uint64_t);
extern int tdcn_recv_coll(void *, const char *, int64_t, int, int, double,
                          TdcnMsg *);
extern uint64_t tdcn_post_recv(void *, const char *, int, int, int);
extern int tdcn_req_wait(void *, uint64_t, double, TdcnMsg *);
extern int tdcn_stats(void *, uint64_t *, int);
extern const char *tdcn_stats_names(void);
extern int tdcn_waitinfo(void *, char *, int);
extern void tdcn_hang_diag(int);
extern void tdcn_set_ring_timeout(void *, double);
extern void tdcn_set_stream(void *, uint64_t, uint64_t, int);
extern unsigned long long tdcn_chan_open(void *, const char *,
                                         const char *);
extern void tdcn_chan_close(void *, unsigned long long);
extern int64_t tdcn_chan_isend1(void *, unsigned long long, int, int, int,
                                int, const char *, int64_t, const void *,
                                uint64_t, int);
extern int tdcn_send_wait(void *, int64_t, double);
extern uint64_t tdcn_post_recv_into(void *, const char *, int, int, int,
                                    void *, uint64_t);
extern void tdcn_free(void *);
extern void tdcn_close(void *);
extern void tdcn_destroy(void *);
extern uint64_t tdcn_coll_open(void *, const char *, int, int,
                               const char *const *, uint64_t);
extern void tdcn_coll_close(void *, uint64_t);
extern uint64_t tdcn_coll_plan(void *, uint64_t, int, int, int, int64_t,
                               int, int);
extern int tdcn_coll_start(void *, uint64_t, const void *, void *);
extern void tdcn_coll_revoke_cid(void *, const char *);
extern int tdcn_set_address_one(void *, int, const char *, int);
typedef int (*tdcn_resolve_fn)(int, char *, int);
extern void tdcn_set_resolver(void *, tdcn_resolve_fn);
}

enum { FK_COLL = 0, FK_P2P = 1 };

static int g_fail = 0;

#define CHECK(cond, ...)                                      \
  do {                                                        \
    if (!(cond)) {                                            \
      fprintf(stderr, "dcn_sanity FAIL %s:%d: ", __FILE__, __LINE__); \
      fprintf(stderr, __VA_ARGS__);                           \
      fprintf(stderr, "\n");                                  \
      g_fail = 1;                                             \
    }                                                         \
  } while (0)

// (proc, nprocs, host_id, eager_limit, frag_size, ring_bytes,
// max_rndv) — small eager/frag limits so modest payloads exercise the
// chunked and rendezvous paths without large allocations under ASan
static void *create_engine(int proc, int nprocs, const char *host) {
  return tdcn_create(proc, nprocs, host, 4096, 8192, 1u << 20, 4);
}

static void free_msg(TdcnMsg *m) {
  if (m->data) tdcn_free(m->data);
  if (m->meta) tdcn_free(m->meta);
  m->data = m->meta = nullptr;
}

// one direction of p2p traffic: src sends `count` messages of `nbytes`
// to dst_proc; receiver posts+waits and verifies the payload pattern
static void send_burst(void *eng, int dst_proc, int src_rank, int dst_rank,
                       const char *cid, int count, uint64_t nbytes,
                       int tag_base) {
  std::vector<uint8_t> payload(nbytes);
  for (uint64_t i = 0; i < nbytes; i++)
    payload[i] = (uint8_t)(i * 131 + 7);
  int64_t shape[1] = {(int64_t)nbytes};
  for (int i = 0; i < count; i++) {
    int rc = tdcn_send(eng, dst_proc, FK_P2P, cid, 0, src_rank, dst_rank,
                       tag_base + i, "u1", 1, shape, nullptr, 0,
                       payload.data(), nbytes);
    CHECK(rc == 0, "send %d (nbytes=%llu) rc=%d", i,
          (unsigned long long)nbytes, rc);
  }
}

static void recv_burst(void *eng, int self_rank, int from_rank,
                       const char *cid, int count, uint64_t nbytes,
                       int tag_base) {
  for (int i = 0; i < count; i++) {
    uint64_t rid = tdcn_post_recv(eng, cid, self_rank, from_rank,
                                  tag_base + i);
    TdcnMsg m;
    memset(&m, 0, sizeof(m));
    int rc = tdcn_req_wait(eng, rid, 30.0, &m);
    CHECK(rc == 0, "req_wait tag=%d rc=%d", tag_base + i, rc);
    if (rc == 0) {
      CHECK(m.nbytes == nbytes, "nbytes %llu != %llu",
            (unsigned long long)m.nbytes, (unsigned long long)nbytes);
      if (m.data && m.nbytes == nbytes) {
        const uint8_t *p = (const uint8_t *)m.data;
        for (uint64_t k = 0; k < nbytes; k += 997)
          CHECK(p[k] == (uint8_t)(k * 131 + 7),
                "payload corrupt at %llu", (unsigned long long)k);
      }
      free_msg(&m);
    }
  }
}

// drive one engine pair through eager + chunked + rendezvous p2p in
// both directions concurrently, then the coll stream
static void exercise_pair(void *a, void *b, const char *label) {
  const uint64_t sizes[] = {64, 4096 + 32, 65536};  // eager/chunk/rndv
  int tag = 1000;
  for (uint64_t nb : sizes) {
    std::thread t_send_a([&] { send_burst(a, 1, 0, 1, "san", 8, nb, tag); });
    std::thread t_send_b([&] {
      send_burst(b, 0, 1, 0, "san", 8, nb, tag + 500);
    });
    std::thread t_recv_b([&] { recv_burst(b, 1, 0, "san", 8, nb, tag); });
    recv_burst(a, 0, 1, "san", 8, nb, tag + 500);
    t_send_a.join();
    t_send_b.join();
    t_recv_b.join();
    tag += 1000;
  }
  // coll stream: one exchange each way on the slot matcher
  int64_t shape[1] = {8};
  uint8_t cbuf[8] = {1, 2, 3, 4, 5, 6, 7, 8};
  int rc = tdcn_send(a, 1, FK_COLL, "csan", 42, 0, 1, 0, "u1", 1, shape,
                     nullptr, 0, cbuf, sizeof(cbuf));
  CHECK(rc == 0, "%s coll send rc=%d", label, rc);
  TdcnMsg m;
  memset(&m, 0, sizeof(m));
  rc = tdcn_recv_coll(b, "csan", 42, 0, -1, 30.0, &m);
  CHECK(rc == 0, "%s recv_coll rc=%d", label, rc);
  if (rc == 0) {
    CHECK(m.nbytes == sizeof(cbuf), "%s coll nbytes=%llu", label,
          (unsigned long long)m.nbytes);
    free_msg(&m);
  }
  // stats must read back without overrun and stay self-describing
  const char *names = tdcn_stats_names();
  int n = 1;
  for (const char *p = names; *p; p++) n += (*p == ',');
  std::vector<uint64_t> stats((size_t)n + 8, 0);
  int got = tdcn_stats(a, stats.data(), n);
  CHECK(got == n, "%s stats count %d != %d", label, got, n);
  CHECK(stats[0] == 1, "%s stats version %llu", label,
        (unsigned long long)stats[0]);
}

// Streaming send engine soak (the pipelined large-message ring path):
// a windowed burst of mixed-size zero-copy isends from concurrent
// issuer threads, collected via tdcn_send_wait, against a receiver
// that posts buffer-carrying recvs (in-place placement) interleaved
// with plain posts — ordering, reassembly integrity, and the
// sender-thread/doorbell machinery all under the sanitizers.
static void exercise_stream(void *a, void *b) {
  // small chunk + tight inflight cap so modest payloads exercise the
  // pipelined FRAG path, adaptive shrink, and the occupancy gate
  tdcn_set_stream(a, 8192, 1u << 18, 1);
  unsigned long long ch = tdcn_chan_open(a, tdcn_address(b), "str");
  const int N = 12;
  const uint64_t SZ = 96 * 1024;  // > chunk: streams as RTS + FRAGs
  std::vector<std::vector<uint8_t>> bufs(N);
  std::vector<int64_t> sreqs(N, 0);
  // receiver: half the posts carry their buffer (in-place), half take
  // the copy path; posts land BEFORE the sends so placement matches
  std::vector<std::vector<uint8_t>> into(N);
  std::vector<uint64_t> rids(N);
  for (int i = 0; i < N; i++) {
    into[i].assign(SZ, 0);
    rids[i] = (i % 2 == 0)
                  ? tdcn_post_recv_into(b, "str", 1, 0, 3000 + i,
                                        into[i].data(), SZ)
                  : tdcn_post_recv_into(b, "str", 1, 0, 3000 + i,
                                        nullptr, 0);
  }
  // phase A — sequential window: all posts in place before the sends,
  // no competing traffic, so every even post MUST take the in-place
  // path (deterministic: RTS i consumes the gate slot at match time,
  // so RTS i+1 matches even while i's FRAGs are still streaming)
  for (int i = 0; i < N; i++) {
    bufs[i].resize(SZ);
    for (uint64_t k = 0; k < SZ; k++)
      bufs[i][k] = (uint8_t)(k * 31 + i);
    int64_t r = tdcn_chan_isend1(a, ch, FK_P2P, 0, 1, 3000 + i, "u1",
                                 (int64_t)SZ, bufs[i].data(), SZ,
                                 0 /* zero-copy */);
    CHECK(r >= 0, "stream isend %d rc=%lld", i, (long long)r);
    sreqs[i] = r > 0 ? r : 0;
  }
  for (int i = 0; i < N; i++) {
    TdcnMsg m;
    memset(&m, 0, sizeof(m));
    int rc = tdcn_req_wait(b, rids[i], 30.0, &m);
    CHECK(rc == 0, "stream wait %d rc=%d", i, rc);
    if (rc != 0) continue;
    CHECK(m.nbytes == SZ, "stream nbytes %llu",
          (unsigned long long)m.nbytes);
    if (i % 2 == 0)
      CHECK((uint8_t *)m.data == into[i].data(),
            "in-place recv %d did not land in the posted buffer", i);
    const uint8_t *p = (const uint8_t *)m.data;
    for (uint64_t k = 0; k < SZ; k += 509)
      CHECK(p[k] == (uint8_t)(k * 31 + i), "stream payload %d @%llu", i,
            (unsigned long long)k);
    if ((uint8_t *)m.data != into[i].data()) free_msg(&m);
  }
  // collect the zero-copy descriptors (the MPI_Wait leg)
  for (int i = 0; i < N; i++) {
    if (!sreqs[i]) continue;
    int w;
    do {
      w = tdcn_send_wait(a, sreqs[i], 30.0);
    } while (w == 1);
    CHECK(w == 0, "send_wait %d rc=%d", i, w);
  }
  // phase B — concurrency soak: a second issuer interleaves buffered
  // small isends with a zero-copy stream window; ordering may route
  // any message through gate/copy fallbacks, so verify payloads from
  // wherever delivery landed them (the fp_take contract)
  std::thread issue2([&] {
    for (int i = 0; i < 8; i++) {
      uint8_t tiny[64];
      memset(tiny, 0x40 + i, sizeof(tiny));
      int64_t r = tdcn_chan_isend1(a, ch, FK_P2P, 0, 1, 5000 + i, "u1",
                                   64, tiny, 64, 1 /* buffered copy */);
      CHECK(r >= 0, "tiny isend %d rc=%lld", i, (long long)r);
    }
  });
  std::vector<int64_t> sreqs2(N, 0);
  std::vector<uint64_t> rids2(N);
  for (int i = 0; i < N; i++) {
    into[i].assign(SZ, 0);
    rids2[i] = tdcn_post_recv_into(b, "str", 1, 0, 7000 + i,
                                   i % 2 ? nullptr : into[i].data(),
                                   i % 2 ? 0 : SZ);
  }
  for (int i = 0; i < N; i++) {
    int64_t r = tdcn_chan_isend1(a, ch, FK_P2P, 0, 1, 7000 + i, "u1",
                                 (int64_t)SZ, bufs[i].data(), SZ, 0);
    CHECK(r >= 0, "soak isend %d rc=%lld", i, (long long)r);
    sreqs2[i] = r > 0 ? r : 0;
  }
  issue2.join();
  for (int i = 0; i < 8; i++) {
    uint64_t rid = tdcn_post_recv_into(b, "str", 1, 0, 5000 + i,
                                       nullptr, 0);
    TdcnMsg m;
    memset(&m, 0, sizeof(m));
    int rc = tdcn_req_wait(b, rid, 30.0, &m);
    CHECK(rc == 0, "tiny wait %d rc=%d", i, rc);
    if (rc == 0) {
      CHECK(m.nbytes == 64 && ((uint8_t *)m.data)[5] == 0x40 + i,
            "tiny payload %d", i);
      free_msg(&m);
    }
  }
  for (int i = 0; i < N; i++) {
    TdcnMsg m;
    memset(&m, 0, sizeof(m));
    int rc = tdcn_req_wait(b, rids2[i], 30.0, &m);
    CHECK(rc == 0, "soak wait %d rc=%d", i, rc);
    if (rc != 0) continue;
    const uint8_t *p = (const uint8_t *)m.data;
    for (uint64_t k = 0; k < SZ; k += 509)
      CHECK(p[k] == (uint8_t)(k * 31 + i), "soak payload %d @%llu", i,
            (unsigned long long)k);
    if ((uint8_t *)m.data != into[i].data()) free_msg(&m);
  }
  for (int i = 0; i < N; i++) {
    if (!sreqs2[i]) continue;
    int w;
    do {
      w = tdcn_send_wait(a, sreqs2[i], 30.0);
    } while (w == 1);
    CHECK(w == 0, "soak send_wait %d rc=%d", i, w);
  }
  tdcn_chan_close(a, ch);
  // restore defaults for any later section
  tdcn_set_stream(a, 512u << 10, 32u << 20, 1);
}

// C collective fast path (the dispatch-floor leg): both members run
// their compiled schedules concurrently — barrier, linear and ring
// allreduce, rooted reduce/bcast, allgather, plan-cache identity, and
// the persistent replay loop, all under the sanitizers.
static void coll_side(void *eng, uint64_t cx, int me, const char *label) {
  // barrier (kind 0)
  uint64_t pl = tdcn_coll_plan(eng, cx, 0, 0, 7, 0, 0, -1);
  CHECK(pl != 0, "%s coll barrier plan", label);
  CHECK(tdcn_coll_start(eng, pl, nullptr, nullptr) == 0,
        "%s coll barrier", label);

  // small float SUM allreduce (linear fold) + plan-cache identity +
  // persistent-style replay
  enum { N = 33 };
  float x[N], r[N];
  uint64_t pa = tdcn_coll_plan(eng, cx, 3, 1, 13, N, 0, -1);
  CHECK(pa != 0, "%s allreduce plan", label);
  CHECK(tdcn_coll_plan(eng, cx, 3, 1, 13, N, 0, -1) == pa,
        "%s plan cache identity", label);
  for (int round = 0; round < 3; round++) {
    for (int i = 0; i < N; i++) x[i] = (float)(me + 1 + round) + 0.5f * i;
    int rc = tdcn_coll_start(eng, pa, x, r);
    CHECK(rc == 0, "%s allreduce start rc=%d", label, rc);
    for (int i = 0; i < N; i++) {
      float e = ((float)(1 + round) + 0.5f * i) +
                ((float)(2 + round) + 0.5f * i);
      if (r[i] != e) {
        CHECK(0, "%s allreduce round %d value @%d", label, round, i);
        break;
      }
    }
  }

  // ring crossover: 64 KiB of floats over a 32 KiB threshold
  {
    const int64_t BIGN = 16384;
    std::vector<float> bx(BIGN), br(BIGN);
    for (int64_t i = 0; i < BIGN; i++)
      bx[(size_t)i] = (float)(me + 1) + (float)(i & 255);
    uint64_t pb = tdcn_coll_plan(eng, cx, 3, 1, 13, BIGN, 0, -1);
    CHECK(pb != 0, "%s ring allreduce plan", label);
    int rc = tdcn_coll_start(eng, pb, bx.data(), br.data());
    CHECK(rc == 0, "%s ring allreduce rc=%d", label, rc);
    for (int64_t i = 0; i < BIGN; i += 251) {
      float e = (1.0f + (float)(i & 255)) + (2.0f + (float)(i & 255));
      CHECK(br[(size_t)i] == e, "%s ring allreduce @%lld", label,
            (long long)i);
    }
    // a FORCED algorithm (the tuned/reproducible decision) must not be
    // shadowed by the cached crossover-resolved plan: same signature,
    // forced linear → a DISTINCT plan that still computes the same sum
    uint64_t plin = tdcn_coll_plan(eng, cx, 3, 1, 13, BIGN, 0, 0);
    CHECK(plin != 0 && plin != pb, "%s forced-algo plan distinct",
          label);
    rc = tdcn_coll_start(eng, plin, bx.data(), br.data());
    CHECK(rc == 0, "%s forced-linear allreduce rc=%d", label, rc);
    for (int64_t i = 0; i < BIGN; i += 509) {
      float e = (1.0f + (float)(i & 255)) + (2.0f + (float)(i & 255));
      CHECK(br[(size_t)i] == e, "%s forced-linear @%lld", label,
            (long long)i);
    }
  }

  // rooted reduce (double SUM at root 1) and bcast (root 0)
  {
    double dx[3] = {0.5 + me, 1.25 * (me + 1), -2.0 * me};
    double dr[3] = {0, 0, 0};
    uint64_t pr = tdcn_coll_plan(eng, cx, 2, 1, 14, 3, 1, -1);
    CHECK(pr != 0, "%s reduce plan", label);
    CHECK(tdcn_coll_start(eng, pr, dx, dr) == 0, "%s reduce", label);
    if (me == 1)
      CHECK(dr[0] == 2.0 && dr[1] == 3.75 && dr[2] == -2.0,
            "%s reduce values", label);
    int32_t bv[4] = {0, 0, 0, 0};
    if (me == 0)
      for (int i = 0; i < 4; i++) bv[i] = 40 + i;
    uint64_t pc = tdcn_coll_plan(eng, cx, 1, 0, 7, 4, 0, -1);
    CHECK(pc != 0, "%s bcast plan", label);
    CHECK(tdcn_coll_start(eng, pc, bv, bv) == 0, "%s bcast", label);
    CHECK(bv[0] == 40 && bv[3] == 43, "%s bcast values", label);
  }

  // allgather
  {
    int32_t gv[2] = {me * 10, me * 10 + 1};
    int32_t ga[4] = {0, 0, 0, 0};
    uint64_t pg = tdcn_coll_plan(eng, cx, 4, 0, 7, 2, 0, -1);
    CHECK(pg != 0, "%s allgather plan", label);
    CHECK(tdcn_coll_start(eng, pg, gv, ga) == 0, "%s allgather", label);
    CHECK(ga[0] == 0 && ga[1] == 1 && ga[2] == 10 && ga[3] == 11,
          "%s allgather values", label);
  }

  // unsupported signatures must refuse a plan (fallback contract)
  CHECK(tdcn_coll_plan(eng, cx, 3, 5 /* LAND */, 7, 4, 0, -1) == 0,
        "%s LAND must not plan", label);
  CHECK(tdcn_coll_plan(eng, cx, 3, 1, 16 /* bool */, 4, 0, -1) == 0,
        "%s bool must not plan", label);
}

// ULFM revoke wake + replace invalidation on the C coll path, under
// the sanitizers: a schedule receive parked on a peer that never
// answers must wake promptly when the comm is revoked (-6, not the
// ~600 s give-up), a revoked view refuses new starts, and an address
// change (a reborn incarnation's endpoint) evicts the view's
// compiled plans so the repaired comm re-plans.
static void exercise_coll_revoke(void *a, void *b, const char *label) {
  std::string aa = tdcn_address(a), bb = tdcn_address(b);
  const char *addrs[2] = {aa.c_str(), bb.c_str()};
  uint64_t ca = tdcn_coll_open(a, "crev", 0, 2, addrs, 32 * 1024);
  CHECK(ca != 0, "%s revoke coll_open", label);
  if (!ca) return;
  uint64_t pl = tdcn_coll_plan(a, ca, 0, 0, 7, 0, 0, -1);  // barrier
  CHECK(pl != 0, "%s revoke barrier plan", label);
  int rc = -100;
  std::thread park([&] { rc = tdcn_coll_start(a, pl, nullptr, nullptr); });
  struct timespec ts = {0, 300 * 1000000};
  nanosleep(&ts, nullptr);  // let it park (rank 1 never calls)
  // blocked-state introspection smoke: the parked schedule receive
  // must be visible to the mesh doctor while it waits (and the buffer
  // contract — whole rows, NUL-terminated JSON — must hold under the
  // sanitizers)
  {
    char winfo[2048];
    int wn = tdcn_waitinfo(a, winfo, (int)sizeof(winfo));
    CHECK(wn > 2 && winfo[0] == '[' && winfo[wn - 1] == ']',
          "%s waitinfo shape n=%d", label, wn);
    CHECK(wn <= 2 || strstr(winfo, "\"site\":\"coll_recv\"") != nullptr,
          "%s waitinfo missing parked coll wait: %s", label, winfo);
  }
  tdcn_coll_revoke_cid(a, "crev");
  park.join();
  CHECK(rc == -6, "%s revoke wake rc=%d", label, rc);
  CHECK(tdcn_coll_start(a, pl, nullptr, nullptr) == -6,
        "%s revoked view refuses new starts", label);
  tdcn_coll_close(a, ca);

  // invalidation: an address change for a member evicts cached plans
  uint64_t ci = tdcn_coll_open(a, "cinv", 0, 2, addrs, 32 * 1024);
  CHECK(ci != 0, "%s invalidate coll_open", label);
  uint64_t p1 = tdcn_coll_plan(a, ci, 3, 1, 13, 16, 0, -1);
  CHECK(p1 != 0 && tdcn_coll_plan(a, ci, 3, 1, 13, 16, 0, -1) == p1,
        "%s invalidate warm plan", label);
  std::string reborn = bb + "#reborn";
  CHECK(tdcn_set_address_one(a, 1, reborn.c_str(), 0) == 0,
        "%s set_address_one", label);
  uint64_t p2 = tdcn_coll_plan(a, ci, 3, 1, 13, 16, 0, -1);
  CHECK(p2 != 0 && p2 != p1, "%s plan evicted on address change",
        label);
  // restore the real address so later sections keep talking
  CHECK(tdcn_set_address_one(a, 1, bb.c_str(), 0) == 0,
        "%s address restore", label);
  tdcn_coll_close(a, ci);

  // lazy resolver: an empty slot resolves through the callback on
  // first send (the sharded native modex's C half)
  static std::string g_resolved;
  g_resolved = bb;
  tdcn_set_addresses(a, (aa + "\n").c_str());  // hole for proc 1
  tdcn_set_resolver(a, [](int proc, char *out, int cap) -> int {
    if (proc != 1 || (int)g_resolved.size() + 1 > cap) return -1;
    memcpy(out, g_resolved.c_str(), g_resolved.size() + 1);
    return (int)g_resolved.size();
  });
  int32_t payload[4] = {1, 2, 3, 4};
  int64_t shape[1] = {4};
  CHECK(tdcn_send(a, 1, FK_P2P, "9", 0, 0, 1, 5, "<i4", 1, shape,
                  nullptr, 0, payload, sizeof(payload)) == 0,
        "%s lazy-resolved send", label);
  tdcn_set_resolver(a, nullptr);
  // restore the full table for any later section
  tdcn_set_addresses(a, (aa + "\n" + bb).c_str());
}

static void exercise_coll(void *a, void *b, const char *label) {
  std::string aa = tdcn_address(a), bb = tdcn_address(b);
  const char *addrs[2] = {aa.c_str(), bb.c_str()};
  uint64_t ca = tdcn_coll_open(a, "csec", 0, 2, addrs, 32 * 1024);
  uint64_t cb = tdcn_coll_open(b, "csec", 1, 2, addrs, 32 * 1024);
  CHECK(ca != 0 && cb != 0, "%s coll_open", label);
  if (!ca || !cb) return;
  std::thread tb([&] { coll_side(b, cb, 1, label); });
  coll_side(a, ca, 0, label);
  tb.join();
  tdcn_coll_close(a, ca);
  tdcn_coll_close(b, cb);
}

int main() {
  // pair 1: same host id → shared-memory rings
  void *a = create_engine(0, 2, "sanhost");
  void *b = create_engine(1, 2, "sanhost");
  CHECK(a && b, "create shm pair");
  {
    std::string joined = std::string(tdcn_address(a)) + "\n" +
                         tdcn_address(b);
    tdcn_set_addresses(a, joined.c_str());
    tdcn_set_addresses(b, joined.c_str());
  }
  tdcn_set_ring_timeout(a, 30.0);
  tdcn_set_ring_timeout(b, 30.0);
  exercise_pair(a, b, "shm");
  exercise_stream(a, b);
  exercise_coll(a, b, "shm");
  exercise_coll_revoke(a, b, "shm");
  // full teardown (close + reader drain + free) so the ASan leg's
  // leak check sees only REAL lost allocations, not the documented
  // intentional close()-time engine leak
  tdcn_destroy(a);
  tdcn_destroy(b);

  // pair 2: distinct host ids → framed tcp (eager + RTS/CTS rndv)
  void *c = create_engine(0, 2, "sanhostA");
  void *d = create_engine(1, 2, "sanhostB");
  CHECK(c && d, "create tcp pair");
  {
    std::string joined = std::string(tdcn_address(c)) + "\n" +
                         tdcn_address(d);
    tdcn_set_addresses(c, joined.c_str());
    tdcn_set_addresses(d, joined.c_str());
  }
  exercise_pair(c, d, "tcp");
  exercise_coll(c, d, "tcp");
  exercise_coll_revoke(c, d, "tcp");
  tdcn_destroy(c);
  tdcn_destroy(d);

  if (g_fail) {
    fprintf(stderr, "dcn_sanity: FAILED\n");
    return 1;
  }
  printf("dcn_sanity: OK\n");
  return 0;
}
