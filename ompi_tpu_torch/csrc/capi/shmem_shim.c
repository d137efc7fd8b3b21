/* libtpushmem — OpenSHMEM 1.4 surface + 1.5 teams/contexts/signals
 * over the port's MPI C ABI (ompi_tpu_torch's libtpumpi).
 *
 * Port of the reference's native/src/shmem_shim.c, built by
 * ompi_tpu_torch/native.py (build_shmem) against csrc/capi/include.
 *
 * ≈ Open MPI's oshmem layering (SURVEY.md §2.5: liboshmem's
 * spml/scoll/atomic/memheap components delegate to ompi's pml, coll
 * and osc): every entry point here is a thin mapping onto libtpumpi —
 *
 *   memheap  → one malloc'd symmetric region per PE, exposed as a
 *              byte MPI window (disp_unit 1) under passive
 *              MPI_Win_lock_all for the whole run; SPMD lockstep
 *              bump allocation keeps offsets symmetric (the memheap
 *              contract);
 *   spml     → shmem_put/get = MPI_Put/MPI_Get at (addr - heap_base),
 *              quiet/fence = MPI_Win_flush_all; _nbi forms skip the
 *              per-op flush (completion deferred to shmem_quiet);
 *   atomic   → MPI_Fetch_and_op / MPI_Compare_and_swap (standard,
 *              bitwise and extended-float AMO families);
 *   scoll    → broadcast/collect/reductions/alltoall = MPI
 *              collectives over a communicator derived from the
 *              active set or team (MPI_Comm_create_group over the
 *              member ranks — only members participate, exactly the
 *              OpenSHMEM collective-participation contract);
 *   teams    → (start, stride, size) descriptors + a real
 *              communicator per team, so team collectives and
 *              shmem_team_sync are first-class;
 *   lock     → shmem_set_lock/test_lock/clear_lock via remote CAS on
 *              the PE-0 copy of the symmetric lock word;
 *   ctx      → contexts share the single heap window: every ctx op
 *              is remote-complete at return, so per-ctx quiet/fence
 *              are satisfied a fortiori (stronger ordering than the
 *              spec requires, never weaker).
 *
 * The wide type x op matrix is macro-generated from X-macro lists the
 * same way Open MPI's oshmem/shmem/c sources are generated.
 * PE numbering = MPI_COMM_WORLD rank.  longdouble variants are the
 * one omitted family (no MPI_LONG_DOUBLE in the host ABI).
 */
#include <complex.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <time.h>

#include "mpi.h"
#include "shmem.h"

static MPI_Win g_win = (MPI_Win)-1;
static unsigned char *g_heap = NULL;
static size_t g_heap_size = 0;
static size_t g_brk = 0;       /* bump pointer (symmetric by SPMD) */
static int g_pe = -1, g_npes = 0;
static int g_inited = 0;

#define HEAP_ALIGN 16

static void die(const char *msg) {
  fprintf(stderr, "tpushmem: %s\n", msg);
  MPI_Abort(MPI_COMM_WORLD, 13);
}

static size_t heap_off(const void *p, const char *who) {
  if (!g_inited) die("call before shmem_init");
  if ((const unsigned char *)p < g_heap ||
      (const unsigned char *)p >= g_heap + g_heap_size) {
    fprintf(stderr, "tpushmem: %s: address %p outside the symmetric "
                    "heap\n", who, p);
    MPI_Abort(MPI_COMM_WORLD, 13);
  }
  return (size_t)((const unsigned char *)p - g_heap);
}

void shmem_init(void) {
  if (g_inited) return;
  int flag = 0;
  MPI_Initialized(&flag);
  if (!flag) MPI_Init(NULL, NULL);
  MPI_Comm_rank(MPI_COMM_WORLD, &g_pe);
  MPI_Comm_size(MPI_COMM_WORLD, &g_npes);
  const char *sz = getenv("SHMEM_SYMMETRIC_SIZE");
  g_heap_size = sz ? (size_t)strtoull(sz, NULL, 10) : (size_t)(64 << 20);
  if (g_heap_size < (1 << 16)) g_heap_size = 1 << 16;
  g_heap = (unsigned char *)calloc(1, g_heap_size);
  if (!g_heap) die("symmetric heap allocation failed");
  if (MPI_Win_create(g_heap, (MPI_Aint)g_heap_size, 1, MPI_INFO_NULL,
                     MPI_COMM_WORLD, &g_win) != MPI_SUCCESS)
    die("symmetric-heap window creation failed");
  /* passive exposure for the whole run: OpenSHMEM has no epochs */
  MPI_Win_lock_all(0, g_win);
  g_brk = 0;
  g_inited = 1;
  MPI_Barrier(MPI_COMM_WORLD);
}

int shmem_init_thread(int requested, int *provided) {
  shmem_init();
  if (provided) *provided = SHMEM_THREAD_SINGLE >= requested
                                ? requested
                                : SHMEM_THREAD_SINGLE;
  return 0;
}

void shmem_query_thread(int *provided) {
  if (provided) *provided = SHMEM_THREAD_SINGLE;
}

void shmem_finalize(void) {
  if (!g_inited) return;
  MPI_Win_flush_all(g_win);
  MPI_Barrier(MPI_COMM_WORLD);
  MPI_Win_unlock_all(g_win);
  MPI_Win_free(&g_win);
  free(g_heap);
  g_heap = NULL;
  g_inited = 0;
  int fin = 0;
  MPI_Finalized(&fin);
  if (!fin) MPI_Finalize();
}

int shmem_my_pe(void) { return g_pe; }
int shmem_n_pes(void) { return g_npes; }
int _my_pe(void) { return g_pe; }
int _num_pes(void) { return g_npes; }

void start_pes(int npes) {
  (void)npes;
  shmem_init();
}

void shmem_info_get_version(int *major, int *minor) {
  if (major) *major = SHMEM_MAJOR_VERSION;
  if (minor) *minor = SHMEM_MINOR_VERSION;
}

void shmem_info_get_name(char *name) {
  if (name) snprintf(name, SHMEM_MAX_NAME_LEN, "%s", SHMEM_VENDOR_STRING);
}

int shmem_pe_accessible(int pe) { return pe >= 0 && pe < g_npes; }

int shmem_addr_accessible(const void *addr, int pe) {
  return shmem_pe_accessible(pe) &&
         (const unsigned char *)addr >= g_heap &&
         (const unsigned char *)addr < g_heap + g_heap_size;
}

void shmem_global_exit(int status) { MPI_Abort(MPI_COMM_WORLD, status); }

/* ---- memheap ------------------------------------------------------- */

/* SPMD lockstep bump: every PE performs the same allocation sequence,
 * so the bump pointer (and thus every offset) stays symmetric — the
 * memheap invariant.  Callers add the one collective barrier AFTER any
 * local initialization, so the barrier-on-return contract covers the
 * initialized state (a peer's post-allocation put must never race a
 * local memset). */
static void *heap_alloc_nobarrier(size_t alignment, size_t size) {
  if (!g_inited) die("shmem_malloc before shmem_init");
  if (alignment < HEAP_ALIGN) alignment = HEAP_ALIGN;
  size_t off = (g_brk + alignment - 1) / alignment * alignment;
  if (off + size > g_heap_size) die("symmetric heap exhausted "
                                    "(set SHMEM_SYMMETRIC_SIZE)");
  g_brk = off + size;
  return g_heap + off;
}

void *shmem_align(size_t alignment, size_t size) {
  void *p = heap_alloc_nobarrier(alignment, size);
  shmem_barrier_all();
  return p;
}

void *shmem_malloc(size_t size) { return shmem_align(HEAP_ALIGN, size); }

void *shmem_calloc(size_t count, size_t size) {
  void *p = heap_alloc_nobarrier(HEAP_ALIGN, count * size);
  memset(p, 0, count * size);
  shmem_barrier_all();
  return p;
}

void shmem_free(void *ptr) {
  /* bump allocator: individual frees are a no-op (valid OpenSHMEM
   * behavior for a region allocator); the heap dies at finalize */
  if (ptr) heap_off(ptr, "shmem_free");
  shmem_barrier_all();  /* shmem_free is collective per the spec */
}

void *shmem_realloc(void *ptr, size_t size) {
  void *p = shmem_malloc(size);
  if (ptr) {
    size_t old_off = heap_off(ptr, "shmem_realloc");
    size_t avail = g_heap_size - old_off;
    memcpy(p, ptr, size < avail ? size : avail);
  }
  return p;
}

void *shmem_malloc_with_hints(size_t size, long hints) {
  (void)hints; /* all heap memory has identical properties here */
  return shmem_malloc(size);
}

/* test hook: current symmetric-heap bump offset (symmetry pinning) */
size_t tpushmem_brk(void) { return g_brk; }

void *shmem_ptr(const void *dest, int pe) {
  /* cross-process load/store sharing is not provided (separate
   * address spaces); own-PE pointers resolve directly */
  return pe == g_pe ? (void *)dest : NULL;
}

/* ---- ordering ------------------------------------------------------ */

void shmem_quiet(void) {
  if (g_inited) MPI_Win_flush_all(g_win);
}

void shmem_fence(void) { shmem_quiet(); }

void shmem_barrier_all(void) {
  shmem_quiet();
  MPI_Barrier(MPI_COMM_WORLD);
}

void shmem_sync_all(void) { MPI_Barrier(MPI_COMM_WORLD); }

/* ---- contexts (1.5) -------------------------------------------------
 * All contexts share the single symmetric-heap window and every op is
 * remote-complete at return, so shmem_ctx_quiet/fence hold a fortiori
 * for any context (stronger than required, never weaker).  Context
 * handles are real allocations so create/destroy pairing bugs in user
 * code still surface under leak checkers. */

int shmem_ctx_create(long options, shmem_ctx_t *ctx) {
  (void)options; /* SERIALIZED/PRIVATE/NOSTORE are relaxations */
  if (!ctx) return -1;
  *ctx = (shmem_ctx_t)malloc(8);
  return *ctx ? 0 : -1;
}

void shmem_ctx_destroy(shmem_ctx_t ctx) {
  if (ctx != SHMEM_CTX_DEFAULT && ctx != SHMEM_CTX_INVALID) free(ctx);
}

void shmem_ctx_quiet(shmem_ctx_t ctx) {
  (void)ctx;
  shmem_quiet();
}

void shmem_ctx_fence(shmem_ctx_t ctx) {
  (void)ctx;
  shmem_quiet();
}

int shmem_team_create_ctx(shmem_team_t team, long options,
                          shmem_ctx_t *ctx) {
  (void)team;
  return shmem_ctx_create(options, ctx);
}

int shmem_ctx_get_team(shmem_ctx_t ctx, shmem_team_t *team) {
  (void)ctx;
  if (team) *team = SHMEM_TEAM_WORLD;
  return 0;
}

/* ---- RMA ----------------------------------------------------------- */

static void put_bytes(void *dest, const void *source, size_t nbytes,
                      int pe) {
  size_t off = heap_off(dest, "shmem_put");
  if (!nbytes) return;
  MPI_Put(source, (int)nbytes, MPI_BYTE, pe, (MPI_Aint)off, (int)nbytes,
          MPI_BYTE, g_win);
  /* spml/ucx completes puts at return for small payloads; we keep the
   * stronger contract: remote completion at return (flush per op) —
   * quiet/fence then cost nothing extra */
  MPI_Win_flush(pe, g_win);
}

static void get_bytes(void *dest, const void *source, size_t nbytes,
                      int pe) {
  size_t off = heap_off((void *)source, "shmem_get");
  if (!nbytes) return;
  MPI_Get(dest, (int)nbytes, MPI_BYTE, pe, (MPI_Aint)off, (int)nbytes,
          MPI_BYTE, g_win);
  MPI_Win_flush(pe, g_win);
}

/* non-blocking: queue the transfer, complete at shmem_quiet */
static void put_bytes_nbi(void *dest, const void *source, size_t nbytes,
                          int pe) {
  size_t off = heap_off(dest, "shmem_put_nbi");
  if (!nbytes) return;
  MPI_Put(source, (int)nbytes, MPI_BYTE, pe, (MPI_Aint)off, (int)nbytes,
          MPI_BYTE, g_win);
}

static void get_bytes_nbi(void *dest, const void *source, size_t nbytes,
                          int pe) {
  size_t off = heap_off((void *)source, "shmem_get_nbi");
  if (!nbytes) return;
  MPI_Get(dest, (int)nbytes, MPI_BYTE, pe, (MPI_Aint)off, (int)nbytes,
          MPI_BYTE, g_win);
}

void shmem_putmem(void *d, const void *s, size_t n, int pe) {
  put_bytes(d, s, n, pe);
}
void shmem_getmem(void *d, const void *s, size_t n, int pe) {
  get_bytes(d, s, n, pe);
}
void shmem_putmem_nbi(void *d, const void *s, size_t n, int pe) {
  put_bytes_nbi(d, s, n, pe);
}
void shmem_getmem_nbi(void *d, const void *s, size_t n, int pe) {
  get_bytes_nbi(d, s, n, pe);
}
void shmem_ctx_putmem(shmem_ctx_t c, void *d, const void *s, size_t n,
                      int pe) {
  (void)c;
  put_bytes(d, s, n, pe);
}
void shmem_ctx_getmem(shmem_ctx_t c, void *d, const void *s, size_t n,
                      int pe) {
  (void)c;
  get_bytes(d, s, n, pe);
}
void shmem_ctx_putmem_nbi(shmem_ctx_t c, void *d, const void *s, size_t n,
                          int pe) {
  (void)c;
  put_bytes_nbi(d, s, n, pe);
}
void shmem_ctx_getmem_nbi(shmem_ctx_t c, void *d, const void *s, size_t n,
                          int pe) {
  (void)c;
  get_bytes_nbi(d, s, n, pe);
}

/* the standard RMA type table (OpenSHMEM 1.5 Table 5, minus
 * longdouble: no MPI_LONG_DOUBLE in the host ABI) */
#define SHMEM_RMA_TYPES(X)                                                \
  X(char, char, MPI_CHAR)                                                 \
  X(schar, signed char, MPI_SIGNED_CHAR)                                  \
  X(short, short, MPI_SHORT)                                              \
  X(int, int, MPI_INT)                                                    \
  X(long, long, MPI_LONG)                                                 \
  X(longlong, long long, MPI_LONG_LONG)                                   \
  X(uchar, unsigned char, MPI_UNSIGNED_CHAR)                              \
  X(ushort, unsigned short, MPI_UNSIGNED_SHORT)                           \
  X(uint, unsigned int, MPI_UNSIGNED)                                     \
  X(ulong, unsigned long, MPI_UNSIGNED_LONG)                              \
  X(ulonglong, unsigned long long, MPI_UNSIGNED_LONG_LONG)                \
  X(float, float, MPI_FLOAT)                                              \
  X(double, double, MPI_DOUBLE)                                           \
  X(int8, int8_t, MPI_INT8_T)                                             \
  X(int16, int16_t, MPI_INT16_T)                                          \
  X(int32, int32_t, MPI_INT32_T)                                          \
  X(int64, int64_t, MPI_INT64_T)                                          \
  X(uint8, uint8_t, MPI_UINT8_T)                                          \
  X(uint16, uint16_t, MPI_UINT16_T)                                       \
  X(uint32, uint32_t, MPI_UINT32_T)                                       \
  X(uint64, uint64_t, MPI_UINT64_T)                                       \
  X(size, size_t, MPI_UINT64_T)                                           \
  X(ptrdiff, ptrdiff_t, MPI_INT64_T)

#define GEN_PUTGET(NAME, T, MPIT)                                         \
  void shmem_##NAME##_put(T *d, const T *s, size_t n, int pe) {           \
    put_bytes(d, s, n * sizeof(T), pe);                                   \
  }                                                                       \
  void shmem_##NAME##_get(T *d, const T *s, size_t n, int pe) {           \
    get_bytes(d, (const void *)s, n * sizeof(T), pe);                     \
  }                                                                       \
  void shmem_##NAME##_put_nbi(T *d, const T *s, size_t n, int pe) {       \
    put_bytes_nbi(d, s, n * sizeof(T), pe);                               \
  }                                                                       \
  void shmem_##NAME##_get_nbi(T *d, const T *s, size_t n, int pe) {       \
    get_bytes_nbi(d, (const void *)s, n * sizeof(T), pe);                 \
  }                                                                       \
  void shmem_##NAME##_p(T *d, T v, int pe) {                              \
    put_bytes(d, &v, sizeof(T), pe);                                      \
  }                                                                       \
  T shmem_##NAME##_g(const T *s, int pe) {                                \
    T v;                                                                  \
    get_bytes(&v, s, sizeof(T), pe);                                      \
    return v;                                                             \
  }                                                                       \
  void shmem_##NAME##_iput(T *d, const T *s, ptrdiff_t dst,               \
                           ptrdiff_t sst, size_t n, int pe) {             \
    size_t off = heap_off(d, "shmem_iput");                               \
    for (size_t i = 0; i < n; i++)                                        \
      MPI_Put(s + i * sst, (int)sizeof(T), MPI_BYTE, pe,                  \
              (MPI_Aint)(off + (size_t)(i * dst) * sizeof(T)),            \
              (int)sizeof(T), MPI_BYTE, g_win);                           \
    if (n) MPI_Win_flush(pe, g_win);                                      \
  }                                                                       \
  void shmem_##NAME##_iget(T *d, const T *s, ptrdiff_t dst,               \
                           ptrdiff_t sst, size_t n, int pe) {             \
    size_t off = heap_off((const void *)s, "shmem_iget");                 \
    for (size_t i = 0; i < n; i++)                                        \
      MPI_Get(d + i * dst, (int)sizeof(T), MPI_BYTE, pe,                  \
              (MPI_Aint)(off + (size_t)(i * sst) * sizeof(T)),            \
              (int)sizeof(T), MPI_BYTE, g_win);                           \
    if (n) MPI_Win_flush(pe, g_win);                                      \
  }                                                                       \
  void shmem_ctx_##NAME##_put(shmem_ctx_t c, T *d, const T *s, size_t n,  \
                              int pe) {                                   \
    (void)c;                                                              \
    put_bytes(d, s, n * sizeof(T), pe);                                   \
  }                                                                       \
  void shmem_ctx_##NAME##_get(shmem_ctx_t c, T *d, const T *s, size_t n,  \
                              int pe) {                                   \
    (void)c;                                                              \
    get_bytes(d, (const void *)s, n * sizeof(T), pe);                     \
  }                                                                       \
  void shmem_ctx_##NAME##_put_nbi(shmem_ctx_t c, T *d, const T *s,        \
                                  size_t n, int pe) {                     \
    (void)c;                                                              \
    put_bytes_nbi(d, s, n * sizeof(T), pe);                               \
  }                                                                       \
  void shmem_ctx_##NAME##_get_nbi(shmem_ctx_t c, T *d, const T *s,        \
                                  size_t n, int pe) {                     \
    (void)c;                                                              \
    get_bytes_nbi(d, (const void *)s, n * sizeof(T), pe);                 \
  }                                                                       \
  void shmem_ctx_##NAME##_p(shmem_ctx_t c, T *d, T v, int pe) {           \
    (void)c;                                                              \
    put_bytes(d, &v, sizeof(T), pe);                                      \
  }                                                                       \
  T shmem_ctx_##NAME##_g(shmem_ctx_t c, const T *s, int pe) {             \
    (void)c;                                                              \
    T v;                                                                  \
    get_bytes(&v, s, sizeof(T), pe);                                      \
    return v;                                                             \
  }

SHMEM_RMA_TYPES(GEN_PUTGET)

/* sized (bit-width) forms */
#define GEN_SIZED(BITS, BYTES)                                            \
  void shmem_put##BITS(void *d, const void *s, size_t n, int pe) {        \
    put_bytes(d, s, n * (BYTES), pe);                                     \
  }                                                                       \
  void shmem_get##BITS(void *d, const void *s, size_t n, int pe) {        \
    get_bytes(d, s, n * (BYTES), pe);                                     \
  }                                                                       \
  void shmem_put##BITS##_nbi(void *d, const void *s, size_t n, int pe) {  \
    put_bytes_nbi(d, s, n * (BYTES), pe);                                 \
  }                                                                       \
  void shmem_get##BITS##_nbi(void *d, const void *s, size_t n, int pe) {  \
    get_bytes_nbi(d, s, n * (BYTES), pe);                                 \
  }                                                                       \
  void shmem_iput##BITS(void *d, const void *s, ptrdiff_t dst,            \
                        ptrdiff_t sst, size_t n, int pe) {                \
    size_t off = heap_off(d, "shmem_iput" #BITS);                         \
    for (size_t i = 0; i < n; i++)                                        \
      MPI_Put((const unsigned char *)s + (size_t)(i * sst) * (BYTES),     \
              (int)(BYTES), MPI_BYTE, pe,                                 \
              (MPI_Aint)(off + (size_t)(i * dst) * (BYTES)),              \
              (int)(BYTES), MPI_BYTE, g_win);                             \
    if (n) MPI_Win_flush(pe, g_win);                                      \
  }                                                                       \
  void shmem_iget##BITS(void *d, const void *s, ptrdiff_t dst,            \
                        ptrdiff_t sst, size_t n, int pe) {                \
    size_t off = heap_off(s, "shmem_iget" #BITS);                         \
    for (size_t i = 0; i < n; i++)                                        \
      MPI_Get((unsigned char *)d + (size_t)(i * dst) * (BYTES),           \
              (int)(BYTES), MPI_BYTE, pe,                                 \
              (MPI_Aint)(off + (size_t)(i * sst) * (BYTES)),              \
              (int)(BYTES), MPI_BYTE, g_win);                             \
    if (n) MPI_Win_flush(pe, g_win);                                      \
  }

GEN_SIZED(8, 1)
GEN_SIZED(16, 2)
GEN_SIZED(32, 4)
GEN_SIZED(64, 8)
GEN_SIZED(128, 16)

/* ---- atomics ------------------------------------------------------- */

/* standard AMO types (1.5 Table 6) */
#define SHMEM_AMO_TYPES(X)                                                \
  X(int, int, MPI_INT)                                                    \
  X(long, long, MPI_LONG)                                                 \
  X(longlong, long long, MPI_LONG_LONG)                                   \
  X(uint, unsigned int, MPI_UNSIGNED)                                     \
  X(ulong, unsigned long, MPI_UNSIGNED_LONG)                              \
  X(ulonglong, unsigned long long, MPI_UNSIGNED_LONG_LONG)                \
  X(int32, int32_t, MPI_INT32_T)                                          \
  X(int64, int64_t, MPI_INT64_T)                                          \
  X(uint32, uint32_t, MPI_UINT32_T)                                       \
  X(uint64, uint64_t, MPI_UINT64_T)                                       \
  X(size, size_t, MPI_UINT64_T)                                           \
  X(ptrdiff, ptrdiff_t, MPI_INT64_T)

/* bitwise AMO types (1.5 Table 7) */
#define SHMEM_BITWISE_TYPES(X)                                            \
  X(uint, unsigned int, MPI_UNSIGNED)                                     \
  X(ulong, unsigned long, MPI_UNSIGNED_LONG)                              \
  X(ulonglong, unsigned long long, MPI_UNSIGNED_LONG_LONG)                \
  X(int32, int32_t, MPI_INT32_T)                                          \
  X(int64, int64_t, MPI_INT64_T)                                          \
  X(uint32, uint32_t, MPI_UINT32_T)                                       \
  X(uint64, uint64_t, MPI_UINT64_T)

static void amo_fop(const void *val, void *old, MPI_Datatype t, int pe,
                    const void *dest, MPI_Op op, const char *who) {
  size_t off = heap_off(dest, who);
  MPI_Fetch_and_op(val, old, t, pe, (MPI_Aint)off, op, g_win);
  MPI_Win_flush(pe, g_win);
}

#define GEN_AMO(NAME, T, MPIT)                                            \
  T shmem_##NAME##_atomic_fetch_add(T *dest, T value, int pe) {           \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_SUM, "atomic");             \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_add(T *dest, T value, int pe) {              \
    (void)shmem_##NAME##_atomic_fetch_add(dest, value, pe);               \
  }                                                                       \
  T shmem_##NAME##_atomic_fetch_inc(T *dest, int pe) {                    \
    return shmem_##NAME##_atomic_fetch_add(dest, (T)1, pe);               \
  }                                                                       \
  void shmem_##NAME##_atomic_inc(T *dest, int pe) {                       \
    (void)shmem_##NAME##_atomic_fetch_add(dest, (T)1, pe);                \
  }                                                                       \
  T shmem_##NAME##_atomic_swap(T *dest, T value, int pe) {                \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_REPLACE, "atomic");         \
    return old;                                                           \
  }                                                                       \
  T shmem_##NAME##_atomic_compare_swap(T *dest, T cond, T value,          \
                                       int pe) {                          \
    size_t off = heap_off(dest, "atomic");                                \
    T old;                                                                \
    MPI_Compare_and_swap(&value, &cond, &old, MPIT, pe, (MPI_Aint)off,    \
                         g_win);                                          \
    MPI_Win_flush(pe, g_win);                                             \
    return old;                                                           \
  }                                                                       \
  T shmem_##NAME##_atomic_fetch(const T *source, int pe) {                \
    T old, dummy = 0;                                                     \
    amo_fop(&dummy, &old, MPIT, pe, source, MPI_NO_OP, "atomic");         \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_set(T *dest, T value, int pe) {              \
    (void)shmem_##NAME##_atomic_swap(dest, value, pe);                    \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch_add(shmem_ctx_t c, T *dest, T value,  \
                                        int pe) {                         \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch_add(dest, value, pe);              \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_add(shmem_ctx_t c, T *dest, T value,     \
                                     int pe) {                            \
    (void)c;                                                              \
    shmem_##NAME##_atomic_add(dest, value, pe);                           \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_swap(shmem_ctx_t c, T *dest, T value,       \
                                   int pe) {                              \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_swap(dest, value, pe);                   \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_compare_swap(shmem_ctx_t c, T *dest,        \
                                           T cond, T value, int pe) {     \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_compare_swap(dest, cond, value, pe);     \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch(shmem_ctx_t c, const T *source,       \
                                    int pe) {                             \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch(source, pe);                       \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_set(shmem_ctx_t c, T *dest, T value,     \
                                     int pe) {                            \
    (void)c;                                                              \
    shmem_##NAME##_atomic_set(dest, value, pe);                           \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch_inc(shmem_ctx_t c, T *dest, int pe) { \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch_inc(dest, pe);                     \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_inc(shmem_ctx_t c, T *dest, int pe) {    \
    (void)c;                                                              \
    shmem_##NAME##_atomic_inc(dest, pe);                                  \
  }

SHMEM_AMO_TYPES(GEN_AMO)

/* extended AMOs: float/double fetch/set/swap (1.5 Table 8) */
#define GEN_AMO_EXT(NAME, T, MPIT)                                        \
  T shmem_##NAME##_atomic_fetch(const T *source, int pe) {                \
    T old, dummy = 0;                                                     \
    amo_fop(&dummy, &old, MPIT, pe, source, MPI_NO_OP, "atomic");         \
    return old;                                                           \
  }                                                                       \
  T shmem_##NAME##_atomic_swap(T *dest, T value, int pe) {                \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_REPLACE, "atomic");         \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_set(T *dest, T value, int pe) {              \
    (void)shmem_##NAME##_atomic_swap(dest, value, pe);                    \
  }

GEN_AMO_EXT(float, float, MPI_FLOAT)
GEN_AMO_EXT(double, double, MPI_DOUBLE)

/* bitwise AMOs */
#define GEN_AMO_BITWISE(NAME, T, MPIT)                                    \
  T shmem_##NAME##_atomic_fetch_and(T *dest, T value, int pe) {           \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_BAND, "atomic_and");        \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_and(T *dest, T value, int pe) {              \
    (void)shmem_##NAME##_atomic_fetch_and(dest, value, pe);               \
  }                                                                       \
  T shmem_##NAME##_atomic_fetch_or(T *dest, T value, int pe) {            \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_BOR, "atomic_or");          \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_or(T *dest, T value, int pe) {               \
    (void)shmem_##NAME##_atomic_fetch_or(dest, value, pe);                \
  }                                                                       \
  T shmem_##NAME##_atomic_fetch_xor(T *dest, T value, int pe) {           \
    T old;                                                                \
    amo_fop(&value, &old, MPIT, pe, dest, MPI_BXOR, "atomic_xor");        \
    return old;                                                           \
  }                                                                       \
  void shmem_##NAME##_atomic_xor(T *dest, T value, int pe) {              \
    (void)shmem_##NAME##_atomic_fetch_xor(dest, value, pe);               \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch_and(shmem_ctx_t c, T *dest, T value,  \
                                        int pe) {                         \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch_and(dest, value, pe);              \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_and(shmem_ctx_t c, T *dest, T value,     \
                                     int pe) {                            \
    (void)c;                                                              \
    shmem_##NAME##_atomic_and(dest, value, pe);                           \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch_or(shmem_ctx_t c, T *dest, T value,   \
                                       int pe) {                          \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch_or(dest, value, pe);               \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_or(shmem_ctx_t c, T *dest, T value,      \
                                    int pe) {                             \
    (void)c;                                                              \
    shmem_##NAME##_atomic_or(dest, value, pe);                            \
  }                                                                       \
  T shmem_ctx_##NAME##_atomic_fetch_xor(shmem_ctx_t c, T *dest, T value,  \
                                        int pe) {                         \
    (void)c;                                                              \
    return shmem_##NAME##_atomic_fetch_xor(dest, value, pe);              \
  }                                                                       \
  void shmem_ctx_##NAME##_atomic_xor(shmem_ctx_t c, T *dest, T value,     \
                                     int pe) {                            \
    (void)c;                                                              \
    shmem_##NAME##_atomic_xor(dest, value, pe);                           \
  }

SHMEM_BITWISE_TYPES(GEN_AMO_BITWISE)

/* deprecated pre-1.4 names map onto the 1.4 atomics */
int shmem_int_fadd(int *d, int v, int pe) {
  return shmem_int_atomic_fetch_add(d, v, pe);
}
int shmem_int_finc(int *d, int pe) {
  return shmem_int_atomic_fetch_inc(d, pe);
}
int shmem_int_cswap(int *d, int c, int v, int pe) {
  return shmem_int_atomic_compare_swap(d, c, v, pe);
}
int shmem_int_swap(int *d, int v, int pe) {
  return shmem_int_atomic_swap(d, v, pe);
}
long shmem_long_fadd(long *d, long v, int pe) {
  return shmem_long_atomic_fetch_add(d, v, pe);
}
long shmem_long_finc(long *d, int pe) {
  return shmem_long_atomic_fetch_inc(d, pe);
}
long shmem_long_cswap(long *d, long c, long v, int pe) {
  return shmem_long_atomic_compare_swap(d, c, v, pe);
}
long shmem_long_swap(long *d, long v, int pe) {
  return shmem_long_atomic_swap(d, v, pe);
}
long long shmem_longlong_fadd(long long *d, long long v, int pe) {
  return shmem_longlong_atomic_fetch_add(d, v, pe);
}
long long shmem_longlong_finc(long long *d, int pe) {
  return shmem_longlong_atomic_fetch_inc(d, pe);
}
float shmem_float_swap(float *d, float v, int pe) {
  return shmem_float_atomic_swap(d, v, pe);
}
double shmem_double_swap(double *d, double v, int pe) {
  return shmem_double_atomic_swap(d, v, pe);
}

/* ---- point synchronization ----------------------------------------- */

/* comparisons run in the ivar's NATIVE type (an unsigned 64-bit value
 * >= 2^63 must not flip sign under a signed cast) */
#define CMP_OK(cur, cmp, value, out)                                      \
  do {                                                                    \
    switch (cmp) {                                                        \
      case SHMEM_CMP_EQ: (out) = (cur) == (value); break;                 \
      case SHMEM_CMP_NE: (out) = (cur) != (value); break;                 \
      case SHMEM_CMP_GT: (out) = (cur) > (value); break;                  \
      case SHMEM_CMP_LE: (out) = (cur) <= (value); break;                 \
      case SHMEM_CMP_LT: (out) = (cur) < (value); break;                  \
      case SHMEM_CMP_GE: (out) = (cur) >= (value); break;                 \
      default: die("bad shmem comparator"); (out) = 0;                    \
    }                                                                     \
  } while (0)

static void sync_backoff(void) {
  struct timespec ts = {0, 200000};
  nanosleep(&ts, NULL);
}

/* The progress rule: an atomic fetch of our OWN cell routes through
 * the osc engine, which also applies queued inbound ops (the spml
 * progress role) — so every poll below fetches via the engine. */
#define GEN_SYNC(NAME, T, MPIT)                                           \
  int shmem_##NAME##_test(T *ivar, int cmp, T value) {                    \
    heap_off(ivar, "test");                                               \
    T cur = shmem_##NAME##_atomic_fetch(ivar, g_pe);                      \
    int ok;                                                               \
    CMP_OK(cur, cmp, value, ok);                                          \
    return ok;                                                            \
  }                                                                       \
  void shmem_##NAME##_wait_until(T *ivar, int cmp, T value) {             \
    heap_off(ivar, "wait_until");                                         \
    while (!shmem_##NAME##_test(ivar, cmp, value)) sync_backoff();        \
  }                                                                       \
  int shmem_##NAME##_test_all(T *ivars, size_t n, const int *status,      \
                              int cmp, T value) {                         \
    for (size_t i = 0; i < n; i++) {                                      \
      if (status && status[i]) continue;                                  \
      if (!shmem_##NAME##_test(&ivars[i], cmp, value)) return 0;          \
    }                                                                     \
    return 1;                                                             \
  }                                                                       \
  size_t shmem_##NAME##_test_any(T *ivars, size_t n, const int *status,   \
                                 int cmp, T value) {                      \
    for (size_t i = 0; i < n; i++) {                                      \
      if (status && status[i]) continue;                                  \
      if (shmem_##NAME##_test(&ivars[i], cmp, value)) return i;           \
    }                                                                     \
    return (size_t)-1;                                                    \
  }                                                                       \
  size_t shmem_##NAME##_test_some(T *ivars, size_t n, size_t *indices,    \
                                  const int *status, int cmp, T value) {  \
    size_t k = 0;                                                         \
    for (size_t i = 0; i < n; i++) {                                      \
      if (status && status[i]) continue;                                  \
      if (shmem_##NAME##_test(&ivars[i], cmp, value)) indices[k++] = i;   \
    }                                                                     \
    return k;                                                             \
  }                                                                       \
  void shmem_##NAME##_wait_until_all(T *ivars, size_t n,                  \
                                     const int *status, int cmp,          \
                                     T value) {                           \
    for (size_t i = 0; i < n; i++) {                                      \
      if (status && status[i]) continue;                                  \
      shmem_##NAME##_wait_until(&ivars[i], cmp, value);                   \
    }                                                                     \
  }                                                                       \
  size_t shmem_##NAME##_wait_until_any(T *ivars, size_t n,                \
                                       const int *status, int cmp,        \
                                       T value) {                         \
    if (!n) return (size_t)-1;                                            \
    int excluded_all = 1;                                                 \
    for (size_t i = 0; i < n; i++)                                        \
      if (!status || !status[i]) excluded_all = 0;                        \
    if (excluded_all) return (size_t)-1;                                  \
    for (;;) {                                                            \
      size_t i = shmem_##NAME##_test_any(ivars, n, status, cmp, value);   \
      if (i != (size_t)-1) return i;                                      \
      sync_backoff();                                                     \
    }                                                                     \
  }                                                                       \
  size_t shmem_##NAME##_wait_until_some(T *ivars, size_t n,               \
                                        size_t *indices,                  \
                                        const int *status, int cmp,       \
                                        T value) {                        \
    if (!n) return 0;                                                     \
    int excluded_all = 1;                                                 \
    for (size_t i = 0; i < n; i++)                                        \
      if (!status || !status[i]) excluded_all = 0;                        \
    if (excluded_all) return 0;                                           \
    for (;;) {                                                            \
      size_t k = shmem_##NAME##_test_some(ivars, n, indices, status,      \
                                          cmp, value);                    \
      if (k) return k;                                                    \
      sync_backoff();                                                     \
    }                                                                     \
  }

SHMEM_AMO_TYPES(GEN_SYNC)

/* deprecated typed wait (until != value) */
void shmem_int_wait(int *ivar, int value) {
  shmem_int_wait_until(ivar, SHMEM_CMP_NE, value);
}
void shmem_long_wait(long *ivar, long value) {
  shmem_long_wait_until(ivar, SHMEM_CMP_NE, value);
}
void shmem_longlong_wait(long long *ivar, long long value) {
  shmem_longlong_wait_until(ivar, SHMEM_CMP_NE, value);
}
void shmem_short_wait(short *ivar, short value) {
  /* no 2-byte AMO exists, so the VALUE is read from the local mapping
   * with a 2-byte memcpy (a 4-byte fetch through an int* would read
   * past the cell).  The progress rule still applies: each backoff
   * iteration performs a NO_OP engine fetch of heap offset 0 on self,
   * which drives the osc engine exactly like the typed waits do. */
  heap_off(ivar, "wait");
  for (;;) {
    short cur;
    memcpy(&cur, ivar, sizeof cur);
    if (cur != value) return;
    uint64_t old, dummy = 0;
    amo_fop(&dummy, &old, MPI_UINT64_T, g_pe, g_heap, MPI_NO_OP, "wait");
    sync_backoff();
  }
}

/* ---- distributed locks ---------------------------------------------
 * The symmetric long lock word's PE-0 copy is the arbiter: value 0 =
 * free, value pe+1 = held.  clear_lock flushes the critical section
 * before release, so the next holder observes its writes (the
 * lock discipline of Open MPI's oshmem over spml completion). */

void shmem_set_lock(long *lock) {
  heap_off(lock, "set_lock");
  for (;;) {
    long old = shmem_long_atomic_compare_swap(lock, 0L, (long)g_pe + 1, 0);
    if (old == 0) return;
    sync_backoff();
  }
}

void shmem_clear_lock(long *lock) {
  heap_off(lock, "clear_lock");
  shmem_quiet(); /* critical-section writes complete before release */
  (void)shmem_long_atomic_compare_swap(lock, (long)g_pe + 1, 0L, 0);
}

int shmem_test_lock(long *lock) {
  heap_off(lock, "test_lock");
  long old = shmem_long_atomic_compare_swap(lock, 0L, (long)g_pe + 1, 0);
  return old == 0 ? 0 : 1;
}

/* ---- signaled puts (OpenSHMEM 1.5) --------------------------------- */

void shmem_putmem_signal(void *dest, const void *source, size_t nelems,
                         uint64_t *sig_addr, uint64_t signal, int sig_op,
                         int pe) {
  /* ordering contract: the signal must not become visible before the
   * data — put_bytes flushes the data put before the signal op */
  if (sig_op != SHMEM_SIGNAL_SET && sig_op != SHMEM_SIGNAL_ADD)
    die("bad shmem_putmem_signal sig_op");
  put_bytes(dest, source, nelems, pe);
  if (sig_op == SHMEM_SIGNAL_ADD)
    (void)shmem_uint64_atomic_fetch_add(sig_addr, signal, pe);
  else
    shmem_uint64_atomic_set(sig_addr, signal, pe);
}

void shmem_putmem_signal_nbi(void *dest, const void *source, size_t nelems,
                             uint64_t *sig_addr, uint64_t signal,
                             int sig_op, int pe) {
  /* data must still be signal-ordered: flush data, then signal — the
   * "nbi" latitude is unused (correct, conservatively blocking) */
  shmem_putmem_signal(dest, source, nelems, sig_addr, signal, sig_op, pe);
}

uint64_t shmem_signal_fetch(const uint64_t *sig_addr) {
  return shmem_uint64_atomic_fetch(sig_addr, g_pe);
}

/* typed + sized put-with-signal (1.5): elementwise forms over the
 * same data-before-signal machinery */
#define GEN_PUT_SIGNAL(NAME, T, MPIT)                                     \
  void shmem_##NAME##_put_signal(T *dest, const T *source, size_t n,      \
                                 uint64_t *sig_addr, uint64_t signal,     \
                                 int sig_op, int pe) {                    \
    shmem_putmem_signal(dest, source, n * sizeof(T), sig_addr, signal,    \
                        sig_op, pe);                                      \
  }                                                                       \
  void shmem_##NAME##_put_signal_nbi(T *dest, const T *source, size_t n,  \
                                     uint64_t *sig_addr,                  \
                                     uint64_t signal, int sig_op,         \
                                     int pe) {                            \
    shmem_putmem_signal_nbi(dest, source, n * sizeof(T), sig_addr,        \
                            signal, sig_op, pe);                          \
  }

SHMEM_RMA_TYPES(GEN_PUT_SIGNAL)

#define GEN_PUT_SIGNAL_SIZED(BITS, BYTES)                                 \
  void shmem_put##BITS##_signal(void *dest, const void *source,           \
                                size_t n, uint64_t *sig_addr,             \
                                uint64_t signal, int sig_op, int pe) {    \
    shmem_putmem_signal(dest, source, n * (BYTES), sig_addr, signal,      \
                        sig_op, pe);                                      \
  }                                                                       \
  void shmem_put##BITS##_signal_nbi(void *dest, const void *source,       \
                                    size_t n, uint64_t *sig_addr,         \
                                    uint64_t signal, int sig_op,          \
                                    int pe) {                             \
    shmem_putmem_signal_nbi(dest, source, n * (BYTES), sig_addr,          \
                            signal, sig_op, pe);                          \
  }

GEN_PUT_SIGNAL_SIZED(8, 1)
GEN_PUT_SIGNAL_SIZED(16, 2)
GEN_PUT_SIGNAL_SIZED(32, 4)
GEN_PUT_SIGNAL_SIZED(64, 8)
GEN_PUT_SIGNAL_SIZED(128, 16)

uint64_t shmem_signal_wait_until(uint64_t *sig_addr, int cmp,
                                 uint64_t cmp_value) {
  /* 1.5 contract: returns the sig_addr contents that SATISFIED the
   * wait (a later fetch could see further updates) */
  heap_off(sig_addr, "signal_wait_until");
  for (;;) {
    uint64_t cur = shmem_uint64_atomic_fetch(sig_addr, g_pe);
    int ok;
    CMP_OK(cur, cmp, cmp_value, ok);
    if (ok) return cur;
    sync_backoff();
  }
}

/* ---- teams (1.5) ----------------------------------------------------
 * (start, stride, size) descriptors + a REAL communicator per team
 * (MPI_Comm_create_group over the member world ranks — only members
 * participate, matching split_strided's collective-over-parent
 * contract), so team collectives and sync are first-class. */

typedef struct {
  int used, start, stride, size;
  MPI_Comm comm;
} tpushmem_team;

#define TEAM_MAX 64
static tpushmem_team g_teams[TEAM_MAX]; /* slot 0 = SHMEM_TEAM_WORLD */

static tpushmem_team *team_of(shmem_team_t t) {
  if (t == SHMEM_TEAM_WORLD) {
    g_teams[0].used = 1;
    g_teams[0].start = 0;
    g_teams[0].stride = 1;
    g_teams[0].size = g_npes;
    g_teams[0].comm = MPI_COMM_WORLD;
    return &g_teams[0];
  }
  if (t <= 0 || t >= TEAM_MAX || !g_teams[t].used) return NULL;
  return &g_teams[t];
}

/* build a communicator over (wstart + i*wstride, i < size): collective
 * over the MEMBER PEs only (MPI_Comm_create_group semantics).  The
 * tag MUST be a pure function of the member triple — a locally-chosen
 * value (e.g. a cache-slot index) can differ across PEs whose
 * team-creation histories differ, and mismatched tags deadlock the
 * members-only CID agreement. */
static int subset_tag(int wstart, int wstride, int size) {
  unsigned h = 2166136261u;
  h = (h ^ (unsigned)wstart) * 16777619u;
  h = (h ^ (unsigned)wstride) * 16777619u;
  h = (h ^ (unsigned)size) * 16777619u;
  return (int)(h & 0x3fffffff);
}

static MPI_Comm subset_comm(int wstart, int wstride, int size, int tag) {
  if (wstart == 0 && wstride == 1 && size == g_npes) return MPI_COMM_WORLD;
  MPI_Group wg, sg;
  MPI_Comm_group(MPI_COMM_WORLD, &wg);
  int *ranks = (int *)malloc(sizeof(int) * (size_t)size);
  for (int i = 0; i < size; i++) ranks[i] = wstart + i * wstride;
  MPI_Group_incl(wg, size, ranks, &sg);
  free(ranks);
  MPI_Comm c = MPI_COMM_NULL;
  MPI_Comm_create_group(MPI_COMM_WORLD, sg, tag, &c);
  MPI_Group_free(&sg);
  MPI_Group_free(&wg);
  return c;
}

int shmem_team_my_pe(shmem_team_t team) {
  tpushmem_team *tm = team_of(team);
  if (!tm) return -1;
  int off = g_pe - tm->start;
  if (off < 0 || off % tm->stride || off / tm->stride >= tm->size)
    return -1; /* not a member */
  return off / tm->stride;
}

int shmem_team_n_pes(shmem_team_t team) {
  tpushmem_team *tm = team_of(team);
  return tm ? tm->size : -1;
}

int shmem_team_translate_pe(shmem_team_t src_team, int src_pe,
                            shmem_team_t dest_team) {
  tpushmem_team *s = team_of(src_team), *d = team_of(dest_team);
  if (!s || !d || src_pe < 0 || src_pe >= s->size) return -1;
  int world = s->start + src_pe * s->stride;
  int off = world - d->start;
  if (off < 0 || off % d->stride || off / d->stride >= d->size) return -1;
  return off / d->stride;
}

int shmem_team_get_config(shmem_team_t team, long config_mask,
                          shmem_team_config_t *config) {
  (void)config_mask;
  if (!team_of(team)) return -1;
  if (config) config->num_contexts = 0;
  return 0;
}

int shmem_team_split_strided(shmem_team_t parent, int start, int stride,
                             int size, const shmem_team_config_t *config,
                             long config_mask, shmem_team_t *new_team) {
  /* Collective over the PARENT team's PEs (1.5): members build the
   * new team's communicator together via MPI_Comm_create_group;
   * NONMEMBER parent PEs participate trivially and receive
   * SHMEM_TEAM_INVALID. */
  (void)config;
  (void)config_mask;
  if (new_team) *new_team = SHMEM_TEAM_INVALID;
  tpushmem_team *p = team_of(parent);
  if (!p || size < 1 || stride < 1 || start < 0 ||
      start + (size - 1) * stride >= p->size)
    return -1;
  int wstart = p->start + start * p->stride;
  int wstride = p->stride * stride;
  int off = g_pe - wstart;
  if (off < 0 || off % wstride || off / wstride >= size)
    return 0; /* not a member: INVALID handle, successful call */
  for (int i = 1; i < TEAM_MAX; i++) {
    if (!g_teams[i].used) {
      g_teams[i].used = 1;
      g_teams[i].start = wstart;
      g_teams[i].stride = wstride;
      g_teams[i].size = size;
      g_teams[i].comm =
          subset_comm(wstart, wstride, size,
                      subset_tag(wstart, wstride, size));
      if (new_team) *new_team = (shmem_team_t)i;
      return 0;
    }
  }
  return -1; /* local table full */
}

void shmem_team_destroy(shmem_team_t team) {
  if (team > 0 && team < TEAM_MAX && g_teams[team].used) {
    if (g_teams[team].comm != MPI_COMM_NULL &&
        g_teams[team].comm != MPI_COMM_WORLD)
      MPI_Comm_free(&g_teams[team].comm);
    g_teams[team].used = 0;
  }
}

int shmem_team_sync(shmem_team_t team) {
  tpushmem_team *tm = team_of(team);
  if (!tm) return -1;
  MPI_Barrier(tm->comm);
  return 0;
}

/* ---- collectives ----------------------------------------------------
 * Active sets map to cached communicators over (PE_start,
 * 1<<logPE_stride, PE_size) — ANY strided subset works, not just the
 * world (the round-4 check_world rejection is gone). */

typedef struct {
  int used, start, stride, size;
  MPI_Comm comm;
} asetcomm;
#define ASET_MAX 64
static asetcomm g_asets[ASET_MAX];

static MPI_Comm aset_comm(int PE_start, int logPE_stride, int PE_size,
                          const char *who) {
  int stride = 1 << logPE_stride;
  if (PE_start == 0 && stride == 1 && PE_size == g_npes)
    return MPI_COMM_WORLD;
  int off = g_pe - PE_start;
  if (off < 0 || off % stride || off / stride >= PE_size) {
    fprintf(stderr, "tpushmem: %s: calling PE %d is not in the active "
                    "set (start=%d, logstride=%d, size=%d)\n",
            who, g_pe, PE_start, logPE_stride, PE_size);
    MPI_Abort(MPI_COMM_WORLD, 13);
  }
  for (int i = 0; i < ASET_MAX; i++)
    if (g_asets[i].used && g_asets[i].start == PE_start &&
        g_asets[i].stride == stride && g_asets[i].size == PE_size)
      return g_asets[i].comm;
  for (int i = 0; i < ASET_MAX; i++)
    if (!g_asets[i].used) {
      g_asets[i].used = 1;
      g_asets[i].start = PE_start;
      g_asets[i].stride = stride;
      g_asets[i].size = PE_size;
      g_asets[i].comm = subset_comm(PE_start, stride, PE_size,
                                    subset_tag(PE_start, stride, PE_size));
      return g_asets[i].comm;
    }
  die("active-set communicator cache full");
  return MPI_COMM_NULL;
}

void shmem_barrier(int PE_start, int logPE_stride, int PE_size,
                   long *pSync) {
  (void)pSync;
  shmem_quiet();
  MPI_Barrier(aset_comm(PE_start, logPE_stride, PE_size, "shmem_barrier"));
}

void shmem_sync(int PE_start, int logPE_stride, int PE_size, long *pSync) {
  (void)pSync;
  MPI_Barrier(aset_comm(PE_start, logPE_stride, PE_size, "shmem_sync"));
}

static void bcast_bytes(MPI_Comm comm, void *dest, const void *source,
                        size_t nbytes, int root_in_comm) {
  /* active-set broadcast: the root's dest is NOT written (1.4
   * semantics); others receive */
  int me;
  MPI_Comm_rank(comm, &me);
  if (me == root_in_comm) {
    MPI_Bcast((void *)source, (int)nbytes, MPI_BYTE, root_in_comm, comm);
  } else {
    MPI_Bcast(dest, (int)nbytes, MPI_BYTE, root_in_comm, comm);
  }
}

#define GEN_BCAST_SIZED(BITS, BYTES)                                      \
  void shmem_broadcast##BITS(void *dest, const void *source,              \
                             size_t nelems, int PE_root, int PE_start,    \
                             int logPE_stride, int PE_size,               \
                             long *pSync) {                               \
    (void)pSync;                                                          \
    bcast_bytes(aset_comm(PE_start, logPE_stride, PE_size, "broadcast"),  \
                dest, source, nelems * (BYTES), PE_root);                 \
  }

GEN_BCAST_SIZED(32, 4)
GEN_BCAST_SIZED(64, 8)

static void fcollect_bytes(MPI_Comm comm, void *dest, const void *source,
                           size_t nbytes) {
  MPI_Allgather((void *)source, (int)nbytes, MPI_BYTE, dest, (int)nbytes,
                MPI_BYTE, comm);
}

static void collect_bytes(MPI_Comm comm, void *dest, const void *source,
                          size_t nbytes) {
  /* jagged: PEs may contribute different sizes */
  int np;
  MPI_Comm_size(comm, &np);
  int n = (int)nbytes;
  int *counts = (int *)malloc(sizeof(int) * (size_t)np);
  int *displs = (int *)malloc(sizeof(int) * (size_t)np);
  MPI_Allgather(&n, 1, MPI_INT, counts, 1, MPI_INT, comm);
  int off = 0;
  for (int i = 0; i < np; i++) {
    displs[i] = off;
    off += counts[i];
  }
  MPI_Allgatherv((void *)source, n, MPI_BYTE, dest, counts, displs,
                 MPI_BYTE, comm);
  free(counts);
  free(displs);
}

static void alltoall_bytes(MPI_Comm comm, void *dest, const void *source,
                           size_t nbytes_per_pair) {
  MPI_Alltoall((void *)source, (int)nbytes_per_pair, MPI_BYTE, dest,
               (int)nbytes_per_pair, MPI_BYTE, comm);
}

/* strided alltoall: element k for/from peer j lives at index
 * (j*nelems + k) * stride (in elements) */
static void alltoalls_bytes(MPI_Comm comm, void *dest, const void *source,
                            ptrdiff_t dst, ptrdiff_t sst, size_t nelems,
                            size_t elem) {
  int np;
  MPI_Comm_size(comm, &np);
  size_t total = (size_t)np * nelems * elem;
  unsigned char *stmp = (unsigned char *)malloc(total ? total : 1);
  unsigned char *rtmp = (unsigned char *)malloc(total ? total : 1);
  for (size_t i = 0; i < (size_t)np * nelems; i++)
    memcpy(stmp + i * elem,
           (const unsigned char *)source + i * (size_t)sst * elem, elem);
  MPI_Alltoall(stmp, (int)(nelems * elem), MPI_BYTE, rtmp,
               (int)(nelems * elem), MPI_BYTE, comm);
  for (size_t i = 0; i < (size_t)np * nelems; i++)
    memcpy((unsigned char *)dest + i * (size_t)dst * elem,
           rtmp + i * elem, elem);
  free(stmp);
  free(rtmp);
}

#define GEN_COLLECT_SIZED(BITS, BYTES)                                    \
  void shmem_collect##BITS(void *dest, const void *source, size_t nelems, \
                           int PE_start, int logPE_stride, int PE_size,   \
                           long *pSync) {                                 \
    (void)pSync;                                                          \
    collect_bytes(aset_comm(PE_start, logPE_stride, PE_size, "collect"),  \
                  dest, source, nelems * (BYTES));                        \
  }                                                                       \
  void shmem_fcollect##BITS(void *dest, const void *source,               \
                            size_t nelems, int PE_start,                  \
                            int logPE_stride, int PE_size,                \
                            long *pSync) {                                \
    (void)pSync;                                                          \
    fcollect_bytes(                                                       \
        aset_comm(PE_start, logPE_stride, PE_size, "fcollect"), dest,     \
        source, nelems * (BYTES));                                        \
  }                                                                       \
  void shmem_alltoall##BITS(void *dest, const void *source,               \
                            size_t nelems, int PE_start,                  \
                            int logPE_stride, int PE_size,                \
                            long *pSync) {                                \
    (void)pSync;                                                          \
    alltoall_bytes(                                                       \
        aset_comm(PE_start, logPE_stride, PE_size, "alltoall"), dest,     \
        source, nelems * (BYTES));                                        \
  }                                                                       \
  void shmem_alltoalls##BITS(void *dest, const void *source,              \
                             ptrdiff_t dst, ptrdiff_t sst, size_t nelems, \
                             int PE_start, int logPE_stride, int PE_size, \
                             long *pSync) {                               \
    (void)pSync;                                                          \
    alltoalls_bytes(                                                      \
        aset_comm(PE_start, logPE_stride, PE_size, "alltoalls"), dest,    \
        source, dst, sst, nelems, (BYTES));                               \
  }

GEN_COLLECT_SIZED(32, 4)
GEN_COLLECT_SIZED(64, 8)

/* ---- active-set reductions (1.4 matrix) ----------------------------- */

#define GEN_TO_ALL(NAME, T, MPIT, MPIOP, OPTOKEN)                         \
  void shmem_##NAME##_##OPTOKEN##_to_all(                                 \
      T *dest, const T *source, int nreduce, int PE_start,                \
      int logPE_stride, int PE_size, T *pWrk, long *pSync) {              \
    (void)pWrk;                                                           \
    (void)pSync;                                                          \
    MPI_Allreduce((void *)source, dest, nreduce, MPIT, MPIOP,             \
                  aset_comm(PE_start, logPE_stride, PE_size,              \
                            "shmem_" #NAME "_" #OPTOKEN "_to_all"));      \
  }

/* integer types get the full op set */
#define GEN_TO_ALL_INT(NAME, T, MPIT)                                     \
  GEN_TO_ALL(NAME, T, MPIT, MPI_BAND, and)                                \
  GEN_TO_ALL(NAME, T, MPIT, MPI_BOR, or)                                  \
  GEN_TO_ALL(NAME, T, MPIT, MPI_BXOR, xor)                                \
  GEN_TO_ALL(NAME, T, MPIT, MPI_MIN, min)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_MAX, max)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_SUM, sum)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_PROD, prod)

#define GEN_TO_ALL_FP(NAME, T, MPIT)                                      \
  GEN_TO_ALL(NAME, T, MPIT, MPI_MIN, min)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_MAX, max)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_SUM, sum)                                 \
  GEN_TO_ALL(NAME, T, MPIT, MPI_PROD, prod)

GEN_TO_ALL_INT(short, short, MPI_SHORT)
GEN_TO_ALL_INT(int, int, MPI_INT)
GEN_TO_ALL_INT(long, long, MPI_LONG)
GEN_TO_ALL_INT(longlong, long long, MPI_LONG_LONG)
GEN_TO_ALL_FP(float, float, MPI_FLOAT)
GEN_TO_ALL_FP(double, double, MPI_DOUBLE)
GEN_TO_ALL(complexf, float _Complex, MPI_C_FLOAT_COMPLEX, MPI_SUM, sum)
GEN_TO_ALL(complexf, float _Complex, MPI_C_FLOAT_COMPLEX, MPI_PROD, prod)
GEN_TO_ALL(complexd, double _Complex, MPI_C_DOUBLE_COMPLEX, MPI_SUM, sum)
GEN_TO_ALL(complexd, double _Complex, MPI_C_DOUBLE_COMPLEX, MPI_PROD,
           prod)

/* ---- team collectives (1.5) ----------------------------------------- */

static MPI_Comm team_comm(shmem_team_t team, const char *who) {
  tpushmem_team *tm = team_of(team);
  if (!tm || tm->comm == MPI_COMM_NULL) {
    fprintf(stderr, "tpushmem: %s: invalid team or non-member PE %d\n",
            who, g_pe);
    MPI_Abort(MPI_COMM_WORLD, 13);
  }
  return tm->comm;
}

int shmem_broadcastmem(shmem_team_t team, void *dest, const void *source,
                       size_t nelems, int PE_root) {
  MPI_Comm c = team_comm(team, "broadcastmem");
  int me;
  MPI_Comm_rank(c, &me);
  /* 1.5 team broadcast: dest is updated on ALL team PEs incl. root */
  if (me == PE_root) {
    MPI_Bcast((void *)source, (int)nelems, MPI_BYTE, PE_root, c);
    if (dest != source) memmove(dest, source, nelems);
  } else {
    MPI_Bcast(dest, (int)nelems, MPI_BYTE, PE_root, c);
  }
  return 0;
}

int shmem_collectmem(shmem_team_t team, void *dest, const void *source,
                     size_t nelems) {
  collect_bytes(team_comm(team, "collectmem"), dest, source, nelems);
  return 0;
}

int shmem_fcollectmem(shmem_team_t team, void *dest, const void *source,
                      size_t nelems) {
  fcollect_bytes(team_comm(team, "fcollectmem"), dest, source, nelems);
  return 0;
}

int shmem_alltoallmem(shmem_team_t team, void *dest, const void *source,
                      size_t nelems) {
  alltoall_bytes(team_comm(team, "alltoallmem"), dest, source, nelems);
  return 0;
}

int shmem_alltoallsmem(shmem_team_t team, void *dest, const void *source,
                       ptrdiff_t dst, ptrdiff_t sst, size_t nelems) {
  alltoalls_bytes(team_comm(team, "alltoallsmem"), dest, source, dst, sst,
                  nelems, 1);
  return 0;
}

#define GEN_TEAM_COLL(NAME, T, MPIT)                                      \
  int shmem_##NAME##_broadcast(shmem_team_t team, T *dest,                \
                               const T *source, size_t nelems,            \
                               int PE_root) {                             \
    return shmem_broadcastmem(team, dest, source, nelems * sizeof(T),     \
                              PE_root);                                   \
  }                                                                       \
  int shmem_##NAME##_collect(shmem_team_t team, T *dest, const T *source, \
                             size_t nelems) {                             \
    return shmem_collectmem(team, dest, source, nelems * sizeof(T));      \
  }                                                                       \
  int shmem_##NAME##_fcollect(shmem_team_t team, T *dest,                 \
                              const T *source, size_t nelems) {           \
    return shmem_fcollectmem(team, dest, source, nelems * sizeof(T));     \
  }                                                                       \
  int shmem_##NAME##_alltoall(shmem_team_t team, T *dest,                 \
                              const T *source, size_t nelems) {           \
    return shmem_alltoallmem(team, dest, source, nelems * sizeof(T));     \
  }                                                                       \
  int shmem_##NAME##_alltoalls(shmem_team_t team, T *dest,                \
                               const T *source, ptrdiff_t dst,            \
                               ptrdiff_t sst, size_t nelems) {            \
    alltoalls_bytes(team_comm(team, "alltoalls"), dest, source, dst,      \
                    sst, nelems, sizeof(T));                              \
    return 0;                                                             \
  }

SHMEM_RMA_TYPES(GEN_TEAM_COLL)

/* team reductions: {min,max,sum,prod} over the arithmetic types,
 * {and,or,xor} over the bitwise-capable types (1.5 Table 10) */
#define GEN_TEAM_REDUCE(NAME, T, MPIT, MPIOP, OPTOKEN)                    \
  int shmem_##NAME##_##OPTOKEN##_reduce(shmem_team_t team, T *dest,       \
                                        const T *source,                  \
                                        size_t nreduce) {                 \
    MPI_Allreduce((void *)source, dest, (int)nreduce, MPIT, MPIOP,        \
                  team_comm(team, #OPTOKEN "_reduce"));                   \
    return 0;                                                             \
  }

#define GEN_TEAM_REDUCE_ARITH(NAME, T, MPIT)                              \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_MIN, min)                            \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_MAX, max)                            \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_SUM, sum)                            \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_PROD, prod)

#define GEN_TEAM_REDUCE_BITS(NAME, T, MPIT)                               \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_BAND, and)                           \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_BOR, or)                             \
  GEN_TEAM_REDUCE(NAME, T, MPIT, MPI_BXOR, xor)

/* arithmetic reduce types: the RMA list minus char/schar (spec gives
 * min/max/sum/prod to the numeric types; char stays put/get-only) */
#define SHMEM_REDUCE_ARITH_TYPES(X)                                       \
  X(short, short, MPI_SHORT)                                              \
  X(int, int, MPI_INT)                                                    \
  X(long, long, MPI_LONG)                                                 \
  X(longlong, long long, MPI_LONG_LONG)                                   \
  X(ushort, unsigned short, MPI_UNSIGNED_SHORT)                           \
  X(uint, unsigned int, MPI_UNSIGNED)                                     \
  X(ulong, unsigned long, MPI_UNSIGNED_LONG)                              \
  X(ulonglong, unsigned long long, MPI_UNSIGNED_LONG_LONG)                \
  X(float, float, MPI_FLOAT)                                              \
  X(double, double, MPI_DOUBLE)                                           \
  X(int8, int8_t, MPI_INT8_T)                                             \
  X(int16, int16_t, MPI_INT16_T)                                          \
  X(int32, int32_t, MPI_INT32_T)                                          \
  X(int64, int64_t, MPI_INT64_T)                                          \
  X(uint8, uint8_t, MPI_UINT8_T)                                          \
  X(uint16, uint16_t, MPI_UINT16_T)                                       \
  X(uint32, uint32_t, MPI_UINT32_T)                                       \
  X(uint64, uint64_t, MPI_UINT64_T)                                       \
  X(size, size_t, MPI_UINT64_T)                                           \
  X(ptrdiff, ptrdiff_t, MPI_INT64_T)

#define SHMEM_REDUCE_BITS_TYPES(X)                                        \
  X(uchar, unsigned char, MPI_UNSIGNED_CHAR)                              \
  X(ushort, unsigned short, MPI_UNSIGNED_SHORT)                           \
  X(uint, unsigned int, MPI_UNSIGNED)                                     \
  X(ulong, unsigned long, MPI_UNSIGNED_LONG)                              \
  X(ulonglong, unsigned long long, MPI_UNSIGNED_LONG_LONG)                \
  X(int8, int8_t, MPI_INT8_T)                                             \
  X(int16, int16_t, MPI_INT16_T)                                          \
  X(int32, int32_t, MPI_INT32_T)                                          \
  X(int64, int64_t, MPI_INT64_T)                                          \
  X(uint8, uint8_t, MPI_UINT8_T)                                          \
  X(uint16, uint16_t, MPI_UINT16_T)                                       \
  X(uint32, uint32_t, MPI_UINT32_T)                                       \
  X(uint64, uint64_t, MPI_UINT64_T)                                       \
  X(size, size_t, MPI_UINT64_T)

SHMEM_REDUCE_ARITH_TYPES(GEN_TEAM_REDUCE_ARITH)
SHMEM_REDUCE_BITS_TYPES(GEN_TEAM_REDUCE_BITS)
GEN_TEAM_REDUCE(complexf, float _Complex, MPI_C_FLOAT_COMPLEX, MPI_SUM,
                sum)
GEN_TEAM_REDUCE(complexf, float _Complex, MPI_C_FLOAT_COMPLEX, MPI_PROD,
                prod)
GEN_TEAM_REDUCE(complexd, double _Complex, MPI_C_DOUBLE_COMPLEX, MPI_SUM,
                sum)
GEN_TEAM_REDUCE(complexd, double _Complex, MPI_C_DOUBLE_COMPLEX, MPI_PROD,
                prod)
