/* shmem.h — OpenSHMEM 1.4 surface + 1.5 teams/contexts/signals over
 * the PyTorch/CUDA MPI framework (ompi_tpu_torch's libtpumpi).
 *
 * ≈ Open MPI's oshmem/include/shmem.h (SURVEY.md §2.5: liboshmem
 * exports ~836 shmem_* symbols layered over ompi).  This build layers
 * the same way: libtpushmem.so implements the OpenSHMEM API families
 * ON TOP of libtpumpi's MPI C ABI — symmetric heap as a byte window
 * under passive lock_all, put/get as MPI_Put/MPI_Get + flush, atomics
 * as MPI_Fetch_and_op / MPI_Compare_and_swap, collectives as their
 * MPI twins over active-set/team communicators — exactly oshmem's
 * spml/scoll-over-ompi architecture.  The typed families are macro-
 * generated from X-macro type lists, as Open MPI generates its
 * oshmem/shmem/c sources.  Omitted: longdouble variants (no
 * MPI_LONG_DOUBLE in the host ABI).
 */
#ifndef TPUSHMEM_H
#define TPUSHMEM_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define SHMEM_MAJOR_VERSION 1
#define SHMEM_MINOR_VERSION 5
#define SHMEM_VENDOR_STRING "ompi_tpu_torch"
#define SHMEM_MAX_NAME_LEN 64

/* threading levels */
#define SHMEM_THREAD_SINGLE 0
#define SHMEM_THREAD_FUNNELED 1
#define SHMEM_THREAD_SERIALIZED 2
#define SHMEM_THREAD_MULTIPLE 3

/* malloc hints (1.5) */
#define SHMEM_MALLOC_ATOMICS_REMOTE (1L << 0)
#define SHMEM_MALLOC_SIGNAL_REMOTE (1L << 1)

/* library setup / query */
void shmem_init(void);
int shmem_init_thread(int requested, int *provided);
void shmem_query_thread(int *provided);
void shmem_finalize(void);
int shmem_my_pe(void);
int shmem_n_pes(void);
void shmem_info_get_version(int *major, int *minor);
void shmem_info_get_name(char *name);
int shmem_pe_accessible(int pe);
int shmem_addr_accessible(const void *addr, int pe);
void shmem_global_exit(int status);
/* legacy (SGI) names */
void start_pes(int npes);
int _my_pe(void);
int _num_pes(void);

/* symmetric heap */
void *shmem_malloc(size_t size);
void *shmem_calloc(size_t count, size_t size);
void *shmem_align(size_t alignment, size_t size);
void shmem_free(void *ptr);
void *shmem_realloc(void *ptr, size_t size);
void *shmem_malloc_with_hints(size_t size, long hints);
void *shmem_ptr(const void *dest, int pe);

/* memory ordering */
void shmem_quiet(void);
void shmem_fence(void);
void shmem_barrier_all(void);
void shmem_sync_all(void);

/* contexts (1.5) */
typedef void *shmem_ctx_t;
#define SHMEM_CTX_DEFAULT ((shmem_ctx_t)0)
#define SHMEM_CTX_INVALID ((shmem_ctx_t)-1)
#define SHMEM_CTX_SERIALIZED (1L << 0)
#define SHMEM_CTX_PRIVATE (1L << 1)
#define SHMEM_CTX_NOSTORE (1L << 2)
int shmem_ctx_create(long options, shmem_ctx_t *ctx);
void shmem_ctx_destroy(shmem_ctx_t ctx);
void shmem_ctx_quiet(shmem_ctx_t ctx);
void shmem_ctx_fence(shmem_ctx_t ctx);

/* teams (1.5) */
typedef int shmem_team_t;
#define SHMEM_TEAM_INVALID ((shmem_team_t)-1)
#define SHMEM_TEAM_WORLD ((shmem_team_t)0)
typedef struct {
  int num_contexts;
} shmem_team_config_t;
int shmem_team_my_pe(shmem_team_t team);
int shmem_team_n_pes(shmem_team_t team);
int shmem_team_translate_pe(shmem_team_t src_team, int src_pe,
                            shmem_team_t dest_team);
int shmem_team_split_strided(shmem_team_t parent, int start, int stride,
                             int size, const shmem_team_config_t *config,
                             long config_mask, shmem_team_t *new_team);
void shmem_team_destroy(shmem_team_t team);
int shmem_team_sync(shmem_team_t team);
int shmem_team_get_config(shmem_team_t team, long config_mask,
                          shmem_team_config_t *config);
int shmem_team_create_ctx(shmem_team_t team, long options,
                          shmem_ctx_t *ctx);
int shmem_ctx_get_team(shmem_ctx_t ctx, shmem_team_t *team);

/* RMA / AMO type lists (macro-generated API families) */
#define TPUSHMEM_RMA_TYPES(X)                                             \
  X(char, char)                                                           \
  X(schar, signed char)                                                   \
  X(short, short)                                                         \
  X(int, int)                                                             \
  X(long, long)                                                           \
  X(longlong, long long)                                                  \
  X(uchar, unsigned char)                                                 \
  X(ushort, unsigned short)                                               \
  X(uint, unsigned int)                                                   \
  X(ulong, unsigned long)                                                 \
  X(ulonglong, unsigned long long)                                        \
  X(float, float)                                                         \
  X(double, double)                                                       \
  X(int8, int8_t)                                                         \
  X(int16, int16_t)                                                       \
  X(int32, int32_t)                                                       \
  X(int64, int64_t)                                                       \
  X(uint8, uint8_t)                                                       \
  X(uint16, uint16_t)                                                     \
  X(uint32, uint32_t)                                                     \
  X(uint64, uint64_t)                                                     \
  X(size, size_t)                                                         \
  X(ptrdiff, ptrdiff_t)

#define TPUSHMEM_AMO_TYPES(X)                                             \
  X(int, int)                                                             \
  X(long, long)                                                           \
  X(longlong, long long)                                                  \
  X(uint, unsigned int)                                                   \
  X(ulong, unsigned long)                                                 \
  X(ulonglong, unsigned long long)                                        \
  X(int32, int32_t)                                                       \
  X(int64, int64_t)                                                       \
  X(uint32, uint32_t)                                                     \
  X(uint64, uint64_t)                                                     \
  X(size, size_t)                                                         \
  X(ptrdiff, ptrdiff_t)

#define TPUSHMEM_BITWISE_TYPES(X)                                         \
  X(uint, unsigned int)                                                   \
  X(ulong, unsigned long)                                                 \
  X(ulonglong, unsigned long long)                                        \
  X(int32, int32_t)                                                       \
  X(int64, int64_t)                                                       \
  X(uint32, uint32_t)                                                     \
  X(uint64, uint64_t)

/* contiguous put/get + p/g + strided + non-blocking + ctx forms */
#define TPUSHMEM_DECL_RMA(NAME, T)                                        \
  void shmem_##NAME##_put(T *dest, const T *source, size_t nelems,        \
                          int pe);                                        \
  void shmem_##NAME##_get(T *dest, const T *source, size_t nelems,        \
                          int pe);                                        \
  void shmem_##NAME##_put_nbi(T *dest, const T *source, size_t nelems,    \
                              int pe);                                    \
  void shmem_##NAME##_get_nbi(T *dest, const T *source, size_t nelems,    \
                              int pe);                                    \
  void shmem_##NAME##_p(T *dest, T value, int pe);                        \
  T shmem_##NAME##_g(const T *source, int pe);                            \
  void shmem_##NAME##_iput(T *dest, const T *source, ptrdiff_t dst,       \
                           ptrdiff_t sst, size_t nelems, int pe);         \
  void shmem_##NAME##_iget(T *dest, const T *source, ptrdiff_t dst,       \
                           ptrdiff_t sst, size_t nelems, int pe);         \
  void shmem_ctx_##NAME##_put(shmem_ctx_t ctx, T *dest, const T *source,  \
                              size_t nelems, int pe);                     \
  void shmem_ctx_##NAME##_get(shmem_ctx_t ctx, T *dest, const T *source,  \
                              size_t nelems, int pe);                     \
  void shmem_ctx_##NAME##_put_nbi(shmem_ctx_t ctx, T *dest,               \
                                  const T *source, size_t nelems,         \
                                  int pe);                                \
  void shmem_ctx_##NAME##_get_nbi(shmem_ctx_t ctx, T *dest,               \
                                  const T *source, size_t nelems,         \
                                  int pe);                                \
  void shmem_ctx_##NAME##_p(shmem_ctx_t ctx, T *dest, T value, int pe);   \
  T shmem_ctx_##NAME##_g(shmem_ctx_t ctx, const T *source, int pe);

TPUSHMEM_RMA_TYPES(TPUSHMEM_DECL_RMA)

void shmem_putmem(void *dest, const void *source, size_t nelems, int pe);
void shmem_getmem(void *dest, const void *source, size_t nelems, int pe);
void shmem_putmem_nbi(void *dest, const void *source, size_t nelems,
                      int pe);
void shmem_getmem_nbi(void *dest, const void *source, size_t nelems,
                      int pe);
void shmem_ctx_putmem(shmem_ctx_t ctx, void *dest, const void *source,
                      size_t nelems, int pe);
void shmem_ctx_getmem(shmem_ctx_t ctx, void *dest, const void *source,
                      size_t nelems, int pe);
void shmem_ctx_putmem_nbi(shmem_ctx_t ctx, void *dest, const void *source,
                          size_t nelems, int pe);
void shmem_ctx_getmem_nbi(shmem_ctx_t ctx, void *dest, const void *source,
                          size_t nelems, int pe);

#define TPUSHMEM_DECL_SIZED(BITS)                                         \
  void shmem_put##BITS(void *dest, const void *source, size_t nelems,     \
                       int pe);                                           \
  void shmem_get##BITS(void *dest, const void *source, size_t nelems,     \
                       int pe);                                           \
  void shmem_put##BITS##_nbi(void *dest, const void *source,              \
                             size_t nelems, int pe);                      \
  void shmem_get##BITS##_nbi(void *dest, const void *source,              \
                             size_t nelems, int pe);                      \
  void shmem_iput##BITS(void *dest, const void *source, ptrdiff_t dst,    \
                        ptrdiff_t sst, size_t nelems, int pe);            \
  void shmem_iget##BITS(void *dest, const void *source, ptrdiff_t dst,    \
                        ptrdiff_t sst, size_t nelems, int pe);

TPUSHMEM_DECL_SIZED(8)
TPUSHMEM_DECL_SIZED(16)
TPUSHMEM_DECL_SIZED(32)
TPUSHMEM_DECL_SIZED(64)
TPUSHMEM_DECL_SIZED(128)

/* atomics: standard family + ctx forms */
#define TPUSHMEM_DECL_AMO(NAME, T)                                        \
  T shmem_##NAME##_atomic_fetch(const T *source, int pe);                 \
  void shmem_##NAME##_atomic_set(T *dest, T value, int pe);               \
  T shmem_##NAME##_atomic_fetch_add(T *dest, T value, int pe);            \
  void shmem_##NAME##_atomic_add(T *dest, T value, int pe);               \
  T shmem_##NAME##_atomic_fetch_inc(T *dest, int pe);                     \
  void shmem_##NAME##_atomic_inc(T *dest, int pe);                        \
  T shmem_##NAME##_atomic_swap(T *dest, T value, int pe);                 \
  T shmem_##NAME##_atomic_compare_swap(T *dest, T cond, T value, int pe); \
  T shmem_ctx_##NAME##_atomic_fetch(shmem_ctx_t ctx, const T *source,     \
                                    int pe);                              \
  void shmem_ctx_##NAME##_atomic_set(shmem_ctx_t ctx, T *dest, T value,   \
                                     int pe);                             \
  T shmem_ctx_##NAME##_atomic_fetch_add(shmem_ctx_t ctx, T *dest,         \
                                        T value, int pe);                 \
  void shmem_ctx_##NAME##_atomic_add(shmem_ctx_t ctx, T *dest, T value,   \
                                     int pe);                             \
  T shmem_ctx_##NAME##_atomic_swap(shmem_ctx_t ctx, T *dest, T value,     \
                                   int pe);                               \
  T shmem_ctx_##NAME##_atomic_compare_swap(shmem_ctx_t ctx, T *dest,      \
                                           T cond, T value, int pe);      \
  T shmem_ctx_##NAME##_atomic_fetch_inc(shmem_ctx_t ctx, T *dest,         \
                                        int pe);                          \
  void shmem_ctx_##NAME##_atomic_inc(shmem_ctx_t ctx, T *dest, int pe);

TPUSHMEM_AMO_TYPES(TPUSHMEM_DECL_AMO)

/* extended AMOs (float/double: fetch/set/swap) */
float shmem_float_atomic_fetch(const float *source, int pe);
void shmem_float_atomic_set(float *dest, float value, int pe);
float shmem_float_atomic_swap(float *dest, float value, int pe);
double shmem_double_atomic_fetch(const double *source, int pe);
void shmem_double_atomic_set(double *dest, double value, int pe);
double shmem_double_atomic_swap(double *dest, double value, int pe);

/* bitwise AMOs */
#define TPUSHMEM_DECL_AMO_BITS(NAME, T)                                   \
  T shmem_##NAME##_atomic_fetch_and(T *dest, T value, int pe);            \
  void shmem_##NAME##_atomic_and(T *dest, T value, int pe);               \
  T shmem_##NAME##_atomic_fetch_or(T *dest, T value, int pe);             \
  void shmem_##NAME##_atomic_or(T *dest, T value, int pe);                \
  T shmem_##NAME##_atomic_fetch_xor(T *dest, T value, int pe);            \
  void shmem_##NAME##_atomic_xor(T *dest, T value, int pe);               \
  T shmem_ctx_##NAME##_atomic_fetch_and(shmem_ctx_t ctx, T *dest,         \
                                        T value, int pe);                 \
  void shmem_ctx_##NAME##_atomic_and(shmem_ctx_t ctx, T *dest, T value,   \
                                     int pe);                             \
  T shmem_ctx_##NAME##_atomic_fetch_or(shmem_ctx_t ctx, T *dest,          \
                                       T value, int pe);                  \
  void shmem_ctx_##NAME##_atomic_or(shmem_ctx_t ctx, T *dest, T value,    \
                                    int pe);                              \
  T shmem_ctx_##NAME##_atomic_fetch_xor(shmem_ctx_t ctx, T *dest,         \
                                        T value, int pe);                 \
  void shmem_ctx_##NAME##_atomic_xor(shmem_ctx_t ctx, T *dest, T value,   \
                                     int pe);

TPUSHMEM_BITWISE_TYPES(TPUSHMEM_DECL_AMO_BITS)

/* deprecated pre-1.4 atomic names (still exported by Open MPI) */
int shmem_int_fadd(int *dest, int value, int pe);
int shmem_int_finc(int *dest, int pe);
int shmem_int_cswap(int *dest, int cond, int value, int pe);
int shmem_int_swap(int *dest, int value, int pe);
long shmem_long_fadd(long *dest, long value, int pe);
long shmem_long_finc(long *dest, int pe);
long shmem_long_cswap(long *dest, long cond, long value, int pe);
long shmem_long_swap(long *dest, long value, int pe);
long long shmem_longlong_fadd(long long *dest, long long value, int pe);
long long shmem_longlong_finc(long long *dest, int pe);
float shmem_float_swap(float *dest, float value, int pe);
double shmem_double_swap(double *dest, double value, int pe);

/* point synchronization */
#define SHMEM_CMP_EQ 0
#define SHMEM_CMP_NE 1
#define SHMEM_CMP_GT 2
#define SHMEM_CMP_LE 3
#define SHMEM_CMP_LT 4
#define SHMEM_CMP_GE 5

#define TPUSHMEM_DECL_SYNC(NAME, T)                                       \
  void shmem_##NAME##_wait_until(T *ivar, int cmp, T value);              \
  void shmem_##NAME##_wait_until_all(T *ivars, size_t nelems,             \
                                     const int *status, int cmp,          \
                                     T value);                            \
  size_t shmem_##NAME##_wait_until_any(T *ivars, size_t nelems,           \
                                       const int *status, int cmp,        \
                                       T value);                          \
  size_t shmem_##NAME##_wait_until_some(T *ivars, size_t nelems,          \
                                        size_t *indices,                  \
                                        const int *status, int cmp,       \
                                        T value);                         \
  int shmem_##NAME##_test(T *ivar, int cmp, T value);                     \
  int shmem_##NAME##_test_all(T *ivars, size_t nelems, const int *status, \
                              int cmp, T value);                          \
  size_t shmem_##NAME##_test_any(T *ivars, size_t nelems,                 \
                                 const int *status, int cmp, T value);    \
  size_t shmem_##NAME##_test_some(T *ivars, size_t nelems,                \
                                  size_t *indices, const int *status,     \
                                  int cmp, T value);

TPUSHMEM_AMO_TYPES(TPUSHMEM_DECL_SYNC)

/* deprecated typed wait (until != value) */
void shmem_int_wait(int *ivar, int value);
void shmem_long_wait(long *ivar, long value);
void shmem_longlong_wait(long long *ivar, long long value);
void shmem_short_wait(short *ivar, short value);

/* distributed locks */
void shmem_set_lock(long *lock);
void shmem_clear_lock(long *lock);
int shmem_test_lock(long *lock);

/* signaled puts (OpenSHMEM 1.5) */
#define SHMEM_SIGNAL_SET 0
#define SHMEM_SIGNAL_ADD 1
void shmem_putmem_signal(void *dest, const void *source, size_t nelems,
                         uint64_t *sig_addr, uint64_t signal, int sig_op,
                         int pe);
void shmem_putmem_signal_nbi(void *dest, const void *source,
                             size_t nelems, uint64_t *sig_addr,
                             uint64_t signal, int sig_op, int pe);
uint64_t shmem_signal_fetch(const uint64_t *sig_addr);
uint64_t shmem_signal_wait_until(uint64_t *sig_addr, int cmp,
                                 uint64_t cmp_value);

/* typed + sized put-with-signal */
#define TPUSHMEM_DECL_PUT_SIGNAL(NAME, T)                                 \
  void shmem_##NAME##_put_signal(T *dest, const T *source,                \
                                 size_t nelems, uint64_t *sig_addr,       \
                                 uint64_t signal, int sig_op, int pe);    \
  void shmem_##NAME##_put_signal_nbi(T *dest, const T *source,            \
                                     size_t nelems, uint64_t *sig_addr,   \
                                     uint64_t signal, int sig_op,         \
                                     int pe);

TPUSHMEM_RMA_TYPES(TPUSHMEM_DECL_PUT_SIGNAL)

#define TPUSHMEM_DECL_PUT_SIGNAL_SIZED(BITS)                              \
  void shmem_put##BITS##_signal(void *dest, const void *source,           \
                                size_t nelems, uint64_t *sig_addr,        \
                                uint64_t signal, int sig_op, int pe);     \
  void shmem_put##BITS##_signal_nbi(void *dest, const void *source,       \
                                    size_t nelems, uint64_t *sig_addr,    \
                                    uint64_t signal, int sig_op, int pe);

TPUSHMEM_DECL_PUT_SIGNAL_SIZED(8)
TPUSHMEM_DECL_PUT_SIGNAL_SIZED(16)
TPUSHMEM_DECL_PUT_SIGNAL_SIZED(32)
TPUSHMEM_DECL_PUT_SIGNAL_SIZED(64)
TPUSHMEM_DECL_PUT_SIGNAL_SIZED(128)

/* collectives: active-set forms (any strided subset) */
void shmem_barrier(int PE_start, int logPE_stride, int PE_size,
                   long *pSync);
void shmem_sync(int PE_start, int logPE_stride, int PE_size, long *pSync);

#define TPUSHMEM_DECL_COLL_SIZED(BITS)                                    \
  void shmem_broadcast##BITS(void *dest, const void *source,              \
                             size_t nelems, int PE_root, int PE_start,    \
                             int logPE_stride, int PE_size, long *pSync); \
  void shmem_collect##BITS(void *dest, const void *source, size_t nelems, \
                           int PE_start, int logPE_stride, int PE_size,   \
                           long *pSync);                                  \
  void shmem_fcollect##BITS(void *dest, const void *source,               \
                            size_t nelems, int PE_start,                  \
                            int logPE_stride, int PE_size, long *pSync);  \
  void shmem_alltoall##BITS(void *dest, const void *source,               \
                            size_t nelems, int PE_start,                  \
                            int logPE_stride, int PE_size, long *pSync);  \
  void shmem_alltoalls##BITS(void *dest, const void *source,              \
                             ptrdiff_t dst, ptrdiff_t sst, size_t nelems, \
                             int PE_start, int logPE_stride, int PE_size, \
                             long *pSync);

TPUSHMEM_DECL_COLL_SIZED(32)
TPUSHMEM_DECL_COLL_SIZED(64)

/* active-set reductions (1.4 matrix; longdouble omitted) */
#define TPUSHMEM_DECL_TO_ALL(NAME, T, OPTOKEN)                            \
  void shmem_##NAME##_##OPTOKEN##_to_all(                                 \
      T *dest, const T *source, int nreduce, int PE_start,                \
      int logPE_stride, int PE_size, T *pWrk, long *pSync);

#define TPUSHMEM_DECL_TO_ALL_INT(NAME, T)                                 \
  TPUSHMEM_DECL_TO_ALL(NAME, T, and)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, or)                                       \
  TPUSHMEM_DECL_TO_ALL(NAME, T, xor)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, min)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, max)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, sum)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, prod)

#define TPUSHMEM_DECL_TO_ALL_FP(NAME, T)                                  \
  TPUSHMEM_DECL_TO_ALL(NAME, T, min)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, max)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, sum)                                      \
  TPUSHMEM_DECL_TO_ALL(NAME, T, prod)

TPUSHMEM_DECL_TO_ALL_INT(short, short)
TPUSHMEM_DECL_TO_ALL_INT(int, int)
TPUSHMEM_DECL_TO_ALL_INT(long, long)
TPUSHMEM_DECL_TO_ALL_INT(longlong, long long)
TPUSHMEM_DECL_TO_ALL_FP(float, float)
TPUSHMEM_DECL_TO_ALL_FP(double, double)
TPUSHMEM_DECL_TO_ALL(complexf, float _Complex, sum)
TPUSHMEM_DECL_TO_ALL(complexf, float _Complex, prod)
TPUSHMEM_DECL_TO_ALL(complexd, double _Complex, sum)
TPUSHMEM_DECL_TO_ALL(complexd, double _Complex, prod)

/* team collectives (1.5) */
int shmem_broadcastmem(shmem_team_t team, void *dest, const void *source,
                       size_t nelems, int PE_root);
int shmem_collectmem(shmem_team_t team, void *dest, const void *source,
                     size_t nelems);
int shmem_fcollectmem(shmem_team_t team, void *dest, const void *source,
                      size_t nelems);
int shmem_alltoallmem(shmem_team_t team, void *dest, const void *source,
                      size_t nelems);
int shmem_alltoallsmem(shmem_team_t team, void *dest, const void *source,
                       ptrdiff_t dst, ptrdiff_t sst, size_t nelems);

#define TPUSHMEM_DECL_TEAM_COLL(NAME, T)                                  \
  int shmem_##NAME##_broadcast(shmem_team_t team, T *dest,                \
                               const T *source, size_t nelems,            \
                               int PE_root);                              \
  int shmem_##NAME##_collect(shmem_team_t team, T *dest, const T *source, \
                             size_t nelems);                              \
  int shmem_##NAME##_fcollect(shmem_team_t team, T *dest,                 \
                              const T *source, size_t nelems);            \
  int shmem_##NAME##_alltoall(shmem_team_t team, T *dest,                 \
                              const T *source, size_t nelems);            \
  int shmem_##NAME##_alltoalls(shmem_team_t team, T *dest,                \
                               const T *source, ptrdiff_t dst,            \
                               ptrdiff_t sst, size_t nelems);

TPUSHMEM_RMA_TYPES(TPUSHMEM_DECL_TEAM_COLL)

/* team reductions (1.5; longdouble omitted) */
#define TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, OPTOKEN)                       \
  int shmem_##NAME##_##OPTOKEN##_reduce(shmem_team_t team, T *dest,       \
                                        const T *source, size_t nreduce);

#define TPUSHMEM_DECL_TEAM_REDUCE_ARITH(NAME, T)                          \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, min)                                 \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, max)                                 \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, sum)                                 \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, prod)

#define TPUSHMEM_DECL_TEAM_REDUCE_BITS(NAME, T)                           \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, and)                                 \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, or)                                  \
  TPUSHMEM_DECL_TEAM_REDUCE(NAME, T, xor)

#define TPUSHMEM_REDUCE_ARITH_TYPES(X)                                    \
  X(short, short)                                                         \
  X(int, int)                                                             \
  X(long, long)                                                           \
  X(longlong, long long)                                                  \
  X(ushort, unsigned short)                                               \
  X(uint, unsigned int)                                                   \
  X(ulong, unsigned long)                                                 \
  X(ulonglong, unsigned long long)                                        \
  X(float, float)                                                         \
  X(double, double)                                                       \
  X(int8, int8_t)                                                         \
  X(int16, int16_t)                                                       \
  X(int32, int32_t)                                                       \
  X(int64, int64_t)                                                       \
  X(uint8, uint8_t)                                                       \
  X(uint16, uint16_t)                                                     \
  X(uint32, uint32_t)                                                     \
  X(uint64, uint64_t)                                                     \
  X(size, size_t)                                                         \
  X(ptrdiff, ptrdiff_t)

#define TPUSHMEM_REDUCE_BITS_TYPES(X)                                     \
  X(uchar, unsigned char)                                                 \
  X(ushort, unsigned short)                                               \
  X(uint, unsigned int)                                                   \
  X(ulong, unsigned long)                                                 \
  X(ulonglong, unsigned long long)                                        \
  X(int8, int8_t)                                                         \
  X(int16, int16_t)                                                       \
  X(int32, int32_t)                                                       \
  X(int64, int64_t)                                                       \
  X(uint8, uint8_t)                                                       \
  X(uint16, uint16_t)                                                     \
  X(uint32, uint32_t)                                                     \
  X(uint64, uint64_t)                                                     \
  X(size, size_t)

TPUSHMEM_REDUCE_ARITH_TYPES(TPUSHMEM_DECL_TEAM_REDUCE_ARITH)
TPUSHMEM_REDUCE_BITS_TYPES(TPUSHMEM_DECL_TEAM_REDUCE_BITS)
TPUSHMEM_DECL_TEAM_REDUCE(complexf, float _Complex, sum)
TPUSHMEM_DECL_TEAM_REDUCE(complexf, float _Complex, prod)
TPUSHMEM_DECL_TEAM_REDUCE(complexd, double _Complex, sum)
TPUSHMEM_DECL_TEAM_REDUCE(complexd, double _Complex, prod)

#define SHMEM_SYNC_SIZE 1
#define SHMEM_BCAST_SYNC_SIZE 1
#define SHMEM_COLLECT_SYNC_SIZE 1
#define SHMEM_REDUCE_SYNC_SIZE 1
#define SHMEM_BARRIER_SYNC_SIZE 1
#define SHMEM_ALLTOALL_SYNC_SIZE 1
#define SHMEM_ALLTOALLS_SYNC_SIZE 1
#define SHMEM_REDUCE_MIN_WRKDATA_SIZE 1
#define SHMEM_SYNC_VALUE 0L
#define _SHMEM_SYNC_VALUE 0L

#ifdef __cplusplus
}
#endif
#endif /* TPUSHMEM_H */
