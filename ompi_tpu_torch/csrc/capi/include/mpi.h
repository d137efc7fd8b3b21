/* mpi.h — C API subset of the PyTorch/CUDA MPI framework (libtpumpi).
 *
 * ABI-compatible-in-spirit with the reference's ompi/include/mpi.h
 * (432 MPI_* entry points, SURVEY.md §2.1): handles are small integers,
 * MPI_Status is a plain struct, every MPI_* symbol is a weak alias of
 * its PMPI_* implementation so profiling tools interpose exactly as
 * they do on the reference (SURVEY.md §5 "PMPI").  Stock MPI C programs
 * (OSU-style benchmarks, hello/ring examples) compile unmodified
 * against this header and link with -ltpumpi.
 */
#ifndef TPUMPI_MPI_H
#define TPUMPI_MPI_H

#ifdef __cplusplus
extern "C" {
#endif

/* -- version ------------------------------------------------------- */
#define MPI_VERSION 3
#define MPI_SUBVERSION 1
#define TPUMPI 1

/* -- handles -------------------------------------------------------- */
typedef int MPI_Comm;
typedef int MPI_Datatype;
typedef int MPI_Op;
typedef int MPI_Request;
typedef int MPI_Errhandler;
typedef int MPI_Info;
typedef int MPI_Group;
typedef int MPI_Win;
typedef int MPI_File;
typedef long long MPI_Aint;
typedef long long MPI_Offset;
typedef long long MPI_Count;

typedef struct MPI_Status {
  int MPI_SOURCE;
  int MPI_TAG;
  int MPI_ERROR;
  long long _nbytes; /* internal: received byte count (Get_count
                      * divides by the queried datatype's size) */
} MPI_Status;

#define MPI_STATUS_IGNORE ((MPI_Status *)0)
#define MPI_STATUSES_IGNORE ((MPI_Status *)0)

/* -- communicators -------------------------------------------------- */
#define MPI_COMM_NULL ((MPI_Comm)0)
#define MPI_COMM_WORLD ((MPI_Comm)1)
#define MPI_COMM_SELF ((MPI_Comm)2)

#define MPI_GROUP_NULL ((MPI_Group)0)
#define MPI_GROUP_EMPTY ((MPI_Group)1)

#define MPI_REQUEST_NULL ((MPI_Request)0)

/* -- wildcards / sentinels ------------------------------------------ */
#define MPI_ANY_SOURCE (-1)
#define MPI_ANY_TAG (-1)
#define MPI_PROC_NULL (-2)
#define MPI_ROOT (-3)
#define MPI_UNDEFINED (-32766)
#define MPI_IN_PLACE ((void *)-1)
#define MPI_BOTTOM ((void *)0)
#define MPI_MAX_PROCESSOR_NAME 256
#define MPI_MAX_ERROR_STRING 256
#define MPI_MAX_OBJECT_NAME 64
#define MPI_MAX_LIBRARY_VERSION_STRING 256

/* -- datatypes (codes mirrored in ompi_tpu_torch/capi.py) ----------- */
#define MPI_DATATYPE_NULL ((MPI_Datatype)0)
#define MPI_CHAR ((MPI_Datatype)1)
#define MPI_SIGNED_CHAR ((MPI_Datatype)2)
#define MPI_UNSIGNED_CHAR ((MPI_Datatype)3)
#define MPI_BYTE ((MPI_Datatype)4)
#define MPI_SHORT ((MPI_Datatype)5)
#define MPI_UNSIGNED_SHORT ((MPI_Datatype)6)
#define MPI_INT ((MPI_Datatype)7)
#define MPI_UNSIGNED ((MPI_Datatype)8)
#define MPI_LONG ((MPI_Datatype)9)
#define MPI_UNSIGNED_LONG ((MPI_Datatype)10)
#define MPI_LONG_LONG_INT ((MPI_Datatype)11)
#define MPI_LONG_LONG MPI_LONG_LONG_INT
#define MPI_UNSIGNED_LONG_LONG ((MPI_Datatype)12)
#define MPI_FLOAT ((MPI_Datatype)13)
#define MPI_DOUBLE ((MPI_Datatype)14)
#define MPI_C_BOOL ((MPI_Datatype)16)
#define MPI_INT8_T ((MPI_Datatype)17)
#define MPI_INT16_T ((MPI_Datatype)18)
#define MPI_INT32_T ((MPI_Datatype)19)
#define MPI_INT64_T ((MPI_Datatype)20)
#define MPI_UINT8_T ((MPI_Datatype)21)
#define MPI_UINT16_T ((MPI_Datatype)22)
#define MPI_UINT32_T ((MPI_Datatype)23)
#define MPI_UINT64_T ((MPI_Datatype)24)
#define MPI_C_FLOAT_COMPLEX ((MPI_Datatype)25)
#define MPI_C_DOUBLE_COMPLEX ((MPI_Datatype)26)
#define MPI_WCHAR ((MPI_Datatype)27)
#define MPI_AINT ((MPI_Datatype)20) /* int64 */
#define MPI_OFFSET ((MPI_Datatype)20)
#define MPI_COUNT ((MPI_Datatype)20)
/* pair types for MAXLOC/MINLOC */
#define MPI_FLOAT_INT ((MPI_Datatype)28)
#define MPI_DOUBLE_INT ((MPI_Datatype)29)
#define MPI_LONG_INT ((MPI_Datatype)30)
#define MPI_2INT ((MPI_Datatype)31)
#define MPI_SHORT_INT ((MPI_Datatype)32)

/* -- ops (codes mirrored in ompi_tpu_torch/capi.py) ----------------- */
#define MPI_OP_NULL ((MPI_Op)0)
#define MPI_SUM ((MPI_Op)1)
#define MPI_MAX ((MPI_Op)2)
#define MPI_MIN ((MPI_Op)3)
#define MPI_PROD ((MPI_Op)4)
#define MPI_LAND ((MPI_Op)5)
#define MPI_LOR ((MPI_Op)6)
#define MPI_LXOR ((MPI_Op)7)
#define MPI_BAND ((MPI_Op)8)
#define MPI_BOR ((MPI_Op)9)
#define MPI_BXOR ((MPI_Op)10)
#define MPI_MAXLOC ((MPI_Op)11)
#define MPI_MINLOC ((MPI_Op)12)
#define MPI_REPLACE ((MPI_Op)13)
#define MPI_NO_OP ((MPI_Op)14)

/* -- error classes --------------------------------------------------- */
#define MPI_SUCCESS 0
#define MPI_ERR_BUFFER 1
#define MPI_ERR_COUNT 2
#define MPI_ERR_TYPE 3
#define MPI_ERR_TAG 4
#define MPI_ERR_COMM 5
#define MPI_ERR_RANK 6
#define MPI_ERR_REQUEST 7
#define MPI_ERR_ROOT 8
#define MPI_ERR_OP 9
#define MPI_ERR_ARG 12
#define MPI_ERR_UNKNOWN 13
#define MPI_ERR_TRUNCATE 14
#define MPI_ERR_OTHER 15
#define MPI_ERR_INTERN 16
#define MPI_ERR_UNSUPPORTED_OPERATION 52
#define MPI_ERR_LASTCODE 92

#define MPI_ERRHANDLER_NULL ((MPI_Errhandler)0)
#define MPI_ERRORS_ARE_FATAL ((MPI_Errhandler)1)
#define MPI_ERRORS_RETURN ((MPI_Errhandler)2)

/* comm/group comparison results */
#define MPI_IDENT 0
#define MPI_CONGRUENT 1
#define MPI_SIMILAR 2
#define MPI_UNEQUAL 3

#define MPI_THREAD_SINGLE 0
#define MPI_THREAD_FUNNELED 1
#define MPI_THREAD_SERIALIZED 2
#define MPI_THREAD_MULTIPLE 3

/* -- prototypes: every MPI_* has a PMPI_* twin ---------------------- */
#define TPUMPI_PROTO(ret, name, args) \
  ret MPI_##name args;                \
  ret PMPI_##name args;

TPUMPI_PROTO(int, Init, (int *argc, char ***argv))
TPUMPI_PROTO(int, Init_thread,
             (int *argc, char ***argv, int required, int *provided))
TPUMPI_PROTO(int, Finalize, (void))
TPUMPI_PROTO(int, Initialized, (int *flag))
TPUMPI_PROTO(int, Finalized, (int *flag))
TPUMPI_PROTO(int, Abort, (MPI_Comm comm, int errorcode))
TPUMPI_PROTO(int, Comm_size, (MPI_Comm comm, int *size))
TPUMPI_PROTO(int, Comm_rank, (MPI_Comm comm, int *rank))
TPUMPI_PROTO(int, Comm_dup, (MPI_Comm comm, MPI_Comm *newcomm))
TPUMPI_PROTO(int, Comm_split,
             (MPI_Comm comm, int color, int key, MPI_Comm *newcomm))
TPUMPI_PROTO(int, Comm_free, (MPI_Comm *comm))
TPUMPI_PROTO(int, Comm_set_name, (MPI_Comm comm, const char *name))
TPUMPI_PROTO(int, Get_processor_name, (char *name, int *resultlen))
TPUMPI_PROTO(int, Get_version, (int *version, int *subversion))
TPUMPI_PROTO(int, Error_string, (int errorcode, char *string, int *resultlen))
TPUMPI_PROTO(int, Type_size, (MPI_Datatype datatype, int *size))
TPUMPI_PROTO(int, Get_count,
             (const MPI_Status *status, MPI_Datatype datatype, int *count))
TPUMPI_PROTO(double, Wtime, (void))
TPUMPI_PROTO(double, Wtick, (void))

TPUMPI_PROTO(int, Comm_get_name,
             (MPI_Comm comm, char *comm_name, int *resultlen))
TPUMPI_PROTO(int, Error_class, (int errorcode, int *errorclass))
TPUMPI_PROTO(int, Get_library_version, (char *version, int *resultlen))
TPUMPI_PROTO(int, Get_address, (const void *location, MPI_Aint *address))

/* pt2pt */
TPUMPI_PROTO(int, Probe, (int source, int tag, MPI_Comm comm,
                          MPI_Status *status))
TPUMPI_PROTO(int, Iprobe, (int source, int tag, MPI_Comm comm, int *flag,
                           MPI_Status *status))
TPUMPI_PROTO(int, Bsend, (const void *buf, int count, MPI_Datatype datatype,
                          int dest, int tag, MPI_Comm comm))
TPUMPI_PROTO(int, Rsend, (const void *buf, int count, MPI_Datatype datatype,
                          int dest, int tag, MPI_Comm comm))
TPUMPI_PROTO(int, Buffer_attach, (void *buffer, int size))
TPUMPI_PROTO(int, Buffer_detach, (void *buffer_addr, int *size))
TPUMPI_PROTO(int, Type_dup, (MPI_Datatype oldtype, MPI_Datatype *newtype))

TPUMPI_PROTO(int, Send, (const void *buf, int count, MPI_Datatype datatype,
                         int dest, int tag, MPI_Comm comm))
TPUMPI_PROTO(int, Recv, (void *buf, int count, MPI_Datatype datatype,
                         int source, int tag, MPI_Comm comm,
                         MPI_Status *status))
TPUMPI_PROTO(int, Isend, (const void *buf, int count, MPI_Datatype datatype,
                          int dest, int tag, MPI_Comm comm,
                          MPI_Request *request))
TPUMPI_PROTO(int, Irecv, (void *buf, int count, MPI_Datatype datatype,
                          int source, int tag, MPI_Comm comm,
                          MPI_Request *request))
TPUMPI_PROTO(int, Sendrecv,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              int dest, int sendtag, void *recvbuf, int recvcount,
              MPI_Datatype recvtype, int source, int recvtag, MPI_Comm comm,
              MPI_Status *status))

/* requests */
TPUMPI_PROTO(int, Wait, (MPI_Request *request, MPI_Status *status))
TPUMPI_PROTO(int, Waitall,
             (int count, MPI_Request requests[], MPI_Status statuses[]))
TPUMPI_PROTO(int, Test, (MPI_Request *request, int *flag, MPI_Status *status))
TPUMPI_PROTO(int, Testall, (int count, MPI_Request requests[], int *flag,
                            MPI_Status statuses[]))
TPUMPI_PROTO(int, Waitany, (int count, MPI_Request requests[], int *index,
                            MPI_Status *status))
TPUMPI_PROTO(int, Testany, (int count, MPI_Request requests[], int *index,
                            int *flag, MPI_Status *status))
TPUMPI_PROTO(int, Waitsome,
             (int incount, MPI_Request requests[], int *outcount,
              int indices[], MPI_Status statuses[]))

/* groups + comm construction */
TPUMPI_PROTO(int, Comm_group, (MPI_Comm comm, MPI_Group *group))
TPUMPI_PROTO(int, Group_size, (MPI_Group group, int *size))
TPUMPI_PROTO(int, Group_rank, (MPI_Group group, int *rank))
TPUMPI_PROTO(int, Group_free, (MPI_Group *group))
TPUMPI_PROTO(int, Group_incl,
             (MPI_Group group, int n, const int ranks[], MPI_Group *newgroup))
TPUMPI_PROTO(int, Group_excl,
             (MPI_Group group, int n, const int ranks[], MPI_Group *newgroup))
TPUMPI_PROTO(int, Group_union,
             (MPI_Group group1, MPI_Group group2, MPI_Group *newgroup))
TPUMPI_PROTO(int, Group_intersection,
             (MPI_Group group1, MPI_Group group2, MPI_Group *newgroup))
TPUMPI_PROTO(int, Group_difference,
             (MPI_Group group1, MPI_Group group2, MPI_Group *newgroup))
TPUMPI_PROTO(int, Group_translate_ranks,
             (MPI_Group group1, int n, const int ranks1[], MPI_Group group2,
              int ranks2[]))
TPUMPI_PROTO(int, Group_compare,
             (MPI_Group group1, MPI_Group group2, int *result))
TPUMPI_PROTO(int, Comm_create,
             (MPI_Comm comm, MPI_Group group, MPI_Comm *newcomm))
TPUMPI_PROTO(int, Comm_create_group,
             (MPI_Comm comm, MPI_Group group, int tag, MPI_Comm *newcomm))
TPUMPI_PROTO(int, Comm_compare,
             (MPI_Comm comm1, MPI_Comm comm2, int *result))

/* cartesian topology */
TPUMPI_PROTO(int, Dims_create, (int nnodes, int ndims, int dims[]))
TPUMPI_PROTO(int, Cart_create,
             (MPI_Comm comm, int ndims, const int dims[], const int periods[],
              int reorder, MPI_Comm *comm_cart))
TPUMPI_PROTO(int, Cartdim_get, (MPI_Comm comm, int *ndims))
TPUMPI_PROTO(int, Cart_get, (MPI_Comm comm, int maxdims, int dims[],
                             int periods[], int coords[]))
TPUMPI_PROTO(int, Cart_rank, (MPI_Comm comm, const int coords[], int *rank))
TPUMPI_PROTO(int, Cart_coords,
             (MPI_Comm comm, int rank, int maxdims, int coords[]))
TPUMPI_PROTO(int, Cart_shift, (MPI_Comm comm, int direction, int disp,
                               int *rank_source, int *rank_dest))

TPUMPI_PROTO(int, Graph_create,
             (MPI_Comm comm, int nnodes, const int index[], const int edges[],
              int reorder, MPI_Comm *comm_graph))
TPUMPI_PROTO(int, Graphdims_get, (MPI_Comm comm, int *nnodes, int *nedges))
TPUMPI_PROTO(int, Graph_neighbors_count,
             (MPI_Comm comm, int rank, int *nneighbors))
TPUMPI_PROTO(int, Graph_neighbors,
             (MPI_Comm comm, int rank, int maxneighbors, int neighbors[]))

/* MPI_T tool interface (int-flavored subset: the cvar/pvar
 * enumeration + read surface tools actually script against) */
typedef int MPI_T_pvar_session;
typedef int MPI_T_cvar_handle;
typedef int MPI_T_pvar_handle;
TPUMPI_PROTO(int, T_pvar_session_create, (MPI_T_pvar_session * session))
TPUMPI_PROTO(int, T_pvar_session_free, (MPI_T_pvar_session * session))
TPUMPI_PROTO(int, T_pvar_handle_alloc,
             (MPI_T_pvar_session session, int pvar_index, void *obj_handle,
              MPI_T_pvar_handle *handle, int *count))
TPUMPI_PROTO(int, T_pvar_handle_free,
             (MPI_T_pvar_session session, MPI_T_pvar_handle *handle))
TPUMPI_PROTO(int, T_pvar_start,
             (MPI_T_pvar_session session, MPI_T_pvar_handle handle))
TPUMPI_PROTO(int, T_pvar_stop,
             (MPI_T_pvar_session session, MPI_T_pvar_handle handle))
TPUMPI_PROTO(int, T_init_thread, (int required, int *provided))
TPUMPI_PROTO(int, T_finalize, (void))
TPUMPI_PROTO(int, T_cvar_get_num, (int *num_cvar))
TPUMPI_PROTO(int, T_cvar_get_name, (int cvar_index, char *name, int *name_len))
TPUMPI_PROTO(int, T_cvar_read_int, (int cvar_index, int *value))
TPUMPI_PROTO(int, T_cvar_get_index, (const char *name, int *cvar_index))
TPUMPI_PROTO(int, T_pvar_get_num, (int *num_pvar))
TPUMPI_PROTO(int, T_pvar_read_int, (int pvar_index, long long *value))
TPUMPI_PROTO(int, T_pvar_get_index, (const char *name, int *pvar_index))

/* MPI-IO */
#define MPI_FILE_NULL ((MPI_File)0)
#define MPI_MODE_CREATE 1
#define MPI_MODE_RDONLY 2
#define MPI_MODE_WRONLY 4
#define MPI_MODE_RDWR 8
#define MPI_MODE_DELETE_ON_CLOSE 16
#define MPI_MODE_UNIQUE_OPEN 32
#define MPI_MODE_EXCL 64
#define MPI_MODE_APPEND 128
#define MPI_MODE_SEQUENTIAL 256
#define MPI_SEEK_SET 600
#define MPI_SEEK_CUR 602
#define MPI_SEEK_END 604
TPUMPI_PROTO(int, File_open,
             (MPI_Comm comm, const char *filename, int amode, MPI_Info info,
              MPI_File *fh))
TPUMPI_PROTO(int, File_close, (MPI_File * fh))
TPUMPI_PROTO(int, File_get_size, (MPI_File fh, MPI_Offset *size))
TPUMPI_PROTO(int, File_set_size, (MPI_File fh, MPI_Offset size))
TPUMPI_PROTO(int, File_seek, (MPI_File fh, MPI_Offset offset, int whence))
TPUMPI_PROTO(int, File_write_at,
             (MPI_File fh, MPI_Offset offset, const void *buf, int count,
              MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO(int, File_read_at,
             (MPI_File fh, MPI_Offset offset, void *buf, int count,
              MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO(int, File_write,
             (MPI_File fh, const void *buf, int count, MPI_Datatype datatype,
              MPI_Status *status))
TPUMPI_PROTO(int, File_read, (MPI_File fh, void *buf, int count,
                              MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO(int, File_write_at_all,
             (MPI_File fh, MPI_Offset offset, const void *buf, int count,
              MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO(int, File_read_at_all,
             (MPI_File fh, MPI_Offset offset, void *buf, int count,
              MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO(int, File_set_view,
             (MPI_File fh, MPI_Offset disp, MPI_Datatype etype,
              MPI_Datatype filetype, const char *datarep, MPI_Info info))

/* one-sided (RMA) */
#define MPI_WIN_NULL ((MPI_Win)0)
#define MPI_LOCK_SHARED 1
#define MPI_LOCK_EXCLUSIVE 2
#define MPI_MODE_NOCHECK 1024
TPUMPI_PROTO(int, Win_create,
             (void *base, MPI_Aint size, int disp_unit, MPI_Info info,
              MPI_Comm comm, MPI_Win *win))
TPUMPI_PROTO(int, Win_free, (MPI_Win * win))
TPUMPI_PROTO(int, Win_fence, (int assertion, MPI_Win win))
TPUMPI_PROTO(int, Put,
             (const void *origin_addr, int origin_count,
              MPI_Datatype origin_datatype, int target_rank,
              MPI_Aint target_disp, int target_count,
              MPI_Datatype target_datatype, MPI_Win win))
TPUMPI_PROTO(int, Get,
             (void *origin_addr, int origin_count,
              MPI_Datatype origin_datatype, int target_rank,
              MPI_Aint target_disp, int target_count,
              MPI_Datatype target_datatype, MPI_Win win))
TPUMPI_PROTO(int, Accumulate,
             (const void *origin_addr, int origin_count,
              MPI_Datatype origin_datatype, int target_rank,
              MPI_Aint target_disp, int target_count,
              MPI_Datatype target_datatype, MPI_Op op, MPI_Win win))
TPUMPI_PROTO(int, Fetch_and_op,
             (const void *origin_addr, void *result_addr,
              MPI_Datatype datatype, int target_rank, MPI_Aint target_disp,
              MPI_Op op, MPI_Win win))
TPUMPI_PROTO(int, Win_lock,
             (int lock_type, int rank, int assertion, MPI_Win win))
TPUMPI_PROTO(int, Win_unlock, (int rank, MPI_Win win))
TPUMPI_PROTO(int, Win_flush, (int rank, MPI_Win win))

/* user-defined reduction operations */
typedef void(MPI_User_function)(void *invec, void *inoutvec, int *len,
                                MPI_Datatype *datatype);
#define MPI_COMM_TYPE_SHARED 1
TPUMPI_PROTO(int, Op_create,
             (MPI_User_function * user_fn, int commute, MPI_Op *op))
TPUMPI_PROTO(int, Op_free, (MPI_Op * op))
TPUMPI_PROTO(int, Comm_split_type,
             (MPI_Comm comm, int split_type, int key, MPI_Info info,
              MPI_Comm *newcomm))
TPUMPI_PROTO(int, Type_create_struct,
             (int count, const int blocklengths[],
              const MPI_Aint displacements[], const MPI_Datatype types[],
              MPI_Datatype *newtype))
TPUMPI_PROTO(int, Reduce_scatter,
             (const void *sendbuf, void *recvbuf, const int recvcounts[],
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm))

/* dynamic process management */
#define MPI_INFO_NULL ((MPI_Info)0)
#define MPI_ARGV_NULL ((char **)0)
#define MPI_ERRCODES_IGNORE ((int *)0)
TPUMPI_PROTO(int, Comm_spawn,
             (const char *command, char *argv[], int maxprocs, MPI_Info info,
              int root, MPI_Comm comm, MPI_Comm *intercomm,
              int array_of_errcodes[]))
TPUMPI_PROTO(int, Comm_get_parent, (MPI_Comm *parent))
TPUMPI_PROTO(int, Intercomm_merge,
             (MPI_Comm intercomm, int high, MPI_Comm *newintracomm))
TPUMPI_PROTO(int, Comm_remote_size, (MPI_Comm comm, int *size))

/* errhandlers */
TPUMPI_PROTO(int, Comm_set_errhandler,
             (MPI_Comm comm, MPI_Errhandler errhandler))
TPUMPI_PROTO(int, Comm_get_errhandler,
             (MPI_Comm comm, MPI_Errhandler *errhandler))
TPUMPI_PROTO(int, Errhandler_free, (MPI_Errhandler *errhandler))

/* derived datatypes */
TPUMPI_PROTO(int, Type_contiguous,
             (int count, MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO(int, Type_vector,
             (int count, int blocklength, int stride, MPI_Datatype oldtype,
              MPI_Datatype *newtype))
TPUMPI_PROTO(int, Type_indexed,
             (int count, const int blocklengths[], const int displacements[],
              MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO(int, Type_commit, (MPI_Datatype *datatype))
TPUMPI_PROTO(int, Type_free, (MPI_Datatype *datatype))
TPUMPI_PROTO(int, Type_get_extent,
             (MPI_Datatype datatype, MPI_Aint *lb, MPI_Aint *extent))

/* collectives: blocking */
TPUMPI_PROTO(int, Barrier, (MPI_Comm comm))
TPUMPI_PROTO(int, Bcast, (void *buffer, int count, MPI_Datatype datatype,
                          int root, MPI_Comm comm))
TPUMPI_PROTO(int, Reduce,
             (const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype datatype, MPI_Op op, int root, MPI_Comm comm))
TPUMPI_PROTO(int, Allreduce,
             (const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm))
TPUMPI_PROTO(int, Allgather,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype,
              MPI_Comm comm))
TPUMPI_PROTO(int, Gather,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
              MPI_Comm comm))
TPUMPI_PROTO(int, Scatter,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
              MPI_Comm comm))
TPUMPI_PROTO(int, Alltoall,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype,
              MPI_Comm comm))
TPUMPI_PROTO(int, Reduce_scatter_block,
             (const void *sendbuf, void *recvbuf, int recvcount,
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm))
TPUMPI_PROTO(int, Scan,
             (const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm))
TPUMPI_PROTO(int, Exscan,
             (const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm))
TPUMPI_PROTO(int, Allgatherv,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, const int recvcounts[], const int displs[],
              MPI_Datatype recvtype, MPI_Comm comm))
TPUMPI_PROTO(int, Gatherv,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, const int recvcounts[], const int displs[],
              MPI_Datatype recvtype, int root, MPI_Comm comm))
TPUMPI_PROTO(int, Scatterv,
             (const void *sendbuf, const int sendcounts[], const int displs[],
              MPI_Datatype sendtype, void *recvbuf, int recvcount,
              MPI_Datatype recvtype, int root, MPI_Comm comm))

/* collectives: non-blocking */
TPUMPI_PROTO(int, Ibarrier, (MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO(int, Ibcast, (void *buffer, int count, MPI_Datatype datatype,
                           int root, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO(int, Iallreduce,
             (const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
              MPI_Request *request))
TPUMPI_PROTO(int, Iallgather,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype,
              MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO(int, Ialltoall,
             (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
              void *recvbuf, int recvcount, MPI_Datatype recvtype,
              MPI_Comm comm, MPI_Request *request))

/* ================================================================== */
/* Round-3 breadth: pack/unpack, attributes, Info, persistent p2p,     */
/* matched probe, topology, RMA/IO extensions (conformance surface).   */
/* ================================================================== */

typedef int MPI_Message;
#define MPI_MESSAGE_NULL ((MPI_Message)0)
#define MPI_MESSAGE_NO_PROC ((MPI_Message)-1)

/* predefined attribute keyvals (values mirrored in capi.py) */
#define MPI_KEYVAL_INVALID (-1)
#define MPI_TAG_UB 1
#define MPI_HOST 2
#define MPI_IO 3
#define MPI_WTIME_IS_GLOBAL 4
#define MPI_WIN_BASE 5
#define MPI_WIN_SIZE 6
#define MPI_WIN_DISP_UNIT 7
#define MPI_UNIVERSE_SIZE 9
#define MPI_APPNUM 11

#define MPI_MAX_INFO_KEY 256
#define MPI_MAX_INFO_VAL 1024
#define MPI_MAX_PORT_NAME 256
#define MPI_BSEND_OVERHEAD 128

#define MPI_ORDER_C 56
#define MPI_ORDER_FORTRAN 57

/* topology types (MPI_Topo_test) */
#define MPI_GRAPH 1
#define MPI_CART 2
#define MPI_DIST_GRAPH 3

#define MPI_UNWEIGHTED ((int *)2)
#define MPI_WEIGHTS_EMPTY ((int *)3)

/* attribute copy/delete callback types + predefined functions */
typedef int(MPI_Comm_copy_attr_function)(MPI_Comm, int, void *, void *,
                                         void *, int *);
typedef int(MPI_Comm_delete_attr_function)(MPI_Comm, int, void *, void *);
typedef MPI_Comm_copy_attr_function MPI_Copy_function;
typedef MPI_Comm_delete_attr_function MPI_Delete_function;
typedef int(MPI_Type_copy_attr_function)(MPI_Datatype, int, void *, void *,
                                         void *, int *);
typedef int(MPI_Type_delete_attr_function)(MPI_Datatype, int, void *, void *);
typedef int(MPI_Win_copy_attr_function)(MPI_Win, int, void *, void *,
                                        void *, int *);
typedef int(MPI_Win_delete_attr_function)(MPI_Win, int, void *, void *);
typedef int(MPI_Grequest_query_function)(void *, MPI_Status *);
typedef int(MPI_Grequest_free_function)(void *);
typedef int(MPI_Grequest_cancel_function)(void *, int);

/* predefined copy/delete fns: REAL exported symbols (the same 13 the
 * reference libmpi exports; the shim also still honors the historical
 * sentinel addresses 0/1 for binaries built against older headers). */
extern int MPI_COMM_NULL_COPY_FN(MPI_Comm, int, void *, void *, void *,
                                 int *);
extern int MPI_COMM_DUP_FN(MPI_Comm, int, void *, void *, void *, int *);
extern int MPI_COMM_NULL_DELETE_FN(MPI_Comm, int, void *, void *);
extern int MPI_NULL_COPY_FN(MPI_Comm, int, void *, void *, void *, int *);
extern int MPI_DUP_FN(MPI_Comm, int, void *, void *, void *, int *);
extern int MPI_NULL_DELETE_FN(MPI_Comm, int, void *, void *);
extern int MPI_TYPE_NULL_COPY_FN(MPI_Datatype, int, void *, void *, void *,
                                 int *);
extern int MPI_TYPE_DUP_FN(MPI_Datatype, int, void *, void *, void *, int *);
extern int MPI_TYPE_NULL_DELETE_FN(MPI_Datatype, int, void *, void *);
extern int MPI_WIN_NULL_COPY_FN(MPI_Win, int, void *, void *, void *, int *);
extern int MPI_WIN_DUP_FN(MPI_Win, int, void *, void *, void *, int *);
extern int MPI_WIN_NULL_DELETE_FN(MPI_Win, int, void *, void *);

#define TPUMPI_PROTO2(ret, name, args) \
  ret MPI_##name args;                 \
  ret PMPI_##name args;

/* pack/unpack */
TPUMPI_PROTO2(int, Pack,
              (const void *inbuf, int incount, MPI_Datatype datatype,
               void *outbuf, int outsize, int *position, MPI_Comm comm))
TPUMPI_PROTO2(int, Unpack,
              (const void *inbuf, int insize, int *position, void *outbuf,
               int outcount, MPI_Datatype datatype, MPI_Comm comm))
TPUMPI_PROTO2(int, Pack_size, (int incount, MPI_Datatype datatype,
                               MPI_Comm comm, int *size))
TPUMPI_PROTO2(int, Pack_external,
              (const char *datarep, const void *inbuf, int incount,
               MPI_Datatype datatype, void *outbuf, MPI_Aint outsize,
               MPI_Aint *position))
TPUMPI_PROTO2(int, Unpack_external,
              (const char *datarep, const void *inbuf, MPI_Aint insize,
               MPI_Aint *position, void *outbuf, int outcount,
               MPI_Datatype datatype))
TPUMPI_PROTO2(int, Pack_external_size,
              (const char *datarep, int incount, MPI_Datatype datatype,
               MPI_Aint *size))

/* local reduction + op introspection */
TPUMPI_PROTO2(int, Reduce_local,
              (const void *inbuf, void *inoutbuf, int count,
               MPI_Datatype datatype, MPI_Op op))
TPUMPI_PROTO2(int, Op_commutative, (MPI_Op op, int *commute))

/* p2p breadth */
TPUMPI_PROTO2(int, Sendrecv_replace,
              (void *buf, int count, MPI_Datatype datatype, int dest,
               int sendtag, int source, int recvtag, MPI_Comm comm,
               MPI_Status *status))
TPUMPI_PROTO2(int, Ssend, (const void *buf, int count, MPI_Datatype datatype,
                           int dest, int tag, MPI_Comm comm))
TPUMPI_PROTO2(int, Ibsend, (const void *buf, int count,
                            MPI_Datatype datatype, int dest, int tag,
                            MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Irsend, (const void *buf, int count,
                            MPI_Datatype datatype, int dest, int tag,
                            MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Issend, (const void *buf, int count,
                            MPI_Datatype datatype, int dest, int tag,
                            MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Testsome,
              (int incount, MPI_Request requests[], int *outcount,
               int indices[], MPI_Status statuses[]))
TPUMPI_PROTO2(int, Cancel, (MPI_Request *request))
TPUMPI_PROTO2(int, Test_cancelled, (const MPI_Status *status, int *flag))
TPUMPI_PROTO2(int, Request_free, (MPI_Request *request))
TPUMPI_PROTO2(int, Request_get_status,
              (MPI_Request request, int *flag, MPI_Status *status))

/* persistent p2p */
TPUMPI_PROTO2(int, Send_init,
              (const void *buf, int count, MPI_Datatype datatype, int dest,
               int tag, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Bsend_init,
              (const void *buf, int count, MPI_Datatype datatype, int dest,
               int tag, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Rsend_init,
              (const void *buf, int count, MPI_Datatype datatype, int dest,
               int tag, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Ssend_init,
              (const void *buf, int count, MPI_Datatype datatype, int dest,
               int tag, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Recv_init,
              (void *buf, int count, MPI_Datatype datatype, int source,
               int tag, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Start, (MPI_Request *request))
TPUMPI_PROTO2(int, Startall, (int count, MPI_Request requests[]))

/* MPI-4 persistent collectives (schedule compiled at init, replayed
 * by MPI_Start with zero per-call planning) */
TPUMPI_PROTO2(int, Allreduce_init,
              (const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
               MPI_Info info, MPI_Request *request))
TPUMPI_PROTO2(int, Bcast_init,
              (void *buffer, int count, MPI_Datatype datatype, int root,
               MPI_Comm comm, MPI_Info info, MPI_Request *request))
TPUMPI_PROTO2(int, Allgather_init,
              (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype,
               MPI_Comm comm, MPI_Info info, MPI_Request *request))
TPUMPI_PROTO2(int, Reduce_init,
              (const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype datatype, MPI_Op op, int root, MPI_Comm comm,
               MPI_Info info, MPI_Request *request))
TPUMPI_PROTO2(int, Barrier_init,
              (MPI_Comm comm, MPI_Info info, MPI_Request *request))

/* matched probe */
TPUMPI_PROTO2(int, Mprobe, (int source, int tag, MPI_Comm comm,
                            MPI_Message *message, MPI_Status *status))
TPUMPI_PROTO2(int, Improbe, (int source, int tag, MPI_Comm comm, int *flag,
                             MPI_Message *message, MPI_Status *status))
TPUMPI_PROTO2(int, Mrecv, (void *buf, int count, MPI_Datatype datatype,
                           MPI_Message *message, MPI_Status *status))
TPUMPI_PROTO2(int, Imrecv, (void *buf, int count, MPI_Datatype datatype,
                            MPI_Message *message, MPI_Request *request))

/* v/i collectives */
TPUMPI_PROTO2(int, Alltoallv,
              (const void *sendbuf, const int sendcounts[],
               const int sdispls[], MPI_Datatype sendtype, void *recvbuf,
               const int recvcounts[], const int rdispls[],
               MPI_Datatype recvtype, MPI_Comm comm))
TPUMPI_PROTO2(int, Ireduce,
              (const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype datatype, MPI_Op op, int root, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Iscan,
              (const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Iexscan,
              (const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Igather,
              (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
               MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Iscatter,
              (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
               MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Igatherv,
              (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, const int recvcounts[], const int displs[],
               MPI_Datatype recvtype, int root, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Iscatterv,
              (const void *sendbuf, const int sendcounts[],
               const int displs[], MPI_Datatype sendtype, void *recvbuf,
               int recvcount, MPI_Datatype recvtype, int root, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Iallgatherv,
              (const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, const int recvcounts[], const int displs[],
               MPI_Datatype recvtype, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Ialltoallv,
              (const void *sendbuf, const int sendcounts[],
               const int sdispls[], MPI_Datatype sendtype, void *recvbuf,
               const int recvcounts[], const int rdispls[],
               MPI_Datatype recvtype, MPI_Comm comm, MPI_Request *request))
TPUMPI_PROTO2(int, Ireduce_scatter,
              (const void *sendbuf, void *recvbuf, const int recvcounts[],
               MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
               MPI_Request *request))
TPUMPI_PROTO2(int, Ireduce_scatter_block,
              (const void *sendbuf, void *recvbuf, int recvcount,
               MPI_Datatype datatype, MPI_Op op, MPI_Comm comm,
               MPI_Request *request))

/* attributes / keyvals */
TPUMPI_PROTO2(int, Comm_create_keyval,
              (MPI_Comm_copy_attr_function *comm_copy_attr_fn,
               MPI_Comm_delete_attr_function *comm_delete_attr_fn,
               int *comm_keyval, void *extra_state))
TPUMPI_PROTO2(int, Comm_free_keyval, (int *comm_keyval))
TPUMPI_PROTO2(int, Comm_set_attr, (MPI_Comm comm, int comm_keyval,
                                   void *attribute_val))
TPUMPI_PROTO2(int, Comm_get_attr, (MPI_Comm comm, int comm_keyval,
                                   void *attribute_val, int *flag))
TPUMPI_PROTO2(int, Comm_delete_attr, (MPI_Comm comm, int comm_keyval))
TPUMPI_PROTO2(int, Keyval_create,
              (MPI_Copy_function *copy_fn, MPI_Delete_function *delete_fn,
               int *keyval, void *extra_state))
TPUMPI_PROTO2(int, Keyval_free, (int *keyval))
TPUMPI_PROTO2(int, Attr_put, (MPI_Comm comm, int keyval, void *attribute_val))
TPUMPI_PROTO2(int, Attr_get, (MPI_Comm comm, int keyval, void *attribute_val,
                              int *flag))
TPUMPI_PROTO2(int, Attr_delete, (MPI_Comm comm, int keyval))
TPUMPI_PROTO2(int, Type_create_keyval,
              (MPI_Type_copy_attr_function *type_copy_attr_fn,
               MPI_Type_delete_attr_function *type_delete_attr_fn,
               int *type_keyval, void *extra_state))
TPUMPI_PROTO2(int, Type_free_keyval, (int *type_keyval))
TPUMPI_PROTO2(int, Type_set_attr, (MPI_Datatype datatype, int type_keyval,
                                   void *attribute_val))
TPUMPI_PROTO2(int, Type_get_attr, (MPI_Datatype datatype, int type_keyval,
                                   void *attribute_val, int *flag))
TPUMPI_PROTO2(int, Type_delete_attr, (MPI_Datatype datatype, int type_keyval))
TPUMPI_PROTO2(int, Win_create_keyval,
              (MPI_Win_copy_attr_function *win_copy_attr_fn,
               MPI_Win_delete_attr_function *win_delete_attr_fn,
               int *win_keyval, void *extra_state))
TPUMPI_PROTO2(int, Win_free_keyval, (int *win_keyval))
TPUMPI_PROTO2(int, Win_set_attr, (MPI_Win win, int win_keyval,
                                  void *attribute_val))
TPUMPI_PROTO2(int, Win_get_attr, (MPI_Win win, int win_keyval,
                                  void *attribute_val, int *flag))
TPUMPI_PROTO2(int, Win_delete_attr, (MPI_Win win, int win_keyval))

/* Info objects */
TPUMPI_PROTO2(int, Info_create, (MPI_Info * info))
TPUMPI_PROTO2(int, Info_set, (MPI_Info info, const char *key,
                              const char *value))
TPUMPI_PROTO2(int, Info_get, (MPI_Info info, const char *key, int valuelen,
                              char *value, int *flag))
TPUMPI_PROTO2(int, Info_get_valuelen, (MPI_Info info, const char *key,
                                       int *valuelen, int *flag))
TPUMPI_PROTO2(int, Info_delete, (MPI_Info info, const char *key))
TPUMPI_PROTO2(int, Info_dup, (MPI_Info info, MPI_Info *newinfo))
TPUMPI_PROTO2(int, Info_free, (MPI_Info * info))
TPUMPI_PROTO2(int, Info_get_nkeys, (MPI_Info info, int *nkeys))
TPUMPI_PROTO2(int, Info_get_nthkey, (MPI_Info info, int n, char *key))

/* error classes/codes */
TPUMPI_PROTO2(int, Add_error_class, (int *errorclass))
TPUMPI_PROTO2(int, Add_error_code, (int errorclass, int *errorcode))
TPUMPI_PROTO2(int, Add_error_string, (int errorcode, const char *string))
TPUMPI_PROTO2(int, Comm_call_errhandler, (MPI_Comm comm, int errorcode))
TPUMPI_PROTO2(int, Win_call_errhandler, (MPI_Win win, int errorcode))
TPUMPI_PROTO2(int, File_call_errhandler, (MPI_File fh, int errorcode))
TPUMPI_PROTO2(int, Comm_create_errhandler,
              (void (*comm_errhandler_fn)(MPI_Comm *, int *, ...),
               MPI_Errhandler *errhandler))
TPUMPI_PROTO2(int, Win_create_errhandler,
              (void (*win_errhandler_fn)(MPI_Win *, int *, ...),
               MPI_Errhandler *errhandler))
TPUMPI_PROTO2(int, File_create_errhandler,
              (void (*file_errhandler_fn)(MPI_File *, int *, ...),
               MPI_Errhandler *errhandler))
TPUMPI_PROTO2(int, Win_set_errhandler, (MPI_Win win,
                                        MPI_Errhandler errhandler))
TPUMPI_PROTO2(int, Win_get_errhandler, (MPI_Win win,
                                        MPI_Errhandler *errhandler))
TPUMPI_PROTO2(int, File_set_errhandler, (MPI_File fh,
                                         MPI_Errhandler errhandler))
TPUMPI_PROTO2(int, File_get_errhandler, (MPI_File fh,
                                         MPI_Errhandler *errhandler))

/* deprecated-but-exported (MPI-1 names the reference still carries) */
TPUMPI_PROTO2(int, Address, (void *location, MPI_Aint *address))
TPUMPI_PROTO2(int, Type_extent, (MPI_Datatype datatype, MPI_Aint *extent))
TPUMPI_PROTO2(int, Type_lb, (MPI_Datatype datatype, MPI_Aint *lb))
TPUMPI_PROTO2(int, Type_ub, (MPI_Datatype datatype, MPI_Aint *ub))
TPUMPI_PROTO2(int, Type_hvector,
              (int count, int blocklength, MPI_Aint stride,
               MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_hindexed,
              (int count, int blocklengths[], MPI_Aint displacements[],
               MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_struct,
              (int count, int blocklengths[], MPI_Aint displacements[],
               MPI_Datatype types[], MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Errhandler_create,
              (void (*fn)(MPI_Comm *, int *, ...),
               MPI_Errhandler *errhandler))
TPUMPI_PROTO2(int, Errhandler_set, (MPI_Comm comm, MPI_Errhandler errhandler))
TPUMPI_PROTO2(int, Errhandler_get, (MPI_Comm comm,
                                    MPI_Errhandler *errhandler))

/* datatype breadth */
TPUMPI_PROTO2(int, Type_create_hvector,
              (int count, int blocklength, MPI_Aint stride,
               MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_create_hindexed,
              (int count, const int blocklengths[],
               const MPI_Aint displacements[], MPI_Datatype oldtype,
               MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_create_hindexed_block,
              (int count, int blocklength, const MPI_Aint displacements[],
               MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_create_indexed_block,
              (int count, int blocklength, const int displacements[],
               MPI_Datatype oldtype, MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_create_resized,
              (MPI_Datatype oldtype, MPI_Aint lb, MPI_Aint extent,
               MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_create_subarray,
              (int ndims, const int sizes[], const int subsizes[],
               const int starts[], int order, MPI_Datatype oldtype,
               MPI_Datatype *newtype))
TPUMPI_PROTO2(int, Type_get_true_extent,
              (MPI_Datatype datatype, MPI_Aint *true_lb,
               MPI_Aint *true_extent))
TPUMPI_PROTO2(int, Type_get_true_extent_x,
              (MPI_Datatype datatype, MPI_Count *true_lb,
               MPI_Count *true_extent))
TPUMPI_PROTO2(int, Type_get_extent_x,
              (MPI_Datatype datatype, MPI_Count *lb, MPI_Count *extent))
TPUMPI_PROTO2(int, Type_size_x, (MPI_Datatype datatype, MPI_Count *size))
TPUMPI_PROTO2(int, Type_set_name, (MPI_Datatype datatype,
                                   const char *type_name))
TPUMPI_PROTO2(int, Type_get_name, (MPI_Datatype datatype, char *type_name,
                                   int *resultlen))
TPUMPI_PROTO2(int, Get_elements, (const MPI_Status *status,
                                  MPI_Datatype datatype, int *count))
TPUMPI_PROTO2(int, Get_elements_x, (const MPI_Status *status,
                                    MPI_Datatype datatype, MPI_Count *count))
TPUMPI_PROTO2(int, Status_set_elements,
              (MPI_Status * status, MPI_Datatype datatype, int count))
TPUMPI_PROTO2(int, Status_set_elements_x,
              (MPI_Status * status, MPI_Datatype datatype, MPI_Count count))
TPUMPI_PROTO2(int, Status_set_cancelled, (MPI_Status * status, int flag))

/* comm/group breadth */
TPUMPI_PROTO2(int, Comm_test_inter, (MPI_Comm comm, int *flag))
TPUMPI_PROTO2(int, Comm_remote_group, (MPI_Comm comm, MPI_Group *group))
TPUMPI_PROTO2(int, Intercomm_create,
              (MPI_Comm local_comm, int local_leader, MPI_Comm peer_comm,
               int remote_leader, int tag, MPI_Comm *newintercomm))
TPUMPI_PROTO2(int, Comm_dup_with_info,
              (MPI_Comm comm, MPI_Info info, MPI_Comm *newcomm))
TPUMPI_PROTO2(int, Comm_idup, (MPI_Comm comm, MPI_Comm *newcomm,
                               MPI_Request *request))
TPUMPI_PROTO2(int, Comm_set_info, (MPI_Comm comm, MPI_Info info))
TPUMPI_PROTO2(int, Comm_get_info, (MPI_Comm comm, MPI_Info *info_used))
TPUMPI_PROTO2(int, Group_range_incl,
              (MPI_Group group, int n, int ranges[][3], MPI_Group *newgroup))
TPUMPI_PROTO2(int, Group_range_excl,
              (MPI_Group group, int n, int ranges[][3], MPI_Group *newgroup))
TPUMPI_PROTO2(int, Comm_disconnect, (MPI_Comm * comm))

/* handle conversions (handles ARE ints; identity maps) */
TPUMPI_PROTO2(MPI_Comm, Comm_f2c, (int comm))
TPUMPI_PROTO2(int, Comm_c2f, (MPI_Comm comm))
TPUMPI_PROTO2(MPI_Datatype, Type_f2c, (int datatype))
TPUMPI_PROTO2(int, Type_c2f, (MPI_Datatype datatype))
TPUMPI_PROTO2(MPI_Group, Group_f2c, (int group))
TPUMPI_PROTO2(int, Group_c2f, (MPI_Group group))
TPUMPI_PROTO2(MPI_Op, Op_f2c, (int op))
TPUMPI_PROTO2(int, Op_c2f, (MPI_Op op))
TPUMPI_PROTO2(MPI_Request, Request_f2c, (int request))
TPUMPI_PROTO2(int, Request_c2f, (MPI_Request request))
TPUMPI_PROTO2(MPI_Win, Win_f2c, (int win))
TPUMPI_PROTO2(int, Win_c2f, (MPI_Win win))
TPUMPI_PROTO2(MPI_File, File_f2c, (int file))
TPUMPI_PROTO2(int, File_c2f, (MPI_File file))
TPUMPI_PROTO2(MPI_Info, Info_f2c, (int info))
TPUMPI_PROTO2(int, Info_c2f, (MPI_Info info))
TPUMPI_PROTO2(MPI_Errhandler, Errhandler_f2c, (int errhandler))
TPUMPI_PROTO2(int, Errhandler_c2f, (MPI_Errhandler errhandler))
TPUMPI_PROTO2(MPI_Message, Message_f2c, (int message))
TPUMPI_PROTO2(int, Message_c2f, (MPI_Message message))
TPUMPI_PROTO2(int, Status_f2c, (const int *f_status, MPI_Status *c_status))
TPUMPI_PROTO2(int, Status_c2f, (const MPI_Status *c_status, int *f_status))

/* Fortran-interop status sentinels (exported data symbols, matching
 * the reference libmpi's dynamic symbol table) */
typedef int MPI_Fint;
extern MPI_Fint *MPI_F_STATUS_IGNORE;
extern MPI_Fint *MPI_F_STATUSES_IGNORE;

/* misc locals */
TPUMPI_PROTO2(int, Alloc_mem, (MPI_Aint size, MPI_Info info, void *baseptr))
TPUMPI_PROTO2(int, Free_mem, (void *base))
TPUMPI_PROTO2(int, Pcontrol, (const int level, ...))
TPUMPI_PROTO2(int, Is_thread_main, (int *flag))
TPUMPI_PROTO2(int, Query_thread, (int *provided))
TPUMPI_PROTO2(MPI_Aint, Aint_add, (MPI_Aint base, MPI_Aint disp))
TPUMPI_PROTO2(MPI_Aint, Aint_diff, (MPI_Aint addr1, MPI_Aint addr2))

/* topology breadth */
TPUMPI_PROTO2(int, Cart_sub, (MPI_Comm comm, const int remain_dims[],
                              MPI_Comm *newcomm))
TPUMPI_PROTO2(int, Topo_test, (MPI_Comm comm, int *status))
TPUMPI_PROTO2(int, Cart_map, (MPI_Comm comm, int ndims, const int dims[],
                              const int periods[], int *newrank))
TPUMPI_PROTO2(int, Graph_map, (MPI_Comm comm, int nnodes, const int index[],
                               const int edges[], int *newrank))
TPUMPI_PROTO2(int, Graph_get, (MPI_Comm comm, int maxindex, int maxedges,
                               int index[], int edges[]))
TPUMPI_PROTO2(int, Dist_graph_create_adjacent,
              (MPI_Comm comm_old, int indegree, const int sources[],
               const int sourceweights[], int outdegree,
               const int destinations[], const int destweights[],
               MPI_Info info, int reorder, MPI_Comm *comm_dist_graph))
TPUMPI_PROTO2(int, Dist_graph_create,
              (MPI_Comm comm_old, int n, const int sources[],
               const int degrees[], const int destinations[],
               const int weights[], MPI_Info info, int reorder,
               MPI_Comm *comm_dist_graph))
TPUMPI_PROTO2(int, Dist_graph_neighbors_count,
              (MPI_Comm comm, int *indegree, int *outdegree, int *weighted))
TPUMPI_PROTO2(int, Dist_graph_neighbors,
              (MPI_Comm comm, int maxindegree, int sources[],
               int sourceweights[], int maxoutdegree, int destinations[],
               int destweights[]))

/* RMA breadth */
TPUMPI_PROTO2(int, Win_lock_all, (int assertion, MPI_Win win))
TPUMPI_PROTO2(int, Win_unlock_all, (MPI_Win win))
TPUMPI_PROTO2(int, Win_flush_all, (MPI_Win win))
TPUMPI_PROTO2(int, Win_flush_local, (int rank, MPI_Win win))
TPUMPI_PROTO2(int, Win_flush_local_all, (MPI_Win win))
TPUMPI_PROTO2(int, Win_sync, (MPI_Win win))
TPUMPI_PROTO2(int, Win_post, (MPI_Group group, int assertion, MPI_Win win))
TPUMPI_PROTO2(int, Win_start, (MPI_Group group, int assertion, MPI_Win win))
TPUMPI_PROTO2(int, Win_complete, (MPI_Win win))
TPUMPI_PROTO2(int, Win_wait, (MPI_Win win))
TPUMPI_PROTO2(int, Win_test, (MPI_Win win, int *flag))
TPUMPI_PROTO2(int, Win_get_group, (MPI_Win win, MPI_Group *group))
TPUMPI_PROTO2(int, Win_set_name, (MPI_Win win, const char *win_name))
TPUMPI_PROTO2(int, Win_get_name, (MPI_Win win, char *win_name,
                                  int *resultlen))
TPUMPI_PROTO2(int, Win_allocate,
              (MPI_Aint size, int disp_unit, MPI_Info info, MPI_Comm comm,
               void *baseptr, MPI_Win *win))
TPUMPI_PROTO2(int, Get_accumulate,
              (const void *origin_addr, int origin_count,
               MPI_Datatype origin_datatype, void *result_addr,
               int result_count, MPI_Datatype result_datatype,
               int target_rank, MPI_Aint target_disp, int target_count,
               MPI_Datatype target_datatype, MPI_Op op, MPI_Win win))
TPUMPI_PROTO2(int, Compare_and_swap,
              (const void *origin_addr, const void *compare_addr,
               void *result_addr, MPI_Datatype datatype, int target_rank,
               MPI_Aint target_disp, MPI_Win win))
TPUMPI_PROTO2(int, Rput,
              (const void *origin_addr, int origin_count,
               MPI_Datatype origin_datatype, int target_rank,
               MPI_Aint target_disp, int target_count,
               MPI_Datatype target_datatype, MPI_Win win,
               MPI_Request *request))
TPUMPI_PROTO2(int, Rget,
              (void *origin_addr, int origin_count,
               MPI_Datatype origin_datatype, int target_rank,
               MPI_Aint target_disp, int target_count,
               MPI_Datatype target_datatype, MPI_Win win,
               MPI_Request *request))
TPUMPI_PROTO2(int, Raccumulate,
              (const void *origin_addr, int origin_count,
               MPI_Datatype origin_datatype, int target_rank,
               MPI_Aint target_disp, int target_count,
               MPI_Datatype target_datatype, MPI_Op op, MPI_Win win,
               MPI_Request *request))
TPUMPI_PROTO2(int, Rget_accumulate,
              (const void *origin_addr, int origin_count,
               MPI_Datatype origin_datatype, void *result_addr,
               int result_count, MPI_Datatype result_datatype,
               int target_rank, MPI_Aint target_disp, int target_count,
               MPI_Datatype target_datatype, MPI_Op op, MPI_Win win,
               MPI_Request *request))

/* MPI-IO breadth */
TPUMPI_PROTO2(int, File_delete, (const char *filename, MPI_Info info))
TPUMPI_PROTO2(int, File_sync, (MPI_File fh))
TPUMPI_PROTO2(int, File_preallocate, (MPI_File fh, MPI_Offset size))
TPUMPI_PROTO2(int, File_get_amode, (MPI_File fh, int *amode))
TPUMPI_PROTO2(int, File_set_atomicity, (MPI_File fh, int flag))
TPUMPI_PROTO2(int, File_get_atomicity, (MPI_File fh, int *flag))
TPUMPI_PROTO2(int, File_get_position, (MPI_File fh, MPI_Offset *offset))
TPUMPI_PROTO2(int, File_get_byte_offset,
              (MPI_File fh, MPI_Offset offset, MPI_Offset *disp))
TPUMPI_PROTO2(int, File_get_type_extent,
              (MPI_File fh, MPI_Datatype datatype, MPI_Aint *extent))
TPUMPI_PROTO2(int, File_write_all,
              (MPI_File fh, const void *buf, int count,
               MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO2(int, File_read_all, (MPI_File fh, void *buf, int count,
                                   MPI_Datatype datatype,
                                   MPI_Status *status))
TPUMPI_PROTO2(int, File_write_shared,
              (MPI_File fh, const void *buf, int count,
               MPI_Datatype datatype, MPI_Status *status))
TPUMPI_PROTO2(int, File_read_shared,
              (MPI_File fh, void *buf, int count, MPI_Datatype datatype,
               MPI_Status *status))
TPUMPI_PROTO2(int, File_seek_shared,
              (MPI_File fh, MPI_Offset offset, int whence))
TPUMPI_PROTO2(int, File_get_position_shared,
              (MPI_File fh, MPI_Offset *offset))
TPUMPI_PROTO2(int, File_iwrite_at,
              (MPI_File fh, MPI_Offset offset, const void *buf, int count,
               MPI_Datatype datatype, MPI_Request *request))
TPUMPI_PROTO2(int, File_iread_at,
              (MPI_File fh, MPI_Offset offset, void *buf, int count,
               MPI_Datatype datatype, MPI_Request *request))
TPUMPI_PROTO2(int, File_iwrite, (MPI_File fh, const void *buf, int count,
                                 MPI_Datatype datatype,
                                 MPI_Request *request))
TPUMPI_PROTO2(int, File_iread, (MPI_File fh, void *buf, int count,
                                MPI_Datatype datatype, MPI_Request *request))
TPUMPI_PROTO2(int, File_get_group, (MPI_File fh, MPI_Group *group))
TPUMPI_PROTO2(int, File_set_info, (MPI_File fh, MPI_Info info))
TPUMPI_PROTO2(int, File_get_info, (MPI_File fh, MPI_Info *info_used))
TPUMPI_PROTO2(int, File_get_view,
              (MPI_File fh, MPI_Offset *disp, MPI_Datatype *etype,
               MPI_Datatype *filetype, char *datarep))


/* batch-2 constants */
#define MPI_COMBINER_NAMED 1
#define MPI_COMBINER_DUP 2
#define MPI_COMBINER_CONTIGUOUS 3
#define MPI_COMBINER_VECTOR 4
#define MPI_COMBINER_HVECTOR 5
#define MPI_COMBINER_INDEXED 6
#define MPI_COMBINER_HINDEXED 7
#define MPI_COMBINER_INDEXED_BLOCK 8
#define MPI_COMBINER_HINDEXED_BLOCK 9
#define MPI_COMBINER_STRUCT 10
#define MPI_COMBINER_SUBARRAY 11
#define MPI_COMBINER_DARRAY 12
#define MPI_COMBINER_RESIZED 13
#define MPI_COMBINER_F90_REAL 14
#define MPI_COMBINER_F90_COMPLEX 15
#define MPI_COMBINER_F90_INTEGER 16
#define MPI_DISTRIBUTE_BLOCK 121
#define MPI_DISTRIBUTE_CYCLIC 122
#define MPI_DISTRIBUTE_NONE 123
#define MPI_DISTRIBUTE_DFLT_DARG (-1)
#define MPI_TYPECLASS_INTEGER 1
#define MPI_TYPECLASS_REAL 2
#define MPI_TYPECLASS_COMPLEX 3
#define MPI_MAX_DATAREP_STRING 128

typedef int(MPI_Datarep_conversion_function)(void *, MPI_Datatype, int,
                                             void *, MPI_Offset, void *);
typedef int(MPI_Datarep_extent_function)(MPI_Datatype, MPI_Aint *, void *);
extern int MPI_CONVERSION_FN_NULL(void *, MPI_Datatype, int, void *,
                                  MPI_Offset, void *);

#define TPUMPI_PROTO3(ret, name, args) \
  ret MPI_##name args;                 \
  ret PMPI_##name args;

/* neighbor collectives */
TPUMPI_PROTO3(int, Neighbor_allgather,
              (const void *, int, MPI_Datatype, void *, int, MPI_Datatype,
               MPI_Comm))
TPUMPI_PROTO3(int, Neighbor_allgatherv,
              (const void *, int, MPI_Datatype, void *, const int[],
               const int[], MPI_Datatype, MPI_Comm))
TPUMPI_PROTO3(int, Neighbor_alltoall,
              (const void *, int, MPI_Datatype, void *, int, MPI_Datatype,
               MPI_Comm))
TPUMPI_PROTO3(int, Neighbor_alltoallv,
              (const void *, const int[], const int[], MPI_Datatype, void *,
               const int[], const int[], MPI_Datatype, MPI_Comm))
TPUMPI_PROTO3(int, Neighbor_alltoallw,
              (const void *, const int[], const MPI_Aint[],
               const MPI_Datatype[], void *, const int[], const MPI_Aint[],
               const MPI_Datatype[], MPI_Comm))
TPUMPI_PROTO3(int, Ineighbor_allgather,
              (const void *, int, MPI_Datatype, void *, int, MPI_Datatype,
               MPI_Comm, MPI_Request *))
TPUMPI_PROTO3(int, Ineighbor_allgatherv,
              (const void *, int, MPI_Datatype, void *, const int[],
               const int[], MPI_Datatype, MPI_Comm, MPI_Request *))
TPUMPI_PROTO3(int, Ineighbor_alltoall,
              (const void *, int, MPI_Datatype, void *, int, MPI_Datatype,
               MPI_Comm, MPI_Request *))
TPUMPI_PROTO3(int, Ineighbor_alltoallv,
              (const void *, const int[], const int[], MPI_Datatype, void *,
               const int[], const int[], MPI_Datatype, MPI_Comm,
               MPI_Request *))
TPUMPI_PROTO3(int, Ineighbor_alltoallw,
              (const void *, const int[], const MPI_Aint[],
               const MPI_Datatype[], void *, const int[], const MPI_Aint[],
               const MPI_Datatype[], MPI_Comm, MPI_Request *))
TPUMPI_PROTO3(int, Alltoallw,
              (const void *, const int[], const int[], const MPI_Datatype[],
               void *, const int[], const int[], const MPI_Datatype[],
               MPI_Comm))
TPUMPI_PROTO3(int, Ialltoallw,
              (const void *, const int[], const int[], const MPI_Datatype[],
               void *, const int[], const int[], const MPI_Datatype[],
               MPI_Comm, MPI_Request *))

/* type introspection */
TPUMPI_PROTO3(int, Type_get_envelope,
              (MPI_Datatype, int *, int *, int *, int *))
TPUMPI_PROTO3(int, Type_get_contents,
              (MPI_Datatype, int, int, int, int[], MPI_Aint[],
               MPI_Datatype[]))
TPUMPI_PROTO3(int, Type_create_darray,
              (int, int, int, const int[], const int[], const int[],
               const int[], int, MPI_Datatype, MPI_Datatype *))
TPUMPI_PROTO3(int, Type_match_size, (int, int, MPI_Datatype *))
TPUMPI_PROTO3(int, Type_create_f90_real, (int, int, MPI_Datatype *))
TPUMPI_PROTO3(int, Type_create_f90_complex, (int, int, MPI_Datatype *))
TPUMPI_PROTO3(int, Type_create_f90_integer, (int, MPI_Datatype *))

/* generalized requests */
TPUMPI_PROTO3(int, Grequest_start,
              (MPI_Grequest_query_function *, MPI_Grequest_free_function *,
               MPI_Grequest_cancel_function *, void *, MPI_Request *))
TPUMPI_PROTO3(int, Grequest_complete, (MPI_Request))

/* name service / DPM remainder */
TPUMPI_PROTO3(int, Open_port, (MPI_Info, char *))
TPUMPI_PROTO3(int, Close_port, (const char *))
TPUMPI_PROTO3(int, Publish_name, (const char *, MPI_Info, const char *))
TPUMPI_PROTO3(int, Unpublish_name, (const char *, MPI_Info, const char *))
TPUMPI_PROTO3(int, Lookup_name, (const char *, MPI_Info, char *))
TPUMPI_PROTO3(int, Comm_accept,
              (const char *, MPI_Info, int, MPI_Comm, MPI_Comm *))
TPUMPI_PROTO3(int, Comm_connect,
              (const char *, MPI_Info, int, MPI_Comm, MPI_Comm *))
TPUMPI_PROTO3(int, Comm_join, (int, MPI_Comm *))
TPUMPI_PROTO3(int, Comm_spawn_multiple,
              (int, char *[], char **[], const int[], const MPI_Info[],
               int, MPI_Comm, MPI_Comm *, int[]))

/* windows remainder */
TPUMPI_PROTO3(int, Win_allocate_shared,
              (MPI_Aint, int, MPI_Info, MPI_Comm, void *, MPI_Win *))
TPUMPI_PROTO3(int, Win_create_dynamic, (MPI_Info, MPI_Comm, MPI_Win *))
TPUMPI_PROTO3(int, Win_attach, (MPI_Win, void *, MPI_Aint))
TPUMPI_PROTO3(int, Win_detach, (MPI_Win, const void *))
TPUMPI_PROTO3(int, Win_shared_query,
              (MPI_Win, int, MPI_Aint *, int *, void *))
TPUMPI_PROTO3(int, Win_set_info, (MPI_Win, MPI_Info))
TPUMPI_PROTO3(int, Win_get_info, (MPI_Win, MPI_Info *))

/* MPI-IO remainder */
TPUMPI_PROTO3(int, File_write_ordered,
              (MPI_File, const void *, int, MPI_Datatype, MPI_Status *))
TPUMPI_PROTO3(int, File_read_ordered,
              (MPI_File, void *, int, MPI_Datatype, MPI_Status *))
TPUMPI_PROTO3(int, File_iwrite_shared,
              (MPI_File, const void *, int, MPI_Datatype, MPI_Request *))
TPUMPI_PROTO3(int, File_iread_shared,
              (MPI_File, void *, int, MPI_Datatype, MPI_Request *))
TPUMPI_PROTO3(int, File_iwrite_at_all,
              (MPI_File, MPI_Offset, const void *, int, MPI_Datatype,
               MPI_Request *))
TPUMPI_PROTO3(int, File_iread_at_all,
              (MPI_File, MPI_Offset, void *, int, MPI_Datatype,
               MPI_Request *))
TPUMPI_PROTO3(int, File_iwrite_all,
              (MPI_File, const void *, int, MPI_Datatype, MPI_Request *))
TPUMPI_PROTO3(int, File_iread_all,
              (MPI_File, void *, int, MPI_Datatype, MPI_Request *))
TPUMPI_PROTO3(int, File_write_all_begin,
              (MPI_File, const void *, int, MPI_Datatype))
TPUMPI_PROTO3(int, File_write_all_end,
              (MPI_File, const void *, MPI_Status *))
TPUMPI_PROTO3(int, File_read_all_begin, (MPI_File, void *, int,
                                         MPI_Datatype))
TPUMPI_PROTO3(int, File_read_all_end, (MPI_File, void *, MPI_Status *))
TPUMPI_PROTO3(int, File_write_at_all_begin,
              (MPI_File, MPI_Offset, const void *, int, MPI_Datatype))
TPUMPI_PROTO3(int, File_write_at_all_end,
              (MPI_File, const void *, MPI_Status *))
TPUMPI_PROTO3(int, File_read_at_all_begin,
              (MPI_File, MPI_Offset, void *, int, MPI_Datatype))
TPUMPI_PROTO3(int, File_read_at_all_end, (MPI_File, void *, MPI_Status *))
TPUMPI_PROTO3(int, File_write_ordered_begin,
              (MPI_File, const void *, int, MPI_Datatype))
TPUMPI_PROTO3(int, File_write_ordered_end,
              (MPI_File, const void *, MPI_Status *))
TPUMPI_PROTO3(int, File_read_ordered_begin, (MPI_File, void *, int,
                                             MPI_Datatype))
TPUMPI_PROTO3(int, File_read_ordered_end, (MPI_File, void *, MPI_Status *))
TPUMPI_PROTO3(int, Register_datarep,
              (const char *, MPI_Datarep_conversion_function *,
               MPI_Datarep_conversion_function *,
               MPI_Datarep_extent_function *, void *))

/* MPI_T remainder */
TPUMPI_PROTO3(int, T_cvar_get_info,
              (int, char *, int *, int *, MPI_Datatype *, void *, char *,
               int *, int *, int *))
TPUMPI_PROTO3(int, T_cvar_handle_alloc,
              (int, void *, MPI_T_cvar_handle *, int *))
TPUMPI_PROTO3(int, T_cvar_handle_free, (MPI_T_cvar_handle *))
TPUMPI_PROTO3(int, T_cvar_read, (MPI_T_cvar_handle, void *))
TPUMPI_PROTO3(int, T_cvar_write, (MPI_T_cvar_handle, const void *))
TPUMPI_PROTO3(int, T_pvar_get_info,
              (int, char *, int *, int *, int *, MPI_Datatype *, void *,
               char *, int *, int *, int *, int *, int *))
TPUMPI_PROTO3(int, T_pvar_read,
              (MPI_T_pvar_session, MPI_T_pvar_handle, void *))
TPUMPI_PROTO3(int, T_pvar_write,
              (MPI_T_pvar_session, MPI_T_pvar_handle, const void *))
TPUMPI_PROTO3(int, T_pvar_reset, (MPI_T_pvar_session, MPI_T_pvar_handle))
TPUMPI_PROTO3(int, T_pvar_readreset,
              (MPI_T_pvar_session, MPI_T_pvar_handle, void *))
TPUMPI_PROTO3(int, T_enum_get_info, (int, int *, char *, int *))
TPUMPI_PROTO3(int, T_enum_get_item, (int, int, int *, char *, int *))
TPUMPI_PROTO3(int, T_category_get_num, (int *))
TPUMPI_PROTO3(int, T_category_get_info,
              (int, char *, int *, char *, int *, int *, int *, int *))
TPUMPI_PROTO3(int, T_category_get_index, (const char *, int *))
TPUMPI_PROTO3(int, T_category_get_cvars, (int, int, int[]))
TPUMPI_PROTO3(int, T_category_get_pvars, (int, int, int[]))
TPUMPI_PROTO3(int, T_category_get_categories, (int, int, int[]))
TPUMPI_PROTO3(int, T_category_changed, (int *))

#undef TPUMPI_PROTO3

#undef TPUMPI_PROTO2
#undef TPUMPI_PROTO

#ifdef __cplusplus
}
#endif
#endif /* TPUMPI_MPI_H */
