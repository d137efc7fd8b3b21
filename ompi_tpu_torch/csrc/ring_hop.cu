// Ring-hop kernels for Hopper (sm_90a): the virtual-rank counterpart of
// the JAX package's Pallas hop.
//
// Replaces ompi_tpu/coll/pallas_kernels.py::_remote_hop_kernel (launched
// by _dma_hop) and its interpret-mode body _copy_kernel.  On the TPU the
// hop is an HBM->HBM async remote copy of device r's block into device
// (r+1) % n, with a send and a recv DMA semaphore.  Here a
// communicator's n ranks are the rows of one rank-major tensor on one
// card, so the hop is one launch that moves every rank's chunk to its
// right neighbour's row at once.  Kernel order on the stream takes the
// place of the semaphores: a launch starts after the previous step's
// launch has finished, and the next one after this one.
//
// ring_hop        dst[(r+1)%n, dst_idx[(r+1)%n]] = src[r, src_idx[r]]
// ring_hop_fold   d[r, d_idx[r]] = op(a[r, a_idx[r]], b[l, b_idx[l]]),
//                 l = (r-1)%n, operands swapped when recv_first is set
//
// Tensors are rank-major (n, rows, chunk).  The index vectors are int32
// on the card, one entry per rank.  Both kernels may run in place
// (src == dst, or a == b == d): at ring step s rank r writes chunk c of
// its own row while rank r+1 reads chunk c of row r only when r writes
// another chunk, so no element is read by one block and written by
// another in the same launch (the fold reads and writes an element of
// d in the same thread).
//
// Bound: pure data movement.  ring_hop reads and writes n*chunk bytes
// (2*n*chunk bytes moved); ring_hop_fold reads two operands and writes
// one (3*n*chunk bytes).  The least time is bytes / 3.35 TB/s on an
// H100 SXM.  The design, against what held the first form back (one
// word width for the whole launch, scalar fold loads, one load in flight
// per thread, a grid-stride loop over 4096 blocks):
//
//   1. one flat work space.  Each rank's chunk is cut into kTile-byte
//      tiles of its body (of each operand); the (rank, tile) pairs are
//      one flat space and each block takes one tile, so the block
//      scheduler hands the next tile to whichever SM frees first and the
//      launch ends one tile after the last is handed out.  A persistent
//      grid (the card's SMs times the blocks the occupancy calculator
//      gives, each block striding over the tiles) was slower on the
//      card: its fixed share per block ends with the slowest block's.
//   2. the word width per rank, not per launch.  Each rank takes
//      16-byte words when its ends agree modulo 16 (source and
//      destination; for the fold both operands and the destination),
//      else the widest power of two they agree modulo, and peels a head
//      and a tail of fewer than that many bytes (its first tile's block
//      moves them).  ring_hop_put_kernel (ring_hop_peer.cu) uses the
//      same rule, and coll/cuda_kernels.py:hop_split mirrors it.  A
//      chunk whose length is not a multiple of 16 no longer drags every
//      rank down to narrow words.
//   3. bytes in flight.  Every thread loads kUnroll words of each
//      operand before it stores any; the fold reads 16-byte vectors
//      (4 f32, 8 f16 or bf16, 2 f64/i64/u64 lanes) and folds them lane
//      by lane.  Small blocks (kThreads) keep many resident per SM.
//      Moving the hop's 16-byte bodies through the Tensor Memory
//      Accelerator (cp.async.bulk through mbarrier-tracked shared-memory
//      stages) and streaming cache hints (ld/st.global.cs) were timed
//      against this form on the card and gained nothing beyond the
//      spread between two calls.
//
// The fold computes f16/bf16 in f32 and rounds once (__float2half_rn,
// __float2bfloat16_rn): for one add or multiply that equals torch's and
// XLA's result, since f32 has more than 2p+1 bits for both.  MAX/MIN
// propagate NaN as torch.maximum/minimum do (the first NaN operand is
// returned as it is); fmaxf/fminf would return the other operand.  The
// vector form changes no element's arithmetic: each lane goes through
// the same fold<T, OP>.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math: it flushes
//             denormals and breaks bit parity).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // threads of a block (hop and fold)
constexpr int kUnroll = 2;     // words in flight per thread and operand
// body bytes of one tile (of each operand): one pass of a block's
// threads over kUnroll 16-byte words each
constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll * 16;

// One rank's byte range: [0, head) and [head + words*w, nbytes) move
// byte by byte (or element by element), the body in w-byte words.
struct Split {
  long long head, words, tail;
  int w;
};

// `s`: the first end's address; `mis`: the XOR of it with every other
// end's address.
__device__ __forceinline__ Split split_of(uintptr_t s, uintptr_t mis, long long nbytes) {
  const int w = (mis & 15) == 0 ? 16 : (mis & 7) == 0 ? 8 : (mis & 3) == 0 ? 4
              : (mis & 1) == 0 ? 2 : 1;
  long long head = static_cast<long long>((w - (s & (w - 1))) & (w - 1));
  if (head > nbytes) head = nbytes;
  const long long words = (nbytes - head) / w;
  return {head, words, nbytes - head - words * w, w};
}

template <int W> struct WordOf;
template <> struct WordOf<16> { using T = uint4; };
template <> struct WordOf<8> { using T = uint2; };
template <> struct WordOf<4> { using T = unsigned int; };
template <> struct WordOf<2> { using T = unsigned short; };
template <> struct WordOf<1> { using T = unsigned char; };

// -- the hop -----------------------------------------------------------

struct HopArgs {
  const char* src;
  char* dst;
  const int* src_idx;
  const int* dst_idx;
  long long n, src_rows, dst_rows, chunk_bytes;
  long long tiles;  // per rank: ceil(chunk_bytes / kTile)
};

struct HopRank {
  const char* s;
  char* d;
  Split sp;
};

__device__ __forceinline__ HopRank hop_rank(const HopArgs& a, long long r) {
  const long long to = (r + 1) % a.n;  // the receiving rank
  const char* s = a.src + (r * a.src_rows + a.src_idx[r]) * a.chunk_bytes;
  char* d = a.dst + (to * a.dst_rows + a.dst_idx[to]) * a.chunk_bytes;
  const uintptr_t us = reinterpret_cast<uintptr_t>(s);
  return {s, d, split_of(us, us ^ reinterpret_cast<uintptr_t>(d), a.chunk_bytes)};
}

// Words [w0, w1) of a body: kUnroll words loaded before any is stored.
template <int W>
__device__ __forceinline__ void copy_words(const char* src, char* dst, long long w0,
                                           long long w1) {
  using V = typename WordOf<W>::T;
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  constexpr long long kStep = static_cast<long long>(kThreads) * kUnroll;
  long long i = w0 + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < w1; i += kStep) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * kThreads] = v[u];
  }
  for (; i < w1; i += kThreads) d[i] = s[i];
}

// Block t moves tile t of the flat (rank, tile) space: the tile's body
// words, and the rank's head and tail when it is the rank's first tile.
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(const HopArgs a) {
  const long long t = blockIdx.x;
  const long long r = t / a.tiles;
  const long long k = t - r * a.tiles;
  const HopRank h = hop_rank(a, r);
  if (k == 0) {
    const long long tail_at = h.sp.head + h.sp.words * h.sp.w;
    if (threadIdx.x < h.sp.head) h.d[threadIdx.x] = h.s[threadIdx.x];
    if (threadIdx.x < h.sp.tail) h.d[tail_at + threadIdx.x] = h.s[tail_at + threadIdx.x];
  }
  const long long per = kTile / h.sp.w;
  const long long w0 = k * per;
  const long long w1 = w0 + per < h.sp.words ? w0 + per : h.sp.words;
  if (w0 >= w1) return;
  const char* s = h.s + h.sp.head;
  char* d = h.d + h.sp.head;
  switch (h.sp.w) {  // uniform across the block
    case 16: copy_words<16>(s, d, w0, w1); break;
    case 8: copy_words<8>(s, d, w0, w1); break;
    case 4: copy_words<4>(s, d, w0, w1); break;
    case 2: copy_words<2>(s, d, w0, w1); break;
    default: copy_words<1>(s, d, w0, w1); break;
  }
}

cudaError_t launch_hop(const HopArgs& a, cudaStream_t stream) {
  const long long total = a.n * a.tiles;
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  ring_hop_kernel<<<static_cast<unsigned>(total), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// -- the fold ---------------------------------------------------------

enum FoldOp { kSum = 0, kProd = 1, kMax = 2, kMin = 3 };

template <typename T>
struct Num {  // f32, f64 and the integer types: native arithmetic
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T mul(T a, T b) { return a * b; }
  __device__ static double wide(T a) { return static_cast<double>(a); }
};

template <>
struct Num<__half> {
  __device__ static __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  __device__ static __half mul(__half a, __half b) {
    return __float2half_rn(__half2float(a) * __half2float(b));
  }
  __device__ static float wide(__half a) { return __half2float(a); }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) * __bfloat162float(b));
  }
  __device__ static float wide(__nv_bfloat16 a) { return __bfloat162float(a); }
};

// MAX (want_max) or MIN with torch's NaN rule: a NaN operand wins, the
// first one if both are NaN, returned bit for bit.  Equal values are
// the same bits except for +0/-0, where MAX gives +0 and MIN gives -0.
template <typename T>
__device__ T pick(T a, T b, bool want_max) {
  if constexpr (std::is_integral<T>::value) {
    return want_max ? (a > b ? a : b) : (a < b ? a : b);
  } else {
    const auto x = Num<T>::wide(a);
    const auto y = Num<T>::wide(b);
    if (x != x) return a;
    if (y != y) return b;
    if (x > y) return want_max ? a : b;
    if (y > x) return want_max ? b : a;
    return ((signbit(x) != 0) == want_max) ? b : a;
  }
}

template <typename T, int OP>
__device__ T fold(T a, T b) {
  if constexpr (OP == kSum) return Num<T>::add(a, b);
  if constexpr (OP == kProd) return Num<T>::mul(a, b);
  if constexpr (OP == kMax) return pick(a, b, true);
  return pick(a, b, false);
}

template <typename T, int OP>
__device__ __forceinline__ T fold_pair(T mine, T recv, int recv_first) {
  return recv_first ? fold<T, OP>(recv, mine) : fold<T, OP>(mine, recv);
}

// One W-byte word of each operand folded lane by lane.
template <typename T, int OP, int W>
__device__ __forceinline__ typename WordOf<W>::T fold_word(typename WordOf<W>::T x,
                                                          typename WordOf<W>::T y,
                                                          int recv_first) {
  constexpr int kLanes = W / static_cast<int>(sizeof(T));
  T xs[kLanes], ys[kLanes];
  memcpy(xs, &x, W);
  memcpy(ys, &y, W);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) xs[l] = fold_pair<T, OP>(xs[l], ys[l], recv_first);
  typename WordOf<W>::T z;
  memcpy(&z, xs, W);
  return z;
}

// Words [w0, w1) of the bodies: kUnroll words of each operand loaded
// before any result is stored.
template <typename T, int OP, int W>
__device__ __forceinline__ void fold_words(const char* pa, const char* pb, char* pd,
                                           long long w0, long long w1, int recv_first) {
  using V = typename WordOf<W>::T;
  const V* a = reinterpret_cast<const V*>(pa);
  const V* b = reinterpret_cast<const V*>(pb);
  V* d = reinterpret_cast<V*>(pd);
  constexpr long long kStep = static_cast<long long>(kThreads) * kUnroll;
  long long i = w0 + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < w1; i += kStep) {
    V x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = a[i + u * kThreads];
      y[u] = b[i + u * kThreads];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      d[i + u * kThreads] = fold_word<T, OP, W>(x[u], y[u], recv_first);
  }
  for (; i < w1; i += kThreads) d[i] = fold_word<T, OP, W>(a[i], b[i], recv_first);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_hop_fold_kernel(const T* a, const T* b, T* d, const int* a_idx, const int* b_idx,
                         const int* d_idx, long long n, long long a_rows, long long b_rows,
                         long long d_rows, long long m, int recv_first, long long tiles) {
  constexpr long long es = sizeof(T);
  const long long t = blockIdx.x;          // tile t of the flat (rank, tile) space
  const long long r = t / tiles;           // folding rank
  const long long k = t - r * tiles;
  const long long left = (r + n - 1) % n;  // the rank it receives from
  const T* pa = a + (r * a_rows + a_idx[r]) * m;
  const T* pb = b + (left * b_rows + b_idx[left]) * m;
  T* pd = d + (r * d_rows + d_idx[r]) * m;
  const uintptr_t ua = reinterpret_cast<uintptr_t>(pa);
  const Split sp = split_of(ua, (ua ^ reinterpret_cast<uintptr_t>(pb)) |
                                    (ua ^ reinterpret_cast<uintptr_t>(pd)),
                            m * es);
  if (k == 0) {  // the head and tail, fewer than w bytes each
    const long long head = sp.head / es, tail = sp.tail / es, at = m - tail;
    if (threadIdx.x < head)
      pd[threadIdx.x] = fold_pair<T, OP>(pa[threadIdx.x], pb[threadIdx.x], recv_first);
    if (threadIdx.x < tail)
      pd[at + threadIdx.x] =
          fold_pair<T, OP>(pa[at + threadIdx.x], pb[at + threadIdx.x], recv_first);
  }
  const long long per = kTile / sp.w;  // words of one tile
  const long long w0 = k * per;
  const long long w1 = w0 + per < sp.words ? w0 + per : sp.words;
  if (w0 >= w1) return;
  const long long h = sp.head / es;
  const char* ba = reinterpret_cast<const char*>(pa + h);
  const char* bb = reinterpret_cast<const char*>(pb + h);
  char* bd = reinterpret_cast<char*>(pd + h);
  // every end is T-aligned, so w >= sizeof(T)
  switch (sp.w) {  // uniform across the block
    case 16: fold_words<T, OP, 16>(ba, bb, bd, w0, w1, recv_first); break;
    case 8:
      if constexpr (es <= 8) fold_words<T, OP, 8>(ba, bb, bd, w0, w1, recv_first);
      break;
    case 4:
      if constexpr (es <= 4) fold_words<T, OP, 4>(ba, bb, bd, w0, w1, recv_first);
      break;
    default:
      if constexpr (es <= 2) fold_words<T, OP, 2>(ba, bb, bd, w0, w1, recv_first);
      break;
  }
}

template <typename T, int OP>
cudaError_t launch_fold_op(const void* a, const void* b, void* d, const int* a_idx,
                           const int* b_idx, const int* d_idx, long long n, long long a_rows,
                           long long b_rows, long long d_rows, long long m, int recv_first,
                           cudaStream_t stream) {
  const long long tiles = (m * static_cast<long long>(sizeof(T)) + kTile - 1) / kTile;
  if (n * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  ring_hop_fold_kernel<T, OP><<<static_cast<unsigned>(n * tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(d), a_idx, b_idx,
      d_idx, n, a_rows, b_rows, d_rows, m, recv_first, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fold(int op, const void* a, const void* b, void* d,
                        const int* a_idx, const int* b_idx, const int* d_idx,
                        long long n, long long a_rows, long long b_rows,
                        long long d_rows, long long m, int recv_first,
                        cudaStream_t stream) {
  switch (op) {
    case kSum:
      return launch_fold_op<T, kSum>(a, b, d, a_idx, b_idx, d_idx, n, a_rows,
                                     b_rows, d_rows, m, recv_first, stream);
    case kProd:
      return launch_fold_op<T, kProd>(a, b, d, a_idx, b_idx, d_idx, n, a_rows,
                                      b_rows, d_rows, m, recv_first, stream);
    case kMax:
      return launch_fold_op<T, kMax>(a, b, d, a_idx, b_idx, d_idx, n, a_rows,
                                     b_rows, d_rows, m, recv_first, stream);
    case kMin:
      return launch_fold_op<T, kMin>(a, b, d, a_idx, b_idx, d_idx, n, a_rows,
                                     b_rows, d_rows, m, recv_first, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ompi_ring_hop(const void* src, void* dst, const int* src_idx,
                  const int* dst_idx, long long n, long long src_rows,
                  long long dst_rows, long long chunk_bytes, void* stream) {
  if (n <= 0 || n > 65535 || chunk_bytes <= 0) return cudaErrorInvalidValue;
  const HopArgs a{static_cast<const char*>(src), static_cast<char*>(dst), src_idx, dst_idx,
                  n, src_rows, dst_rows, chunk_bytes, (chunk_bytes + kTile - 1) / kTile};
  return launch_hop(a, static_cast<cudaStream_t>(stream));
}

// dtype: 0 f32, 1 f64, 2 f16, 3 bf16, 4 i32, 5 i64, 6 u32, 7 u64
// op:    0 SUM, 1 PROD, 2 MAX, 3 MIN
int ompi_ring_hop_fold(const void* a, const void* b, void* d, const int* a_idx,
                       const int* b_idx, const int* d_idx, long long n,
                       long long a_rows, long long b_rows, long long d_rows,
                       long long m, int dtype, int op, int recv_first,
                       void* stream) {
  if (n <= 0 || n > 65535 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OMPI_FOLD(T)                                                       \
  return launch_fold<T>(op, a, b, d, a_idx, b_idx, d_idx, n, a_rows, b_rows, \
                        d_rows, m, recv_first, st)
  switch (dtype) {
    case 0: OMPI_FOLD(float);
    case 1: OMPI_FOLD(double);
    case 2: OMPI_FOLD(__half);
    case 3: OMPI_FOLD(__nv_bfloat16);
    case 4: OMPI_FOLD(int32_t);
    case 5: OMPI_FOLD(int64_t);
    case 6: OMPI_FOLD(uint32_t);
    case 7: OMPI_FOLD(uint64_t);
    default: return cudaErrorInvalidValue;
  }
#undef OMPI_FOLD
}

}  // extern "C"
