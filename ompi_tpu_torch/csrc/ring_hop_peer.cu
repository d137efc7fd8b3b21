// Cross-device ring hop for Hopper (sm_90a): rank r pushes its chunk
// into the landing buffer that rank (r+1) % n owns, through that
// buffer's pointer, and device-side semaphores order the write.
//
// Replaces ompi_tpu/coll/pallas_kernels.py::_remote_hop_kernel (launched
// by _dma_hop) on the port's "devices" layout, where every rank owns a
// buffer of its own on its own card (ompi_tpu_torch/mesh/mesh.py).  The
// TPU kernel starts an HBM->HBM remote DMA toward the right neighbour
// and waits on two DMA semaphores: send (the buffer may be reused) and
// recv (the bytes have landed).  Here a hop is three launches per card,
// planned on the host (coll/cuda_kernels.py:_peer_plan), each taking
// up to kMaxEntries entries by value in its parameters (more ranks on
// one card split into further launches):
//
//   credit wait     ring_hop_wait_kernel on the card's stream, one lane
//                   per sender of the card: the receiver's `consumed`
//                   counter has reached h - 1, so landing zone h % 2,
//                   last used by hop h - 2, has been read.
//   put (start)     ring_hop_put_kernel on the same stream: every
//                   sender of the card copies its chunk into its
//                   receiver's zone (a plain pointer on the same card, a
//                   peer pointer over NVLink on another).  The put never
//                   waits.  Every block ends with one system-scope
//                   release add of 1 on the receiver's `recv` counter.
//   arrival wait    ring_hop_wait_kernel, one lane per receiver of the
//                   card: release-store h into its `consumed` counter
//                   (on its stream every reader of hop h-1's zone has
//                   finished by then), then acquire-load `recv` until it
//                   reaches the epoch's target: the blocks of every put
//                   into it so far (the plan counts them; one signal per
//                   block, not one per put, so no last-block counter and
//                   no scratch word is needed).
//
// The host enqueues every card's credit wait and put of hop h before
// any card's arrival wait of hop h.
//
// Counters are 64-bit, epoch-numbered (hop h of the communicator's life,
// not of one call) and compared as a signed difference, so they are
// never reset and a wrap does not break the order.  They live in one
// page per rank per communicator, cudaMalloc'd once and set to the
// ring's starting epoch (ompi_peer_page_alloc).  Memory ordering uses
// PTX release/acquire at system scope, not `volatile` alone, so the same
// code is right when the two ends are different cards.
//
// Deadlock: a spinning kernel holds an SM, so only the wait kernel
// spins (one warp), and ranks that share a card share its one current
// stream.  Each wait depends only on earlier (hop, phase) work: the
// credit wait of hop h on the arrival waits of hop h-1 (each posts its
// `consumed` as it starts, after its own stream's earlier work), the
// arrival wait of hop h on the puts of hop h, which on every card sit
// behind that card's credit wait of hop h.  On one card all of it is
// earlier work on the same stream; across cards the order of (hop,
// phase) pairs is acyclic.  A credit wait now covers every sender of a
// card, so it waits for the card's slowest receiver; that adds no
// dependency on later work.  Every lane gives up after `timeout_ns` of
// %globaltimer: it then stores 1 into its host flag (pinned memory the
// host reads without a synchronise) and returns, so a lost signal fails
// the call instead of hanging the card.
//
// Bound: pure data movement.  A put reads and writes the chunk once:
// 2 x chunk bytes of one card's HBM (3.35 TB/s on an H100 SXM), so a
// hop step of n ranks on one card moves 2 n chunk bytes; across cards
// the sender's put crosses NVLink at 450 GB/s each way.  What the design
// does about what held the first form back:
//
//   1. launches: three per card per hop (24 per hop step on one card of
//      eight ranks before), one ctypes call each, the stream looked up
//      once per card per hop; no per-hop allocation or copy (the
//      entries travel in the kernels' parameters).
//   2. fences: one __threadfence_system() per block, by the signalling
//      thread after __syncthreads() (the cooperative-groups grid-sync
//      pattern: the barrier orders the block's stores before the
//      thread's system-scope fence and release add), not one per thread.
//   3. the copy loop: each thread loads kUnroll words before it stores
//      any, with cache hints for data touched once (ld.global.nc loads,
//      st.global.cs evict-first stores): a 128 MiB chunk is 2.7x the
//      50 MB L2.  Each block copies one contiguous range of its put.
//      Each put gets one wave of blocks (SMs x resident blocks,
//      ompi_peer_grid), fewer for a small put; a persistent grid of one
//      wave shared by all the card's puts was slower (chip_smoke.py's
//      cross_device row prints both).  A TMA (cp.async.bulk) form was
//      not kept: it was not faster by more than the run-to-run spread,
//      and it would need a proof that bulk stores to a peer pointer are
//      ordered before the signal.
//   4. alignment: each put peels a head and a tail of fewer than w
//      bytes, so its body moves in w-byte words, w = 16 whenever src and
//      dst agree modulo 16, else the widest power of two they agree
//      modulo.  The width is chosen per put, not per launch.
//   5. a card's puts share one launch, and their blocks interleave
//      (block b works for put b % count), so every wave works on every
//      put: on four cards a card's HBM put and NVLink put run at once.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Counter;

constexpr int kThreads = 256;
// words a thread keeps in flight (16 bytes each in a put's body)
constexpr int kUnroll = 8;
// entries one put or wait launch takes by value
constexpr int kMaxEntries = 16;
// A rank's page: recv counter, consumed counter, spare to 256 bytes.
constexpr size_t kPageBytes = 256;

struct Put {
  const char* src;
  char* dst;
  long long nbytes;
  Counter* signal;  // the receiver's recv counter
};

struct PutBatch {
  Put put[kMaxEntries];
  int count;  // block b works for put b % count, as its block b / count
};

struct Wait {
  Counter* post;  // null: nothing to post
  Counter post_val;
  const Counter* wait;
  Counter target;
  long long* timed_out;  // pinned host flag
};

struct WaitBatch {
  Wait entry[kMaxEntries];
  int count;
  long long timeout_ns;
};

__device__ __forceinline__ Counter load_acquire(const Counter* p) {
  Counter v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(Counter* p, Counter v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void add_release(Counter* p, Counter v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The body of one put: `words` words of W, block `lb` of the put's `nb`
// copying its own contiguous range, kUnroll words per thread loaded
// before any is stored: read-only non-coherent loads (ld.global.nc) and
// evict-first streaming stores (st.global.cs).
template <typename W>
__device__ __forceinline__ void copy_words(const char* src, char* dst, long long words,
                                           long long lb, long long nb) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  constexpr long long kStep = static_cast<long long>(kThreads) * kUnroll;
  const long long per = ((words + nb - 1) / nb + kStep - 1) / kStep * kStep;
  const long long beg = lb * per;
  const long long end = beg + per < words ? beg + per : words;
  long long i = beg + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < end; i += kStep) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(s + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcs(d + i + u * kThreads, v[u]);
  }
  for (; i < end; i += kThreads) __stcs(d + i, __ldg(s + i));
}

__global__ void __launch_bounds__(kThreads) ring_hop_put_kernel(const PutBatch batch) {
  // the puts' blocks interleave, so every wave of the grid works on
  // every put (on four cards a card's HBM put and NVLink put overlap)
  const Put p = batch.put[blockIdx.x % batch.count];
  const long long lb = blockIdx.x / batch.count;
  const long long nb = gridDim.x / batch.count;
  const uintptr_t s = reinterpret_cast<uintptr_t>(p.src);
  const uintptr_t mis = s ^ reinterpret_cast<uintptr_t>(p.dst);
  const int w = (mis & 15) == 0 ? 16 : (mis & 7) == 0 ? 8 : (mis & 3) == 0 ? 4
              : (mis & 1) == 0 ? 2 : 1;
  long long head = static_cast<long long>((w - (s & (w - 1))) & (w - 1));
  if (head > p.nbytes) head = p.nbytes;
  const long long words = (p.nbytes - head) / w;
  const long long body_end = head + words * w;
  if (lb == nb - 1) {  // the head and the tail, fewer than w bytes each
    const long long t = threadIdx.x;
    if (t < head) p.dst[t] = p.src[t];
    if (t < p.nbytes - body_end) p.dst[body_end + t] = p.src[body_end + t];
  }
  const char* bs = p.src + head;
  char* bd = p.dst + head;
  switch (w) {  // uniform across the block
    case 16: copy_words<uint4>(bs, bd, words, lb, nb); break;
    case 8: copy_words<uint2>(bs, bd, words, lb, nb); break;
    case 4: copy_words<unsigned int>(bs, bd, words, lb, nb); break;
    case 2: copy_words<unsigned short>(bs, bd, words, lb, nb); break;
    default: copy_words<unsigned char>(bs, bd, words, lb, nb); break;
  }
  // the block's stores, then one system-wide fence and one signal
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    add_release(p.signal, 1ULL);
  }
}

__global__ void ring_hop_wait_kernel(const WaitBatch batch) {
  const int lane = threadIdx.x;
  if (lane >= batch.count) return;
  const Wait w = batch.entry[lane];
  if (w.post != nullptr) store_release(w.post, w.post_val);
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while (static_cast<long long>(load_acquire(w.wait) - w.target) < 0) {
    if (static_cast<long long>(global_ns() - t0) > batch.timeout_ns) {
      *static_cast<volatile long long*>(w.timed_out) = 1;
      return;
    }
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns *= 2;
  }
}

// Runs `fn` with `device` current, then restores the caller's device;
// switches only when the caller's device is another.
template <typename F>
int on_device(int device, F fn) {
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  if (prev != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  const int rc = fn();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

extern "C" {

// The start of `count` puts of one card, one launch on `stream` (of
// `device`) of `blocks` blocks per put, each adding one signal.  `desc`
// holds four int64 per put: src, dst (the receiver's buffer, on any card
// that `device` can reach), byte count, and the receiver's recv
// counter.  Returns cudaGetLastError() after the launch (0 = launched).
int ompi_peer_put(int device, const long long* desc, int count, long long blocks,
                  void* stream) {
  if (desc == nullptr || count < 1 || count > kMaxEntries || blocks < 1 ||
      blocks * count > (1LL << 30))
    return cudaErrorInvalidValue;
  PutBatch b = {};
  for (int e = 0; e < count; ++e) {
    const long long* d = desc + 4 * e;
    if (d[2] < 0 || d[3] == 0) return cudaErrorInvalidValue;
    b.put[e] = Put{reinterpret_cast<const char*>(d[0]), reinterpret_cast<char*>(d[1]),
                   d[2], reinterpret_cast<Counter*>(d[3])};
  }
  b.count = count;
  return on_device(device, [&]() -> int {
    ring_hop_put_kernel<<<static_cast<unsigned>(blocks * count), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(b);
    return cudaGetLastError();
  });
}

// The semaphore waits of one card, one launch (one warp) on `stream` (of
// `device`).  `entries` holds five uint64 per wait: the counter to post
// into (0: none), the value posted, the counter waited on, its target,
// and the pinned host flag that gets 1 if the wait gives up after
// `timeout_ns`.
int ompi_peer_wait(int device, const unsigned long long* entries, int count,
                   long long timeout_ns, void* stream) {
  if (entries == nullptr || count < 1 || count > kMaxEntries || timeout_ns <= 0)
    return cudaErrorInvalidValue;
  WaitBatch b = {};
  for (int e = 0; e < count; ++e) {
    const unsigned long long* w = entries + 5 * e;
    if (w[2] == 0 || w[4] == 0) return cudaErrorInvalidValue;
    b.entry[e] = Wait{reinterpret_cast<Counter*>(w[0]), w[1],
                      reinterpret_cast<const Counter*>(w[2]), w[3],
                      reinterpret_cast<long long*>(w[4])};
  }
  b.count = count;
  b.timeout_ns = timeout_ns;
  return on_device(device, [&]() -> int {
    ring_hop_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(b);
    return cudaGetLastError();
  });
}

// The put's persistent grid on `device`: its SMs times the put kernel's
// resident blocks per SM.
int ompi_peer_grid(int device, int* blocks) {
  if (blocks == nullptr) return cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_hop_put_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    return cudaSuccess;
  });
}

// One rank's counter page on `device`: cudaMalloc'd once, both counters
// set to `epoch` and the rest zeroed.
int ompi_peer_page_alloc(int device, unsigned long long epoch, void** out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    Counter init[kPageBytes / sizeof(Counter)] = {epoch, epoch};
    void* p = nullptr;
    cudaError_t e = cudaMalloc(&p, kPageBytes);
    if (e != cudaSuccess) return e;
    e = cudaMemcpy(p, init, kPageBytes, cudaMemcpyHostToDevice);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e != cudaSuccess) {
      cudaFree(p);
      return e;
    }
    *out = p;
    return cudaSuccess;
  });
}

int ompi_peer_page_free(int device, void* page) {
  return on_device(device, [&]() -> int { return cudaFree(page); });
}

// Lets kernels on `device` read and write memory of `peer`.  Enabling
// twice is not an error; the runtime's last-error slot is cleared so a
// later launch check does not see it.
int ompi_peer_enable(int device, int peer) {
  return on_device(device, [&]() -> int {
    cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
    return e;
  });
}

}  // extern "C"
