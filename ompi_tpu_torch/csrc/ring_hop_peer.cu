// Cross-device ring hop for Hopper (sm_90a): rank r pushes its chunk
// into the landing buffer that rank (r+1) % n owns, through that
// buffer's pointer, and device-side semaphores order the write.
//
// Replaces ompi_tpu/coll/pallas_kernels.py::_remote_hop_kernel (launched
// by _dma_hop) on the port's "devices" layout, where every rank owns a
// buffer of its own on its own card (ompi_tpu_torch/mesh/mesh.py).  The
// TPU kernel starts an HBM->HBM remote DMA toward the right neighbour
// and waits on two DMA semaphores: send (the buffer may be reused) and
// recv (the bytes have landed).  Here:
//
//   start           ring_hop_peer_kernel, launched on the SENDER's card
//                   and stream: a grid-stride copy from the sender's
//                   chunk into the receiver's buffer.  On another card
//                   the destination is a peer pointer over NVLink; on
//                   one card it is a plain device pointer.  The kernel
//                   never waits.
//   recv semaphore  every block of the copy ends with
//                   __threadfence_system() and a system-scope release
//                   add of 1 to the receiver's `recv` counter.  The
//                   receiver's ring_hop_wait_kernel (one thread, on the
//                   receiver's stream) acquire-loads `recv` until it
//                   reaches the epoch's target (the blocks of every put
//                   so far), before anything there reads the landing
//                   buffer.
//   send semaphore  the landing zones are double buffered (hop h uses
//                   zone h % 2).  The receiver's wait for hop h first
//                   release-stores h into its `consumed` counter: on its
//                   stream every reader of hop h-1's zone (the fold, the
//                   copy-out, the forwarding put) has finished by then.
//                   Before the put of hop h the sender's stream runs the
//                   same wait kernel on the receiver's `consumed`, for
//                   h - 1: the zone it is about to overwrite, last used
//                   by hop h - 2, has been consumed.
//
// Counters are 64-bit, epoch-numbered (hop h of the communicator's life,
// not of one call) and compared as a signed difference, so they are
// never reset and a wrap would not break the order.  They live in one
// page per rank per communicator, cudaMalloc'd and zeroed once
// (ompi_peer_page_alloc).  Memory ordering uses PTX release/acquire at
// system scope, not `volatile` alone, so the same code is right when the
// two ends are different cards.
//
// Deadlock: a spinning kernel holds an SM, so only the one-thread wait
// kernel spins, and the host enqueues every rank's put of a hop before
// any rank's wait of that hop.  Ranks that share a card share its
// current stream: there each wait is satisfied by work earlier on the
// same stream.  Across cards each dependency points to an earlier
// (hop, phase) pair, so the order is acyclic.  Every wait gives up
// after `timeout_ns` of %globaltimer: it then stores 1 into its host
// flag (pinned memory the host reads without a synchronise) and
// returns, so a lost signal fails the call instead of hanging the card.
//
// Bound: pure data movement.  A put reads and writes the chunk once
// (2 x chunk bytes; one hop of n ranks moves 2 n chunk bytes) at the
// card's 3.35 TB/s on one H100 SXM, or at NVLink's 450 GB/s each way
// between two cards.  The design does what a copy needs: a grid-stride
// loop with 64-bit offsets and the widest load (16, 8, 4, 2 or 1 bytes)
// that both pointers and the byte count allow, as ring_hop.cu does.
// No shared memory; one atomic per block.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Counter;

constexpr int kThreads = 256;
// One put fills the card alone: puts of ranks that share a card run one
// after another on its stream.
constexpr long long kMaxBlocks = 2048;
// A rank's page: recv counter, consumed counter, spare to 256 bytes.
constexpr size_t kPageBytes = 256;

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

template <typename W>
__global__ void ring_hop_peer_kernel(const char* __restrict__ src,
                                     char* __restrict__ dst, long long nbytes,
                                     Counter* recv) {
  const long long words = nbytes / static_cast<long long>(sizeof(W));
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < words; i += stride) {
    d[i] = s[i];
  }
  // every thread's stores are visible system-wide before the block's
  // one signal
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) add_release(recv, 1ULL);
}

__global__ void ring_hop_wait_kernel(Counter* post, Counter post_val,
                                     const Counter* wait, Counter target,
                                     volatile long long* timed_out,
                                     long long timeout_ns) {
  if (post != nullptr) store_release(post, post_val);
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while (static_cast<long long>(load_acquire(wait) - target) < 0) {
    if (static_cast<long long>(global_ns() - t0) > timeout_ns) {
      *timed_out = 1;
      return;
    }
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns *= 2;
  }
}

// Runs `fn` with `device` current, then restores the caller's device.
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

template <typename W>
int launch_put(const void* src, void* dst, long long nbytes, Counter* recv,
               cudaStream_t stream, long long* blocks_out) {
  const long long words = nbytes / static_cast<long long>(sizeof(W));
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ring_hop_peer_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), nbytes, recv);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) *blocks_out = blocks;
  return e;
}

}  // namespace

extern "C" {

// The start: copy `nbytes` from `src` (on `device`) to `dst` (the
// receiver's buffer, on any card that `device` can reach), then one
// signal per block on `recv` (the receiver's page).  Launched on
// `stream`, which belongs to `device`.  Writes the block count (the
// signals this put adds) to `blocks_out`.  Returns cudaGetLastError()
// after the launch (0 = launched).
int ompi_peer_put(int device, const void* src, void* dst, long long nbytes,
                  void* recv, void* stream, long long* blocks_out) {
  if (nbytes < 0 || recv == nullptr || blocks_out == nullptr)
    return cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Counter* ctr = static_cast<Counter*>(recv);
    const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                            reinterpret_cast<uintptr_t>(dst) |
                            static_cast<uintptr_t>(nbytes);
    if (align % 16 == 0) return launch_put<uint4>(src, dst, nbytes, ctr, st, blocks_out);
    if (align % 8 == 0) return launch_put<uint2>(src, dst, nbytes, ctr, st, blocks_out);
    if (align % 4 == 0) return launch_put<unsigned>(src, dst, nbytes, ctr, st, blocks_out);
    if (align % 2 == 0)
      return launch_put<unsigned short>(src, dst, nbytes, ctr, st, blocks_out);
    return launch_put<unsigned char>(src, dst, nbytes, ctr, st, blocks_out);
  });
}

// The semaphore wait: on `stream` (of `device`), release-store
// `post_val` into `post` (skipped when null), then wait until the
// counter at `wait` reaches `target`, or store 1 into `timed_out` (host
// memory) after `timeout_ns` and give up.  One thread.
int ompi_peer_wait(int device, void* post, unsigned long long post_val,
                   const void* wait, unsigned long long target, void* timed_out,
                   long long timeout_ns, void* stream) {
  if (wait == nullptr || timed_out == nullptr || timeout_ns <= 0)
    return cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    ring_hop_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<Counter*>(post), post_val, static_cast<const Counter*>(wait),
        target, static_cast<volatile long long*>(timed_out), timeout_ns);
    return cudaGetLastError();
  });
}

// One rank's counter page on `device`: cudaMalloc'd, zeroed once.
int ompi_peer_page_alloc(int device, void** out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    void* p = nullptr;
    cudaError_t e = cudaMalloc(&p, kPageBytes);
    if (e != cudaSuccess) return e;
    e = cudaMemset(p, 0, kPageBytes);
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
