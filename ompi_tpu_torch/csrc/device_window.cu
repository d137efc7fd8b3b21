// Device windows for the DCN device plane: card memory that two
// processes on one host share through CUDA IPC memory handles.
//
// The JAX package's device plane (ompi_tpu/dcn/device.py) stands in for
// a TPU HBM->HBM DMA with a POSIX shared-memory window, one memcpy and a
// semaphore word.  On an H100 the real thing exists: the sender copies
// its payload into a window allocated here, exports the window's IPC
// handle in the descriptor, and the receiver maps the handle and copies
// the window straight into the tensor it posted.  The payload never
// crosses host memory.  The semaphore word and the placed length stay
// in the 16-byte shared-memory header of the reference's window format
// (dcn/device.py), so the waits, the deadline, the truncation check,
// reap and reclaim are the reference's code.
//
// No kernel lives here: a window's copy is cudaMemcpyAsync on the
// caller's stream, which the copy engines carry at the card's memory
// rate, and every function returns the CUDA error code (0 = success).
//
// Ordering, which the protocol relies on:
//  * the sender's copy into the window has completed (stream
//    synchronize) before the caller stores SEM_DATA in the header;
//  * the receiver's copy out of the window has completed and its
//    mapping is closed before the caller stores SEM_CONSUMED: the
//    sender's reap frees the window, and freeing memory that another
//    process still maps is undefined.
//
// Windows are allocated with cudaMalloc, not through torch's caching
// allocator: a block inside a cached segment exports the whole
// segment's handle (the importer would need an offset), and its
// lifetime would be the allocator's rather than the protocol's.
// cudaMalloc, cudaFree (which synchronizes the device) and
// cudaIpcOpenMemHandle are paid once per transfer.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <string.h>

extern "C" {

int ompi_dw_alloc(int device, unsigned long long nbytes, void** ptr) {
  *ptr = nullptr;
  if (nbytes == 0) return cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  return cudaMalloc(ptr, static_cast<size_t>(nbytes));
}

int ompi_dw_free(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  return cudaFree(ptr);
}

// The window's 64-byte IPC handle, copied into out.
int ompi_dw_ipc_handle(void* ptr, unsigned char* out) {
  cudaIpcMemHandle_t h;
  cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc != cudaSuccess) return rc;
  memcpy(out, &h, sizeof(h));
  return cudaSuccess;
}

int ompi_dw_ipc_handle_size(void) { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Map another process's window (fails on a handle this process exported).
int ompi_dw_ipc_open(int device, const unsigned char* handle, void** ptr) {
  *ptr = nullptr;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ompi_dw_ipc_close(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  return cudaIpcCloseMemHandle(ptr);
}

// Device-to-device copy on the caller's stream, complete on return.
int ompi_dw_copy(void* dst, const void* src, unsigned long long nbytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemcpyAsync(dst, src, static_cast<size_t>(nbytes),
                                   cudaMemcpyDeviceToDevice, st);
  if (rc != cudaSuccess) return rc;
  return cudaStreamSynchronize(st);
}

const char* ompi_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
