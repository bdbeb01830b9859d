// Device memory shared between the processes of a mesh's seq axis, through
// CUDA IPC. Plain C interface, loaded with ctypes from
// omnivggt_tpu_torch/parallel/peer.py.
//
// A symmetric buffer is one allocation per process, each of the same size.
// Every process exports a handle to its own (omnivggt_peer_handle), the
// handles are exchanged on the host, and every process maps every other
// process's allocation into its own address space (omnivggt_peer_open with
// cudaIpcMemLazyEnablePeerAccess, so the same call maps memory of another
// card or of the same card). A kernel then reaches a peer's buffer through
// the mapped pointer as through its own: the ring kernels'
// rotation stores into the right neighbour's slot, which is what the TPU
// kernels' remote copy does.
//
// The allocations are this library's own cudaMalloc, not PyTorch's caching
// allocator: a pointer from the caching allocator lies inside a larger
// block, and an IPC handle names a whole allocation from its base.
//
// Every entry point sets the device first and returns a cudaError_t (0 =
// success); omnivggt_peer_error turns one into CUDA's own message.

#include <cuda_runtime.h>

#include <cstring>

extern "C" {

int omnivggt_peer_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

const char* omnivggt_peer_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `bytes` of device memory on `device`, zero-filled; *ptr receives it.
int omnivggt_peer_malloc(int device, unsigned long long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

int omnivggt_peer_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

// The IPC handle of an allocation of this library, copied into `out`
// (omnivggt_peer_handle_bytes() bytes).
int omnivggt_peer_handle(int device, void* ptr, unsigned char* out) {
  cudaIpcMemHandle_t handle;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&handle, ptr);
  if (err == cudaSuccess) std::memcpy(out, &handle, sizeof(handle));
  return static_cast<int>(err);
}

// Map another process's allocation, named by its handle, into this
// process on `device`; *ptr receives the mapped base. A process cannot
// open a handle of its own.
int omnivggt_peer_open(int device, const unsigned char* in, void** ptr) {
  cudaIpcMemHandle_t handle;
  std::memcpy(&handle, in, sizeof(handle));
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(ptr, handle, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(err);
}

int omnivggt_peer_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

}  // extern "C"
