// What a CUDA engine owns on the device side: its streams and its
// page-locked host memory, created and destroyed by the engine itself.
//
// torch.cuda.Stream() hands out streams from a fixed pool of 32 per
// device, round robin: the 33rd stream a process asks for is the first
// one again. Every engine takes three (compute, copy, graph capture), so
// with eleven engines alive two of them share a stream, and a capture on
// it would record the other engine's work. These entry points create a
// stream of the engine's own (non-blocking, like the pool's: it does not
// synchronize with the legacy default stream) and destroy it when the
// engine stops. The Python side wraps the handle as
// torch.cuda.ExternalStream (evam_tpu_torch/engine/streams.py).
//
// A stream that is destroyed must not be named again, and torch's
// caching host allocator names every stream a pinned block of its was
// copied on when the block is freed (it records an event there). So the
// engine's staging and readback memory is not torch's: numpy memory
// page-locked here with cudaHostRegister, which the host allocator does
// not track.
//
// A plain C interface, loaded with ctypes like the kernels. No kernel
// lives here.

#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// Creates a non-blocking stream of `priority` on `device`; writes its
// handle to *out. The calling thread's current device is left as it was.
int evam_stream_create(int device, int priority, uint64_t* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = nullptr;
  err = cudaStreamCreateWithPriority(&stream, cudaStreamNonBlocking,
                                     priority);
  cudaSetDevice(prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = reinterpret_cast<uint64_t>(stream);
  return 0;
}

// Destroys a stream made by evam_stream_create. Work still queued on it
// completes first (cudaStreamDestroy returns at once and releases the
// stream when the device is done with it).
int evam_stream_destroy(int device, uint64_t handle) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamDestroy(reinterpret_cast<cudaStream_t>(handle));
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Page-locks [ptr, ptr + size) for every context (the engine's copies
// from and to it are then true asynchronous DMA).
int evam_host_register(uint64_t ptr, uint64_t size) {
  return static_cast<int>(cudaHostRegister(reinterpret_cast<void*>(ptr),
                                           size, cudaHostRegisterPortable));
}

int evam_host_unregister(uint64_t ptr) {
  return static_cast<int>(cudaHostUnregister(reinterpret_cast<void*>(ptr)));
}

const char* evam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
