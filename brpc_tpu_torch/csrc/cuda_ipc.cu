// CUDA IPC for the xfer lane: export a device allocation to another process
// on the same host, map a peer's export, copy out of it, and unmap.
//
// A plain C interface, loaded with ctypes by brpc_tpu_torch/rpc/
// cuda_ipc_transfer.py. Every function first makes `dev` current on the
// calling thread (the runtime binds the device's primary context, which
// PyTorch shares), so it may be called from any thread.
//
// Return value: 0 on success; a cudaError_t of the failing runtime call; or
// BT_CU_ERROR + CUresult when the libcuda call fails.
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#define BT_CU_ERROR 100000
#define BT_NO_CU_SYMBOL 200000

// cuMemGetAddressRange_v2(CUdeviceptr* base, size_t* size, CUdeviceptr ptr)
typedef int (*mem_range_fn)(unsigned long long*, size_t*, unsigned long long);

static mem_range_fn mem_range() {
  static mem_range_fn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) {
      fn = (mem_range_fn)dlsym(lib, "cuMemGetAddressRange_v2");
    }
  }
  return fn;
}

extern "C" {

// The handle of the allocation that holds `ptr`, and ptr's byte offset from
// the allocation's base: a handle names the whole allocation (the caching
// allocator's segment), never a tensor inside it.
int bt_ipc_export(int dev, uint64_t ptr, char* out_handle,
                  uint64_t* out_offset) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  mem_range_fn range = mem_range();
  if (range == nullptr) return BT_NO_CU_SYMBOL;
  unsigned long long base = 0;
  size_t size = 0;
  int res = range(&base, &size, (unsigned long long)ptr);
  if (res != 0) return BT_CU_ERROR + res;
  cudaIpcMemHandle_t handle;
  err = cudaIpcGetMemHandle(&handle, (void*)(uintptr_t)base);
  if (err != cudaSuccess) return (int)err;
  memcpy(out_handle, &handle, sizeof(handle));
  *out_offset = ptr - (uint64_t)base;
  return 0;
}

// Map a peer's allocation; *out_base is its base in this process.
int bt_ipc_open(int dev, const char* handle, uint64_t* out_base) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* base = nullptr;
  err = cudaIpcOpenMemHandle(&base, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) return (int)err;
  *out_base = (uint64_t)(uintptr_t)base;
  return 0;
}

int bt_ipc_close(int dev, uint64_t base) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaIpcCloseMemHandle((void*)(uintptr_t)base);
}

// Device-to-device copy of n bytes, queued on `stream` (PyTorch's stream).
int bt_ipc_copy(int dev, uint64_t dst, uint64_t src, uint64_t n,
                uint64_t stream) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync((void*)(uintptr_t)dst, (const void*)(uintptr_t)src,
                              (size_t)n, cudaMemcpyDeviceToDevice,
                              (cudaStream_t)(uintptr_t)stream);
}

int bt_ipc_sync(int dev, uint64_t stream) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize((cudaStream_t)(uintptr_t)stream);
}

const char* bt_ipc_error_string(int code) {
  if (code == BT_NO_CU_SYMBOL) {
    return "cuMemGetAddressRange_v2 not found in libcuda.so.1";
  }
  if (code >= BT_CU_ERROR) return "libcuda error";
  return cudaGetErrorString((cudaError_t)code);
}

int bt_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

}  // extern "C"
