// peer_window: the host side of the RDMA rung across processes. No kernel.
//
// Replaces no Pallas kernel. The TPU kernel it serves is
// mpi_and_open_mp_tpu/parallel/haloplan.py:_rdma_edge_pair.kernel (its
// pallas_call is at :309), which signals a barrier semaphore on both ring
// neighbours, waits for both, then copies its edges into the neighbours'
// buffers by remote DMA. Across processes of one card (or of cards with
// peer access) the port's two rung kernels, halo_frame.cu and
// halo_edge_pair.cu, read the neighbours' cells where they lie instead:
// each rank owns a window, a device buffer in two slots, and maps its ring
// neighbours' windows into its own address space through CUDA IPC. This
// file holds the CUDA runtime calls that needs (parallel/peers.py drives
// them):
//
// peer_window_alloc   one window of `bytes` (cudaMalloc, so that the IPC
//                     handle maps exactly this allocation) and an
//                     interprocess event, with the handles of both
//                     (64 bytes each) for the neighbours;
// peer_window_open    a neighbour's window and event from its handles
//                     (cudaIpcMemLazyEnablePeerAccess);
// peer_window_close   a window and event, own or opened;
// peer_window_record  the event on a stream, after the writes to a slot;
// peer_window_wait    a stream waits for a neighbour's event;
// peer_window_can_access  cudaDeviceCanAccessPeer (1 for the same card).
//
// The event stands in for the TPU kernel's barrier semaphore, and waits on
// the card (cudaStreamWaitEvent): no kernel spins on a flag in peer memory,
// which two processes that time-slice one card would never release.
//
// Bound on the H100: none of its own. It moves no bytes; the rung's
// kernels read the windows in place, and their bounds count those bytes.
#include <cuda_runtime.h>

#include <cstring>

// Code of the entry points' own checks (CUDA's error codes are positive).
namespace {
constexpr int kErrArg = -1;
}

extern "C" int peer_window_alloc(long long bytes, void** ptr, void** event,
                                 void* mem_handle, void* event_handle) {
  if (bytes <= 0 || !ptr || !event || !mem_handle || !event_handle)
    return kErrArg;
  *ptr = nullptr;
  *event = nullptr;
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t mh;
  e = cudaIpcGetMemHandle(&mh, *ptr);
  cudaEvent_t ev = nullptr;
  if (e == cudaSuccess)
    e = cudaEventCreateWithFlags(
        &ev, cudaEventDisableTiming | cudaEventInterprocess);
  cudaIpcEventHandle_t eh;
  if (e == cudaSuccess) e = cudaIpcGetEventHandle(&eh, ev);
  if (e != cudaSuccess) {
    if (ev) cudaEventDestroy(ev);
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(e);
  }
  std::memcpy(mem_handle, &mh, sizeof(mh));
  std::memcpy(event_handle, &eh, sizeof(eh));
  *event = ev;
  return 0;
}

extern "C" int peer_window_open(const void* mem_handle,
                                const void* event_handle, void** ptr,
                                void** event) {
  if (!mem_handle || !event_handle || !ptr || !event) return kErrArg;
  *ptr = nullptr;
  *event = nullptr;
  cudaIpcMemHandle_t mh;
  cudaIpcEventHandle_t eh;
  std::memcpy(&mh, mem_handle, sizeof(mh));
  std::memcpy(&eh, event_handle, sizeof(eh));
  cudaError_t e = cudaIpcOpenMemHandle(ptr, mh, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaEvent_t ev = nullptr;
  e = cudaIpcOpenEventHandle(&ev, eh);
  if (e != cudaSuccess) {
    cudaIpcCloseMemHandle(*ptr);
    *ptr = nullptr;
    return static_cast<int>(e);
  }
  *event = ev;
  return 0;
}

// own: 1 for a window this process allocated, 0 for one it opened.
extern "C" int peer_window_close(void* ptr, void* event, int own) {
  cudaError_t e = cudaSuccess, e2 = cudaSuccess;
  if (event) e = cudaEventDestroy(static_cast<cudaEvent_t>(event));
  if (ptr) e2 = own ? cudaFree(ptr) : cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(e != cudaSuccess ? e : e2);
}

extern "C" int peer_window_record(void* event, void* stream) {
  if (!event) return kErrArg;
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int peer_window_wait(void* event, void* stream) {
  if (!event) return kErrArg;
  return static_cast<int>(cudaStreamWaitEvent(
      static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t>(event), 0));
}

extern "C" int peer_window_can_access(int device, int peer, int* out) {
  if (!out) return kErrArg;
  *out = 0;
  if (device == peer) {
    *out = 1;
    return 0;
  }
  return static_cast<int>(cudaDeviceCanAccessPeer(out, device, peer));
}

extern "C" const char* peer_window_error(int code) {
  if (code == kErrArg) return "a null pointer or a size below 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
