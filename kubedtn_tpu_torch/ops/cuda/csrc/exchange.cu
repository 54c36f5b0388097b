// K4: one step of the sharded live tick's mailbox ring, for Hopper (sm_90a).
//
// Counterpart of the Pallas kernel `_right_permute_kernel` in
// kubedtn_tpu/parallel/exchange.py (launched by `dma_right_shift`): shard s
// copies its mailbox block into the buffer of its right neighbour,
// dst[(s+1) mod S] = src[s], byte for byte. No arithmetic touches the
// payload: the mailbox is one buffer of 32-bit words per shard, [R, 24] =
// 21 float words (props, clocks, correlation memory) then 3 int words
// (owner flag, packet count, active), and the float payload is a view of
// the same words. One ring step is one launch per shard.
//
// What bounds it on an H100: bytes, 2 * R * 96 B per shard and step (read
// once, written once), against 3.35 TB/s within one card or 450 GB/s each
// way over NVLink. At the live tick's R = 4096 that is about 0.2 us, well
// under a launch's own latency, so a step is launch-bound; the byte regime
// shows only from R ~ 32768 up. The kernel is a grid-stride copy with
// 16-byte vector loads and stores where both pointers are 16-byte aligned,
// and a scalar tail for a word count not divisible by four.
//
// Cross-device ordering. Where the Pallas kernel waits on a send and a recv
// DMA semaphore, the port orders with CUDA events, outside the kernel:
//   - recv side: the wrapper records an event on the writer's stream after
//     the launch, and the destination card's stream waits on it before the
//     select-combine reads the buffer;
//   - send side: the destination buffer is allocated fresh for every step
//     on its card (as the JAX ring's `rf = shift(rf)` is a new array). The
//     allocator orders that block on the destination card's stream, where
//     work queued earlier may still read or write it, so the writer's
//     stream first waits on the destination card's stream; the buffer is
//     then marked used by the writer's stream (record_stream), so it is
//     not reused while the write may still run. Both directions are
//     ordered, as torch's own cross-device copy orders them, with no
//     in-kernel flag. An in-kernel flag protocol (st.release.sys /
//     ld.acquire.sys) is later work.
// With shards on several cards of one process, `dst` lies on the right
// neighbour's card and the stores go straight over NVLink once
// kdt_enable_peer has enabled peer access from the writer's card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // a few waves over the 132 SMs

__global__ void ring_step(const uint32_t* __restrict__ src,
                          uint32_t* __restrict__ dst, long long n_vec,
                          long long n_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (long long j = i; j < n_vec; j += stride) d4[j] = s4[j];
  for (long long j = 4 * n_vec + i; j < n_words; j += stride) dst[j] = src[j];
}

}  // namespace

// dst[0:n_words] = src[0:n_words] (32-bit words) on `stream`. Returns the
// launch's cudaError_t.
extern "C" int kdt_ring_step(const void* src, void* dst, int n_words,
                             void* stream) {
  if (n_words <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15u) == 0;
  const long long n = n_words;
  const long long n_vec = aligned ? n / 4 : 0;
  const long long items = n_vec + (n - 4 * n_vec);
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  ring_step<<<static_cast<unsigned>(blocks), THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), n_vec,
      n);
  return static_cast<int>(cudaGetLastError());
}

// Let kernels running on card `dev` store into card `peer`'s memory.
// Returns cudaErrorPeerAccessUnsupported when the pair cannot, 0 when access
// is enabled (or already was), else the error. The caller's current device
// is restored.
extern "C" int kdt_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: already enabled is success here
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(restore);
}
