// K4: one step of the sharded live tick's mailbox ring, for Hopper (sm_90a).
//
// Counterpart of the Pallas kernel `_right_permute_kernel` in
// kubedtn_tpu/parallel/exchange.py (launched by `dma_right_shift`): shard s
// copies its mailbox block into the buffer of its right neighbour,
// dst[(s+1) mod S] = src[s], byte for byte. No arithmetic touches the
// payload: the mailbox is one buffer of 32-bit words per shard, [R, 24] =
// 21 float words (props, clocks, correlation memory) then 3 int words
// (owner flag, packet count, active), and the float payload is a view of
// the same words.
//
// What bounds it on an H100: bytes, 2 * R * 96 B per shard and step (read
// once, written once), against 3.35 TB/s within one card or 450 GB/s each
// way over NVLink: 0.94 us for 4 shards at the live tick's R = 4096,
// 7.5 us at R = 32768.
//
// What held the first design back. It launched once per shard, a
// grid-stride copy of one uint4 per thread and loop trip, its grid capped
// at 132 x 8 blocks. One ring step on 4 virtual shards took 15.3 us at
// R = 4096 against torch.roll's 7.7 us over the same bytes, and 23.6 us
// at R = 32768 against torch.roll's 20.9 us (kubedtn_tpu_torch/
// kernel_bench.py; NVIDIA H100 80GB HBM3, 700 W): four launches where
// torch.roll pays one, and one 16-byte load in flight per thread.
//
// The design now:
//   - ONE launch per card and ring step. The launch takes a RingPlan by
//     value, the (src, dst) pointers of every shard whose block lies on
//     the launching card; blockIdx.y picks the shard. On virtual shards
//     (the same card repeated in the mesh) a ring step is one launch.
//   - Each thread keeps UNROLL 16-byte loads in flight before it stores
//     them, and the grid is sized to the bytes: one block per
//     THREADS * UNROLL * 16 bytes of one shard, no cap.
//   - A shard whose pointers are not both 16-byte aligned copies scalar
//     words (UNROLL * 4 per thread, the same grid); an aligned shard copies
//     its word count's remainder mod 4 as a scalar tail.
// One ring step on 4 virtual shards now takes 7.1 us at R = 4096 and
// 13.6-14.4 us at R = 32768, against torch.roll's 7.8 and 21.0 us in the
// same calls (PERF.md): launch latency still dominates at the live tick's
// R, and the larger step reaches about half of the byte rate.
//
// Cross-device ordering. Where the Pallas kernel waits on a send and a recv
// DMA semaphore, the port orders with CUDA events, outside the kernel
// (kubedtn_tpu_torch/parallel/exchange.py, once per pair of source card
// and destination card):
//   - recv side: the wrapper records an event on the writer's stream after
//     the launch, and the destination card's stream waits on it before the
//     select-combine reads the buffer;
//   - send side: every destination buffer is allocated fresh for the step
//     on its card (as the JAX ring's `rf = shift(rf)` is a new array). The
//     allocator orders that block on the destination card's stream, where
//     work queued earlier may still read or write it, so the writer's
//     stream first waits on the destination card's stream; the buffer is
//     then marked used by the writer's stream (record_stream), so it is
//     not reused while the write may still run. Both directions are
//     ordered, as torch's own cross-device copy orders them, with no
//     in-kernel flag.
// With shards on several cards of one process, `dst` lies on the right
// neighbour's card and the stores go straight over NVLink once
// kdt_enable_peer has enabled peer access from the writer's card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                       // 16-byte loads in flight
constexpr int WORDS_PER_THREAD = 4 * UNROLL;    // 64 bytes
constexpr int WORDS_PER_BLOCK = THREADS * WORDS_PER_THREAD;
// Shards of one card per launch: parallel/exchange.py's PLAN_MAX.
constexpr int MAX_PLAN = 32;

struct RingPlan {
  const uint32_t* src[MAX_PLAN];
  uint32_t* dst[MAX_PLAN];
};

__global__ void __launch_bounds__(THREADS)
ring_step(RingPlan plan, long long n_words) {
  const uint32_t* src = plan.src[blockIdx.y];
  uint32_t* dst = plan.dst[blockIdx.y];
  const long long base = static_cast<long long>(blockIdx.x) *
                         WORDS_PER_BLOCK;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15u) == 0;
  if (aligned) {
    const long long n_vec = n_words / 4;
    const long long v0 = base / 4 + threadIdx.x;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    uint4 r[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long v = v0 + static_cast<long long>(j) * THREADS;
      if (v < n_vec) r[j] = s4[v];
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long v = v0 + static_cast<long long>(j) * THREADS;
      if (v < n_vec) d4[v] = r[j];
    }
    const long long w = 4 * n_vec + threadIdx.x;  // at most 3 tail words
    if (blockIdx.x == 0 && w < n_words) dst[w] = src[w];
  } else {
    const long long w0 = base + threadIdx.x;
    uint32_t r[WORDS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < WORDS_PER_THREAD; ++j) {
      const long long w = w0 + static_cast<long long>(j) * THREADS;
      if (w < n_words) r[j] = src[w];
    }
#pragma unroll
    for (int j = 0; j < WORDS_PER_THREAD; ++j) {
      const long long w = w0 + static_cast<long long>(j) * THREADS;
      if (w < n_words) dst[w] = r[j];
    }
  }
}

}  // namespace

// For s < n_shards: dsts[s][0:n_words] = srcs[s][0:n_words] (32-bit words),
// every pair in ONE launch on `stream`, n_shards <= MAX_PLAN. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a plan that does not
// fit).
extern "C" int kdt_ring_step(const void* const* srcs, void* const* dsts,
                             int n_shards, int n_words, void* stream) {
  if (n_shards < 0 || n_shards > MAX_PLAN || n_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_shards == 0 || n_words == 0) return 0;
  RingPlan plan{};
  for (int s = 0; s < n_shards; ++s) {
    plan.src[s] = static_cast<const uint32_t*>(srcs[s]);
    plan.dst[s] = static_cast<uint32_t*>(dsts[s]);
  }
  const long long n = n_words;
  const dim3 grid(
      static_cast<unsigned>((n + WORDS_PER_BLOCK - 1) / WORDS_PER_BLOCK),
      static_cast<unsigned>(n_shards));
  ring_step<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(plan,
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
