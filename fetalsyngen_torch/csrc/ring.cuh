// The ring of tiles shared by the staged kernels of probes.cu (K3, K4) and
// hat_single.cu (K2): device code that walks a persistent block over tiles of
// consecutive rows, and the host code that plans and launches such a walk.
//
// A tile is a run of consecutive rows of a flattened (rows, S) operand, a
// multiple of 4 / gcd(S, 4) rows so that every tile starts on 16 bytes; the
// operand's last tile may be partial. A persistent grid (as many blocks as
// fit the card, at most one per tile) draws tiles from a counter in device
// memory: thread 0 fills a ring of three tile buffers (two where three do not
// fit) in shared memory with TMA bulk copies (cp.async.bulk, one mbarrier
// per buffer counts the bytes in) while every thread computes on the current
// buffer; the __syncthreads() that ends a tile frees its buffer for the next
// draw.
// Drawing balances the blocks: with a fixed grid-stride share each, the
// card's slowest blocks ran on alone at the end of a launch. A bulk copy
// moves whole 16-byte units, so thread 0 reads the last len % 4 floats of
// the operand's last tile itself, before it arrives on the buffer's
// mbarrier, whose release orders them before the other threads' wait.
//
// Everything here is in the anonymous namespace (a nested one trips nvcc's
// registration stubs): each library that includes the header keeps its own
// caches and its own counter per (device, stream).
// Built with -DFSG_RING_PROFILE (fetalsyngen_torch/probes/ring_profile.py),
// each ring block records its start and end on the global timer and, for
// thread 32, the cycles it waited on the ring's barriers and the cycles of
// its walk; fsg_ring_records reads them back.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRingThreads = 512;  // threads of a ring block
constexpr int kSmemMax = 232448;   // the dynamic shared memory a block may opt into on sm_90
constexpr int kRingHeader = 128;   // the ring's mbarriers and tile numbers, ahead of its buffers

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)), "r"(1u) : "memory");
}

// Arrive on `bar` (a release: this thread's earlier shared-memory writes are
// seen by the threads its phase releases) and expect `bytes` from bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: `bytes` (a multiple of 16) from global `src` to shared `dst`, both on
// 16 bytes; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// The tile counter the blocks of one ring launch draw from; the launch's last
// block to finish sets it back to zero for the next launch on its stream.
struct TileCounter {
  unsigned long long next;
  unsigned int done;
};

template <int kOps>
struct Ring {
  unsigned char* smem;  // the block's dynamic shared memory
  const float* x[kOps];
  long long elems;   // floats per operand
  long long ntiles;  // tiles per operand
  int tile_elems;    // floats per operand and tile, a multiple of 4
  int stages;

  __device__ uint64_t* bar(int s) const { return reinterpret_cast<uint64_t*>(smem) + s; }
  // the tile in buffer s, ntiles or more once the counter has run out
  __device__ long long* tile(int s) const { return reinterpret_cast<long long*>(smem + kRingHeader / 2) + s; }
  __device__ float* buf(int s, int op) const {
    return reinterpret_cast<float*>(smem + kRingHeader) +
           (static_cast<size_t>(s) * kOps + op) * tile_elems;
  }
  // thread 0: tile t of every operand into buffer s (none past the last tile)
  __device__ void fill(long long t, int s) const {
    *tile(s) = t;
    const long long e0 = t * tile_elems;
    const int len = t < ntiles ? static_cast<int>(min(static_cast<long long>(tile_elems), elems - e0)) : 0;
    const int bulk = len & ~3;
    for (int op = 0; op < kOps; ++op) {
      for (int i = bulk; i < len; ++i) buf(s, op)[i] = x[op][e0 + i];
    }
    mbar_arrive_expect(bar(s), static_cast<uint32_t>(kOps * bulk * sizeof(float)));
    if (bulk > 0) {
      for (int op = 0; op < kOps; ++op) {
        bulk_load(buf(s, op), x[op] + e0, static_cast<uint32_t>(bulk * sizeof(float)), bar(s));
      }
    }
  }
};

#ifdef FSG_RING_PROFILE
// For each of the first kRecords ring blocks of the last launch: its start
// and end on the global timer (ns), and for thread 32 the cycles it waited on
// the ring's barriers and the cycles of its walk.
constexpr int kRecords = 65536;
__device__ unsigned long long ring_records[4 * kRecords];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct RingClock {
  long long walk0 = 0, waited = 0, wait0 = 0;
  __device__ void start() {
    if (threadIdx.x == 0 && blockIdx.x < kRecords) ring_records[4 * blockIdx.x] = global_ns();
    walk0 = clock64();
  }
  __device__ void wait_begin() { wait0 = clock64(); }
  __device__ void wait_end() { waited += clock64() - wait0; }
  __device__ void end() {
    if (threadIdx.x == 32 && blockIdx.x < kRecords) {
      ring_records[4 * blockIdx.x + 2] = waited;
      ring_records[4 * blockIdx.x + 3] = clock64() - walk0;
    }
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < kRecords) ring_records[4 * blockIdx.x + 1] = global_ns();
  }
};
#else
struct RingClock {  // records nothing
  __device__ void start() {}
  __device__ void wait_begin() {}
  __device__ void wait_end() {}
  __device__ void end() {}
};
#endif

// The block draws tiles from `counter` in turn into its buffers, waits for
// each, runs body(t, s) on it and, once every thread has left the buffer,
// refills it with the next tile drawn. The draws of one block rise, so the
// first buffer past the last tile ends the walk with no copy in flight.
template <int kOps, typename Body>
__device__ __forceinline__ void ring_walk(const Ring<kOps>& ring, TileCounter* counter, Body&& body) {
  RingClock clock;
  clock.start();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) mbar_init(ring.bar(s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) ring.fill(static_cast<long long>(atomicAdd(&counter->next, 1ull)), s);
  }
  int s = 0;
  uint32_t parity = 0;
  while (true) {
    clock.wait_begin();
    mbar_wait(ring.bar(s), parity);
    clock.wait_end();
    const long long t = *ring.tile(s);
    if (t >= ring.ntiles) break;
    body(t, s);
    __syncthreads();
    if (threadIdx.x == 0) ring.fill(static_cast<long long>(atomicAdd(&counter->next, 1ull)), s);
    if (++s == ring.stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  clock.end();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's draws before its count
    if (atomicAdd(&counter->done, 1u) == gridDim.x - 1) {
      counter->next = 0;
      counter->done = 0;
    }
  }
}

// out[l + k] = v[k] for the lanes l + k < S: one 16-byte store, streaming
// past the caches, where all four lie in the row on a 16-byte boundary, else
// lane by lane
__device__ __forceinline__ void store4(float* out, int l, int S, const float* v) {
  if (l + 3 < S && (reinterpret_cast<uintptr_t>(out + l) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(out + l), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (l + k < S) out[l + k] = v[k];
    }
  }
}

// --- the host side -------------------------------------------------------------

struct Geometry {
  int tile_rows, stages, grid, smem;  // stages 0: no ring (one tile per block)
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The host's caches below are shared by the threads that launch.
std::atomic_flag cache_lock = ATOMIC_FLAG_INIT;

struct CacheLock {
  CacheLock() {
    while (cache_lock.test_and_set(std::memory_order_acquire)) {
    }
  }
  ~CacheLock() { cache_lock.clear(std::memory_order_release); }
};

// Blocks of the ring kernel `fn` that fit on device `dev` at `smem` bytes,
// cached per (kernel, device, size); the first launch also lets the kernel
// opt into all of kSmemMax and prefer shared memory over L1.
cudaError_t card_blocks(const void* fn, int dev, int smem, int* blocks) {
  struct Fit {
    const void* fn;
    int dev, smem, blocks;
  };
  constexpr int kFits = 64;
  static Fit fits[kFits];
  static int nfits = 0;
  CacheLock lock;
  for (int i = 0; i < nfits; ++i) {
    if (fits[i].fn == fn && fits[i].dev == dev && fits[i].smem == smem) {
      *blocks = fits[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kRingThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) {
    *blocks = sms * per_sm;
    if (nfits < kFits) fits[nfits++] = {fn, dev, smem, *blocks};
  }
  return e;
}

// The ring kernels' tile counter of (device `dev`, stream `st`), allocated and
// zeroed on the stream at its first launch. Launches on one stream run one
// after another and each leaves the counter at zero; launches on two streams
// never share one.
cudaError_t tile_counter(int dev, cudaStream_t st, TileCounter** counter) {
  struct Slot {
    int dev;
    cudaStream_t st;
    TileCounter* counter;
  };
  constexpr int kSlots = 64;
  static Slot slots[kSlots];
  static int nslots = 0;
  CacheLock lock;
  for (int i = 0; i < nslots; ++i) {
    if (slots[i].dev == dev && slots[i].st == st) {
      *counter = slots[i].counter;
      return cudaSuccess;
    }
  }
  if (nslots == kSlots) return cudaErrorMemoryAllocation;
  cudaError_t e = cudaMalloc(reinterpret_cast<void**>(counter), sizeof(TileCounter));
  if (e == cudaSuccess) e = cudaMemsetAsync(*counter, 0, sizeof(TileCounter), st);
  if (e == cudaSuccess) slots[nslots++] = {dev, st, *counter};
  return e;
}

// The launch of a kernel on nrows rows of S lanes of `ops` operands: tiles of
// as many rows as fit `target` bytes per operand, in units of 4 / gcd(S, 4)
// rows (whole 16-byte units). No ring (`fn` null): one tile per block, placed
// by the card's block scheduler. The ring kernel `fn`: three stages, two
// where three do not fit kSmemMax, and as many blocks as fit the card (at
// most one per tile).
cudaError_t plan(const void* fn, int dev, int ops, long long nrows, int S, int target, Geometry* g) {
  if (nrows < 1 || S < 1) return cudaErrorInvalidValue;
  const int unit = S % 4 == 0 ? 1 : (S % 2 == 0 ? 2 : 4);
  g->tile_rows = target / (4 * S) / unit * unit;
  if (g->tile_rows < unit) g->tile_rows = unit;
  const long long ntiles = (nrows + g->tile_rows - 1) / g->tile_rows;
  g->stages = 0;
  g->smem = 0;
  if (fn == nullptr) {
    if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
    g->grid = static_cast<int>(ntiles);
    return cudaSuccess;
  }
  const long long stage = static_cast<long long>(ops) * g->tile_rows * S * sizeof(float);
  g->stages = kRingHeader + 3 * stage <= kSmemMax ? 3 : 2;
  if (kRingHeader + g->stages * stage > kSmemMax) return cudaErrorInvalidValue;
  g->smem = static_cast<int>(kRingHeader + g->stages * stage);
  int blocks = 0;
  const cudaError_t e = card_blocks(fn, dev, g->smem, &blocks);
  if (e != cudaSuccess) return e;
  g->grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
  return cudaSuccess;
}

}  // namespace

#ifdef FSG_RING_PROFILE
// The ring blocks' records of the last launch: 4 per block, `blocks` <=
// kRecords. Returns a cudaError code.
extern "C" int fsg_ring_records(unsigned long long* out, int blocks) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, ring_records, sizeof(unsigned long long) * 4 * blocks));
}
#endif
