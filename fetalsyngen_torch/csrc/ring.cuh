// The ring of tiles shared by the staged kernels of probes.cu (K3, K4) and
// the hat ring kernel of hat_common.cuh (K1, K2): device code that walks a
// persistent block over tiles of consecutive rows, and the host code that
// plans and launches such a walk.
//
// A tile is a run of consecutive rows of a flattened (rows, S) operand of
// f32 (or, for the hat kernels' bf16 forms, bf16) elements, a multiple of
// V / gcd(S, V) rows (V = 16 / element size: 4 floats, 8 bf16) so that every
// tile starts on 16 bytes, or, for a "loose" ring (K1), any number of rows of
// an operand at any element offset; the operand's last tile may be partial. A persistent grid (as
// many blocks as fit the card, at most one per tile) draws tiles from a
// counter in device memory: thread 0 fills a ring of three tile buffers (two
// where three do not fit) in shared memory with TMA bulk copies
// (cp.async.bulk, one mbarrier per buffer counts the bytes in) while every
// thread computes on the current buffer; the __syncthreads() that ends a
// tile frees its buffer for the next draw (ring_walk). ring_walk_producer
// walks the same ring with a producer warp and a second mbarrier per buffer
// that the computing warps arrive on, for a kernel of one block per SM.
// Drawing balances the blocks: with a fixed grid-stride share each, the
// card's slowest blocks ran on alone at the end of a launch. A bulk copy
// moves whole 16-byte units between 16-byte boundaries, so a tile lies in
// its buffer at the element whose address agrees with the tile's first
// element modulo 16 bytes (Ring::lead, 0 where tiles start on 16 bytes), the
// copy takes the tile's whole 16-byte units, and thread 0 reads the 0 to V-1
// elements before the first unit and after the last itself, before it
// arrives on the buffer's mbarrier, whose release orders them before the
// other threads' wait. A loose ring's buffers have room for the V-1 elements
// of lead.
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
constexpr int kRingConsumers = kRingThreads - 32;  // the threads that compute in ring_walk_producer

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bar` completes a phase on `count` arrivals (and the bytes they expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)), "r"(count) : "memory");
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
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

// Elements of one operand's tile buffer for tiles of tile_elems elements,
// `vec` of them to 16 bytes: as many, or for a loose ring a whole number of
// 16-byte units with room for the up to vec - 1 elements of lead ahead of
// the tile.
__host__ __device__ constexpr int ring_pitch(int tile_elems, bool loose, int vec = 4) {
  return loose ? (tile_elems + 2 * (vec - 1)) & ~(vec - 1) : tile_elems;
}

// The ring of kOps operands of T elements (float, or __nv_bfloat16 for the
// hat kernels' bf16 forms).
template <int kOps, typename T = float>
struct Ring {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  unsigned char* smem;  // the block's dynamic shared memory
  const T* x[kOps];
  long long elems;   // elements per operand
  long long ntiles;  // tiles per operand
  int tile_elems;    // elements per operand and tile
  int pitch;         // elements per operand buffer, ring_pitch(tile_elems, loose, kVec)
  int stages;

  __device__ uint64_t* bar(int s) const { return reinterpret_cast<uint64_t*>(smem) + s; }
  // the tile in buffer s, ntiles or more once the counter has run out
  __device__ long long* tile(int s) const { return reinterpret_cast<long long*>(smem + kRingHeader / 2) + s; }
  __device__ T* buf(int s, int op) const {
    return reinterpret_cast<T*>(smem + kRingHeader) + (static_cast<size_t>(s) * kOps + op) * pitch;
  }
  // elements of tile t of operand op ahead of its first 16-byte boundary, mod kVec
  __device__ int lead(int op, long long t) const {
    return static_cast<int>((reinterpret_cast<uintptr_t>(x[op] + t * tile_elems) & 15) / sizeof(T));
  }
  // where tile t of operand op lies in buffer s
  __device__ const T* data(int s, int op, long long t) const { return buf(s, op) + lead(op, t); }
  // thread 0: tile t of every operand into buffer s (none past the last tile)
  __device__ void fill(long long t, int s) const {
    *tile(s) = t;
    const long long e0 = t * tile_elems;
    const int len = t < ntiles ? static_cast<int>(min(static_cast<long long>(tile_elems), elems - e0)) : 0;
    int head[kOps], bulk[kOps];
    uint32_t bytes = 0;
    for (int op = 0; op < kOps; ++op) {
      const T* src = x[op] + e0;
      T* dst = buf(s, op) + lead(op, t);
      head[op] = min(len, (kVec - lead(op, t)) & (kVec - 1));
      bulk[op] = (len - head[op]) & ~(kVec - 1);
      for (int i = 0; i < head[op]; ++i) dst[i] = src[i];
      for (int i = head[op] + bulk[op]; i < len; ++i) dst[i] = src[i];
      bytes += static_cast<uint32_t>(bulk[op] * sizeof(T));
    }
    mbar_arrive_expect(bar(s), bytes);
    for (int op = 0; op < kOps; ++op) {
      if (bulk[op] > 0) {
        bulk_load(buf(s, op) + lead(op, t) + head[op], x[op] + e0 + head[op],
                  static_cast<uint32_t>(bulk[op] * sizeof(T)), bar(s));
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
template <int kOps, typename T, typename Body>
__device__ __forceinline__ void ring_walk(const Ring<kOps, T>& ring, TileCounter* counter, Body&& body) {
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

// Arrive on `bar` (a release of this thread's earlier shared-memory reads and
// writes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_addr(bar)) : "memory");
}

// The walk of ring_walk with a producer warp: of a block's kRingThreads
// threads, the last warp's first thread (the producer) draws tiles (its
// first `stages` in one atomic) and fills the buffers; the other warps
// (kRingConsumers threads) run body(t, s) on each tile in turn and release
// its buffer on the buffer's `empty` mbarrier, one arrival per warp; the
// producer draws and refills a buffer once every consumer warp has released
// it. No barrier spans the block: a warp waits for its tile's bytes alone,
// up to `stages` tiles ahead of the slowest warp, and the draw's round trip
// to L2 and the fills stay off the consumers' path. The header holds the
// full mbarriers of up to four stages in slots 0-3 and their empty ones in
// 4-7 (plan() gives at most three).
template <int kOps, typename T, typename Body>
__device__ __forceinline__ void ring_walk_producer(const Ring<kOps, T>& ring, TileCounter* counter, Body&& body) {
  constexpr int kConsumerWarps = kRingConsumers / 32;
  RingClock clock;
  clock.start();
  const auto empty = [&](int s) { return ring.bar(s) + 4; };  // the header's mbarrier slots 4-7
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.bar(s));
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == kRingConsumers) {  // the producer
    const unsigned long long first = atomicAdd(&counter->next, static_cast<unsigned long long>(ring.stages));
    long long filled = 0;
    for (int s = 0; s < ring.stages && filled < ring.ntiles; ++s) {
      filled = static_cast<long long>(first + s);
      ring.fill(filled, s);
    }
    for (int k = ring.stages; filled < ring.ntiles; ++k) {
      const int s = k % ring.stages;
      mbar_wait(empty(s), static_cast<uint32_t>((k / ring.stages - 1) & 1));
      filled = static_cast<long long>(atomicAdd(&counter->next, 1ull));
      ring.fill(filled, s);
    }
    __threadfence();  // this block's draws before its count
    if (atomicAdd(&counter->done, 1u) == gridDim.x - 1) {
      counter->next = 0;
      counter->done = 0;
    }
  } else if (threadIdx.x < kRingConsumers) {  // the consumers
    int s = 0;
    uint32_t parity = 0;
    while (true) {
      clock.wait_begin();
      mbar_wait(ring.bar(s), parity);
      clock.wait_end();
      const long long t = *ring.tile(s);
      if (t >= ring.ntiles) break;
      body(t, s);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
      if (++s == ring.stages) {
        s = 0;
        parity ^= 1u;
      }
    }
  }
  clock.end();
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

// Rows of a tile of about `target` bytes of S lanes of `esize`-byte
// elements: a multiple of lcm(unit, step) where one fits, else of unit (at
// least one unit).
int tile_rows_for(int target, int esize, int S, int unit, int step) {
  const int fit = target / (esize * S);
  int both = unit;
  while (both % step) both += unit;
  if (fit >= both) return fit / both * both;
  return fit >= unit ? fit / unit * unit : unit;
}

// The launch of a kernel on nrows rows of S lanes of `ops` operands of
// `esize`-byte elements (4: f32, 2: bf16): tiles of as many rows as fit
// `target` bytes per operand, in units of V / gcd(S, V) rows (whole 16-byte
// units, V = 16 / esize), or of one row for a `loose` ring, and a multiple
// of `step` rows (the rows a block computes at once) where that fits. No
// ring (`fn` null): one tile per block, placed by the card's block
// scheduler. The ring kernel `fn`: three stages, two where three do not fit
// kSmemMax, and as many blocks as fit the card (at most one per tile). With
// `min_tiles`, a pass of fewer than min_tiles tiles per resident block takes
// tiles of half the bytes, down to `step` rows, so that a block's ring
// stages overlap.
cudaError_t plan(const void* fn, int dev, int ops, long long nrows, int S, int target, Geometry* g,
                 bool loose = false, int esize = 4, int step = 1, int min_tiles = 0) {
  if (nrows < 1 || S < 1 || step < 1 || (esize != 2 && esize != 4)) return cudaErrorInvalidValue;
  const int vec = 16 / esize;
  int common = vec;  // gcd(S, vec), vec a power of two
  while (S % common) common /= 2;
  const int unit = loose ? 1 : vec / common;
  while (true) {
    g->tile_rows = tile_rows_for(target, esize, S, unit, step);
    const long long ntiles = (nrows + g->tile_rows - 1) / g->tile_rows;
    g->stages = 0;
    g->smem = 0;
    if (fn == nullptr) {
      if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
      g->grid = static_cast<int>(ntiles);
      return cudaSuccess;
    }
    const long long stage = static_cast<long long>(ops) * ring_pitch(g->tile_rows * S, loose, vec) * esize;
    g->stages = kRingHeader + 3 * stage <= kSmemMax ? 3 : 2;
    if (kRingHeader + g->stages * stage > kSmemMax) return cudaErrorInvalidValue;
    g->smem = static_cast<int>(kRingHeader + g->stages * stage);
    int blocks = 0;
    const cudaError_t e = card_blocks(fn, dev, g->smem, &blocks);
    if (e != cudaSuccess) return e;
    g->grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
    const int smaller = tile_rows_for(target / 2, esize, S, unit, step);
    if (ntiles >= static_cast<long long>(min_tiles) * blocks || smaller >= g->tile_rows || smaller < step) {
      return cudaSuccess;
    }
    target /= 2;
  }
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
