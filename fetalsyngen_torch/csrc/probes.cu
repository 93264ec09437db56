// Kernel probes: the constructs the hat kernels are built from, each timed on
// its own (copy, shared-memory staging, window reads, tap arithmetic,
// transposes). Each probe computes the function its TPU probe computes, with
// Hopper's construct in place of the TPU's where the two differ; the plain
// PyTorch versions are in fetalsyngen_torch/kernels/probes.py, and every
// kernel here matches its plain version bit for bit. Products and sums are
// explicit _rn intrinsics, so nvcc cannot contract them into FMAs.
//
// K5 pair_copy (replaces scripts/probe_blocktp.py::_copy_kernel): two f32
//   arrays copied as they are, bits and all (NaN payloads, -0.0). Bound:
//   device memory, 16 bytes per element pair. Design: K3 copy's, one 16 KB
//   tile per operand and block, the blocks placed by the card's scheduler,
//   four 16-byte loads per operand in flight a thread, then streaming
//   stores; the measured rate is the copy floor of the card. A grid-stride
//   loop over a fixed grid left the slowest blocks running alone at the end
//   of a launch.
// K6 pair_transpose (replaces scripts/probe_blocktp.py::_tp_kernel): two
//   (N, H, W) arrays to (N, W, H), (n, j, k) -> (n, k, j). Bound: device
//   memory, as K5. Design: 32 x 32 tiles through shared memory padded to 33
//   columns (no bank conflicts on the transposed read), coalesced loads and
//   stores on both sides.
// K3 probe2_* (replaces the probe2_* probe_kernel of
//   scripts/microbench_warp.py): the paired hat kernel's constructs on two
//   (B, R, S) operands, rows r = row_i*H + row_j:
//     copy   out = 2*x, no shared memory;
//     stage  out = the row passed through shared memory;
//     taps   pos = (0.07*row_j + l) + 0.3, n0 = -1, d0 = (pos - l) - n0,
//            out = sum over m < ntaps of max(0, 1 - |d0 - m|) *
//            x[clamp(n0 + m + l, 0, S - 1)], in tap order.
//   The TPU probe stages each row between edge pads of max(128, S) and 128 +
//   S lanes and reads its window at the 128-aligned floor of pad + n0,
//   adding the remainder (127) to d0; here the window starts at n0 + l
//   itself and a pad lane is the clamp of the index. The two agree where
//   every nonzero tap lies inside both windows.
// K4 probe_* (replaces the probe_* probe_kernel of
//   scripts/microbench_warp.py): the single-operand kernel's constructs on a
//   (B, R, S) operand, S a multiple of 128. The TPU stages a row between
//   128-lane edge pads: padded[c] = x[clamp(c - 128, 0, S - 1)].
//     copy    out = 2*x, no shared memory;  stage  the row through shared memory;
//     ladder  pos = 0.11*(r % 8) + l (the TPU's sub-row of 8), n0 =
//             floor(pos - pos) (zero, but computed), base = clamp(128 +
//             lane0 + n0, 0, S) for the lane's 128-lane tile lane0,
//             out = padded[base + l - lane0]: the window shift, which the TPU
//             does with a seven-step roll ladder, here a read at a runtime
//             offset;
//     tiles   out = padded[128*floor(base/128) + l - lane0] + 0*pos: the
//             aligned window without the shift (0*pos turns -0 into +0);
//     sweep12 the ladder's window, d0 = pos - floor(pos), out = sum over
//             m < 12 of max(0, 1 - |d0 - m|) * padded[base + l - lane0 + m].
//   n0 is computed per element here; the TPU takes a tile-wide minimum,
//   which for finite positions is the same zero.
// Bound of K3 and K4: device memory (8 bytes per element and operand); the
//   taps at most ~100 operations per element pair.
// Design of K3 and K4: a block works on tiles of consecutive rows, one
//   contiguous span per operand (at S = 256, 16 rows of 1 KB per operand for
//   K3 and 32 for K4). copy takes one tile per block and leaves the placing
//   of blocks to the card's scheduler: 16-byte loads and stores, four loads
//   per operand in flight a thread, no shared memory. The staged modes walk
//   the ring of ring.cuh (a persistent grid drawing tiles from a counter,
//   three TMA-filled tile buffers per block). Only the S lanes of a row are
//   staged, so each input byte is read from device memory once: a pad lane
//   is the clamp of its index. A thread computes four consecutive lanes of a
//   row, reads shared memory 16 bytes at a time where the four lie in the row
//   on a 16-byte boundary (else one by one, clamped) and stores 16 bytes,
//   streaming past the caches, where the lanes allow (else lane by lane).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kTileRows = 8;
constexpr int kSinglePad = 128;  // K4's edge pad (warp.PAD)
constexpr int kPairTileBytes = 16 * 1024;    // K3's and K5's tile per operand
constexpr int kSingleTileBytes = 32 * 1024;  // K4's tile

__global__ void pair_transpose_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                                      float* __restrict__ oa, float* __restrict__ ob, int H,
                                      int W) {
  __shared__ float ta[kTile][kTile + 1];
  __shared__ float tb[kTile][kTile + 1];
  const size_t slab = static_cast<size_t>(blockIdx.z) * H * W;
  const int k = blockIdx.x * kTile + threadIdx.x;
  const int j0 = blockIdx.y * kTile;
  for (int t = threadIdx.y; t < kTile; t += kTileRows) {
    const int j = j0 + t;
    if (j < H && k < W) {
      ta[t][threadIdx.x] = xa[slab + static_cast<size_t>(j) * W + k];
      tb[t][threadIdx.x] = xb[slab + static_cast<size_t>(j) * W + k];
    }
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  const int k0 = blockIdx.x * kTile;
  for (int t = threadIdx.y; t < kTile; t += kTileRows) {
    const int kk = k0 + t;
    if (kk < W && j < H) {
      oa[slab + static_cast<size_t>(kk) * H + j] = ta[threadIdx.x][t];
      ob[slab + static_cast<size_t>(kk) * H + j] = tb[threadIdx.x][t];
    }
  }
}

// max(0, 1 - |d0 - m|)
__device__ __forceinline__ float tap_weight(float d0, int m) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(d0, static_cast<float>(m)))));
}

enum PairMode : int { kPairCopy = 0, kPairStage = 1, kPairTaps = 2 };
enum SingleMode : int { kCopy = 0, kStage = 1, kLadder = 2, kTiles = 3, kSweep12 = 4 };

// v[i] = row[clamp(c + i, 0, S - 1)], i < 4: one 16-byte read where the four
// lie in the row on a 16-byte boundary, else four
__device__ __forceinline__ void load4(const float* row, int c, int S, float* v) {
  if (c >= 0 && c + 3 < S && (reinterpret_cast<uintptr_t>(row + c) & 15) == 0) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = row[min(max(c + i, 0), S - 1)];
  }
}

// K3 taps at lanes l..l+3 of a staged row pair (sa, sb), four taps at a time
// from the window w[j] = row[clamp(l + n0 + m0 + j)], j < 8: the last value of
// the previous quad, the quad at l + m0 and three of the next.
__device__ __forceinline__ void pair_taps(const float* sa, const float* sb, int l, int S, float row_j,
                                          int ntaps, float* acc_a, float* acc_b) {
  constexpr int n0 = -1;
  float d0[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lf = static_cast<float>(l + k);
    const float pos = __fadd_rn(__fadd_rn(__fmul_rn(0.07f, row_j), lf), 0.3f);
    d0[k] = __fsub_rn(__fsub_rn(pos, lf), static_cast<float>(n0));
    acc_a[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  const int first = min(max(l + n0, 0), S - 1);
  float wa[8], wb[8];
  wa[0] = sa[first];
  wb[0] = sb[first];
  load4(sa, l, S, wa + 1);
  load4(sb, l, S, wb + 1);
  for (int m0 = 0; m0 < ntaps; m0 += 4) {
    float na[4], nb[4];
    load4(sa, l + m0 + 4, S, na);
    load4(sb, l + m0 + 4, S, nb);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wa[5 + j] = na[j];
      wb[5 + j] = nb[j];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (m0 + t < ntaps) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float w = tap_weight(d0[k], m0 + t);
          acc_a[k] = __fadd_rn(acc_a[k], __fmul_rn(w, wa[k + t]));
          acc_b[k] = __fadd_rn(acc_b[k], __fmul_rn(w, wb[k + t]));
        }
      }
    }
    wa[0] = wa[4];
    wb[0] = wb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wa[1 + j] = na[j];
      wb[1 + j] = nb[j];
    }
  }
}

// K4's window modes at lanes l..l+3 (one 128-lane tile) of a staged row
template <int kMode>
__device__ __forceinline__ void single_window(const float* row, int l, int S, float sub_row, float* v) {
  const int lane0 = l & ~127;
  float pos[4];
  int c[4];  // the staged index of each lane's first read: padded column - 128
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pos[k] = __fadd_rn(__fmul_rn(0.11f, sub_row), static_cast<float>(l + k));
    const int n0 = static_cast<int>(floorf(__fsub_rn(pos[k], pos[k])));
    const int base = min(max(kSinglePad + lane0 + n0, 0), S);  // S = width - 384
    c[k] = (kMode == kTiles ? (base / 128) * 128 : base) + l + k - lane0 - kSinglePad;
  }
  const bool run = c[1] == c[0] + 1 && c[2] == c[0] + 2 && c[3] == c[0] + 3;
  if constexpr (kMode == kSweep12) {
    float d0[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d0[k] = __fsub_rn(pos[k], floorf(pos[k]));
      v[k] = 0.0f;
    }
    if (run) {  // one window of 16 for the four lanes
      float w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(row, c[0] + 4 * q, S, w + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int m = 0; m < 12; ++m) v[k] = __fadd_rn(v[k], __fmul_rn(tap_weight(d0[k], m), w[k + m]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int m = 0; m < 12; ++m) {
          v[k] = __fadd_rn(v[k], __fmul_rn(tap_weight(d0[k], m), row[min(max(c[k] + m, 0), S - 1)]));
        }
      }
    }
    return;
  }
  if (run) {
    load4(row, c[0], S, v);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = row[min(max(c[k], 0), S - 1)];
  }
  if constexpr (kMode == kTiles) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(v[k], __fmul_rn(0.0f, pos[k]));
  }
}

// K3 (kOps 2, a PairMode) and K4 (kOps 1, a SingleMode) in their staged
// modes on nrows rows of S lanes per operand, r = row % R within a volume.
template <int kOps, int kMode>
__global__ void __launch_bounds__(kRingThreads) probe_ring_kernel(
    const float* __restrict__ xa, const float* __restrict__ xb, float* __restrict__ oa,
    float* __restrict__ ob, long long nrows, int R, int H, int S, int tile_rows, int stages,
    int ntaps, TileCounter* counter) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<kOps> ring;
  ring.smem = smem;
  ring.x[0] = xa;
  if constexpr (kOps == 2) ring.x[1] = xb;
  ring.elems = nrows * S;
  ring.ntiles = (nrows + tile_rows - 1) / tile_rows;
  ring.tile_elems = tile_rows * S;
  ring.pitch = ring.tile_elems;
  ring.stages = stages;
  const int G = (S + 3) / 4;  // groups of four lanes per row
  ring_walk(ring, counter, [&](long long t, int s) {
    const long long n0 = t * tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), nrows - n0));
    const int r0 = static_cast<int>(n0 % R);
    for (int i = threadIdx.x; i < rows * G; i += kRingThreads) {
      const int row = i / G;
      const int l = 4 * (i - row * G);
      int r = r0 + row;  // the row within its volume; a division only where the tile wraps
      if (r >= R) r %= R;
      const size_t out = static_cast<size_t>(n0 + row) * S;
      const float* sa = ring.buf(s, 0) + row * S;
      if constexpr (kOps == 2) {
        const float* sb = ring.buf(s, 1) + row * S;
        float va[4], vb[4];
        if constexpr (kMode == kPairStage) {
          load4(sa, l, S, va);
          load4(sb, l, S, vb);
        } else {
          pair_taps(sa, sb, l, S, static_cast<float>(r % H), ntaps, va, vb);
        }
        store4(oa + out, l, S, va);
        store4(ob + out, l, S, vb);
      } else {
        float v[4];
        if constexpr (kMode == kStage) {
          load4(sa, l, S, v);
        } else {
          single_window<kMode>(sa, l, S, static_cast<float>(r % 8), v);
        }
        store4(oa + out, l, S, v);
      }
    }
  });
}

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(__fmul_rn(v.x, 2.0f), __fmul_rn(v.y, 2.0f), __fmul_rn(v.z, 2.0f),
                     __fmul_rn(v.w, 2.0f));
}

// copy (K3 and K4: out = 2*x; K5, kTwice false: out = x, bits and all) for
// kOps operands of `elems` floats, block b on the b-th tile of tile_elems (a
// multiple of 4) floats, four 16-byte reads per operand in flight per
// thread; the operand's last elems % 4 floats one by one.
template <int kOps, bool kTwice>
__global__ void __launch_bounds__(kThreads) probe_copy_kernel(
    const float* __restrict__ xa, const float* __restrict__ xb, float* __restrict__ oa,
    float* __restrict__ ob, long long elems, int tile_elems) {
  constexpr int kUnroll = 4;
  const float* const x[2] = {xa, xb};
  float* const o[2] = {oa, ob};
  const long long e0 = static_cast<long long>(blockIdx.x) * tile_elems;
  const int len = static_cast<int>(min(static_cast<long long>(tile_elems), elems - e0));
  const int n4 = len >> 2;
  for (int i = threadIdx.x; i < n4; i += kUnroll * kThreads) {
    float4 v[kOps][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        if (i + u * kThreads < n4) v[op][u] = __ldg(reinterpret_cast<const float4*>(x[op] + e0) + i + u * kThreads);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        if (i + u * kThreads < n4) {
          __stcs(reinterpret_cast<float4*>(o[op] + e0) + i + u * kThreads, kTwice ? twice(v[op][u]) : v[op][u]);
        }
      }
    }
  }
  const int tail = static_cast<int>(threadIdx.x) + 4 * n4;
  if (tail < len) {
#pragma unroll
    for (int op = 0; op < kOps; ++op) {
      o[op][e0 + tail] = kTwice ? __fmul_rn(x[op][e0 + tail], 2.0f) : x[op][e0 + tail];
    }
  }
}

// --- K3 and K4: the launch ----------------------------------------------------

// Plans the launch of K3's (kOps 2) or K4's (kOps 1) mode into g, and
// launches it if `launch`.
template <int kOps, int kMode>
cudaError_t run(const float* xa, const float* xb, float* oa, float* ob, long long nrows, int R, int H,
                int S, int ntaps, bool launch, cudaStream_t st, Geometry* g) {
  constexpr bool kRing = kMode != 0;  // copy is mode 0 in both enums
  const int target = kOps == 2 ? kPairTileBytes : kSingleTileBytes;
  const void* fn = nullptr;  // the ring kernel; none for copy
  if constexpr (kRing) fn = reinterpret_cast<const void*>(&probe_ring_kernel<kOps, kMode>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = plan(fn, dev, kOps, nrows, S, target, g);
  if (e != cudaSuccess || !launch) return e;
  if (!aligned16(xa) || !aligned16(oa) || (kOps == 2 && (!aligned16(xb) || !aligned16(ob)))) {
    return cudaErrorMisalignedAddress;
  }
  if constexpr (kRing) {
    TileCounter* counter = nullptr;
    e = tile_counter(dev, st, &counter);
    if (e != cudaSuccess) return e;
    probe_ring_kernel<kOps, kMode><<<g->grid, kRingThreads, g->smem, st>>>(
        xa, xb, oa, ob, nrows, R, H, S, g->tile_rows, g->stages, ntaps, counter);
  } else {
    probe_copy_kernel<kOps, true><<<g->grid, kThreads, 0, st>>>(xa, xb, oa, ob, nrows * S, g->tile_rows * S);
  }
  return cudaGetLastError();
}

cudaError_t probe2_run(const float* xa, const float* xb, float* oa, float* ob, long long nrows, int R,
                       int H, int S, int mode, int ntaps, bool launch, cudaStream_t st, Geometry* g) {
  switch (mode) {
    case kPairCopy: return run<2, kPairCopy>(xa, xb, oa, ob, nrows, R, H, S, ntaps, launch, st, g);
    case kPairStage: return run<2, kPairStage>(xa, xb, oa, ob, nrows, R, H, S, ntaps, launch, st, g);
    case kPairTaps: return run<2, kPairTaps>(xa, xb, oa, ob, nrows, R, H, S, ntaps, launch, st, g);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t probe_run(const float* x, float* o, long long nrows, int R, int S, int mode, bool launch,
                      cudaStream_t st, Geometry* g) {
  switch (mode) {
    case kCopy: return run<1, kCopy>(x, nullptr, o, nullptr, nrows, R, 1, S, 0, launch, st, g);
    case kStage: return run<1, kStage>(x, nullptr, o, nullptr, nrows, R, 1, S, 0, launch, st, g);
    case kLadder: return run<1, kLadder>(x, nullptr, o, nullptr, nrows, R, 1, S, 0, launch, st, g);
    case kTiles: return run<1, kTiles>(x, nullptr, o, nullptr, nrows, R, 1, S, 0, launch, st, g);
    case kSweep12: return run<1, kSweep12>(x, nullptr, o, nullptr, nrows, R, 1, S, 0, launch, st, g);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K5: 4*n4 + tail floats (tail < 4) each of xa, xb into oa, ob, one tile of
// kPairTileBytes per operand and block. Returns cudaGetLastError(), or
// cudaErrorMisalignedAddress without launching unless every pointer is on 16
// bytes.
extern "C" int fsg_pair_copy_f32(const float* xa, const float* xb, float* oa, float* ob, int n4,
                                 int tail, void* stream) {
  if (!aligned16(xa) || !aligned16(xb) || !aligned16(oa) || !aligned16(ob)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  constexpr int kTileElems = kPairTileBytes / static_cast<int>(sizeof(float));
  const long long elems = 4 * static_cast<long long>(n4) + tail;
  const long long tiles = (elems + kTileElems - 1) / kTileElems;
  probe_copy_kernel<2, false><<<static_cast<int>(tiles > 0 ? tiles : 1), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(xa, xb, oa, ob, elems, kTileElems);
  return static_cast<int>(cudaGetLastError());
}

// K6: xa, xb (N, H, W) -> oa, ob (N, W, H), N <= 65535. Returns
// cudaGetLastError().
extern "C" int fsg_pair_transpose_f32(const float* xa, const float* xb, float* oa, float* ob,
                                      int N, int H, int W, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  pair_transpose_kernel<<<grid, dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, oa, ob, H, W);
  return static_cast<int>(cudaGetLastError());
}

// K3: xa, xb, oa, ob (B, R, S), 16-byte aligned, with rows r = row_i*H +
// row_j; mode 0 copy, 1 stage, 2 taps (ntaps taps, ntaps >= 1). Returns
// cudaGetLastError(), or an error without launching: cudaErrorInvalidValue
// for another mode or an S whose two ring stages do not fit, a misaligned
// pointer, or the failed attribute, occupancy or tile-counter call.
extern "C" int fsg_probe2_f32(const float* xa, const float* xb, float* oa, float* ob, int B,
                              int R, int H, int S, int mode, int ntaps, void* stream) {
  Geometry g;
  return static_cast<int>(probe2_run(xa, xb, oa, ob, static_cast<long long>(B) * R, R, H, S, mode,
                                     ntaps, true, static_cast<cudaStream_t>(stream), &g));
}

// K4: x, o (B, R, S), 16-byte aligned, S a multiple of 128; mode 0 copy, 1
// stage, 2 ladder, 3 tiles, 4 sweep12. Returns as fsg_probe2_f32.
extern "C" int fsg_probe_f32(const float* x, float* o, int B, int R, int S, int mode,
                             void* stream) {
  Geometry g;
  return static_cast<int>(probe_run(x, o, static_cast<long long>(B) * R, R, S, mode, true,
                                    static_cast<cudaStream_t>(stream), &g));
}

// The launch fsg_probe2_f32 (kernel 3) or fsg_probe_f32 (kernel 4) makes on
// the current device for (B, R, S) in `mode`: geometry = {tile rows, ring
// stages (0 for copy), grid blocks, dynamic shared-memory bytes}. Returns a
// cudaError code.
extern "C" int fsg_probe_geometry(int kernel, int B, int R, int S, int mode, int* geometry) {
  Geometry g{};
  const long long nrows = static_cast<long long>(B) * R;
  cudaError_t e = cudaErrorInvalidValue;
  if (kernel == 3) e = probe2_run(nullptr, nullptr, nullptr, nullptr, nrows, R, 1, S, mode, 1, false, nullptr, &g);
  if (kernel == 4) e = probe_run(nullptr, nullptr, nrows, R, S, mode, false, nullptr, &g);
  geometry[0] = g.tile_rows;
  geometry[1] = g.stages;
  geometry[2] = g.grid;
  geometry[3] = g.smem;
  return static_cast<int>(e);
}
