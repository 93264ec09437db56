// Kernel probes: the constructs the hat kernels are built from, each timed on
// its own (copy, shared-memory staging, window reads, tap arithmetic,
// transposes). Each probe computes the function its TPU probe computes, with
// Hopper's construct in place of the TPU's where the two differ; the plain
// PyTorch versions are in fetalsyngen_torch/kernels/probes.py, and every
// kernel here matches its plain version bit for bit. Products and sums are
// explicit _rn intrinsics, so nvcc cannot contract them into FMAs.
//
// K5 pair_copy (replaces scripts/probe_blocktp.py::_copy_kernel): two f32
//   arrays copied as they are. Bound: device memory, 16 bytes per element
//   pair. Design: 16-byte loads and stores, a grid-stride loop; the measured
//   rate is the copy floor of the card.
// K6 pair_transpose (replaces scripts/probe_blocktp.py::_tp_kernel): two
//   (N, H, W) arrays to (N, W, H), (n, j, k) -> (n, k, j). Bound: device
//   memory, as K5. Design: 32 x 32 tiles through shared memory padded to 33
//   columns (no bank conflicts on the transposed read), coalesced loads and
//   stores on both sides.
// K3 probe2_* (replaces the probe2_* probe_kernel of
//   scripts/microbench_warp.py): the paired hat kernel's constructs in K1's
//   launch geometry, one block per row of two (B, R, S) operands:
//     copy   out = 2*x, no staging;
//     stage  both rows staged edge-padded in shared memory, s[c] =
//            x[clamp(c - pad, 0, S - 1)], pad = max(128, S), then copied out;
//     taps   staging, pos = (0.07*row_j + l) + 0.3, n0 = -1,
//            d0 = (pos - l) - n0, out = sum over m < ntaps of
//            max(0, 1 - |d0 - m|) * s[pad + n0 + m + l], in tap order.
//   The TPU probe reads its window at the 128-aligned floor of pad + n0 and
//   adds the remainder (127) to d0; on Hopper the window starts at pad + n0
//   itself, one unaligned shared-memory read. The two agree where every
//   nonzero tap lies inside both windows.
// K4 probe_* (replaces the probe_* probe_kernel of
//   scripts/microbench_warp.py): the single-operand kernel's constructs in
//   K2's launch geometry, one block per row of a (B, R, S) operand, S a
//   multiple of 128, the row staged with a 128-lane edge pad:
//     copy    out = 2*x;  stage  staging, copy out;
//     ladder  pos = 0.11*(r % 8) + l (the TPU's sub-row of 8), n0 =
//             floor(pos - pos) (zero, but computed), base = clamp(128 +
//             lane0 + n0, 0, width - 384) for the lane's 128-lane tile lane0,
//             out = s[base + l - lane0]: the window shift, which the TPU
//             does with a seven-step roll ladder, here an unaligned read at a
//             runtime offset;
//     tiles   out = s[128*floor(base/128) + l - lane0] + 0*pos: the aligned
//             window without the shift;
//     sweep12 the ladder's window, d0 = pos - floor(pos), out = sum over
//             m < 12 of max(0, 1 - |d0 - m|) * s[base + l - lane0 + m].
//   n0 is computed per element here; the TPU takes a tile-wide minimum,
//   which for finite positions is the same zero.
// Bound of K3 and K4: device memory (8 bytes per element and operand); the
// taps at most ~100 operations per element pair.

#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyBlocks = 132 * 32;  // a grid-stride grid: 32 blocks per SM
constexpr int kTile = 32;
constexpr int kTileRows = 8;
constexpr int kSinglePad = 128;  // K4's edge pad (warp.PAD)
constexpr int kSingleWin = 384;  // K4's window width

__global__ void __launch_bounds__(kThreads) pair_copy_kernel(
    const float4* __restrict__ xa, const float4* __restrict__ xb, float4* __restrict__ oa,
    float4* __restrict__ ob, size_t n4, const float* __restrict__ ta,
    const float* __restrict__ tb, float* __restrict__ toa, float* __restrict__ tob, int tail) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += stride) {
    oa[i] = xa[i];
    ob[i] = xb[i];
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    toa[threadIdx.x] = ta[threadIdx.x];
    tob[threadIdx.x] = tb[threadIdx.x];
  }
}

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

template <int kMode>
__global__ void __launch_bounds__(kThreads) probe2_kernel(
    const float* __restrict__ xa, const float* __restrict__ xb, float* __restrict__ oa,
    float* __restrict__ ob, int R, int H, int S, int pad, int width, int ntaps) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + width;
  const int r = blockIdx.x;
  const size_t row = (static_cast<size_t>(blockIdx.y) * R + r) * S;
  if (kMode == kPairCopy) {
    for (int l = threadIdx.x; l < S; l += blockDim.x) {
      oa[row + l] = __fmul_rn(xa[row + l], 2.0f);
      ob[row + l] = __fmul_rn(xb[row + l], 2.0f);
    }
    return;
  }
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    const int k = min(max(c - pad, 0), S - 1);
    sa[c] = xa[row + k];
    sb[c] = xb[row + k];
  }
  __syncthreads();
  if (kMode == kPairStage) {
    for (int l = threadIdx.x; l < S; l += blockDim.x) {
      oa[row + l] = sa[pad + l];
      ob[row + l] = sb[pad + l];
    }
    return;
  }
  constexpr int n0 = -1;
  const float row_j = static_cast<float>(r % H);
  for (int l = threadIdx.x; l < S; l += blockDim.x) {
    const float lf = static_cast<float>(l);
    const float pos = __fadd_rn(__fadd_rn(__fmul_rn(0.07f, row_j), lf), 0.3f);
    const float d0 = __fsub_rn(__fsub_rn(pos, lf), static_cast<float>(n0));
    const float* wa = sa + pad + n0 + l;
    const float* wb = sb + pad + n0 + l;
    float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll 8
    for (int m = 0; m < ntaps; ++m) {
      const float w = tap_weight(d0, m);
      acc_a = __fadd_rn(acc_a, __fmul_rn(w, wa[m]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(w, wb[m]));
    }
    oa[row + l] = acc_a;
    ob[row + l] = acc_b;
  }
}

enum SingleMode : int { kCopy = 0, kStage = 1, kLadder = 2, kTiles = 3, kSweep12 = 4 };

template <int kMode>
__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ x,
                                                         float* __restrict__ o, int R, int S,
                                                         int width) {
  extern __shared__ float srow[];
  const int r = blockIdx.x;
  const size_t row = (static_cast<size_t>(blockIdx.y) * R + r) * S;
  if (kMode == kCopy) {
    for (int l = threadIdx.x; l < S; l += blockDim.x) o[row + l] = __fmul_rn(x[row + l], 2.0f);
    return;
  }
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    srow[c] = x[row + min(max(c - kSinglePad, 0), S - 1)];
  }
  __syncthreads();
  if (kMode == kStage) {
    for (int l = threadIdx.x; l < S; l += blockDim.x) o[row + l] = srow[kSinglePad + l];
    return;
  }
  const float sub_row = static_cast<float>(r % 8);
  for (int l = threadIdx.x; l < S; l += blockDim.x) {
    const int lane0 = l & ~127;
    const float pos = __fadd_rn(__fmul_rn(0.11f, sub_row), static_cast<float>(l));
    const int n0 = static_cast<int>(floorf(__fsub_rn(pos, pos)));
    const int base = min(max(kSinglePad + lane0 + n0, 0), width - kSingleWin);
    if (kMode == kLadder) {
      o[row + l] = srow[base + l - lane0];
    } else if (kMode == kTiles) {
      o[row + l] = __fadd_rn(srow[(base / 128) * 128 + l - lane0], __fmul_rn(0.0f, pos));
    } else {
      const float d0 = __fsub_rn(pos, floorf(pos));
      const float* w = srow + base + l - lane0;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < 12; ++m) acc = __fadd_rn(acc, __fmul_rn(tap_weight(d0, m), w[m]));
      o[row + l] = acc;
    }
  }
}

template <int kMode>
void launch_probe2(const float* xa, const float* xb, float* oa, float* ob, int B, int R, int H,
                   int S, int pad, int width, int ntaps, cudaStream_t st) {
  const size_t smem = kMode == kPairCopy ? 0 : 2 * static_cast<size_t>(width) * sizeof(float);
  probe2_kernel<kMode><<<dim3(R, B), kThreads, smem, st>>>(xa, xb, oa, ob, R, H, S, pad, width, ntaps);
}

template <int kMode>
void launch_probe(const float* x, float* o, int B, int R, int S, int width, cudaStream_t st) {
  const size_t smem = kMode == kCopy ? 0 : static_cast<size_t>(width) * sizeof(float);
  probe_kernel<kMode><<<dim3(R, B), kThreads, smem, st>>>(x, o, R, S, width);
}

}  // namespace

// K5: 4*n4 + tail floats (tail < 4) each of xa, xb into oa, ob; every
// pointer 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int fsg_pair_copy_f32(const float* xa, const float* xb, float* oa, float* ob, int n4,
                                 int tail, void* stream) {
  const size_t want = (static_cast<size_t>(n4) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kCopyBlocks ? (want > 0 ? want : 1) : kCopyBlocks);
  pair_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(xa), reinterpret_cast<const float4*>(xb),
      reinterpret_cast<float4*>(oa), reinterpret_cast<float4*>(ob), n4, xa + 4 * static_cast<size_t>(n4),
      xb + 4 * static_cast<size_t>(n4), oa + 4 * static_cast<size_t>(n4), ob + 4 * static_cast<size_t>(n4), tail);
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

// K3: xa, xb, oa, ob (B, R, S) with rows r = row_i*H + row_j; mode 0 copy, 1
// stage, 2 taps (ntaps taps, 1 <= ntaps <= S + 128). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another mode.
extern "C" int fsg_probe2_f32(const float* xa, const float* xb, float* oa, float* ob, int B,
                              int R, int H, int S, int mode, int ntaps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pad = S > 128 ? S : 128;
  const int width = S + pad + S + 128;
  switch (mode) {
    case kPairCopy: launch_probe2<kPairCopy>(xa, xb, oa, ob, B, R, H, S, pad, width, ntaps, st); break;
    case kPairStage: launch_probe2<kPairStage>(xa, xb, oa, ob, B, R, H, S, pad, width, ntaps, st); break;
    case kPairTaps: launch_probe2<kPairTaps>(xa, xb, oa, ob, B, R, H, S, pad, width, ntaps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: x, o (B, R, S), S a multiple of 128; mode 0 copy, 1 stage, 2 ladder, 3
// tiles, 4 sweep12. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another mode.
extern "C" int fsg_probe_f32(const float* x, float* o, int B, int R, int S, int mode,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = S + 2 * kSinglePad + 128;
  switch (mode) {
    case kCopy: launch_probe<kCopy>(x, o, B, R, S, width, st); break;
    case kStage: launch_probe<kStage>(x, o, B, R, S, width, st); break;
    case kLadder: launch_probe<kLadder>(x, o, B, R, S, width, st); break;
    case kTiles: launch_probe<kTiles>(x, o, B, R, S, width, st); break;
    case kSweep12: launch_probe<kSweep12>(x, o, B, R, S, width, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
