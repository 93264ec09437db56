// Code shared by the hat-pass kernels (hat_pass.cu, K1; hat_single.cu, K2):
// the position polynomial, its displacement forms, the edge-clamped samples
// of one staged row, and the ring kernel both run with its launch.
//
// Spec: _hat_pass_jnp and the fallback positions of _hat_pass_impl in
// fetalsyngen_tpu/ops/warp.py; plain PyTorch versions: positions() and
// _sample_ref() in fetalsyngen_torch/kernels/hat.py, which these functions
// match bit for bit.
//
// Rounding is pinned: every product and sum is an explicit _rn intrinsic in
// the plain version's association order, so nvcc cannot contract them into
// FMAs. An FMA would move positions by an ulp and flip nearest-mode labels
// that sit at half-voxel positions. Nearest mode rounds half to even (rintf,
// as torch.round).
//
// The operand rows and outputs are f32 or bf16 (T, the stream's production
// mode); positions, coefficients, displacements and tables are f32. A bf16
// row's taps widen to f32 (exactly), the linear sample is computed in f32 as
// for f32 rows and rounded once to bf16 (__float2bfloat16_rn, as torch's
// .to(bfloat16)); a nearest or edge sample is the row's value as it is.
//
// Two kernels run the forms: hat_ring_kernel (every f32 form, and the bf16
// forms with a nearest operand or a displacement volume) and
// hat_lanes_kernel (the other linear bf16 forms: lane-affine, per-slice and
// per-sample without a displacement, K1's and K2's; designed for 2-byte
// rows; below).

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace fsg {

// Where a pass's per-row coefficients (ci, cj, ck, bias) come from: one row
// per sample, (B, 4), or one per slice row_i, (B, D, 4).
enum CoefMode : int { kCoefPerSample = 0, kCoefPerSlice = 1 };

// The displacement added to the position: none, a (B, R, OW) volume, or a
// (B, 3, OW) lane-affine table (A0[l]*row_i + A1[l]*row_j + A2[l]).
enum DispMode : int { kDispNone = 0, kDispVolume = 1, kDispLaneAffine = 2 };

// The coefficient row of sample b, row r = row_i*H + row_j (R rows).
template <int kCoef>
__device__ __forceinline__ const float* hat_coefs(const float* coefs, int b, int r, int R, int H) {
  if (kCoef == kCoefPerSlice) return coefs + 4 * (static_cast<size_t>(b) * (R / H) + r / H);
  return coefs + 4 * static_cast<size_t>(b);
}

// ci*row_i + cj*row_j: the lane-independent part of the position, computed
// once per row.
__device__ __forceinline__ float hat_row_base(float ci, float cj, float row_i, float row_j) {
  return __fadd_rn(__fmul_rn(ci, row_i), __fmul_rn(cj, row_j));
}

// ((ci*row_i + cj*row_j) + ck*l) + bias
__device__ __forceinline__ float hat_position(float base, float ck, float bias, int l) {
  return __fadd_rn(__fadd_rn(base, __fmul_rn(ck, static_cast<float>(l))), bias);
}

// A lane's position plus its displacement of kDisp, from the values read for
// the lane: d[0] of a volume, or (d[0], d[1], d[2]) = (A0[l], A1[l], A2[l])
// of a lane-affine table, added as (A0[l]*row_i + A1[l]*row_j) + A2[l].
template <int kDisp>
__device__ __forceinline__ float hat_displace(float pos, const float* d, float row_i, float row_j) {
  if (kDisp == kDispVolume) return __fadd_rn(pos, d[0]);
  if (kDisp == kDispLaneAffine) {
    return __fadd_rn(pos, __fadd_rn(__fadd_rn(__fmul_rn(d[0], row_i), __fmul_rn(d[1], row_j)), d[2]));
  }
  return pos;
}

// Where the displacement of sample b, row r starts (volume: the row; table:
// the sample's (3, OW) block).
template <int kDisp>
__device__ __forceinline__ const float* hat_disp_row(const float* disp, int b, int r, int R, int OW) {
  if (kDisp == kDispVolume) return disp + (static_cast<size_t>(b) * R + r) * OW;
  if (kDisp == kDispLaneAffine) return disp + static_cast<size_t>(b) * 3 * OW;
  return nullptr;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// an f32 result in T, rounded to nearest even for bf16
template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Sample of the staged row (length S) at pos: row[0] where pos <= 0,
// row[S-1] where pos >= S-1, else linear (two taps, in f32) or nearest.
// Between the edges the clamps are the identity; they keep a NaN position in
// bounds.
template <bool kNearest, typename T>
__device__ __forceinline__ T hat_sample(const T* row, float pos, int S) {
  const float last = static_cast<float>(S - 1);
  if (pos <= 0.0f) return row[0];
  if (pos >= last) return row[S - 1];
  const float c = fminf(fmaxf(pos, 0.0f), last);
  if (kNearest) return row[static_cast<int>(rintf(c))];
  const float f = fminf(floorf(c), static_cast<float>(S - 2));
  const float w = __fsub_rn(c, f);
  const int fi = static_cast<int>(f);
  return narrow<T>(__fadd_rn(__fmul_rn(widen(row[fi]), __fsub_rn(1.0f, w)), __fmul_rn(widen(row[fi + 1]), w)));
}

}  // namespace fsg

// The hat ring kernel: K1 (two operands, kOps 2) and K2 (one) on the tile
// ring of ring.cuh. A tile is a run of consecutive rows of the flattened
// (B*R, S) operands, about kTileBytes (16 KB) per operand; a persistent grid
// of 512-thread blocks draws tiles from a per-stream counter and stages them
// through a three-stage ring of TMA bulk copies (two stages where three do
// not fit). Each row of a tile finds its own sample b = n / R, row r = n % R
// and coefficient row, so a tile may span two samples or two slices. Each
// thread computes four consecutive output lanes of a row: their positions,
// then their taps read from the staged rows in shared memory (one for
// nearest, two for linear, at data-dependent columns), then one 16-byte
// streaming store per output where the four lanes lie on a 16-byte boundary,
// lane by lane otherwise. The displacement volume is not staged: each thread
// reads its four values with one 16-byte __ldg where they lie on 16 bytes
// (else four), for four groups of lanes (two for a pair) before it computes
// any, so sixteen (eight) values per thread are in flight. Staged as another ring operand it would
// add a tile to every stage; read once and coalesced, it gains nothing from
// shared memory. The lane-affine table is read the same way, from the caches
// (3 OW floats a sample, shared by all its rows). Outputs, the displacement
// volume and the table have rows of OW lanes, the staged rows S. The
// kernel's element type T (float or __nv_bfloat16) is that of the staged
// rows and the outputs: a bf16 tile holds twice the rows of an f32 one in
// the same kTileBytes, and four bf16 outputs go out as one 8-byte store.
namespace {

using namespace fsg;

// K1's and K2's tile per operand, chosen by measurement (8 to 32 KB): for
// K2 at B=1 256^3 16 KB was the fastest, 8 KB 9-12% slower; for K1 8 KB ran
// 0.4-0.8% faster at B=4 256^3 but 0.6-3.7% slower on the scanner's
// lane-affine passes, which launch more often, and 32 KB 6% slower
constexpr int kTileBytes = 16 * 1024;

// v[k] = p[l + k] for the lanes l + k < n (0 past the row): one 16-byte read
// through the read-only cache where all four lie on a 16-byte boundary,
// else lane by lane
__device__ __forceinline__ void load_lanes(const float* __restrict__ p, int l, int n, float* v) {
  if (l + 3 < n && (reinterpret_cast<uintptr_t>(p + l) & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + l));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = l + k < n ? __ldg(p + l + k) : 0.0f;
  }
}

// out[l + k] = v[k] for the bf16 lanes l + k < S: one 8-byte streaming store
// where all four lie in the row on 8 bytes, else lane by lane
__device__ __forceinline__ void store4(__nv_bfloat16* out, int l, int S, const __nv_bfloat16* v) {
  if (l + 3 < S && (reinterpret_cast<uintptr_t>(out + l) & 7) == 0) {
    uint2 u;
    u.x = static_cast<uint32_t>(__bfloat16_as_ushort(v[0])) | (static_cast<uint32_t>(__bfloat16_as_ushort(v[1])) << 16);
    u.y = static_cast<uint32_t>(__bfloat16_as_ushort(v[2])) | (static_cast<uint32_t>(__bfloat16_as_ushort(v[3])) << 16);
    __stcs(reinterpret_cast<uint2*>(out + l), u);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (l + k < S) out[l + k] = v[k];
    }
  }
}

// kOps operands xa and xb of T elements, the last sampled nearest if
// kNearestLast, the first if kNearestFirst (one operand: both are it);
// nrows rows of S lanes in, of OW lanes out
template <typename T, int kOps, bool kNearestLast, int kCoef, int kDisp, bool kNearestFirst = kOps == 1 && kNearestLast>
__global__ void __launch_bounds__(kRingThreads, 2) hat_ring_kernel(
    const T* __restrict__ xa, const T* __restrict__ xb, const float* __restrict__ disp,
    const float* __restrict__ coefs, T* __restrict__ oa, T* __restrict__ ob, long long nrows, int R,
    int H, int S, int OW, int tile_rows, int pitch, int stages, TileCounter* counter) {
  // groups of four lanes a thread takes at once: the displacement volume's
  // loads of all of them go out before the first group is computed (four
  // groups of one operand, two of a pair: a pair's registers for four spill)
  constexpr int kGroups = kDisp == kDispVolume ? 4 / kOps : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<kOps, T> ring;
  ring.smem = smem;
  ring.x[0] = xa;
  if constexpr (kOps == 2) ring.x[1] = xb;
  ring.elems = nrows * S;
  ring.ntiles = (nrows + tile_rows - 1) / tile_rows;
  ring.tile_elems = tile_rows * S;
  ring.pitch = pitch;
  ring.stages = stages;
  const int G = (OW + 3) / 4;  // groups of four lanes per output row
  ring_walk(ring, counter, [&](long long t, int s) {
    const long long n0 = t * tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), nrows - n0));
    const int b0 = static_cast<int>(n0 / R);
    const int r0 = static_cast<int>(n0 - static_cast<long long>(b0) * R);
    const T* src[kOps];
#pragma unroll
    for (int op = 0; op < kOps; ++op) src[op] = ring.data(s, op, t);
    const int groups = rows * G;
    for (int i0 = threadIdx.x; i0 < groups; i0 += kGroups * kRingThreads) {
      float d[kGroups][4];
      if constexpr (kDisp == kDispVolume) {
#pragma unroll
        for (int u = 0; u < kGroups; ++u) {
          const int i = i0 + u * kRingThreads;
          if (i < groups) {
            const int row = i / G;
            load_lanes(disp + static_cast<size_t>(n0 + row) * OW, 4 * (i - row * G), OW, d[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int i = i0 + u * kRingThreads;
        if (i >= groups) break;
        const int row = i / G;
        const int l = 4 * (i - row * G);
        int b = b0, r = r0 + row;  // the row's sample and row; a division only where the tile wraps
        if (r >= R) {
          b += r / R;
          r %= R;
        }
        const int ri = r / H;
        const float row_i = static_cast<float>(ri);
        const float row_j = static_cast<float>(r - ri * H);
        const float* c = hat_coefs<kCoef>(coefs, b, r, R, H);
        const float ck = __ldg(c + 2);
        const float bias = __ldg(c + 3);
        const float base = hat_row_base(__ldg(c), __ldg(c + 1), row_i, row_j);
        float pos[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) pos[k] = hat_position(base, ck, bias, l + k);
        if constexpr (kDisp == kDispVolume) {
#pragma unroll
          for (int k = 0; k < 4; ++k) pos[k] = hat_displace<kDisp>(pos[k], &d[u][k], row_i, row_j);
        } else if constexpr (kDisp == kDispLaneAffine) {
          const float* tab = hat_disp_row<kDisp>(disp, b, r, R, OW);
          float a0[4], a1[4], a2[4];
          load_lanes(tab, l, OW, a0);
          load_lanes(tab + OW, l, OW, a1);
          load_lanes(tab + 2 * OW, l, OW, a2);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float a[3] = {a0[k], a1[k], a2[k]};
            pos[k] = hat_displace<kDisp>(pos[k], a, row_i, row_j);
          }
        }
        const size_t out = static_cast<size_t>(n0 + row) * OW;
        T v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = hat_sample<kNearestFirst>(src[0] + row * S, pos[k], S);
        store4(oa + out, l, OW, v);
        if constexpr (kOps == 2) {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = hat_sample<kNearestLast>(src[1] + row * S, pos[k], S);
          store4(ob + out, l, OW, v);
        }
      }
    }
  });
}

// Plans the launch of a hat form on nrows rows of T elements into g (tiles
// of kTileBytes per operand), and launches it if `launch`. K1's ring is
// loose (tiles of any row count, operands at any element offset: with two
// operands, 4-row tiles of odd f32 S would not fit two stages above
// S = 3630); K2's tiles are whole 16-byte units of an x on 16 bytes,
// cudaErrorMisalignedAddress for an x that is not.
template <typename T, int kOps, bool kNearestLast, int kCoef, int kDisp, bool kNearestFirst = kOps == 1 && kNearestLast>
cudaError_t hat_ring_run(const T* xa, const T* xb, const float* disp, const float* coefs, T* oa, T* ob,
                         long long nrows, int R, int H, int S, int OW, bool launch, cudaStream_t st, Geometry* g) {
  constexpr bool kLoose = kOps == 2;
  constexpr int kVec = Ring<kOps, T>::kVec;
  const void* fn =
      reinterpret_cast<const void*>(&hat_ring_kernel<T, kOps, kNearestLast, kCoef, kDisp, kNearestFirst>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = plan(fn, dev, kOps, nrows, S, kTileBytes, g, kLoose, static_cast<int>(sizeof(T)));
  if (e != cudaSuccess || !launch) return e;
  if (!kLoose && !aligned16(xa)) return cudaErrorMisalignedAddress;
  TileCounter* counter = nullptr;
  e = tile_counter(dev, st, &counter);
  if (e != cudaSuccess) return e;
  hat_ring_kernel<T, kOps, kNearestLast, kCoef, kDisp, kNearestFirst><<<g->grid, kRingThreads, g->smem, st>>>(
      xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW, g->tile_rows, ring_pitch(g->tile_rows * S, kLoose, kVec),
      g->stages, counter);
  return cudaGetLastError();
}

// --- the linear bf16 forms: a thread keeps its lanes across rows ------------
//
// hat_lanes_kernel computes the linear bf16 forms without a displacement
// volume: those of the scanner and the stream (K2's lane-affine and
// per-slice forms, K1's lane-affine pair), K2's per-sample form (the affine
// warp's, without the nonlinear field) and K1's other linear pairs
// (per-slice, and per-sample: the separable pair warp's), the same function
// bit for bit on finite rows, with a design for 2-byte rows. A bf16 element
// moves 4 bytes (K2), so the card's memory leaves some 35 issued
// instructions per element; the f32 ring kernel spent about as many on
// re-deriving each group of four lanes' row, coefficients, table and lane
// products, and its floorf, float-to-int and int-to-float conversions run at
// an eighth of the FMA rate. With the instructions cut, what held it back
// was the block's time between tiles (probes/ring_profile.py, PERF.md).
// - A row's OW lanes go to tpr = ceil(OW / 8) threads, and thread j of a
//   row takes the lane pairs l = 2j + 2*tpr*m + {0, 1}, m = 0..3: a warp's
//   tap reads are consecutive 4-byte words of the staged row (no bank
//   conflicts) and its stores one 4-byte bf16x2 each, coalesced. The
//   block's 480 consumer threads take rp = 480 / tpr rows at once (OW above
//   3840: one row, each thread several lane groups), and a tile is a
//   multiple of rp rows where that fits.
// - The thread's lanes stay the same across the rows of every tile, so the
//   per-lane terms are registers: ck*l and the lane-affine table's A0, A1,
//   A2 loaded only when the sample changes, A0*row_i and ci*row_i computed
//   again when the slice does (per-slice: the slice's coefficients and ck*l
//   loaded). A product of the same operands has the same bits wherever it is
//   computed. A thread steps its row's slice row with the row and divides
//   (by multiplication) only where a step leaves the slice. A block's
//   successive tiles lie about a grid's worth of tiles apart, so nearly every
//   tile starts a new slice: the table stays in registers rather than being
//   read again then.
// - floor(c) and its index come from one add rounding down, c + 2^23, whose
//   bits hold the index (c in [0, 2^23)); the index goes into the tap's
//   shared-memory address by one multiply-add. The clamp to the largest
//   float below S - 1 keeps both taps in the row where the edge selects
//   row[S - 1] anyway.
// - Saturated lanes select the row's edge value, widened, before the
//   rounding; a pair of lanes rounds to bf16 in one cvt.rn.bf16x2.f32. The
//   edge value is exact in bf16, so it comes out as its bits (a NaN row
//   value comes out as bf16's canonical NaN, as an interior NaN does).
// - The eight lanes' terms take up to 125 registers, so one 512-thread block
//   fits an SM and nothing hides a stall of the whole block: the ring is
//   walked by a producer warp (ring_walk_producer in ring.cuh, no barrier
//   spans the block), its stages are 32 KB (a tile per operand of 16 or 32
//   KB), and a pass of fewer than kLanesMinTiles tiles per block takes
//   smaller tiles (plan()), down to rp rows.

// Division of n in [0, 2^31) by a fixed d >= 1: umulhi(n, mul) >> shift
// (the round-up method; d == 1 is n itself).
struct FastDiv {
  int d;
  unsigned int mul;
  int shift;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0};
  if (d > 1) {
    int p = 31;  // 31 + ceil(log2(d))
    while ((1ll << (p - 31)) < d) ++p;
    f.mul = static_cast<unsigned int>(((1ull << p) + static_cast<unsigned int>(d) - 1) / static_cast<unsigned int>(d));
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ int div_of(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned int>(n), f.mul) >> f.shift);
}

// the bf16 at shared-memory address `addr`, widened to f32
__device__ __forceinline__ float lds_bf16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return __uint_as_float(v << 16);
}

// the two bf16 at shared-memory address base + 2*idx and the next, widened to
// f32 (the address formed in the asm: one multiply-add for both loads)
__device__ __forceinline__ void lds_taps(uint32_t base, uint32_t idx, float& g0, float& g1) {
  uint32_t a, b;
  asm volatile(
      "{\n\t.reg .u32 p;\n\tmad.lo.u32 p, %3, 2, %2;\n\tld.shared.u16 %0, [p];\n\t"
      "ld.shared.u16 %1, [p+2];\n\t}"
      : "=r"(a), "=r"(b)
      : "r"(base), "r"(idx));
  g0 = __uint_as_float(a << 16);
  g1 = __uint_as_float(b << 16);
}

// The lanes kernel's lane pairs per thread and row; bytes of a ring stage,
// all operands' tiles (16, 32, 64 and 72 KB measured: 32 KB the fastest on 9
// of the stream's 17 passes and within 5% of the fastest on the others,
// PERF.md); and the tiles per resident block below which plan() halves them.
constexpr int kLanePairs = 4;
constexpr int kLanesStageBytes = 32 * 1024;
constexpr int kLanesMinTiles = 3;

// threads of a row of OW lanes
__host__ __device__ constexpr int lanes_tpr(int OW) { return (OW + 2 * kLanePairs - 1) / (2 * kLanePairs); }

// rows a block's consumer threads compute at once
__host__ __device__ constexpr int lanes_rows(int OW) {
  return lanes_tpr(OW) <= kRingConsumers ? kRingConsumers / lanes_tpr(OW) : 1;
}

// kOps linear bf16 operands (K2: one; K1: a pair), lane-affine, per-slice or
// per-sample without a displacement; nrows < 2^31 - 512 rows of S lanes in,
// of OW lanes out
template <int kOps, int kCoef, int kDisp>
__global__ void __launch_bounds__(kRingThreads, 1) hat_lanes_kernel(
    const __nv_bfloat16* __restrict__ xa, const __nv_bfloat16* __restrict__ xb, const float* __restrict__ disp,
    const float* __restrict__ coefs, __nv_bfloat16* __restrict__ oa, __nv_bfloat16* __restrict__ ob, int nrows,
    int R, int H, int S, int OW, int tile_rows, int pitch, int stages, TileCounter* counter, FastDiv div_r,
    FastDiv div_h) {
  constexpr bool kTable = kDisp == kDispLaneAffine;
  constexpr int kLanes = 2 * kLanePairs;
  static_assert(kDisp != kDispVolume, "the lanes kernel takes no displacement volume");
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<kOps, __nv_bfloat16> ring;
  ring.smem = smem;
  ring.x[0] = xa;
  if constexpr (kOps == 2) ring.x[1] = xb;
  ring.elems = static_cast<long long>(nrows) * S;
  ring.ntiles = (static_cast<long long>(nrows) + tile_rows - 1) / tile_rows;
  ring.tile_elems = tile_rows * S;
  ring.pitch = pitch;
  ring.stages = stages;
  __nv_bfloat16* const outs[2] = {oa, ob};
  const int tpr = lanes_tpr(OW);
  const int rp = lanes_rows(OW);
  const bool one_group = tpr <= kRingConsumers;
  const int tid = static_cast<int>(threadIdx.x);
  const int c_first = one_group ? tid % tpr : tid;   // the thread's first lane group
  const int c_step = one_group ? tpr : kRingConsumers;  // (several only above 3840 lanes)
  // the thread's first row of a tile; a thread past rp rows' worth computes none
  const int row_first = !one_group ? 0 : tid < rp * tpr ? tid / tpr : tile_rows;
  const int D = R / H;
  const float last = static_cast<float>(S - 1);
  const float below = __uint_as_float(__float_as_uint(last) - 1u);  // the largest float below S - 1
  constexpr float kTwo23 = 8388608.0f;
  // the row offset that turns the bits of c + 2^23 into a tap's byte offset
  constexpr uint32_t kTapBias = 2u * 0x4B000000u;
  const int stride = 2 * tpr;  // lanes from one of a thread's pairs to the next
  // the per-lane terms of sample kb, slice kri, lane group kc
  int kb = -1, kri = -1, kc = -1;
  float ci = 0.0f, cj = 0.0f, bias = 0.0f, ciri = 0.0f;
  float ckl[kLanes], a0[kLanes], a1[kLanes], a2[kLanes], a0ri[kLanes];
  ring_walk_producer(ring, counter, [&](long long t, int s) {
    const int n0 = static_cast<int>(t * tile_rows);
    const int rows = min(tile_rows, nrows - n0);
    uint32_t src[kOps];
#pragma unroll
    for (int op = 0; op < kOps; ++op) src[op] = shared_addr(ring.data(s, op, t));
    for (int c = c_first; c < tpr; c += c_step) {
      const int l0 = 2 * c;
      const auto lane = [&](int k) { return l0 + stride * (k >> 1) + (k & 1); };
      const bool all_in = lane(2 * kLanePairs - 1) < OW;  // every lane of the thread in the row
      // the row's global index n, sample b, slice ri and row in the slice rj,
      // stepped by rp rows; divided anew where a step leaves the slice
      int n = n0 + row_first, b = 0, ri = 0, rj = H;
      for (int row = row_first; row < rows; row += rp, n += rp, rj += rp) {
        if (rj >= H) {
          b = div_of(n, div_r);
          const int r = n - b * R;
          ri = div_of(r, div_h);
          rj = r - ri * H;
        }
        const float* tab = kTable ? disp + static_cast<size_t>(b) * 3 * OW : nullptr;
        if (b != kb || c != kc) {
          kb = b;
          kc = c;
          kri = -1;
          if constexpr (kCoef == kCoefPerSample) {
            const float* cr = coefs + 4 * static_cast<size_t>(b);
            ci = __ldg(cr);
            cj = __ldg(cr + 1);
            bias = __ldg(cr + 3);
            const float ck = __ldg(cr + 2);
#pragma unroll
            for (int k = 0; k < kLanes; ++k) ckl[k] = __fmul_rn(ck, static_cast<float>(lane(k)));
          }
          if constexpr (kTable) {
#pragma unroll
            for (int k = 0; k < kLanes; ++k) {
              const bool in = lane(k) < OW;
              a0[k] = in ? __ldg(tab + lane(k)) : 0.0f;
              a1[k] = in ? __ldg(tab + OW + lane(k)) : 0.0f;
              a2[k] = in ? __ldg(tab + 2 * OW + lane(k)) : 0.0f;
            }
          }
        }
        if (ri != kri) {
          kri = ri;
          const float ri_f = static_cast<float>(ri);
          if constexpr (kCoef == kCoefPerSlice) {
            const float* cr = coefs + 4 * (static_cast<size_t>(b) * D + ri);
            ci = __ldg(cr);
            cj = __ldg(cr + 1);
            bias = __ldg(cr + 3);
            const float ck = __ldg(cr + 2);
#pragma unroll
            for (int k = 0; k < kLanes; ++k) ckl[k] = __fmul_rn(ck, static_cast<float>(lane(k)));
          }
          ciri = __fmul_rn(ci, ri_f);
          if constexpr (kTable) {
#pragma unroll
            for (int k = 0; k < kLanes; ++k) a0ri[k] = __fmul_rn(a0[k], ri_f);
          }
        }
        const float rj_f = static_cast<float>(rj);
        const float base = __fadd_rn(ciri, __fmul_rn(cj, rj_f));  // ci*row_i + cj*row_j
        uint32_t taps[kOps];
        float lo[kOps], hi[kOps];
#pragma unroll
        for (int op = 0; op < kOps; ++op) {
          const uint32_t a = src[op] + 2u * static_cast<uint32_t>(row * S);
          lo[op] = lds_bf16(a);
          hi[op] = lds_bf16(a + 2u * static_cast<uint32_t>(S - 1));
          taps[op] = a - kTapBias;
        }
        uint32_t packed[kOps][kLanePairs];  // the lane pairs' bf16x2
#pragma unroll
        for (int m = 0; m < kLanePairs; ++m) {
          float v[kOps][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * m + e;
            // ((ci*row_i + cj*row_j) + ck*l) + bias [+ ((A0*row_i + A1*row_j) + A2)]
            float pos = __fadd_rn(__fadd_rn(base, ckl[k]), bias);
            if constexpr (kTable) pos = __fadd_rn(pos, __fadd_rn(__fadd_rn(a0ri[k], __fmul_rn(a1[k], rj_f)), a2[k]));
            const float cl = fminf(fmaxf(pos, 0.0f), below);
            const float t23 = __fadd_rd(cl, kTwo23);  // 2^23 + floor(cl)
            const float w = __fsub_rn(cl, __fsub_rn(t23, kTwo23));
            const float omw = __fsub_rn(1.0f, w);
#pragma unroll
            for (int op = 0; op < kOps; ++op) {
              float g0, g1;
              lds_taps(taps[op], __float_as_uint(t23), g0, g1);
              float val = __fadd_rn(__fmul_rn(g0, omw), __fmul_rn(g1, w));
              val = pos <= 0.0f ? lo[op] : val;
              v[op][e] = pos >= last ? hi[op] : val;
            }
          }
#pragma unroll
          for (int op = 0; op < kOps; ++op) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[op][0], v[op][1]);
            packed[op][m] = reinterpret_cast<const uint32_t&>(h);
          }
        }
#pragma unroll
        for (int op = 0; op < kOps; ++op) {
          __nv_bfloat16* p = outs[op] + static_cast<size_t>(n) * OW + l0;
          if (all_in && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
#pragma unroll
            for (int m = 0; m < kLanePairs; ++m) __stcs(reinterpret_cast<unsigned int*>(p + stride * m), packed[op][m]);
          } else {  // lanes past the row, or a row off 4 bytes (odd OW)
#pragma unroll
            for (int k = 0; k < kLanes; ++k) {
              if (lane(k) < OW) {
                const uint32_t bits = packed[op][k >> 1] >> (16 * (k & 1));
                p[stride * (k >> 1) + (k & 1)] = __ushort_as_bfloat16(static_cast<unsigned short>(bits));
              }
            }
          }
        }
      }
    }
  });
}

// Plans the launch of a lanes-kernel form on nrows rows into g and launches
// it if `launch`; as hat_ring_run, with tiles of rp rows where they fit and
// smaller tiles for small passes. cudaErrorInvalidValue for 2^31 - 512 rows
// or more (int rows).
template <int kOps, int kCoef, int kDisp>
cudaError_t hat_lanes_run(const __nv_bfloat16* xa, const __nv_bfloat16* xb, const float* disp, const float* coefs,
                          __nv_bfloat16* oa, __nv_bfloat16* ob, long long nrows, int R, int H, int S, int OW,
                          bool launch, cudaStream_t st, Geometry* g) {
  constexpr bool kLoose = kOps == 2;
  constexpr int kVec = Ring<kOps, __nv_bfloat16>::kVec;
  if (nrows > 0x7fffffffll - kRingThreads || OW < 1 || H < 1 || R % H) return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(&hat_lanes_kernel<kOps, kCoef, kDisp>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = plan(fn, dev, kOps, nrows, S, kLanesStageBytes / kOps, g, kLoose, static_cast<int>(sizeof(__nv_bfloat16)),
             lanes_rows(OW), kLanesMinTiles);
  }
  if (e != cudaSuccess || !launch) return e;
  if (!kLoose && !aligned16(xa)) return cudaErrorMisalignedAddress;
  TileCounter* counter = nullptr;
  e = tile_counter(dev, st, &counter);
  if (e != cudaSuccess) return e;
  hat_lanes_kernel<kOps, kCoef, kDisp><<<g->grid, kRingThreads, g->smem, st>>>(
      xa, xb, disp, coefs, oa, ob, static_cast<int>(nrows), R, H, S, OW, g->tile_rows,
      ring_pitch(g->tile_rows * S, kLoose, kVec), g->stages, counter, fast_div(R), fast_div(H));
  return cudaGetLastError();
}

// geometry = {tile rows, ring stages, grid blocks, dynamic shared-memory
// bytes} of g
void write_geometry(const Geometry& g, int* geometry) {
  geometry[0] = g.tile_rows;
  geometry[1] = g.stages;
  geometry[2] = g.grid;
  geometry[3] = g.smem;
}

}  // namespace
