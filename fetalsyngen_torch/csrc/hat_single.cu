// Single-operand hat pass: resampling of the last axis of one f32 volume at
// edge-clamped positions, linearly (images) or nearest (labels cast to f32).
//
// Replaces the TPU Pallas kernel fetalsyngen_tpu/ops/warp.py::_hat_kernel
// (launched by _hat_pass_impl) in the forms its callers use, OW == W: one
// coefficient row per sample with an optional displacement volume (the
// generator's warps), one coefficient row per sample with a (3, W)
// lane-affine table, linearly (the form the kernel probes time), and one
// coefficient row per slice without a displacement (the scanner's in-plane
// reconstruction passes). Its spec is _hat_pass_jnp in the same file; the
// plain PyTorch version is fetalsyngen_torch/kernels/hat.py::hat_pass_ref,
// which this kernel matches bit for bit.
//
// For sample b, row r (row_i = r / H, row_j = r % H) and lane l:
//   pos = ((ci*row_i + cj*row_j) + ck*l) + bias
//         [+ disp[b, r, l]  or  + ((A0[l]*row_i + A1[l]*row_j) + A2[l])]
//   out = edge-clamped linear or nearest sample of the row at pos
// with (ci, cj, ck, bias) the sample's row or slice row_i's. The position
// and sample code is K1's (hat_common.cuh). The U passes of the affine warp
// have general slopes and up to three nonzero products, so the pinned
// association order matters on every one of them. The displacement is a
// template parameter rather than a zero volume: pos + 0.0f is not the
// identity for pos = -0.0f.
//
// Bound: device memory. Per element it reads (amortised over the row) one
// source value, one displacement when present, and writes one output: 8 to
// 12 bytes per element. Design: one block per row; the source row is staged
// in shared memory with coalesced loads, then one thread per output lane
// reads its taps from shared memory and writes one coalesced output.
//
// The second kernel, hat_variant_kernel, replaces the TPU cost probe
// scripts/profile_kernel_variants.py::make_kernel (K7): the hat kernel's
// windowed form (a block-wide window of staged taps, a weight per tap, a
// tap-span budget) in five variants, each a template instantiation. Variants
// 1-4 compute deliberately wrong functions; each is still a well-defined one
// that hat_variant_ref in fetalsyngen_torch/kernels/probes.py writes out and
// this kernel matches bit for bit. For a block of kVariantRows rows, with the
// padded row s[c] = x[r, clamp(c - pad, 0, S - 1)], pad = max(128, S):
//   pos   = ((((ci*row_i + cj*row_j) + ck*l) + bias) + A0[l]*row_i) + A1[l]*row_j) + A2[l]
//           (the TPU probe's own association order)
//   rel   = pos - l over the block's valid (unsaturated) elements
//   n0    = clamp(floor(min rel), -pad, S - 1)   (V0, V1, V3), else -8
//   span  = floor(max rel) - n0 + 2              (V0, V1, V2), else 8
//   base  = pad + n0 (V0, V3), its 128-aligned floor (V1), pad - 64 (V2, V4)
//   d0    = clamp(rel - n0, 0, maxspan - 1), maxspan 48 (4 for V4)
//   out   = sum over taps m < maxspan in chunks of 8 that start below span
//           of max(0, 1 - |d0 - m|) * s[base + m + l], in tap order;
//           x[r, 0] where pos <= 0 and x[r, S - 1] where pos >= S - 1.
// On the TPU, V0 realigns its window with a seven-step lane-roll ladder and
// V1 skips it; on Hopper the shift is a plain unaligned shared-memory read,
// so V1 differs from V0 only in the address. The per-block min and max of
// rel are block reductions (a pass over the block's positions, warp
// shuffles, one shared-memory round), kept where the TPU variant has them.
// Bound: for V0 at its probe shapes, the tap arithmetic (up to 48 taps of 6
// operations per element) rather than its 8 bytes per element.

#include "hat_common.cuh"

namespace {

template <bool kNearest, int kCoef, int kDisp>
__global__ void __launch_bounds__(fsg::kHatThreads) hat_single_kernel(
    const float* __restrict__ x, const float* __restrict__ disp,
    const float* __restrict__ coefs, float* __restrict__ out, int R, int H, int S) {
  extern __shared__ float srow[];

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = (static_cast<size_t>(b) * R + r) * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) srow[s] = x[row + s];
  __syncthreads();

  const float row_i = static_cast<float>(r / H);
  const float row_j = static_cast<float>(r % H);
  const float* c = fsg::hat_coefs<kCoef>(coefs, b, r, R, H);
  const float ck = c[2];
  const float bias = c[3];
  const float base = fsg::hat_row_base(c[0], c[1], row_i, row_j);
  const float* d = fsg::hat_disp_row<kDisp>(disp, b, r, R, S);

  for (int l = threadIdx.x; l < S; l += blockDim.x) {
    const float pos =
        fsg::hat_displaced<kDisp>(fsg::hat_position(base, ck, bias, l), d, S, l, row_i, row_j);
    out[row + l] = fsg::hat_sample<kNearest>(srow, pos, S);
  }
}

template <bool kNearest, int kCoef, int kDisp>
void launch(const float* x, const float* disp, const float* coefs, float* out, int B, int R,
            int H, int S, cudaStream_t stream) {
  const dim3 grid(R, B);
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  hat_single_kernel<kNearest, kCoef, kDisp><<<grid, fsg::kHatThreads, smem, stream>>>(
      x, disp, coefs, out, R, H, S);
}

constexpr int kVariantRows = 32;   // rows per block, the TPU variants' block
constexpr int kVariantChunk = 8;   // taps per predicated chunk (TAP_CHUNK)
constexpr float kVariantBig = 1e9f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The probe's position: K2's polynomial, then the (3, S) table added term by
// term, ((pos + A0*row_i) + A1*row_j) + A2.
__device__ __forceinline__ float variant_position(float base, float ck, float bias,
                                                  const float* tab, int S, int l, float row_i,
                                                  float row_j) {
  const float pos = fsg::hat_position(base, ck, bias, l);
  return __fadd_rn(__fadd_rn(__fadd_rn(pos, __fmul_rn(tab[l], row_i)), __fmul_rn(tab[S + l], row_j)),
                   tab[2 * S + l]);
}

template <int kVariant>
__global__ void hat_variant_kernel(const float* __restrict__ x, const float* __restrict__ tab,
                                   const float* __restrict__ coefs, float* __restrict__ out, int H,
                                   int S, int pad, int width) {
  constexpr bool kMin = kVariant == 0 || kVariant == 1 || kVariant == 3;
  constexpr bool kMax = kVariant <= 2;
  constexpr int kMaxspan = kVariant == 4 ? 4 : 48;
  extern __shared__ float srow[];  // one edge-padded row, width floats
  __shared__ float red_min[32], red_max[32];
  __shared__ int geo[2];

  const int r0 = blockIdx.x * kVariantRows;
  const float ci = coefs[0], cj = coefs[1], ck = coefs[2], bias = coefs[3];
  const float last = static_cast<float>(S - 1);

  int n0 = -8, span = 8;
  if (kMin || kMax) {
    float mn = kVariantBig, mx = -kVariantBig;
    for (int rr = 0; rr < kVariantRows; ++rr) {
      const int r = r0 + rr;
      const float row_i = static_cast<float>(r / H);
      const float row_j = static_cast<float>(r % H);
      const float base = fsg::hat_row_base(ci, cj, row_i, row_j);
      for (int l = threadIdx.x; l < S; l += blockDim.x) {
        const float pos = variant_position(base, ck, bias, tab, S, l, row_i, row_j);
        if (!(pos <= 0.0f) && !(pos >= last)) {
          const float rel = __fsub_rn(pos, static_cast<float>(l));
          if (kMin) mn = fminf(mn, rel);
          if (kMax) mx = fmaxf(mx, rel);
        }
      }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    if (kMin) mn = warp_min(mn);
    if (kMax) mx = warp_max(mx);
    if (lane == 0) {
      red_min[warp] = mn;
      red_max[warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
      mn = lane < nwarps ? red_min[lane] : kVariantBig;
      mx = lane < nwarps ? red_max[lane] : -kVariantBig;
      if (kMin) mn = warp_min(mn);
      if (kMax) mx = warp_max(mx);
      if (lane == 0) {
        const int n = kMin ? min(max(static_cast<int>(floorf(mn)), -pad), S - 1) : -8;
        geo[0] = n;
        geo[1] = kMax ? static_cast<int>(floorf(mx)) - n + 2 : 8;
      }
    }
    __syncthreads();
    n0 = geo[0];
    span = geo[1];
  }
  const int win = (kVariant == 0 || kVariant == 3) ? pad + n0
                  : kVariant == 1                 ? ((pad + n0) / 128) * 128
                                                  : pad - 64;

  for (int rr = 0; rr < kVariantRows; ++rr) {
    const int r = r0 + rr;
    const float* xr = x + static_cast<size_t>(r) * S;
    __syncthreads();  // the previous row's taps are read
    for (int c = threadIdx.x; c < width; c += blockDim.x) srow[c] = xr[min(max(c - pad, 0), S - 1)];
    __syncthreads();
    const float row_i = static_cast<float>(r / H);
    const float row_j = static_cast<float>(r % H);
    const float base = fsg::hat_row_base(ci, cj, row_i, row_j);
    for (int l = threadIdx.x; l < S; l += blockDim.x) {
      const float pos = variant_position(base, ck, bias, tab, S, l, row_i, row_j);
      float v;
      if (pos <= 0.0f) {
        v = srow[pad];
      } else if (pos >= last) {
        v = srow[pad + S - 1];
      } else {
        const float rel = __fsub_rn(pos, static_cast<float>(l));
        const float d0 =
            fminf(fmaxf(__fsub_rn(rel, static_cast<float>(n0)), 0.0f), static_cast<float>(kMaxspan - 1));
        const float* w = srow + win + l;
        float acc = 0.0f;
#pragma unroll
        for (int c0 = 0; c0 < kMaxspan; c0 += kVariantChunk) {
          if (c0 < span) {
#pragma unroll
            for (int m = c0; m < (c0 + kVariantChunk < kMaxspan ? c0 + kVariantChunk : kMaxspan); ++m) {
              const float wgt = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(d0, static_cast<float>(m)))));
              acc = __fadd_rn(acc, __fmul_rn(wgt, w[m]));
            }
          }
        }
        v = acc;
      }
      out[static_cast<size_t>(r) * S + l] = v;
    }
  }
}

}  // namespace

// x, out: (B, R, S); coefs: (B, 4), or per slice (B, R/H, 4) when coef_mode
// is kCoefPerSlice; disp: (B, R, S), (B, 3, S) or null as disp_mode says
// (DispMode in hat_common.cuh); all f32, contiguous, on the current device.
// nearest != 0 selects nearest sampling. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a form that is not instantiated.
extern "C" int fsg_hat_pass_f32(const float* x, const float* disp, const float* coefs,
                                float* out, int B, int R, int H, int S, int nearest,
                                int coef_mode, int disp_mode, void* stream) {
  using namespace fsg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coef_mode == kCoefPerSlice) {
    if (nearest || disp_mode != kDispNone) return static_cast<int>(cudaErrorInvalidValue);
    launch<false, kCoefPerSlice, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  } else if (disp_mode == kDispLaneAffine) {
    if (nearest) return static_cast<int>(cudaErrorInvalidValue);
    launch<false, kCoefPerSample, kDispLaneAffine>(x, disp, coefs, out, B, R, H, S, st);
  } else if (nearest) {
    if (disp_mode == kDispVolume) launch<true, kCoefPerSample, kDispVolume>(x, disp, coefs, out, B, R, H, S, st);
    else launch<true, kCoefPerSample, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  } else {
    if (disp_mode == kDispVolume) launch<false, kCoefPerSample, kDispVolume>(x, disp, coefs, out, B, R, H, S, st);
    else launch<false, kCoefPerSample, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: x, out: (R, S) rows of a (R / H, H, S) volume, R a multiple of 32;
// tab: (3, S); coefs: (4,); all f32, contiguous, on the current device.
// variant in 0..4. One block of `threads` (a multiple of 32, at most 1024)
// per 32 rows, with (3*S + 128) (S >= 128) or (2*S + 256) floats of shared
// memory. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for another variant.
extern "C" int fsg_hat_variant_f32(const float* x, const float* tab, const float* coefs,
                                   float* out, int R, int H, int S, int variant, int threads,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pad = S > 128 ? S : 128;
  const int width = S + pad + S + 128;
  const size_t smem = static_cast<size_t>(width) * sizeof(float);
  const dim3 grid(R / kVariantRows);
  switch (variant) {
    case 0: hat_variant_kernel<0><<<grid, threads, smem, st>>>(x, tab, coefs, out, H, S, pad, width); break;
    case 1: hat_variant_kernel<1><<<grid, threads, smem, st>>>(x, tab, coefs, out, H, S, pad, width); break;
    case 2: hat_variant_kernel<2><<<grid, threads, smem, st>>>(x, tab, coefs, out, H, S, pad, width); break;
    case 3: hat_variant_kernel<3><<<grid, threads, smem, st>>>(x, tab, coefs, out, H, S, pad, width); break;
    case 4: hat_variant_kernel<4><<<grid, threads, smem, st>>>(x, tab, coefs, out, H, S, pad, width); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
