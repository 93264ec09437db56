// Device code shared by the hat-pass kernels (hat_pass.cu, hat_single.cu): the
// position polynomial, its displacement forms, and the edge-clamped samples of
// one staged row.
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

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace fsg {

constexpr int kHatThreads = 256;

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

// The position of lane l plus the displacement of kDisp: disp_row is the
// row's (OW,) slice of the volume, or the sample's (3, OW) table.
template <int kDisp>
__device__ __forceinline__ float hat_displaced(float pos, const float* disp_row, int OW, int l,
                                               float row_i, float row_j) {
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (kDisp == kDispVolume) d[0] = disp_row[l];
  if (kDisp == kDispLaneAffine) {
    d[0] = disp_row[l];
    d[1] = disp_row[OW + l];
    d[2] = disp_row[2 * OW + l];
  }
  return hat_displace<kDisp>(pos, d, row_i, row_j);
}

// Where the displacement of sample b, row r starts (volume: the row; table:
// the sample's (3, OW) block).
template <int kDisp>
__device__ __forceinline__ const float* hat_disp_row(const float* disp, int b, int r, int R, int OW) {
  if (kDisp == kDispVolume) return disp + (static_cast<size_t>(b) * R + r) * OW;
  if (kDisp == kDispLaneAffine) return disp + static_cast<size_t>(b) * 3 * OW;
  return nullptr;
}

// Sample of the staged row (length S) at pos: row[0] where pos <= 0,
// row[S-1] where pos >= S-1, else linear (two taps) or nearest. Between the
// edges the clamps are the identity; they keep a NaN position in bounds.
template <bool kNearest>
__device__ __forceinline__ float hat_sample(const float* row, float pos, int S) {
  const float last = static_cast<float>(S - 1);
  if (pos <= 0.0f) return row[0];
  if (pos >= last) return row[S - 1];
  const float c = fminf(fmaxf(pos, 0.0f), last);
  if (kNearest) return row[static_cast<int>(rintf(c))];
  const float f = fminf(floorf(c), static_cast<float>(S - 2));
  const float w = __fsub_rn(c, f);
  const int fi = static_cast<int>(f);
  return __fadd_rn(__fmul_rn(row[fi], __fsub_rn(1.0f, w)), __fmul_rn(row[fi + 1], w));
}

}  // namespace fsg
