// Device code shared by the hat-pass kernels (hat_pass.cu, hat_single.cu): the
// position polynomial and the edge-clamped samples of one staged row.
//
// Spec: _hat_pass_jnp in fetalsyngen_tpu/ops/warp.py; plain PyTorch versions:
// positions() and _sample_ref() in fetalsyngen_torch/kernels/hat.py, which
// these functions match bit for bit.
//
// Rounding is pinned: every product and sum is an explicit _rn intrinsic in
// the plain version's association order, so nvcc cannot contract them into
// FMAs. An FMA would move positions by an ulp and flip nearest-mode labels
// that sit at half-voxel positions. Nearest mode rounds half to even (rintf,
// as torch.round).

#pragma once

#include <cuda_runtime.h>

namespace fsg {

constexpr int kHatThreads = 256;

// ci*row_i + cj*row_j for row r = row_i*H + row_j: the lane-independent part
// of the position, computed once per row.
__device__ __forceinline__ float hat_row_base(float ci, float cj, int r, int H) {
  const float row_i = static_cast<float>(r / H);
  const float row_j = static_cast<float>(r % H);
  return __fadd_rn(__fmul_rn(ci, row_i), __fmul_rn(cj, row_j));
}

// ((ci*row_i + cj*row_j) + ck*l) + bias
__device__ __forceinline__ float hat_position(float base, float ck, float bias, int l) {
  return __fadd_rn(__fadd_rn(base, __fmul_rn(ck, static_cast<float>(l))), bias);
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
