// Paired hat pass: resampling of the last axis of two f32 (or bf16) volumes at shared,
// edge-clamped positions, each operand linearly or nearest: an image and its
// labels (linear, nearest), the scanner's value and weight, or slice and
// mask, chains (linear, linear), and the separable pair warp in any of the
// four modes.
//
// Replaces the TPU Pallas kernel fetalsyngen_tpu/ops/warp.py::_hat_pair_kernel
// (launched by _hat_pass_pair_impl). Its spec is _hat_pass_jnp in the same
// file; the plain PyTorch version is fetalsyngen_torch/kernels/hat.py::
// hat_pass_pair_ref, which this kernel matches bit for bit.
//
// For sample b, row r (row_i = r / H, row_j = r % H) and output lane l:
//   pos = ((ci*row_i + cj*row_j) + ck*l) + bias, (ci, cj, ck, bias) the
//         sample's coefficient row or its slice row_i's (per-slice table)
//   pos += disp[b, r, l]                                  (volume), or
//   pos += (A0[l]*row_i + A1[l]*row_j) + A2[l]            (lane-affine), or
//   nothing
//   a, b: edge-clamped samples of the two rows at pos
// (hat_common.cuh holds the position and sample code shared with K2, with the
// rounding rules that keep it bit-equal to the plain version). The forms are
// template parameters; only those the callers use are instantiated, each in
// f32 and bf16: the generator's (linear, nearest; per-sample coefficients,
// displacement volume), the scanner's (linear pair; per-sample coefficients
// with a lane-affine table: the z-extraction and slice-placement passes; or
// per-slice coefficients without a displacement: the in-plane passes), and
// per-sample coefficients without a displacement in the four modes (the
// separable pair warp's passes and the kernel probes' plain passes). The
// (nearest, linear) form is the (linear, nearest) one with the operands
// swapped: the positions are shared, so the samples are the same.
//
// Bound: device memory. Per output element it reads (amortised over the row)
// one source value per operand, a displacement when the form has a volume,
// and writes two outputs: 16 to 20 bytes per element in f32, 8 to 12 in the
// bf16 forms (bf16 rows and outputs, f32 displacement), two taps of
// arithmetic.
//
// Design: K2's ring kernel (hat_ring_kernel in hat_common.cuh) with two
// operands: a persistent grid draws tiles of consecutive rows, about 16 KB
// per operand, through a three-stage TMA ring, each thread computing four
// output lanes from both staged rows. Where it differs from K2:
// - outputs, the displacement volume and the lane-affine table have rows of
//   OW lanes, which need not equal the staged rows' S;
// - the ring is loose: a tile holds any number of rows and an operand may
//   start at any float (a view into a larger tensor; xa and xb each at its
//   own offset). The bulk copy takes the tile's whole 16-byte units and
//   thread 0 copies the 0-3 floats before the first and after the last
//   (ring.cuh). With tiles in units of four rows for odd S, as K2 has them,
//   two stages of the two operands' 4-row tiles would not fit 227 KB above
//   S = 3630; one-row tiles fit up to S of about 14,500.
// Per tile, each operand's lead (its first float's offset from a 16-byte
// boundary) places it in its buffer; the ring's buffers have room for it.
// The linear bf16 pairs without a displacement volume (lane-affine,
// per-slice, per-sample) run hat_lanes_kernel (hat_common.cuh) on the same
// loose ring: a thread keeps eight lanes across rows, and the two operands
// share each lane's position, weights and tap address.

#include "hat_common.cuh"

namespace {

// The instantiated forms of element type T (every one in f32 and bf16);
// cudaErrorInvalidValue for another.
template <typename T>
cudaError_t pair_run(const T* xa, const T* xb, const float* disp, const float* coefs, T* oa, T* ob, long long nrows,
                     int R, int H, int S, int OW, int nearest_a, int nearest_b, int coef_mode, int disp_mode,
                     bool launch, cudaStream_t st, Geometry* g) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const bool linear = !nearest_a && !nearest_b;
  if (coef_mode == kCoefPerSample && disp_mode == kDispVolume) {
    if (nearest_a || !nearest_b) return cudaErrorInvalidValue;
    return hat_ring_run<T, 2, true, kCoefPerSample, kDispVolume>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW,
                                                                 launch, st, g);
  }
  if (coef_mode == kCoefPerSample && disp_mode == kDispLaneAffine) {
    if (!linear) return cudaErrorInvalidValue;
    if constexpr (kBf16) {
      return hat_lanes_run<2, kCoefPerSample, kDispLaneAffine>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW,
                                                               launch, st, g);
    } else {
      return hat_ring_run<T, 2, false, kCoefPerSample, kDispLaneAffine>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S,
                                                                        OW, launch, st, g);
    }
  }
  if (disp_mode != kDispNone) return cudaErrorInvalidValue;
  if (coef_mode == kCoefPerSlice) {
    if (!linear) return cudaErrorInvalidValue;
    if constexpr (kBf16) {
      return hat_lanes_run<2, kCoefPerSlice, kDispNone>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW, launch, st,
                                                        g);
    } else {
      return hat_ring_run<T, 2, false, kCoefPerSlice, kDispNone>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW,
                                                                 launch, st, g);
    }
  }
  if (coef_mode != kCoefPerSample) return cudaErrorInvalidValue;
  // per-sample coefficients, no displacement: the four modes
  if (nearest_a && nearest_b) {
    return hat_ring_run<T, 2, true, kCoefPerSample, kDispNone, true>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW,
                                                                     launch, st, g);
  }
  if (nearest_a) {  // (nearest, linear): (linear, nearest) on the swapped operands
    return hat_ring_run<T, 2, true, kCoefPerSample, kDispNone>(xb, xa, disp, coefs, ob, oa, nrows, R, H, S, OW, launch,
                                                               st, g);
  }
  if (nearest_b) {
    return hat_ring_run<T, 2, true, kCoefPerSample, kDispNone>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW, launch,
                                                               st, g);
  }
  if constexpr (kBf16) {
    return hat_lanes_run<2, kCoefPerSample, kDispNone>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW, launch, st, g);
  } else {
    return hat_ring_run<T, 2, false, kCoefPerSample, kDispNone>(xa, xb, disp, coefs, oa, ob, nrows, R, H, S, OW,
                                                                launch, st, g);
  }
}

}  // namespace

// xa, xb: (B, R, S), each at any float offset; oa, ob: (B, R, OW); coefs:
// (B, 4) or, per slice, (B, R/H, 4); disp: (B, R, OW), (B, 3, OW) or null as
// disp_mode says (DispMode in hat_common.cuh); all f32, contiguous, on the
// current device. nearest_a != 0 samples the first operand nearest,
// nearest_b != 0 the second. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched), or an error without launching:
// cudaErrorInvalidValue for a form that is not instantiated or an S whose
// two ring stages do not fit, or the failed attribute, occupancy or
// tile-counter call.
extern "C" int fsg_hat_pass_pair_f32(const float* xa, const float* xb, const float* disp,
                                     const float* coefs, float* oa, float* ob, int B, int R,
                                     int H, int S, int OW, int nearest_a, int nearest_b, int coef_mode,
                                     int disp_mode, void* stream) {
  Geometry g;
  return static_cast<int>(pair_run(xa, xb, disp, coefs, oa, ob, static_cast<long long>(B) * R, R, H, S, OW, nearest_a,
                                   nearest_b, coef_mode, disp_mode, true, static_cast<cudaStream_t>(stream), &g));
}

// fsg_hat_pass_pair_f32 with bf16 operands and outputs (xa, xb at any bf16
// offset; coefs and disp f32), in the same forms.
extern "C" int fsg_hat_pass_pair_bf16(const __nv_bfloat16* xa, const __nv_bfloat16* xb, const float* disp,
                                      const float* coefs, __nv_bfloat16* oa, __nv_bfloat16* ob, int B, int R,
                                      int H, int S, int OW, int nearest_a, int nearest_b, int coef_mode,
                                      int disp_mode, void* stream) {
  Geometry g;
  return static_cast<int>(pair_run(xa, xb, disp, coefs, oa, ob, static_cast<long long>(B) * R, R, H, S, OW, nearest_a,
                                   nearest_b, coef_mode, disp_mode, true, static_cast<cudaStream_t>(stream), &g));
}

// The launch fsg_hat_pass_pair_f32 (io_bf16 0) or fsg_hat_pass_pair_bf16
// (io_bf16 1) makes on the current device for (B, R, S) operands, OW lanes
// out, in the form (nearest_a, nearest_b, coef_mode, disp_mode): geometry =
// {tile rows, ring stages, grid blocks, dynamic shared-memory bytes}.
// Returns a cudaError code.
extern "C" int fsg_hat_pair_geometry(int B, int R, int S, int OW, int nearest_a, int nearest_b, int coef_mode,
                                     int disp_mode, int io_bf16, int* geometry) {
  Geometry g{};
  const long long nrows = static_cast<long long>(B) * R;
  const cudaError_t e =
      io_bf16 ? pair_run<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nrows, R, 1, S, OW,
                                        nearest_a, nearest_b, coef_mode, disp_mode, false, nullptr, &g)
              : pair_run<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nrows, R, 1, S, OW, nearest_a,
                                nearest_b, coef_mode, disp_mode, false, nullptr, &g);
  write_geometry(g, geometry);
  return static_cast<int>(e);
}
