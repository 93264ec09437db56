// Paired hat pass: resampling of the last axis of two f32 volumes at shared,
// edge-clamped positions, the first operand linearly, the second nearest (an
// image and its labels) or linearly (the scanner's value and weight, or slice
// and mask, chains).
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
// template parameters; only the four the callers use are instantiated: the
// generator's (nearest labels, per-sample coefficients, displacement volume),
// the scanner's (linear pair, per-sample coefficients, lane-affine table:
// the z-extraction and slice-placement passes; linear pair, per-slice
// coefficients, no displacement: the in-plane motion passes) and the kernel
// probes' plain passes (nearest labels, per-sample coefficients, no
// displacement).
//
// Bound: device memory. Per output element it reads (amortised over the row)
// one source value per operand, a displacement when the form has a volume,
// and writes two outputs: 16 to 20 bytes per element, two taps of
// arithmetic. Design: one block per row; the two source rows are staged in
// shared memory with coalesced loads, then one thread per output lane reads
// its taps from shared memory and writes two coalesced outputs.

#include "hat_common.cuh"

namespace {

template <bool kNearestB, int kCoef, int kDisp>
__global__ void __launch_bounds__(fsg::kHatThreads) hat_pair_kernel(
    const float* __restrict__ xa, const float* __restrict__ xb,
    const float* __restrict__ disp, const float* __restrict__ coefs,
    float* __restrict__ oa, float* __restrict__ ob, int R, int H, int S, int OW) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + S;

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const size_t in_row = (static_cast<size_t>(b) * R + r) * S;
  const size_t out_row = (static_cast<size_t>(b) * R + r) * OW;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    sa[s] = xa[in_row + s];
    sb[s] = xb[in_row + s];
  }
  __syncthreads();

  const float row_i = static_cast<float>(r / H);
  const float row_j = static_cast<float>(r % H);
  const float* c = fsg::hat_coefs<kCoef>(coefs, b, r, R, H);
  const float ck = c[2];
  const float bias = c[3];
  const float base = fsg::hat_row_base(c[0], c[1], row_i, row_j);
  const float* d = fsg::hat_disp_row<kDisp>(disp, b, r, R, OW);

  for (int l = threadIdx.x; l < OW; l += blockDim.x) {
    const float pos =
        fsg::hat_displaced<kDisp>(fsg::hat_position(base, ck, bias, l), d, OW, l, row_i, row_j);
    oa[out_row + l] = fsg::hat_sample<false>(sa, pos, S);
    ob[out_row + l] = fsg::hat_sample<kNearestB>(sb, pos, S);
  }
}

template <bool kNearestB, int kCoef, int kDisp>
void launch(const float* xa, const float* xb, const float* disp, const float* coefs, float* oa,
            float* ob, int B, int R, int H, int S, int OW, cudaStream_t stream) {
  const dim3 grid(R, B);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  hat_pair_kernel<kNearestB, kCoef, kDisp><<<grid, fsg::kHatThreads, smem, stream>>>(
      xa, xb, disp, coefs, oa, ob, R, H, S, OW);
}

}  // namespace

// xa, xb: (B, R, S); oa, ob: (B, R, OW); coefs: (B, 4) or, per slice, (B, R/H,
// 4); disp: (B, R, OW), (B, 3, OW) or null as disp_mode says (DispMode in
// hat_common.cuh); all f32, contiguous, on the current device. nearest_b != 0
// samples the second operand nearest. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a form that is not instantiated.
extern "C" int fsg_hat_pass_pair_f32(const float* xa, const float* xb, const float* disp,
                                     const float* coefs, float* oa, float* ob, int B, int R,
                                     int H, int S, int OW, int nearest_b, int coef_mode,
                                     int disp_mode, void* stream) {
  using namespace fsg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nearest_b && coef_mode == kCoefPerSample && disp_mode == kDispVolume) {
    launch<true, kCoefPerSample, kDispVolume>(xa, xb, disp, coefs, oa, ob, B, R, H, S, OW, st);
  } else if (!nearest_b && coef_mode == kCoefPerSample && disp_mode == kDispLaneAffine) {
    launch<false, kCoefPerSample, kDispLaneAffine>(xa, xb, disp, coefs, oa, ob, B, R, H, S, OW, st);
  } else if (nearest_b && coef_mode == kCoefPerSample && disp_mode == kDispNone) {
    launch<true, kCoefPerSample, kDispNone>(xa, xb, disp, coefs, oa, ob, B, R, H, S, OW, st);
  } else if (!nearest_b && coef_mode == kCoefPerSlice && disp_mode == kDispNone) {
    launch<false, kCoefPerSlice, kDispNone>(xa, xb, disp, coefs, oa, ob, B, R, H, S, OW, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
