// Single-operand hat pass: resampling of the last axis of one f32 volume at
// edge-clamped positions, linearly (images) or nearest (labels cast to f32).
//
// Replaces the TPU Pallas kernel fetalsyngen_tpu/ops/warp.py::_hat_kernel
// (launched by _hat_pass_impl) in the forms its callers use, OW == W: one
// coefficient row per sample with an optional displacement volume (the
// generator's warps), and one coefficient row per slice without a
// displacement (the scanner's in-plane reconstruction passes). Its spec is
// _hat_pass_jnp in the same file; the plain PyTorch version is
// fetalsyngen_torch/kernels/hat.py::hat_pass_ref, which this kernel matches
// bit for bit.
//
// For sample b, row r (row_i = r / H, row_j = r % H) and lane l:
//   pos = ((ci*row_i + cj*row_j) + ck*l) + bias [+ disp[b, r, l]]
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

}  // namespace

// x, out: (B, R, S); disp: (B, R, S) or null; coefs: (B, 4), or per slice
// (B, R/H, 4) when per_slice != 0; all f32, contiguous, on the current device.
// nearest != 0 selects nearest sampling. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a form that is not instantiated.
extern "C" int fsg_hat_pass_f32(const float* x, const float* disp, const float* coefs,
                                float* out, int B, int R, int H, int S, int nearest,
                                int per_slice, void* stream) {
  using namespace fsg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_slice) {
    if (nearest || disp) return static_cast<int>(cudaErrorInvalidValue);
    launch<false, kCoefPerSlice, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  } else if (nearest) {
    if (disp) launch<true, kCoefPerSample, kDispVolume>(x, disp, coefs, out, B, R, H, S, st);
    else launch<true, kCoefPerSample, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  } else {
    if (disp) launch<false, kCoefPerSample, kDispVolume>(x, disp, coefs, out, B, R, H, S, st);
    else launch<false, kCoefPerSample, kDispNone>(x, disp, coefs, out, B, R, H, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}
