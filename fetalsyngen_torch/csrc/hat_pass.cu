// Paired hat pass: resampling of the last axis of two f32 volumes at shared,
// edge-clamped positions, the first operand linearly (the image), the second
// nearest (the labels).
//
// Replaces the TPU Pallas kernel fetalsyngen_tpu/ops/warp.py::_hat_pair_kernel
// (launched by _hat_pass_pair_impl). Its spec is _hat_pass_jnp in the same
// file; the plain PyTorch version is fetalsyngen_torch/kernels/hat.py::
// hat_pass_pair_ref, which this kernel matches bit for bit.
//
// For sample b, row r (row_i = r / H, row_j = r % H) and output lane l:
//   pos = ((ci*row_i + cj*row_j) + ck*l) + bias, then pos += disp[b, r, l]
//   a (linear), b (nearest): edge-clamped samples of the two rows at pos
// (hat_common.cuh holds the position and sample code shared with K2, with the
// rounding rules that keep it bit-equal to the plain version).
//
// Bound: device memory. Per output element it reads one displacement and
// (amortised over the row) one source value per operand, and writes two
// outputs: about 20 bytes per element, two taps of arithmetic. Design: one
// block per row; the two source rows are staged in shared memory with
// coalesced loads (2 x 1 KB at S = 256), then one thread per output lane reads
// its two taps per operand from shared memory, one coalesced displacement
// value, and writes two coalesced outputs.

#include "hat_common.cuh"

namespace {

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

  const float ck = coefs[4 * b + 2];
  const float bias = coefs[4 * b + 3];
  const float base = fsg::hat_row_base(coefs[4 * b + 0], coefs[4 * b + 1], r, H);

  for (int l = threadIdx.x; l < OW; l += blockDim.x) {
    const float pos = __fadd_rn(fsg::hat_position(base, ck, bias, l), disp[out_row + l]);
    oa[out_row + l] = fsg::hat_sample<false>(sa, pos, S);
    ob[out_row + l] = fsg::hat_sample<true>(sb, pos, S);
  }
}

}  // namespace

// xa, xb: (B, R, S); disp, oa, ob: (B, R, OW); coefs: (B, 4); all f32,
// contiguous, on the current device. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int fsg_hat_pass_pair_f32(const float* xa, const float* xb, const float* disp,
                                     const float* coefs, float* oa, float* ob, int B, int R,
                                     int H, int S, int OW, void* stream) {
  const dim3 grid(R, B);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  hat_pair_kernel<<<grid, fsg::kHatThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, disp, coefs, oa, ob, R, H, S, OW);
  return static_cast<int>(cudaGetLastError());
}
