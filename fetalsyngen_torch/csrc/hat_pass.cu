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
//   sat_lo = pos <= 0, sat_hi = pos >= S-1, c = clamp(pos, 0, S-1)
//   a (linear):  f = clamp(floor(c), 0, S-2), w = c - f, out = g0*(1-w) + g1*w
//   b (nearest): out = x[rint(c)]   (round half to even, as torch.round)
//   out = x[0] where sat_lo, x[S-1] where sat_hi
//
// Rounding is pinned: every product and sum is an explicit _rn intrinsic in
// the plain version's association order, so nvcc cannot contract them into
// FMAs. An FMA would move positions by an ulp and flip nearest-mode labels
// that sit at half-voxel positions.
//
// Bound: device memory. Per output element it reads one displacement and
// (amortised over the row) one source value per operand, and writes two
// outputs: about 20 bytes per element, two taps of arithmetic. Design: one
// block per row; the two source rows are staged in shared memory with
// coalesced loads (2 x 1 KB at S = 256), then one thread per output lane reads
// its two taps per operand from shared memory, one coalesced displacement
// value, and writes two coalesced outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sample_linear(const float* row, float c, int S) {
  const float f = fminf(fmaxf(floorf(c), 0.0f), static_cast<float>(S - 2));
  const float w = __fsub_rn(c, f);
  const int fi = static_cast<int>(f);
  return __fadd_rn(__fmul_rn(row[fi], __fsub_rn(1.0f, w)), __fmul_rn(row[fi + 1], w));
}

__global__ void __launch_bounds__(kThreads) hat_pair_kernel(
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

  const float ci = coefs[4 * b + 0];
  const float cj = coefs[4 * b + 1];
  const float ck = coefs[4 * b + 2];
  const float bias = coefs[4 * b + 3];
  const float row_i = static_cast<float>(r / H);
  const float row_j = static_cast<float>(r % H);
  const float base = __fadd_rn(__fmul_rn(ci, row_i), __fmul_rn(cj, row_j));
  const float last = static_cast<float>(S - 1);

  for (int l = threadIdx.x; l < OW; l += blockDim.x) {
    float pos = __fadd_rn(__fadd_rn(base, __fmul_rn(ck, static_cast<float>(l))), bias);
    pos = __fadd_rn(pos, disp[out_row + l]);
    const float c = fminf(fmaxf(pos, 0.0f), last);
    float va = sample_linear(sa, c, S);
    float vb = sb[static_cast<int>(rintf(c))];
    if (pos <= 0.0f) {
      va = sa[0];
      vb = sb[0];
    }
    if (pos >= last) {
      va = sa[S - 1];
      vb = sb[S - 1];
    }
    oa[out_row + l] = va;
    ob[out_row + l] = vb;
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
  hat_pair_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, disp, coefs, oa, ob, R, H, S, OW);
  return static_cast<int>(cudaGetLastError());
}
