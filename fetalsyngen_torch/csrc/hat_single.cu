// Single-operand hat pass: resampling of the last axis of one f32 (or bf16) volume at
// edge-clamped positions, linearly (images) or nearest (labels cast to f32),
// to rows of OW lanes.
//
// Replaces the TPU Pallas kernel fetalsyngen_tpu/ops/warp.py::_hat_kernel
// (launched by _hat_pass_impl) in the forms its callers use: one
// coefficient row per sample with an optional displacement volume (the
// generator's warps and the separable affine and displacement warps, OW
// any length: out_len), one coefficient row per sample with a (3, OW)
// lane-affine table, linearly (the form the kernel probes time), and one
// coefficient row per slice without a displacement (the scanner's in-plane
// reconstruction passes); each in f32 and bf16. Its spec is _hat_pass_jnp
// in the same file; the plain PyTorch version is
// fetalsyngen_torch/kernels/hat.py::hat_pass_ref, which this kernel matches
// bit for bit.
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
// Bound: device memory. Per element it reads one source value, one
// displacement when present, and writes one output: 8 to 12 bytes per
// element in f32, 4 to 8 in the bf16 forms (the stream's production mode,
// rows and output bf16, the taps' arithmetic f32, see hat_common.cuh); the
// table of the lane-affine form (3 x 4 bytes a lane) is read once per sample
// from the caches.
//
// Design: the ring kernel of hat_common.cuh (hat_ring_kernel), which K1
// runs with two operands: a persistent grid of 512-thread blocks draws tiles
// of consecutive rows, about 16 KB, from a per-stream counter through a
// three-stage ring of TMA bulk copies; each thread computes four lanes and
// stores them with one 16-byte streaming store; the displacement volume and
// the lane-affine table are read with 16-byte __ldg, not staged. Only the
// staged rows are tiled: outputs of OW lanes go from registers to device
// memory, so OW != S changes the stores, not the ring. K2's tiles are whole
// 16-byte units (4 / gcd(S, 4) rows, x on 16 bytes: the wrapper copies an x
// that is not), so at S = 6143 two stages of its 4-row tiles (197 KB) fit
// where three do not. The linear bf16 forms without a displacement volume
// (lane-affine, per-slice, and per-sample without a displacement) run
// hat_lanes_kernel (hat_common.cuh): a thread keeps eight lanes across the
// rows of its tiles, their terms in registers, and the taps' index comes
// from one rounding add; 4 bytes an element leave too few instructions for
// the ring kernel's per-group work. Its tiles too are whole 16-byte units of
// an x on 16 bytes. On finite rows it gives the plain version's bits; a NaN
// row value that a saturated lane selects comes out as bf16's canonical NaN
// (the edge value is widened and rounded, as an interior sample is), where
// the plain version and the ring kernel keep the NaN's own bits.

// The second kernel, hat_variant_kernel, replaces the TPU cost probe
// scripts/profile_kernel_variants.py::make_kernel (K7): the hat kernel's
// windowed form (a block-wide window of staged taps, a weight per tap, a
// tap-span budget) in five variants, each a template instantiation. Variants
// 1-4 compute deliberately wrong functions; each is still a well-defined one
// that hat_variant_ref in fetalsyngen_torch/kernels/probes.py writes out. For
// a block of kVariantRows rows, with pad = max(128, S):
//   pos   = ((((ci*row_i + cj*row_j) + ck*l) + bias) + A0[l]*row_i) + A1[l]*row_j) + A2[l]
//           (the TPU probe's own association order)
//   rel   = pos - l over the block's valid (unsaturated) elements
//   n0    = clamp(floor(min rel), -pad, S - 1)   (V0, V1, V3), else -8
//   span  = floor(max rel) - n0 + 2              (V0, V1, V2), else 8
//   win   = n0 (V0, V3), the 128-aligned floor of pad + n0, less pad (V1),
//           -64 (V2, V4): the window's first column in the row
//   d0    = clamp(rel - n0, 0, maxspan - 1), maxspan 48 (4 for V4)
//   out   = sum over taps m < maxspan whose chunk of 8 starts below span of
//           max(0, 1 - |d0 - m|) * x[r, clamp(win + l + m, 0, S - 1)], in
//           tap order; x[r, 0] where pos <= 0 and x[r, S - 1] where
//           pos >= S - 1.
// A weight is nonzero only at m0 = floor(d0) and m0 + 1, so the kernel reads
// those two taps and sums (0 + p(m0)) + p(m0 + 1), each where it runs. Every
// other tap of the sum adds w * x = +-0 to a sum that is never -0 (it starts
// at +0, and +0 + -0 = +0), so on finite rows the two forms agree bit for
// bit; a non-finite value under a zero-weight tap other than these two
// makes the full sum NaN and not the two-tap sum. The probe's rows are
// finite.
// On the TPU, V0 realigns its window with a seven-step lane-roll ladder and
// V1 skips it; on Hopper the shift is a read at a runtime offset, so V1
// differs from V0 only in the address. The per-block min and max of rel are
// block reductions (warp shuffles, one shared-memory round), kept where the
// TPU variant has them.
// Bound: device memory, 8 bytes per element (one read, one write); two taps
// of arithmetic after the position.
// Design: one 512-thread block per 32 rows (the unit of the reduction). At
// the start thread 0 stages the block's 32 rows (contiguous) with one TMA
// bulk copy while every thread stages the (3, S) table in shared memory and
// computes the block's positions once, keeping them in shared memory, and
// reduces them; the sampling pass then reads each element's position and
// two taps from shared memory and stores the sample, streaming. Rows and
// positions of 32 rows fit the 227 KB a block may have up to S = 864 (at
// S = 384, 104 KB: two blocks per SM); above that (the wrapper takes S up
// to 19,306) the block stages only the table, reads its taps from device
// memory and computes each position again in the sampling pass.

#include "hat_common.cuh"

namespace {

// K2's form (kNearest, kCoef, kDisp) on T rows, planned into g and launched
// if `launch`: the ring kernel with one operand, tiles in whole 16-byte units
template <typename T, bool kNearest, int kCoef, int kDisp>
cudaError_t run(const T* x, const float* disp, const float* coefs, T* out, long long nrows, int R, int H, int S, int OW,
                bool launch, cudaStream_t st, Geometry* g) {
  return hat_ring_run<T, 1, kNearest, kCoef, kDisp>(x, nullptr, disp, coefs, out, nullptr, nrows, R, H, S, OW, launch,
                                                    st, g);
}

// K2's linear form (kCoef, kDisp) without a displacement volume: the lanes
// kernel (hat_common.cuh) on bf16 rows, the ring kernel on f32 rows
template <typename T, int kCoef, int kDisp>
cudaError_t run_linear(const T* x, const float* disp, const float* coefs, T* out, long long nrows, int R, int H, int S,
                       int OW, bool launch, cudaStream_t st, Geometry* g) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return hat_lanes_run<1, kCoef, kDisp>(x, nullptr, disp, coefs, out, nullptr, nrows, R, H, S, OW, launch, st, g);
  } else {
    return run<T, false, kCoef, kDisp>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
  }
}

// K2's instantiated forms of element type T (every one in f32 and bf16):
// cudaErrorInvalidValue for another one.
template <typename T>
cudaError_t hat_run(const T* x, const float* disp, const float* coefs, T* out, long long nrows, int R, int H, int S,
                    int OW, int nearest, int coef_mode, int disp_mode, bool launch, cudaStream_t st, Geometry* g) {
  if (coef_mode == kCoefPerSlice) {
    if (nearest || disp_mode != kDispNone) return cudaErrorInvalidValue;
    return run_linear<T, kCoefPerSlice, kDispNone>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
  }
  if (coef_mode != kCoefPerSample) return cudaErrorInvalidValue;
  if (disp_mode == kDispLaneAffine) {
    if (nearest) return cudaErrorInvalidValue;
    return run_linear<T, kCoefPerSample, kDispLaneAffine>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
  }
  if (disp_mode == kDispNone) {
    if (nearest) return run<T, true, kCoefPerSample, kDispNone>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
    return run_linear<T, kCoefPerSample, kDispNone>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
  }
  if (disp_mode == kDispVolume) {
    if (nearest) {
      return run<T, true, kCoefPerSample, kDispVolume>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
    }
    return run<T, false, kCoefPerSample, kDispVolume>(x, disp, coefs, out, nrows, R, H, S, OW, launch, st, g);
  }
  return cudaErrorInvalidValue;
}

constexpr int kVariantRows = 32;   // rows per block, the TPU variants' block
constexpr int kVariantChunk = 8;   // taps per chunk (TAP_CHUNK): a tap runs where its chunk starts below span
constexpr float kVariantBig = 1e9f;

// K7's block-wide values, at the head of its dynamic shared memory (a kernel
// with static shared memory could not opt into all of kSmemMax)
struct VariantHead {
  uint64_t bar;                    // completes on the rows' bulk copy
  int geo[2];                      // n0, span
  float red_min[32], red_max[32];  // the warps' partial reductions
  float row_base[kVariantRows], row_fi[kVariantRows], row_fj[kVariantRows];
};
constexpr int kVariantHeader = (sizeof(VariantHead) + 127) / 128 * 128;

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
__device__ __forceinline__ float variant_position(float base, float ck, float bias, const float* tab, int S,
                                                  int l, float row_i, float row_j) {
  const float pos = hat_position(base, ck, bias, l);
  return __fadd_rn(__fadd_rn(__fadd_rn(pos, __fmul_rn(tab[l], row_i)), __fmul_rn(tab[S + l], row_j)),
                   tab[2 * S + l]);
}

// f(i, rr, l) for the elements i = rr*S + l of the block's 32 rows that
// this thread takes, i a multiple of kRingThreads apart
template <typename F>
__device__ __forceinline__ void block_elements(int S, F&& f) {
  int rr = static_cast<int>(threadIdx.x) / S;
  int l = static_cast<int>(threadIdx.x) - rr * S;
  for (int i = threadIdx.x; i < kVariantRows * S; i += kRingThreads) {
    f(i, rr, l);
    for (l += kRingThreads; l >= S; l -= S) ++rr;
  }
}

// kKept: the block's rows and positions in shared memory (see the header)
template <int kVariant, bool kKept>
__global__ void __launch_bounds__(kRingThreads, 2) hat_variant_kernel(
    const float* __restrict__ x, const float* __restrict__ tab, const float* __restrict__ coefs,
    float* __restrict__ out, int H, int S) {
  constexpr bool kMin = kVariant == 0 || kVariant == 1 || kVariant == 3;
  constexpr bool kMax = kVariant <= 2;
  constexpr bool kPre = kMin || kMax;  // a pass over the positions before the samples
  constexpr int kMaxspan = kVariant == 4 ? 4 : 48;
  // the dynamic shared memory: the block's values in a kVariantHeader-byte
  // head, then (kKept) the block's rows and, with a pre-pass, their
  // positions, then the (3, S) table
  extern __shared__ __align__(128) unsigned char smem[];
  VariantHead& head = *reinterpret_cast<VariantHead*>(smem);
  uint64_t* bar = &head.bar;
  float* red_min = head.red_min;
  float* red_max = head.red_max;
  float* row_base = head.row_base;
  float* row_fi = head.row_fi;
  float* row_fj = head.row_fj;
  int* geo = head.geo;
  float* srows = reinterpret_cast<float*>(smem + kVariantHeader);
  float* spos = srows + kVariantRows * S;
  float* stab = srows + (kKept ? (kPre ? 2 : 1) * kVariantRows * S : 0);

  const int r0 = blockIdx.x * kVariantRows;
  const float* xr = x + static_cast<size_t>(r0) * S;  // the block's rows
  if constexpr (kKept) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(kVariantRows * S * sizeof(float));
      mbar_arrive_expect(bar, bytes);
      bulk_load(srows, xr, bytes, bar);
    }
  }
  for (int c = threadIdx.x; c < 3 * S; c += kRingThreads) stab[c] = __ldg(tab + c);
  const float ci = __ldg(coefs), cj = __ldg(coefs + 1), ck = __ldg(coefs + 2), bias = __ldg(coefs + 3);
  if (threadIdx.x < kVariantRows) {
    const int r = r0 + threadIdx.x;
    const int ri = r / H;
    row_fi[threadIdx.x] = static_cast<float>(ri);
    row_fj[threadIdx.x] = static_cast<float>(r - ri * H);
    row_base[threadIdx.x] = hat_row_base(ci, cj, row_fi[threadIdx.x], row_fj[threadIdx.x]);
  }
  __syncthreads();
  const float last = static_cast<float>(S - 1);
  const int pad = S > 128 ? S : 128;
  const auto position = [&](int rr, int l) {
    return variant_position(row_base[rr], ck, bias, stab, S, l, row_fi[rr], row_fj[rr]);
  };

  int n0 = -8, span = 8;
  if constexpr (kPre) {
    float mn = kVariantBig, mx = -kVariantBig;
    block_elements(S, [&](int i, int rr, int l) {
      const float pos = position(rr, l);
      if constexpr (kKept) spos[i] = pos;
      if (!(pos <= 0.0f) && !(pos >= last)) {
        const float rel = __fsub_rn(pos, static_cast<float>(l));
        if (kMin) mn = fminf(mn, rel);
        if (kMax) mx = fmaxf(mx, rel);
      }
    });
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int kWarps = kRingThreads / 32;
    if (kMin) mn = warp_min(mn);
    if (kMax) mx = warp_max(mx);
    if (lane == 0) {
      red_min[warp] = mn;
      red_max[warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
      mn = lane < kWarps ? red_min[lane] : kVariantBig;
      mx = lane < kWarps ? red_max[lane] : -kVariantBig;
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
  const int win = (kVariant == 0 || kVariant == 3) ? n0 : kVariant == 1 ? ((pad + n0) / 128) * 128 - pad : -64;

  if constexpr (kKept) mbar_wait(bar, 0);
  float* o = out + static_cast<size_t>(r0) * S;
  block_elements(S, [&](int i, int rr, int l) {
    const float pos = kKept && kPre ? spos[i] : position(rr, l);
    const float* row = (kKept ? srows : xr) + rr * S;
    float v;
    if (pos <= 0.0f) {
      v = row[0];
    } else if (pos >= last) {
      v = row[S - 1];
    } else {
      const float rel = __fsub_rn(pos, static_cast<float>(l));
      const float d0 =
          fminf(fmaxf(__fsub_rn(rel, static_cast<float>(n0)), 0.0f), static_cast<float>(kMaxspan - 1));
      const int m0 = static_cast<int>(d0);  // floor: d0 >= 0
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // the two taps whose weights may be nonzero
        const int m = m0 + k;
        if (m < kMaxspan && m / kVariantChunk * kVariantChunk < span) {
          const float wgt = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(d0, static_cast<float>(m)))));
          acc = __fadd_rn(acc, __fmul_rn(wgt, row[min(max(win + l + m, 0), S - 1)]));
        }
      }
      v = acc;
    }
    __stcs(o + i, v);
  });
}

// Bytes of shared memory in which a block keeps its 32 rows and positions
constexpr int variant_kept_bytes(int S) { return kVariantHeader + 4 * (2 * kVariantRows + 3) * S; }

template <int kVariant>
cudaError_t variant_run(const float* x, const float* tab, const float* coefs, float* out, int R, int H, int S,
                        cudaStream_t st) {
  const bool kept = variant_kept_bytes(S) <= kSmemMax;
  const int floats = (kept ? (kVariant == 4 ? 1 : 2) * kVariantRows : 0) * S + 3 * S;
  const int smem = kVariantHeader + 4 * floats;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (kept && !aligned16(x)) return cudaErrorMisalignedAddress;
  const void* fn = kept ? reinterpret_cast<const void*>(&hat_variant_kernel<kVariant, true>)
                        : reinterpret_cast<const void*>(&hat_variant_kernel<kVariant, false>);
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = card_blocks(fn, dev, smem, &blocks);  // lets the kernel opt into smem
  if (e != cudaSuccess) return e;
  const dim3 grid(R / kVariantRows);
  if (kept) {
    hat_variant_kernel<kVariant, true><<<grid, kRingThreads, smem, st>>>(x, tab, coefs, out, H, S);
  } else {
    hat_variant_kernel<kVariant, false><<<grid, kRingThreads, smem, st>>>(x, tab, coefs, out, H, S);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (B, R, S); out: (B, R, OW); coefs: (B, 4), or per slice (B, R/H, 4)
// when coef_mode is kCoefPerSlice; disp: (B, R, OW), (B, 3, OW) or null as
// disp_mode says (DispMode in hat_common.cuh); all f32, contiguous, on the
// current device, x on 16 bytes. nearest != 0 selects nearest sampling.
// Launches on `stream` without synchronising and returns cudaGetLastError(),
// or an error without launching: cudaErrorInvalidValue for a form that is
// not instantiated or an S whose two ring stages do not fit,
// cudaErrorMisalignedAddress for x off 16 bytes, or the failed attribute,
// occupancy or tile-counter call.
extern "C" int fsg_hat_pass_f32(const float* x, const float* disp, const float* coefs,
                                float* out, int B, int R, int H, int S, int OW, int nearest,
                                int coef_mode, int disp_mode, void* stream) {
  Geometry g;
  return static_cast<int>(hat_run(x, disp, coefs, out, static_cast<long long>(B) * R, R, H, S, OW, nearest,
                                  coef_mode, disp_mode, true, static_cast<cudaStream_t>(stream), &g));
}

// fsg_hat_pass_f32 with bf16 x and out (x on 16 bytes; coefs and disp f32),
// in the same forms.
extern "C" int fsg_hat_pass_bf16(const __nv_bfloat16* x, const float* disp, const float* coefs,
                                 __nv_bfloat16* out, int B, int R, int H, int S, int OW, int nearest, int coef_mode,
                                 int disp_mode, void* stream) {
  Geometry g;
  return static_cast<int>(hat_run(x, disp, coefs, out, static_cast<long long>(B) * R, R, H, S, OW, nearest, coef_mode,
                                  disp_mode, true, static_cast<cudaStream_t>(stream), &g));
}

// The launch fsg_hat_pass_f32 (io_bf16 0) or fsg_hat_pass_bf16 (io_bf16 1)
// makes on the current device for (B, R, S), OW lanes out, in the form
// (nearest, coef_mode, disp_mode): geometry = {tile rows, ring stages, grid
// blocks, dynamic shared-memory bytes}. Returns a cudaError code.
extern "C" int fsg_hat_geometry(int B, int R, int S, int OW, int nearest, int coef_mode, int disp_mode, int io_bf16,
                                int* geometry) {
  Geometry g{};
  const long long nrows = static_cast<long long>(B) * R;
  const cudaError_t e =
      io_bf16 ? hat_run<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nrows, R, 1, S, OW, nearest, coef_mode,
                                       disp_mode, false, nullptr, &g)
              : hat_run<float>(nullptr, nullptr, nullptr, nullptr, nrows, R, 1, S, OW, nearest, coef_mode, disp_mode,
                               false, nullptr, &g);
  write_geometry(g, geometry);
  return static_cast<int>(e);
}

// The longest row fsg_hat_variant_f32 takes: K7's block values and (3, S)
// table must fit the shared memory a block may opt into.
extern "C" int fsg_hat_variant_max_s() { return (kSmemMax - kVariantHeader) / static_cast<int>(3 * sizeof(float)); }

// K7: x, out: (R, S) rows of a (R / H, H, S) volume, R a multiple of 32;
// tab: (3, S); coefs: (4,); all f32, contiguous, on the current device, x on
// 16 bytes where S <= 864. variant in 0..4. One 512-thread block per 32
// rows. Launches on `stream` and returns cudaGetLastError(), or an error
// without launching: cudaErrorInvalidValue for another variant or an S
// over fsg_hat_variant_max_s(), cudaErrorMisalignedAddress for
// x off 16 bytes, or the failed attribute or occupancy call.
extern "C" int fsg_hat_variant_f32(const float* x, const float* tab, const float* coefs, float* out, int R, int H,
                                   int S, int variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return static_cast<int>(variant_run<0>(x, tab, coefs, out, R, H, S, st));
    case 1: return static_cast<int>(variant_run<1>(x, tab, coefs, out, R, H, S, st));
    case 2: return static_cast<int>(variant_run<2>(x, tab, coefs, out, R, H, S, st));
    case 3: return static_cast<int>(variant_run<3>(x, tab, coefs, out, R, H, S, st));
    case 4: return static_cast<int>(variant_run<4>(x, tab, coefs, out, R, H, S, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
