// Row-affine pair pass: resampling of the last axis of a (B, I, J, S) pair,
// the first operand linearly and the second nearest, at positions shared by
// both that depend on the row j and the output lane k alone:
//   pos = (slope*k + amount*(j - c_fix)) + bias',  clamped to [0, S-1],
// with (slope, amount, bias') one f32 row per sample (bias' = bias +
// amount*c_fix, computed by the caller) and c_fix = (J - 1) / 2. The output
// (i, j, k) is written in any order of its axes, so the pass also performs
// the transpose its consumer needs. These are the five matmul passes of the
// separable field warp (fetalsyngen_torch/ops/warp.py::
// warp_affine_field_pair_pre: U-z, U-y, the two halves of U-x and the L-z
// peel).
//
// It replaces no Pallas kernel: the JAX package runs these passes as an
// einsum of the pair with a dense banded (B, J, S, S) operator for the TPU's
// matrix unit, and the plain PyTorch version
// (fetalsyngen_torch/ops/warp.py::_row_affine_matmul_pair) builds that
// operator and runs a bmm. Each operator row holds two nonzero entries
// (linear: max(0, 1 - |pos - s|) at s = floor(pos), floor(pos) + 1) or one
// (nearest: s = rint(pos), half to even), so this kernel reads those taps
// and computes the einsum's function, with the rounding of each form:
//   kFormF32      f32 weights and operands, an f32 result (the f32 contract);
//   kFormBF16     weights and operands rounded to bf16, the two products
//                 (exact in f32) summed in f32 and rounded to bf16 once (the
//                 storage scope's bf16 chain);
//   kFormDefault  as kFormBF16 with an f32 result (the precision scope's one
//                 bf16 pass).
// Positions follow the plain version's association with _rn intrinsics, so
// nvcc cannot contract them into FMAs: the nearest operand comes out bit
// for bit, the linear one within the rounding of the bmm's f32 sum. The
// operands may arrive as f32, bf16 or, the nearest one, int32 (the
// generator's labels), each converted on load as torch's .to() converts.
//
// Bound: device memory, one read and one write of each operand per output
// element (8 bytes for a bf16 pair; 12 from an f32 image and int32 labels to
// bf16), against the plain version's dense operators and layout copies.
//
// Design: a block takes a 64 x 64 tile of two output axes at one index of
// the third (two where that axis is i) and one sample. Slot P is the axis
// along which the input is contiguous (k where the rows run along s), slot
// Q the output's contiguous axis. Threads run along P to compute the
// samples, so a warp's taps are neighbouring addresses (through L1), and
// store them into shared memory; then threads run along Q to write the tile
// out, two bf16 outputs per 4-byte store (along P where the output is
// contiguous along P too). Rows of the shared tiles are padded so both
// phases are free of bank conflicts, and the read loop holds no branch, so
// the loads of its unrolled rows go out together.
//
// The instruction rate, more than bytes, bounds a bf16 pass done naively
// (some 60 instructions an element on an H100, half its byte bound), so
// the kernel spends few: a thread whose rows share their position (q is i,
// or j under a zero amount: the U passes) computes its taps once for all of
// them; where slot T is i, a block takes two of its indices with one set of
// taps; floor and rint come from adding 2^23 and bf16 rounding from integer
// operations (the card runs its float/int and bf16 conversions at an eighth
// of its f32 rate); bf16 operands travel as bits, the nearest one straight
// through; each tap is one 32-bit offset from a row pointer.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kReadRows = kThreads / kTile;

enum Dtype : int { kF32 = 0, kBF16 = 1, kI32 = 2 };
enum Form : int { kFormF32 = 0, kFormBF16 = 1, kFormDefault = 2 };

// The tile slots P, Q, T: extents, input strides (0 for k, whose input
// index is the tap s), output strides; the slots holding j and k. Offsets
// within a sample fit an int (the wrapper checks); batch strides need not.
struct Layout {
  int n[3];
  int is[3];
  int os[3];
  int in_s;
  long long in_b, out_b;
  int jslot, kslot;
};

// bf16 values travel as their bits (unsigned short): operands, outputs and
// the shared tiles
using bf16_bits = unsigned short;

__device__ __forceinline__ float widen(bf16_bits h) { return __uint_as_float(static_cast<unsigned>(h) << 16); }

// A finite f32 rounded to bf16, nearest even, as torch's .to(bfloat16)
// rounds it, by integer operations (with the conversion instruction the
// passes whose taps move with every row ran some 10% slower on an H100).
// The operands must be finite: a NaN whose top mantissa bits are set would
// carry into the sign bit and come out as -0, and the kernel reads two taps
// where the einsum's dense rows would spread a NaN or infinity over the
// whole row. A test that kept a NaN in the outputs' rounding made the L-z
// peel 44% slower on an H100 (1.01 -> 1.45 ms at B=16 256^3), so the
// generator's operands, which are finite, take none.
__device__ __forceinline__ bf16_bits bf16_rne(float v) {
  const unsigned u = __float_as_uint(v);
  return static_cast<bf16_bits>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float round_bf16(float v) { return widen(bf16_rne(v)); }

// A position's taps: the element offset of the first linear tap along s
// (the second is the next element), the nearest one's from it, and the
// linear weights
struct Taps {
  int o0, on;
  float w0, w1;
};

// An operand value as f32: an f32 as it is, bf16 bits widened, an int32
// rounded to nearest (torch's .to(float32))
__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(bf16_bits h) { return widen(h); }
__device__ __forceinline__ float value(int v) { return __int2float_rn(v); }

template <typename TO>
__device__ __forceinline__ TO narrow(float v) {
  if constexpr (std::is_same_v<TO, float>) {
    return v;
  } else {
    return bf16_rne(v);
  }
}

// 2^23: for 0 <= x < 2^23, x + 2^23 rounded down (to nearest even) holds
// floor(x) (rint(x)) in the low bits of its pattern, and x + 2^23 - 2^23 is
// that integer as a float: a floor and a half-to-even rint without the
// card's slow float/int conversions
constexpr float kTwo23 = 8388608.0f;
constexpr int kTwo23Bits = 0x4B000000;

// kT: the indices of slot T a block takes (2 where slot T is i, so the
// taps, which depend on j and k alone, serve both; bf16 outputs)
template <typename TA, typename TB, typename TO, bool kRound, int kT>
__global__ void __launch_bounds__(kThreads) row_affine_pair_kernel(const TA* __restrict__ xa,
                                                                   const TB* __restrict__ xb,
                                                                   const float* __restrict__ coefs,
                                                                   TO* __restrict__ oa, TO* __restrict__ ob, int S,
                                                                   Layout L, int tiles_p) {
  // bf16: 66 per row (33 words: a 2-byte store by row and a 4-byte read of
  // two columns both hit 32 banks); f32: 65
  constexpr int kVec = sizeof(TO) == 2 ? 2 : 1;
  constexpr int kRow = kTile + kVec;
  __shared__ __align__(16) TO sa[kT][kTile][kRow];
  __shared__ __align__(16) TO sb[kT][kTile][kRow];

  const int b = blockIdx.z;
  const int t = blockIdx.y * kT;
  const int nt = min(kT, L.n[2] - t);
  const int p0 = (blockIdx.x % tiles_p) * kTile;
  const int q0 = (blockIdx.x / tiles_p) * kTile;
  xa += b * L.in_b;
  xb += b * L.in_b;
  oa += b * L.out_b;
  ob += b * L.out_b;
  const float* c = coefs + 3 * b;
  const float slope = __ldg(c), amount = __ldg(c + 1), bias = __ldg(c + 2);
  const int J = L.jslot == 0 ? L.n[0] : (L.jslot == 1 ? L.n[1] : L.n[2]);
  const float c_fix = __fmul_rn(static_cast<float>(J - 1), 0.5f);  // exact
  const float last = static_cast<float>(S - 1);
  const float last_tap = static_cast<float>(S - 2);
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int p = p0 + tx;
  const int nq = min(kTile, L.n[1] - q0);

  if (p < L.n[0]) {
    // pos = (slope*k + amount*(j - c_fix)) + bias: the products of the
    // coordinates in slots P and T once, the slot Q's per row q (its float
    // advances exactly by kReadRows)
    const float pf = static_cast<float>(p), tf = static_cast<float>(t);
    const float tk0 = __fmul_rn(slope, L.kslot == 0 ? pf : tf);
    const float tj0 = __fmul_rn(amount, __fsub_rn(L.jslot == 0 ? pf : tf, c_fix));
    auto taps = [&](float qf) {
      const float tk = L.kslot == 1 ? __fmul_rn(slope, qf) : tk0;
      const float tj = L.jslot == 1 ? __fmul_rn(amount, __fsub_rn(qf, c_fix)) : tj0;
      const float pos = fminf(fmaxf(__fadd_rn(__fadd_rn(tk, tj), bias), 0.0f), last);  // a NaN reads s = 0
      // the taps s0 = min(floor(pos), S - 2) and s0 + 1 (at pos = S - 1 the
      // weights are then 0 and 1, as the operator has them), the nearest
      // rint(pos), one of the two
      const float fl = __fadd_rd(pos, kTwo23);
      const float f = fminf(__fsub_rn(fl, kTwo23), last_tap);
      const int s0 = min(__float_as_int(fl) - kTwo23Bits, S - 2);
      Taps r;
      r.o0 = s0 * L.in_s;
      r.on = (__float_as_int(__fadd_rn(pos, kTwo23)) - kTwo23Bits - s0) * L.in_s;
      // max(0, 1 - |pos - s|) at s = f and f + 1 with its clamp and |.| left
      // out, equal bit for bit: pos - f in [0, 1] is exact, and |RN(pos -
      // (f + 1))| = RN((f + 1) - pos) <= 1
      r.w0 = __fsub_rn(1.0f, __fsub_rn(pos, f));
      r.w1 = __fsub_rn(1.0f, __fsub_rn(__fadd_rn(f, 1.0f), pos));
      if constexpr (kRound) {
        r.w0 = round_bf16(r.w0);
        r.w1 = round_bf16(r.w1);
      }
      return r;
    };
    // The rows of a thread: where the position moves with q, each computes
    // its taps; where it does not (q is i, or j under a zero amount: the
    // U passes), they share the first row's
    auto rows = [&](auto moves) {
      float qf = static_cast<float>(q0 + ty);
      Taps tp;
      if constexpr (!decltype(moves)::value) tp = taps(qf);
      // the row's start in each operand, advanced between rows: each tap is
      // then one 32-bit offset from a pointer
      const int row0 = p * L.is[0] + t * L.is[2] + (q0 + ty) * L.is[1];
      const TA* ra = xa + row0;
      const TB* rb_row = xb + row0;
      const int step = kReadRows * L.is[1];
      // slot T's second index, or the first again past the last (read, not written)
      const int t_step = nt > 1 ? L.is[2] : 0;
#pragma unroll 4
      for (int qq = ty; qq < nq; qq += kReadRows) {
        if constexpr (decltype(moves)::value) tp = taps(qf);
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          const TA* pa = ra + (tt * t_step + tp.o0);
          float a0 = value(__ldg(pa));
          float a1 = value(__ldg(pa + L.in_s));
          const TB rb = __ldg(rb_row + (tt * t_step + tp.o0 + tp.on));
          float bn = value(rb);
          if constexpr (kRound && !std::is_same_v<TA, bf16_bits>) {
            a0 = round_bf16(a0);
            a1 = round_bf16(a1);
          }
          if constexpr (kRound && !std::is_same_v<TB, bf16_bits>) bn = round_bf16(bn);
          // the sum of the two products, rounded once: bf16 operands'
          // products are exact in f32, so one FMA rounds the same sum
          const float sum = kRound ? __fmaf_rn(tp.w1, a1, __fmul_rn(tp.w0, a0))
                                   : __fadd_rn(__fmul_rn(tp.w0, a0), __fmul_rn(tp.w1, a1));
          sa[tt][tx][qq] = narrow<TO>(sum);
          if constexpr (std::is_same_v<TO, bf16_bits> && std::is_same_v<TB, bf16_bits>) {
            sb[tt][tx][qq] = rb;  // the nearest sample's own bits
          } else {
            sb[tt][tx][qq] = narrow<TO>(bn);
          }
        }
        ra += step;
        rb_row += step;
        qf = __fadd_rn(qf, static_cast<float>(kReadRows));
      }
    };
    if (L.kslot == 1 || (L.jslot == 1 && amount != 0.0f)) {
      rows(std::true_type{});
    } else {
      rows(std::false_type{});
    }
  }
  __syncthreads();

  if (L.os[0] == 1) {  // the output runs along P: each thread writes what it computed
    if (p >= L.n[0]) return;
    for (int tt = 0; tt < nt; ++tt) {
      const int out_pt = p + (t + tt) * L.os[2];
      for (int qq = ty; qq < nq; qq += kReadRows) {
        oa[out_pt + (q0 + qq) * L.os[1]] = sa[tt][tx][qq];
        ob[out_pt + (q0 + qq) * L.os[1]] = sb[tt][tx][qq];
      }
    }
    return;
  }
  // the output runs along Q (os[1] == 1): kVec columns a thread
  constexpr int kWriters = kTile / kVec;
  constexpr int kWriteRows = kThreads / kWriters;
  const int col = (threadIdx.x % kWriters) * kVec;
  const int q = q0 + col;
  if (q >= L.n[1]) return;
  const int np = min(kTile, L.n[0] - p0);
  // with an even Q extent every output offset of an even q is even
  const bool pairs = kVec == 2 && L.n[1] % 2 == 0;
  for (int tt = 0; tt < nt; ++tt) {
    for (int pp = threadIdx.x / kWriters; pp < np; pp += kWriteRows) {
      const int o = (p0 + pp) * L.os[0] + (t + tt) * L.os[2] + q;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(oa + o) = *reinterpret_cast<const uint32_t*>(&sa[tt][pp][col]);
        *reinterpret_cast<uint32_t*>(ob + o) = *reinterpret_cast<const uint32_t*>(&sb[tt][pp][col]);
      } else {
        for (int v = 0; v < kVec && q + v < L.n[1]; ++v) {
          oa[o + v] = sa[tt][pp][col + v];
          ob[o + v] = sb[tt][pp][col + v];
        }
      }
    }
  }
}

template <typename TA, typename TB, typename TO, bool kRound>
cudaError_t launch(const void* xa, const void* xb, const float* coefs, void* oa, void* ob, int B, int S,
                   const Layout& L, cudaStream_t st) {
  const int tiles_p = (L.n[0] + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(tiles_p) * ((L.n[1] + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL || L.n[2] > 65535 || B > 65535) return cudaErrorInvalidValue;
  auto go = [&](auto kt) {
    constexpr int k = decltype(kt)::value;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((L.n[2] + k - 1) / k),
                    static_cast<unsigned>(B));
    row_affine_pair_kernel<TA, TB, TO, kRound, k><<<grid, kThreads, 0, st>>>(
        static_cast<const TA*>(xa), static_cast<const TB*>(xb), coefs, static_cast<TO*>(oa), static_cast<TO*>(ob), S,
        L, tiles_p);
  };
  // two indices of slot T a block where it is i (the taps are then shared;
  // bf16 outputs, whose two tiles fit the static shared memory)
  if constexpr (sizeof(TO) == 2) {
    if (L.jslot != 2 && L.kslot != 2) {
      go(std::integral_constant<int, 2>{});
      return cudaGetLastError();
    }
  }
  go(std::integral_constant<int, 1>{});
  return cudaGetLastError();
}

// The form's output type and rounding on the operand types: (f32, f32),
// (f32, int32) or (bf16, bf16)
template <typename TO, bool kRound>
cudaError_t run_form(const void* xa, const void* xb, int dtype_a, int dtype_b, const float* coefs, void* oa, void* ob,
                     int B, int S, const Layout& L, cudaStream_t st) {
  if (dtype_a == kF32 && dtype_b == kF32) return launch<float, float, TO, kRound>(xa, xb, coefs, oa, ob, B, S, L, st);
  if (dtype_a == kF32 && dtype_b == kI32) return launch<float, int, TO, kRound>(xa, xb, coefs, oa, ob, B, S, L, st);
  if (dtype_a == kBF16 && dtype_b == kBF16) {
    return launch<bf16_bits, bf16_bits, TO, kRound>(xa, xb, coefs, oa, ob, B, S, L, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// xa (linear) and xb (nearest): (B, I, J, S) operands of dtype_a and
// dtype_b (Dtype: f32 and f32 or int32, or bf16 and bf16), addressed by the
// layout;
// coefs: (B, 3) f32 rows (slope, amount, bias'); oa, ob: the outputs,
// f32 (kFormF32, kFormDefault) or bf16 (kFormBF16). layout: 14 int64 values,
// the tile slots P, Q, T's extents, input strides and output strides, then
// the input's s stride, its batch stride, the output's batch stride, and
// the slots of j and k (Layout). Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue without launching for a form or operand types
// that are not instantiated, or a grid the card does not take.
extern "C" int fsg_row_affine_pair(const void* xa, const void* xb, const float* coefs, void* oa, void* ob,
                                   int dtype_a, int dtype_b, int form, int B, int S, const long long* layout,
                                   void* stream) {
  Layout L;
  for (int d = 0; d < 3; ++d) {
    L.n[d] = static_cast<int>(layout[d]);
    L.is[d] = static_cast<int>(layout[3 + d]);
    L.os[d] = static_cast<int>(layout[6 + d]);
  }
  L.in_s = static_cast<int>(layout[9]);
  L.in_b = layout[10];
  L.out_b = layout[11];
  L.jslot = static_cast<int>(layout[12]);
  L.kslot = static_cast<int>(layout[13]);
  if (L.os[0] != 1 && L.os[1] != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (form == kFormF32) e = run_form<float, false>(xa, xb, dtype_a, dtype_b, coefs, oa, ob, B, S, L, st);
  if (form == kFormBF16) e = run_form<bf16_bits, true>(xa, xb, dtype_a, dtype_b, coefs, oa, ob, B, S, L, st);
  if (form == kFormDefault) e = run_form<float, true>(xa, xb, dtype_a, dtype_b, coefs, oa, ob, B, S, L, st);
  return static_cast<int>(e);
}
