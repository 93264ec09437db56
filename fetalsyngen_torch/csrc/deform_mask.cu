// The composite OOB mask and margin shift of the small-field pair warp
// (fetalsyngen_torch/generator/pipeline.py::_deform_pair_small_fields),
// computed straight from the small A-mixed field h_s = A F_small.
//
// The plain version zooms h_s to three full-resolution fields H_r and forms,
// per voxel (i, j, k) and axis r,
//   v_r = (((A_r0*x_i + A_r1*y_j) + A_r2*z_k) + c2_r) + H_r(i, j, k),
//   c_r = clamp(v_r, 0, S_r - 1),
// with x, y, z the centred grid; the shift is floor(min over voxels of c_r)
// (margin shift) and the mask ok = AND_r (c_r - shift_r > 0 and
// c_r - shift_r <= S_r - 1), applied to the warped image as where(ok, a, 0).
// Those are some 45 full-volume passes and three (B, D, H, W) zooms.
// H_r is a trilinear upsampling of a field of at most a few thousand
// samples, so these kernels form it on the fly and store nothing of it:
//   mask_shift  each block's min of v_r over its voxels, then one block per
//               sample reduces those and writes floor(clamp(min)) (B, 3);
//   mask_apply  recomputes c_r per voxel and writes ok ? a : 0, reading the
//               warped image through its strides (the pair warp leaves it
//               (B, H, W, D) in memory) and writing it contiguous in
//               (B, D, H, W) through a shared-memory tile.
//
// Same function as the plain version. The zoom (ops/linops.py::zoom_mm)
// contracts axis 0, then 1, then 2 with interp_matrix's operators, whose
// rows hold (1 - w) at f and w at f + 1, in an f32 GEMM that sums a row's
// products in order with fused multiply-adds: each axis is
// fma(w, x[f + 1], (1 - w) * x[f]) rounded once, which the kernels compute
// in that form. Positions follow zoom_coords and interp_matrix, and v_r the
// torch code's association, with _rn intrinsics so nvcc contracts nothing.
// Clamps and the min propagate a NaN as torch's do (min.NaN / max.NaN).
//
// Design: a block takes one sample b, one row j and 64 indices i; it forms
// into shared memory, once, the field's two-axis partial sums t1[r][i][z]
// (axes 0 and 1 interpolated) for its i and a table of every k's axis-2
// taps and A_r2*z_k; then a warp walks k, a lane two k held in registers
// across its rows, and each voxel takes two taps of t1 an axis.
// mask_apply stages each 64 x 64 tile of the image through shared memory
// (rows padded against bank conflicts), read along i, the pair warp's
// contiguous axis (other strides are read correctly, uncoalesced), and
// written along k, two outputs a store.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTI = 64;        // i indices a block takes
constexpr int kTK = 64;        // k lanes a tile takes
constexpr int kThreads = 256;  // 8 warps: warp w takes i = w, w + 8, ...; a lane two k
constexpr int kWarps = kThreads / 32;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

using bf16_bits = unsigned short;

// The problem: the output's extents, the small field's buffer extents
// (h_s is (B, 3, fd, fh, fw) contiguous), the c2 batch stride
struct Geo {
  int D, H, W;
  int fd, fh, fw;
  int c2_b;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// torch.clamp(v, lo, hi): max then min, a NaN kept
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) { return min_nan(max_nan(v, lo), hi); }

// One output index's two taps along an axis: zoom_coords(S, S / n) at idx,
// then interp_matrix with in_valid n: c = clamp(coord, 0, n - 1),
// f = clamp(floor(c), 0, n - 2), weights (1 - w) at f and w = c - f at
// f + 1. The indices are clamped into the buffer [0, nbuf): below n = 2 the
// operator's row holds one entry (weight 1 at 0; the lower tap, of weight
// 0, then reads entry 0 too and adds 0).
struct Tap {
  int z0, z1;
  float w0, w1;
};

__device__ __forceinline__ Tap zoom_tap(int idx, int S, int n, int nbuf) {
  const float factor = __fdiv_rn(static_cast<float>(S), static_cast<float>(n));
  const float delta = __fdiv_rn(__fsub_rn(1.0f, factor), __fmul_rn(2.0f, factor));
  const float coord = __fadd_rn(delta, __fdiv_rn(static_cast<float>(idx), factor));
  const float hi = static_cast<float>(n - 1);
  const float c = clamp_nan(coord, 0.0f, hi);
  const float f = clamp_nan(floorf(c), 0.0f, __fsub_rn(hi, 1.0f));
  const float w = __fsub_rn(c, f);
  const int fi = f == f ? static_cast<int>(f) : 0;
  Tap t;
  t.z0 = min(max(fi, 0), nbuf - 1);
  t.z1 = min(max(fi + 1, 0), nbuf - 1);
  t.w0 = __fsub_rn(1.0f, w);
  t.w1 = w;
  return t;
}

// one axis of the zoom: the row's two products summed in order, rounded once
__device__ __forceinline__ float two_tap(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w1, x1, __fmul_rn(w0, x0));
}

// The centred grid coordinate i - (n - 1) / 2 (exact)
__device__ __forceinline__ float centred(int i, int n) {
  return __fsub_rn(static_cast<float>(i), __fmul_rn(static_cast<float>(n - 1), 0.5f));
}

// What a block shares: its sample's affine, c2, S_r - 1 and size_F_small
struct Block {
  float A[3][3];
  float c2[3];
  float last[3];
  int n[3];
};

// The axis-2 taps and A_r2*z_k of every k, in the dynamic shared memory
// after t1: seven arrays of W words
struct KTable {
  int* z0;
  int* z1;
  float* w0;
  float* w1;
  float* q[3];
};

__device__ __forceinline__ KTable ktable_at(float* base, int W) {
  KTable t;
  t.z0 = reinterpret_cast<int*>(base);
  t.z1 = reinterpret_cast<int*>(base + W);
  t.w0 = base + 2 * W;
  t.w1 = base + 3 * W;
#pragma unroll
  for (int r = 0; r < 3; ++r) t.q[r] = base + (4 + r) * W;
  return t;
}

// One k's entry, held in registers across a thread's rows
struct KLane {
  int z0, z1;
  float w0, w1, q[3];
};

__device__ __forceinline__ KLane k_lane(const KTable& kt, int k) {
  KLane l;
  l.z0 = kt.z0[k];
  l.z1 = kt.z1[k];
  l.w0 = kt.w0[k];
  l.w1 = kt.w1[k];
#pragma unroll
  for (int r = 0; r < 3; ++r) l.q[r] = kt.q[r][k];
  return l;
}

// The block's constants; p[r][ii] = A_r0*x_i + A_r1*y_j; the k table; and
// the two axes' partial sums t1[r][ii][z] (axis 0 at i, then axis 1 at j,
// of h_s[r]) at the start of the dynamic shared memory. The last barrier
// is the caller's.
__device__ void block_setup(const float* __restrict__ h, const int* __restrict__ size, const float* __restrict__ A,
                            const float* __restrict__ c2, const Geo& g, int b, int j, int i0, Block& blk,
                            float (*p)[kTI], Tap* xt, float* t1, const KTable& kt) {
  const int tid = threadIdx.x;
  if (tid < 9) blk.A[tid / 3][tid % 3] = __ldg(A + 9 * b + tid);
  if (tid < 3) {
    blk.c2[tid] = __ldg(c2 + static_cast<long long>(b) * g.c2_b + tid);
    blk.n[tid] = __ldg(size + 3 * b + tid);
    blk.last[tid] = static_cast<float>((tid == 0 ? g.D : (tid == 1 ? g.H : g.W)) - 1);
  }
  __syncthreads();
  if (tid < kTI && i0 + tid < g.D) {
    const float xi = centred(i0 + tid, g.D), yj = centred(j, g.H);
#pragma unroll
    for (int r = 0; r < 3; ++r) p[r][tid] = __fadd_rn(__fmul_rn(blk.A[r][0], xi), __fmul_rn(blk.A[r][1], yj));
    xt[tid] = zoom_tap(i0 + tid, g.D, blk.n[0], g.fd);
  }
  for (int k = tid; k < g.W; k += kThreads) {
    const Tap tz = zoom_tap(k, g.W, blk.n[2], g.fw);
    kt.z0[k] = tz.z0;
    kt.z1[k] = tz.z1;
    kt.w0[k] = tz.w0;
    kt.w1[k] = tz.w1;
    const float zk = centred(k, g.W);
#pragma unroll
    for (int r = 0; r < 3; ++r) kt.q[r][k] = __fmul_rn(blk.A[r][2], zk);
  }
  __syncthreads();
  // element e = ii * fw + z of each r's plane; (ii, z) advanced without a
  // division
  const Tap ty = zoom_tap(j, g.H, blk.n[1], g.fh);
  const int fw = g.fw;
  const long long plane = static_cast<long long>(g.fd) * g.fh * fw;
  const float* hb = h + static_cast<long long>(b) * 3 * plane;
  const int ni = min(kTI, g.D - i0);
  const int dii = kThreads / fw, dz = kThreads % fw;
  int ii = tid / fw, z = tid % fw;
  for (int e = tid; e < kTI * fw; e += kThreads) {
    if (ii < ni) {
      const Tap tx = xt[ii];
      const int o00 = (tx.z0 * g.fh + ty.z0) * fw + z, o10 = (tx.z1 * g.fh + ty.z0) * fw + z;
      const int o01 = (tx.z0 * g.fh + ty.z1) * fw + z, o11 = (tx.z1 * g.fh + ty.z1) * fw + z;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* hr = hb + r * plane;
        const float t0a = two_tap(tx.w0, __ldg(hr + o00), tx.w1, __ldg(hr + o10));
        const float t0b = two_tap(tx.w0, __ldg(hr + o01), tx.w1, __ldg(hr + o11));
        t1[r * kTI * fw + e] = two_tap(ty.w0, t0a, ty.w1, t0b);
      }
    }
    z += dz;
    ii += dii;
    if (z >= fw) {
      z -= fw;
      ++ii;
    }
  }
}

// v_r = (((p + q) + c2) + H), H from the row's two taps of t1
__device__ __forceinline__ float coord(const float* row, float pr, float c2r, const KLane& l, int r) {
  const float hv = two_tap(l.w0, row[l.z0], l.w1, row[l.z1]);
  return __fadd_rn(__fadd_rn(__fadd_rn(pr, l.q[r]), c2r), hv);
}

__global__ void __launch_bounds__(kThreads) mask_shift_kernel(const float* __restrict__ h, const int* __restrict__ size,
                                                              const float* __restrict__ A,
                                                              const float* __restrict__ c2, Geo g,
                                                              float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ Block blk;
  __shared__ float p[3][kTI];
  __shared__ Tap xt[kTI];
  __shared__ float red[3][kWarps];
  const int tiles_i = (g.D + kTI - 1) / kTI;
  const int b = blockIdx.y;
  const int j = blockIdx.x / tiles_i;
  const int i0 = (blockIdx.x % tiles_i) * kTI;
  float* t1 = smem;
  const KTable kt = ktable_at(smem + 3 * kTI * g.fw, g.W);
  block_setup(h, size, A, c2, g, b, j, i0, blk, p, xt, t1, kt);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ni = min(kTI, g.D - i0);
  const int fw = g.fw;
  const float c2r[3] = {blk.c2[0], blk.c2[1], blk.c2[2]};
  float m[3] = {INFINITY, INFINITY, INFINITY};
  // a lane's two k a tile of kTK (the second the first again past W: its
  // value is then the first's, which the min holds already)
  for (int k = 2 * lane; k < g.W; k += kTK) {
    const KLane l0 = k_lane(kt, k), l1 = k_lane(kt, min(k + 1, g.W - 1));
#pragma unroll 2
    for (int ii = warp; ii < ni; ii += kWarps) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* row = t1 + (r * kTI + ii) * fw;
        const float pr = p[r][ii];
        m[r] = min_nan(m[r], min_nan(coord(row, pr, c2r[r], l0, r), coord(row, pr, c2r[r], l1, r)));
      }
    }
  }
  // the block's min: the warp's, then across warps
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    for (int off = 16; off > 0; off /= 2) m[r] = min_nan(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
    if (lane == 0) red[r][warp] = m[r];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int r = threadIdx.x;
    float v = red[r][0];
    for (int w = 1; w < kWarps; ++w) v = min_nan(v, red[r][w]);
    partial[(static_cast<long long>(b) * gridDim.x + blockIdx.x) * 3 + r] = v;
  }
}

// One block a sample: the min of its blocks' partial mins, clamped to
// [0, S_r - 1] (equal to the min of the clamped values), floored
__global__ void __launch_bounds__(kThreads) mask_shift_finish(const float* __restrict__ partial, int nblocks, Geo g,
                                                              float* __restrict__ shift) {
  __shared__ float red[3][kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[3] = {INFINITY, INFINITY, INFINITY};
  const float* pb = partial + static_cast<long long>(b) * nblocks * 3;
  for (int e = threadIdx.x; e < nblocks; e += kThreads) {
#pragma unroll
    for (int r = 0; r < 3; ++r) m[r] = min_nan(m[r], pb[3 * e + r]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    for (int off = 16; off > 0; off /= 2) m[r] = min_nan(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
    if (lane == 0) red[r][warp] = m[r];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int r = threadIdx.x;
    float v = red[r][0];
    for (int w = 1; w < kWarps; ++w) v = min_nan(v, red[r][w]);
    const float last = static_cast<float>((r == 0 ? g.D : (r == 1 ? g.H : g.W)) - 1);
    shift[3 * b + r] = floorf(clamp_nan(v, 0.0f, last));
  }
}

// T: float or bf16 bits; the image's element strides (b, i, j, k)
template <typename T>
__global__ void __launch_bounds__(kThreads) mask_apply_kernel(const T* __restrict__ a, long long sb, int si, int sj,
                                                              int sk, const float* __restrict__ h,
                                                              const int* __restrict__ size,
                                                              const float* __restrict__ A,
                                                              const float* __restrict__ c2,
                                                              const float* __restrict__ shift, Geo g,
                                                              T* __restrict__ out) {
  // rows of 66 bf16 (33 words) or 65 f32: the column writes of the read
  // phase and the row reads of the write phase both hit 32 banks
  constexpr int kPitch = sizeof(T) == 2 ? kTK + 2 : kTK + 1;
  extern __shared__ float smem[];
  __shared__ Block blk;
  __shared__ float p[3][kTI];
  __shared__ Tap xt[kTI];
  __shared__ __align__(16) T tile[kTI][kPitch];
  const int tiles_i = (g.D + kTI - 1) / kTI;
  const int b = blockIdx.y;
  const int j = blockIdx.x / tiles_i;
  const int i0 = (blockIdx.x % tiles_i) * kTI;
  const float sh[3] = {__ldg(shift + 3 * b), __ldg(shift + 3 * b + 1), __ldg(shift + 3 * b + 2)};
  float* t1 = smem;
  const KTable kt = ktable_at(smem + 3 * kTI * g.fw, g.W);
  block_setup(h, size, A, c2, g, b, j, i0, blk, p, xt, t1, kt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ni = min(kTI, g.D - i0);
  const int fw = g.fw;
  const T* ab = a + b * sb + static_cast<long long>(i0) * si + static_cast<long long>(j) * sj;
  T* ob = out + ((static_cast<long long>(b) * g.D + i0) * g.H + j) * g.W;
  const long long o_i = static_cast<long long>(g.H) * g.W;
  const bool pairs = g.W % 2 == 0;
  for (int k0 = 0; k0 < g.W; k0 += kTK) {
    __syncthreads();  // the setup done; the previous tile written out
    const int nk = min(kTK, g.W - k0);
    const int ii_read = threadIdx.x % kTI;  // consecutive threads along i
    if (ii_read < ni) {
      const T* src = ab + static_cast<long long>(ii_read) * si + static_cast<long long>(k0) * sk;
#pragma unroll 4
      for (int c = threadIdx.x / kTI; c < nk; c += kThreads / kTI) {
        tile[ii_read][c] = src[static_cast<long long>(c) * sk];
      }
    }
    __syncthreads();
    const int kk = 2 * lane;
    if (kk >= nk) continue;
    const bool two = kk + 1 < nk;
    const KLane l0 = k_lane(kt, k0 + kk), l1 = k_lane(kt, k0 + (two ? kk + 1 : kk));
#pragma unroll 2
    for (int ii = warp; ii < ni; ii += kWarps) {
      bool ok0 = true, ok1 = two;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* row = t1 + (r * kTI + ii) * fw;
        const float pr = p[r][ii], c2r = blk.c2[r], last = blk.last[r];
        const float c0 = __fsub_rn(clamp_nan(coord(row, pr, c2r, l0, r), 0.0f, last), sh[r]);
        const float c1 = __fsub_rn(clamp_nan(coord(row, pr, c2r, l1, r), 0.0f, last), sh[r]);
        ok0 = ok0 & (c0 > 0.0f) & (c0 <= last);
        ok1 = ok1 & (c1 > 0.0f) & (c1 <= last);
      }
      const T v0 = ok0 ? tile[ii][kk] : T(0);
      const T v1 = ok1 ? tile[ii][kk + 1] : T(0);
      T* o = ob + ii * o_i + k0 + kk;
      if (pairs && two) {
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint32_t*>(o) = static_cast<uint32_t>(v0) | (static_cast<uint32_t>(v1) << 16);
        } else {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        }
      } else {
        o[0] = v0;
        if (two) o[1] = v1;
      }
    }
  }
}

// The dynamic shared memory: t1 (3 * kTI * fw floats), then the k table
// (7 * W words)
size_t smem_bytes(const Geo& g) { return sizeof(float) * (3 * kTI * g.fw + 7 * g.W); }

bool bad_geo(const Geo& g, int B) {
  const long long blocks = static_cast<long long>((g.D + kTI - 1) / kTI) * g.H;
  return B < 1 || B > 65535 || g.D < 1 || g.H < 1 || g.W < 1 || g.fd < 1 || g.fh < 1 || g.fw < 1 ||
         blocks > 0x7fffffffLL || smem_bytes(g) > 160 * 1024;
}

// Above 16 KB of dynamic shared memory the static part may take the block
// past 48 KB: let the launch ask for what it needs
template <typename K>
cudaError_t allow_smem(K kernel, size_t dynamic) {
  if (dynamic <= 16 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dynamic));
}

Geo make_geo(const int* dims, int c2_b) {
  Geo g;
  g.D = dims[0];
  g.H = dims[1];
  g.W = dims[2];
  g.fd = dims[3];
  g.fh = dims[4];
  g.fw = dims[5];
  g.c2_b = c2_b;
  return g;
}

}  // namespace

// dims: D, H, W (the output), fd, fh, fw (h_s's buffer). h: (B, 3, fd, fh,
// fw) f32 contiguous; size: (B, 3) int32 size_F_small; A: (B, 3, 3) f32
// contiguous; c2: (B, 3) f32 rows c2_b apart; partial: (B, ceil(D/64) * H,
// 3) f32 scratch; shift: (B, 3) f32 out. Two launches on `stream` without
// synchronising; returns cudaGetLastError() (0 = launched) or
// cudaErrorInvalidValue without launching for a geometry it does not take.
extern "C" int fsg_mask_shift(const float* h, const int* size, const float* A, const float* c2, int c2_b,
                              float* partial, float* shift, int B, const int* dims, void* stream) {
  const Geo g = make_geo(dims, c2_b);
  if (bad_geo(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(g);
  cudaError_t e = allow_smem(mask_shift_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblocks = ((g.D + kTI - 1) / kTI) * g.H;
  mask_shift_kernel<<<dim3(nblocks, B), kThreads, smem, st>>>(h, size, A, c2, g, partial);
  mask_shift_finish<<<B, kThreads, 0, st>>>(partial, nblocks, g, shift);
  return static_cast<int>(cudaGetLastError());
}

// a: the warped image (B, D, H, W) of dtype (Dtype) at element strides
// (b, i, j, k); out: (B, D, H, W) contiguous of the same type; shift: (B,
// 3) f32; the rest as fsg_mask_shift. One launch.
extern "C" int fsg_mask_apply(const void* a, int dtype, const long long* strides, const float* h, const int* size,
                              const float* A, const float* c2, int c2_b, const float* shift, void* out, int B,
                              const int* dims, void* stream) {
  const Geo g = make_geo(dims, c2_b);
  if (bad_geo(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(g);
  const dim3 grid(((g.D + kTI - 1) / kTI) * g.H, B);
  const int si = static_cast<int>(strides[1]), sj = static_cast<int>(strides[2]), sk = static_cast<int>(strides[3]);
  cudaError_t e;
  if (dtype == kF32) {
    e = allow_smem(mask_apply_kernel<float>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    mask_apply_kernel<float><<<grid, kThreads, smem, st>>>(static_cast<const float*>(a), strides[0], si, sj, sk, h,
                                                           size, A, c2, shift, g, static_cast<float*>(out));
  } else if (dtype == kBF16) {
    e = allow_smem(mask_apply_kernel<bf16_bits>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    mask_apply_kernel<bf16_bits><<<grid, kThreads, smem, st>>>(static_cast<const bf16_bits*>(a), strides[0], si, sj,
                                                               sk, h, size, A, c2, shift, g,
                                                               static_cast<bf16_bits*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
