"""The row-affine pair pass (``csrc/row_affine.cu``): its binding, launch plan and counter.

The pass resamples the last axis of a (B, I, J, S) pair, the first operand
linearly and the second nearest, at ``pos = (slope*k + amount*(j - c_fix)) +
bias'``, edge-clamped, and writes the (i, j, k) output in the order
``out_order`` names. Its plain version is
:func:`fetalsyngen_torch.ops.warp._row_affine_matmul_pair` (a banded
operator and a batched matmul); :func:`fetalsyngen_torch.ops.warp.row_affine_pass_pair`
takes it for CPU tensors and :func:`row_affine_pair` for CUDA tensors.

The kernel reads its operands through their strides, so a permuted view
needs no copy, and writes a contiguous output: :func:`plan` picks the tile
axes, one along which the input is contiguous (read) and one along which the
output is (written).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of each form (one per call, whole batch): the f32 contract, the
# storage scope's bf16 chain, the precision scope's one bf16 pass
LAUNCHES = {"row_affine_pair_f32": 0, "row_affine_pair_bf16": 0, "row_affine_pair_default": 0}

# csrc/row_affine.cu's Form and Dtype
FORMS = {"f32": 0, "bf16": 1, "default": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OUT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "default": torch.float32}


@functools.cache
def _kernel():
    from .build import load_library

    fn = load_library("row_affine").fsg_row_affine_pair
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(shape, strides, out_order: str) -> dict:
    """The kernel's layout for a (B, I, J, S) input of element ``strides``
    writing a contiguous (B, *out_order) output: the tile slots (P, Q, T) as
    logical axes of the output, with their extents and input and output
    strides (k's input stride is 0: its index is the tap), the input's s and
    batch strides, the output's batch stride and shape, and the slots of j
    and k. P is the axis along which the input is contiguous (s counting as
    k), Q the output's contiguous one, or where that is P the output's next."""
    if sorted(out_order) != ["i", "j", "k"]:
        raise ValueError(f"out_order must be a permutation of 'ijk', got {out_order!r}")
    B, I, J, S = shape
    ext = {"i": I, "j": J, "k": S}
    out_shape = (B, *(ext[c] for c in out_order))
    ostride, acc = {}, 1
    for c in reversed(out_order):
        ostride[c] = acc
        acc *= ext[c]
    read = {"i": strides[1], "j": strides[2], "k": strides[3]}
    P = min("kji", key=lambda c: abs(read[c]) if ext[c] > 1 else float("inf"))
    Q = out_order[-1] if out_order[-1] != P else out_order[-2]
    T = next(c for c in "ijk" if c not in (P, Q))
    slots = (P, Q, T)
    istride = {"i": strides[1], "j": strides[2], "k": 0}
    return {
        "slots": slots,
        "n": [ext[c] for c in slots],
        "is": [istride[c] for c in slots],
        "os": [ostride[c] for c in slots],
        "in_s": strides[3],
        "in_b": strides[0],
        "out_b": acc,
        "out_shape": out_shape,
        "jslot": slots.index("j"),
        "kslot": slots.index("k"),
    }


def _operands(xa, xb):
    """The pair in the types the kernel takes: an f32 image and int32 labels
    (the pair warp's first pass), or two f32 or two bf16 operands (its later
    passes); others converted to f32 as the plain version converts them."""
    f32 = torch.float32
    if xb.dtype == torch.int32:
        return xa.to(f32), xb
    if xa.dtype == xb.dtype and xa.dtype in (f32, torch.bfloat16):
        return xa, xb
    return xa.to(f32), xb.to(f32)


def row_affine_pair(xa, xb, coefs, out_order: str, form: str):
    """Launch the pass on CUDA tensors: ``xa`` (linear) and ``xb`` (nearest)
    of one (B, I, J, S) shape, ``coefs`` (B, 3) f32 rows (slope, amount,
    bias'), ``form`` one of :data:`FORMS`; c_fix is (J - 1) / 2. The
    operands must be finite (a NaN may come out of the bf16 rounding as -0).
    Returns the two outputs, contiguous (B, *out_order) tensors of the
    form's type, on the current stream without synchronising."""
    if xa.device.type != "cuda" or xb.device != xa.device or coefs.device != xa.device:
        raise ValueError(f"row_affine_pair runs on one CUDA device, got {xa.device}, {xb.device}, {coefs.device}")
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    if xa.dim() != 4 or xb.shape != xa.shape:
        raise ValueError(f"operands must be equal (B, I, J, S), got {tuple(xa.shape)} and {tuple(xb.shape)}")
    B, I, J, S = xa.shape
    if S < 2:
        raise ValueError(f"rows of S={S} < 2 samples have no kernel")
    if coefs.shape != (B, 3) or coefs.dtype != torch.float32 or not coefs.is_contiguous():
        raise ValueError(f"coefs must be contiguous ({B}, 3) float32, got {tuple(coefs.shape)} {coefs.dtype}")
    xa, xb = _operands(xa, xb)
    if xb.stride() != xa.stride():
        xa, xb = xa.contiguous(), xb.contiguous()
    lay = plan(xa.shape, xa.stride(), out_order)
    out_dtype = _OUT_DTYPES[form]
    oa = torch.empty(lay["out_shape"], dtype=out_dtype, device=xa.device)
    ob = torch.empty_like(oa)
    if oa.numel() == 0:
        return oa, ob
    span = max(I * J * S, 1 + sum((n - 1) * abs(st) for n, st in zip(xa.shape[1:], xa.stride()[1:])))
    if span > 2**31 - 1 or lay["n"][2] > 65535 or B > 65535:
        raise ValueError(f"shape {tuple(xa.shape)} of strides {xa.stride()} exceeds the kernel's int offsets or grid")
    layout = (ctypes.c_longlong * 14)(*lay["n"], *lay["is"], *lay["os"], lay["in_s"], lay["in_b"], lay["out_b"],
                                      lay["jslot"], lay["kslot"])
    with torch.cuda.device(xa.device):
        rc = _kernel()(xa.data_ptr(), xb.data_ptr(), coefs.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                       _DTYPES[xa.dtype], _DTYPES[xb.dtype], FORMS[form], B, S, layout,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_affine_pair kernel launch failed: cudaError {rc}")
    LAUNCHES[f"row_affine_pair_{form}"] += 1
    return oa, ob
