"""The small-field pair warp's OOB mask and margin shift (``csrc/deform_mask.cu``):
its binding and counter.

Both kernels form the A-mixed field's zoom ``H = zoom(A F_small)`` on the fly
from the small field ``h_s`` and store nothing of it: :func:`mask_shift`
gives ``floor(min(clamp(coord)))`` per sample and axis, :func:`mask_apply`
the warped image zeroed outside the composite mask, contiguous. Their plain
version is :func:`fetalsyngen_torch.generator.pipeline.pair_mask_plain` (three
full-resolution zooms and the elementwise composition), which
``_deform_pair_small_fields`` takes for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches (one per call, whole batch): mask_shift's min (two kernels, the
# blocks' mins and their reduction) and mask_apply
LAUNCHES = {"mask_shift": 0, "mask_apply": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TI = 64  # csrc/deform_mask.cu's kTI: the i indices a block takes


@functools.cache
def _kernels():
    from .build import load_library

    lib = load_library("deform_mask")
    shift = lib.fsg_mask_shift
    shift.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2
    shift.restype = ctypes.c_int
    apply = lib.fsg_mask_apply
    apply.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    apply.restype = ctypes.c_int
    return shift, apply


def _field_args(h_s, size, A, c2, shape, B):
    """Check the field's operands and return them with the dims array and
    c2's batch stride."""
    dev = h_s.device
    if dev.type != "cuda" or any(t.device != dev for t in (size, A, c2)):
        raise ValueError(f"the mask kernels run on one CUDA device, got {[t.device for t in (h_s, size, A, c2)]}")
    if h_s.dim() != 5 or h_s.shape[:2] != (B, 3) or h_s.dtype != torch.float32 or not h_s.is_contiguous():
        raise ValueError(f"h_s must be a contiguous ({B}, 3, d, h, w) float32 field, got {tuple(h_s.shape)} "
                         f"{h_s.dtype}")
    if size.shape != (B, 3) or size.dtype != torch.int32 or not size.is_contiguous():
        raise ValueError(f"size must be contiguous ({B}, 3) int32, got {tuple(size.shape)} {size.dtype}")
    if A.shape != (B, 3, 3) or A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError(f"A must be contiguous ({B}, 3, 3) float32, got {tuple(A.shape)} {A.dtype}")
    if c2.shape != (B, 3) or c2.dtype != torch.float32 or c2.stride(1) != 1:
        raise ValueError(f"c2 must be ({B}, 3) float32 with unit stride along its rows, got {tuple(c2.shape)}")
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"shape must be three positive extents, got {shape}")
    dims = (ctypes.c_int * 6)(*shape, *h_s.shape[2:])
    return dims, c2.stride(0)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def mask_shift(h_s, size, A, c2, shape) -> torch.Tensor:
    """The margin shift ``floor(min over voxels of clamp(v_r, 0, S_r - 1))``
    of the (B, D, H, W) = (B, *shape) coordinates ``v_r = A_r . xyz + c2_r +
    H_r`` (``H`` the zoom of ``h_s`` (B, 3, d, h, w) f32 from its logical
    extent ``size`` (B, 3) int32), as a (B, 3) f32 tensor on the card,
    without synchronising."""
    B = h_s.shape[0]
    dims, c2_b = _field_args(h_s, size, A, c2, shape, B)
    nblocks = -(-shape[0] // _TI) * shape[1]
    partial = torch.empty((B, nblocks, 3), dtype=torch.float32, device=h_s.device)
    shift = torch.empty((B, 3), dtype=torch.float32, device=h_s.device)
    with torch.cuda.device(h_s.device):
        rc = _kernels()[0](h_s.data_ptr(), size.data_ptr(), A.data_ptr(), c2.data_ptr(), c2_b, partial.data_ptr(),
                           shift.data_ptr(), B, dims, torch.cuda.current_stream().cuda_stream)
    _check(rc, "mask_shift")
    LAUNCHES["mask_shift"] += 1
    return shift


def mask_apply(a, h_s, size, A, c2, shift) -> torch.Tensor:
    """``where(ok, a, 0)`` of the warped image ``a`` (B, D, H, W), f32 or
    bf16, at any strides (read fastest along D, the pair warp's layout), with ``ok`` the composite mask of the clamped
    coordinates less ``shift`` (B, 3) f32 (:func:`mask_shift`'s, or zeros),
    recomputed per voxel; a contiguous tensor of ``a``'s type, without
    synchronising."""
    if a.dtype not in _DTYPES or a.dim() != 4:
        raise ValueError(f"a must be a (B, D, H, W) float32 or bfloat16 volume, got {tuple(a.shape)} {a.dtype}")
    B = a.shape[0]
    dims, c2_b = _field_args(h_s, size, A, c2, tuple(a.shape[1:]), B)
    if a.device != h_s.device or shift.device != h_s.device:
        raise ValueError("a, shift and the field must share one CUDA device")
    if shift.shape != (B, 3) or shift.dtype != torch.float32 or not shift.is_contiguous():
        raise ValueError(f"shift must be contiguous ({B}, 3) float32, got {tuple(shift.shape)} {shift.dtype}")
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(a.shape[1:], a.stride()[1:]))
    if span > 2**31 - 1:
        raise ValueError(f"a {tuple(a.shape)} at strides {a.stride()} exceeds the kernel's int offsets")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 4)(*a.stride())
    with torch.cuda.device(a.device):
        rc = _kernels()[1](a.data_ptr(), _DTYPES[a.dtype], strides, h_s.data_ptr(), size.data_ptr(), A.data_ptr(),
                           c2.data_ptr(), c2_b, shift.data_ptr(), out.data_ptr(), B, dims,
                           torch.cuda.current_stream().cuda_stream)
    _check(rc, "mask_apply")
    LAUNCHES["mask_apply"] += 1
    return out
