"""Paired hat pass: the CUDA kernel's binding, its wrapper and its plain version.

Port of ``fetalsyngen_tpu.ops.warp.hat_pass_pair`` (TPU kernel
``_hat_pair_kernel``) for batch-first tensors. For each sample ``b``, row
``r`` of the (D, H) row grid (``row_i = r // H``, ``row_j = r % H``) and output
lane ``l``, both operands are sampled along their last axis at the shared
position

    pos = ((ci*row_i + cj*row_j) + ck*l) + bias + disp[b, i, j, l]

edge-clamped, the first operand linearly (the image) and the second nearest,
rounding half to even (the labels), taking ``x[0]`` where ``pos <= 0`` and
``x[S-1]`` where ``pos >= S-1`` (``_hat_pass_jnp`` semantics with modes
(linear, nearest), the only pair the main path uses). ``coefs`` is one (ci, cj, ck, bias) row per
sample. The kernel is ``csrc/hat_pass.cu``; :func:`hat_pass_pair_ref` is the
plain version it is held against. The wrapper takes the plain version only
for tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches made by :func:`hat_pass_pair` (one per call, whole batch).
LAUNCHES = 0

_MAX_S = 6144  # two staged f32 rows must fit the 48 KB default shared memory


def positions(coefs: torch.Tensor, R: int, H: int, OW: int, disp: torch.Tensor) -> torch.Tensor:
    """(B, R, OW) f32 sample positions of rows ``r`` (``row_i = r // H``,
    ``row_j = r % H``) and lanes ``l``: one eager op per product and sum, in
    the association order the kernel pins."""
    dev = coefs.device
    rows = torch.arange(R, device=dev)
    ri = (rows // H).to(torch.float32)[None, :, None]
    rj = (rows % H).to(torch.float32)[None, :, None]
    lanes = torch.arange(OW, dtype=torch.float32, device=dev)[None, None, :]
    c = coefs.to(torch.float32)[:, :, None, None]
    pos = c[:, 0] * ri + c[:, 1] * rj + c[:, 2] * lanes + c[:, 3]
    return pos + disp


def _sample_ref(x: torch.Tensor, pos: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Edge-clamped sample of rows ``x`` (B, R, S) at ``pos`` (B, R, OW)."""
    S = x.shape[-1]
    sat_lo = pos <= 0.0
    sat_hi = pos >= S - 1.0
    c = torch.clamp(pos, 0.0, S - 1.0)
    if nearest:
        out = torch.take_along_dim(x, torch.round(c).to(torch.int64), dim=2)
    else:
        f = torch.clamp(torch.floor(c), 0.0, S - 2.0)
        w = c - f
        fi = f.to(torch.int64)
        g0 = torch.take_along_dim(x, fi, dim=2)
        g1 = torch.take_along_dim(x, fi + 1, dim=2)
        out = g0 * (1.0 - w) + g1 * w
    out = torch.where(sat_lo, x[:, :, :1], out)
    return torch.where(sat_hi, x[:, :, S - 1 :], out)


def hat_pass_pair_ref(va, vb, coefs, disp):
    """Plain PyTorch paired hat pass (the kernel's reference).

    ``va`` (linear), ``vb`` (nearest): (B, D, H, S) f32; ``disp``:
    (B, D, H, OW) f32; ``coefs``: (B, 4). Returns two (B, D, H, OW) tensors.
    """
    B, D, H, S = va.shape
    OW = disp.shape[-1]
    R = D * H
    pos = positions(coefs, R, H, OW, disp.reshape(B, R, OW))
    oa = _sample_ref(va.reshape(B, R, S), pos, nearest=False)
    ob = _sample_ref(vb.reshape(B, R, S), pos, nearest=True)
    return oa.reshape(B, D, H, OW), ob.reshape(B, D, H, OW)


@functools.cache
def _bind():
    from .build import load_library

    lib = load_library()
    fn = lib.fsg_hat_pass_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(va, vb, coefs, disp):
    if va.dim() != 4 or vb.shape != va.shape:
        raise ValueError(
            f"va, vb must be equal (B, D, H, S) volumes, got {tuple(va.shape)}, {tuple(vb.shape)}"
        )
    B, D, H, S = va.shape
    if disp.dim() != 4 or tuple(disp.shape[:3]) != (B, D, H):
        raise ValueError(f"disp must be (B, D, H, OW) = ({B}, {D}, {H}, OW), got {tuple(disp.shape)}")
    if tuple(coefs.shape) != (B, 4):
        raise ValueError(f"coefs must be ({B}, 4), got {tuple(coefs.shape)}")
    if not 2 <= S <= _MAX_S:
        raise ValueError(f"row length S={S} outside [2, {_MAX_S}]")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 samples")
    for name, t in (("va", va), ("vb", vb), ("coefs", coefs), ("disp", disp)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != va.device:
            raise ValueError(f"{name} is on {t.device}, va on {va.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def hat_pass_pair(va, vb, coefs, disp):
    """Paired hat pass over a batch; see the module docstring.

    CPU tensors take :func:`hat_pass_pair_ref`. CUDA tensors must be f32 and
    contiguous; the kernel launches once for the whole batch on the current
    stream, without synchronising.
    """
    if va.device.type == "cpu":
        return hat_pass_pair_ref(va, vb, coefs, disp)
    if va.device.type != "cuda":
        raise ValueError(f"hat_pass_pair runs on cpu or cuda tensors, got {va.device}")
    _check(va, vb, coefs, disp)
    B, D, H, S = va.shape
    OW = disp.shape[-1]
    fn = _bind()
    oa = torch.empty((B, D, H, OW), dtype=torch.float32, device=va.device)
    ob = torch.empty_like(oa)
    with torch.cuda.device(va.device):
        stream = torch.cuda.current_stream(va.device).cuda_stream
        rc = fn(
            va.data_ptr(), vb.data_ptr(), disp.data_ptr(), coefs.data_ptr(),
            oa.data_ptr(), ob.data_ptr(), B, D * H, H, S, OW, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hat_pass_pair kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return oa, ob
