"""Separable voxel operators as batched matmuls (port of ``fetalsyngen_tpu.ops.linops``).

Every separable 1-D operation of the pipeline (Gaussian blur, zoom,
anisotropic resample) is a banded ``(out, in)`` operator along one axis,
built per sample from tensor parameters and contracted with ``torch.einsum``.
Operators are (B, out, in); volumes are (B, D, H, W). The contract is f32:
callers on the GPU keep TF32 off.

The stream's bf16 production mode narrows it in two scopes, as the JAX
package does:

- :func:`precision_scope` (``DEFAULT``): a plain matmul or einsum of f32
  operands (:func:`prec_einsum`) takes one bf16 pass, the TPU MXU's default:
  the operands rounded to bf16, the products summed in f32;
- :func:`storage_scope` (``torch.bfloat16``): the chain contractions
  (:func:`einsum_store`, :func:`apply_axis_matrix` and what calls it) keep
  their intermediates in bf16: the operands rounded to bf16, the sum in
  f32, the result rounded to bf16 once, unless ``out_f32`` marks a segment
  boundary whose consumer needs f32.

:func:`f32_scope` suspends both. The scopes are per-thread context
(``contextvars``): torch runs eagerly, so the stream's producer thread may
generate in bf16 while another thread draws from the dataset in f32. A new
thread starts outside both scopes. On the card a bf16 contraction runs as
``torch.bmm`` on bf16 operands with f32 sums; on the CPU the rounded
operands are contracted in f32 (the JAX package's CPU branch). Products of
two bf16 values are exact in f32, so both compute one function up to the
order of the sum. The scopes change no process-wide setting: callers on
the GPU keep TF32 off, and with cuBLAS's reduced-precision bf16 reductions
off as well (``allow_bf16_reduced_precision_reduction = False``) a bf16
result comes straight from the GEMM; while they are allowed, cuBLAS might
sum in bf16, so the GEMM writes an f32 result (``aten::bmm.dtype``) that is
rounded after, one more pass over the output.

Semantics match the reference kernels:
- ``toeplitz_blur_matrix`` == truncated ``make_gaussian_kernel`` + 'same' conv
  (``generation.py:74-110``);
- ``interp_matrix(oob_zero=True)`` == ``fast_3D_interp_torch`` linear-mode
  per-axis factor on a product grid (``generation.py:227-288``);
- ``interp_matrix(oob_zero=False)`` == ``myzoom_torch`` clamped interpolation
  (``generation.py:310-397``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .blur import gaussian_kernel_fixed
from .interp import zoom_coords

# The precision scope's one narrowed value: one bf16 pass, JAX's
# lax.Precision.DEFAULT (None is the f32 contract, JAX's HIGHEST)
DEFAULT = "default"
# The control's precision and storage: f32 tensors holding values rounded to
# float8 e4m3 under a per-tensor scale (round_fp8), at the points where the
# production mode rounds to bf16
FP8 = "fp8"
_E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest finite value, back in f32."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(), 1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

_PRECISION: contextvars.ContextVar[str | None] = contextvars.ContextVar("fsg_precision", default=None)
_STORAGE: contextvars.ContextVar[torch.dtype | None] = contextvars.ContextVar("fsg_storage", default=None)


@contextlib.contextmanager
def precision_scope(prec: str | None):
    """This thread's matmul precision inside the block: ``DEFAULT`` (one
    bf16 pass) or None (the f32 contract)."""
    if prec not in (None, DEFAULT, FP8):
        raise ValueError(f"precision must be None, {DEFAULT!r} or {FP8!r}, got {prec!r}")
    token = _PRECISION.set(prec)
    try:
        yield
    finally:
        _PRECISION.reset(token)


@contextlib.contextmanager
def storage_scope(dtype: torch.dtype | None):
    """This thread's storage type of the chain contractions' intermediates
    inside the block: ``torch.bfloat16`` or None (f32)."""
    if dtype not in (None, torch.bfloat16, FP8):
        raise ValueError(f"storage must be None, torch.bfloat16 or {FP8!r}, got {dtype}")
    token = _STORAGE.set(dtype)
    try:
        yield
    finally:
        _STORAGE.reset(token)


@contextlib.contextmanager
def f32_scope():
    """Suspend both scopes: the f32 contract inside the block (positions,
    morphology, replay-faithful host programs)."""
    with precision_scope(None), storage_scope(None):
        yield


def current_precision() -> str | None:
    """This thread's precision scope (None outside one)."""
    return _PRECISION.get()


def current_storage() -> torch.dtype | None:
    """This thread's storage scope (None outside one)."""
    return _STORAGE.get()


def io_dtype() -> torch.dtype:
    """The hat passes' row type: the storage scope's, else f32 (the taps'
    arithmetic stays f32 either way)."""
    d = _STORAGE.get()
    return torch.float32 if d in (None, FP8) else d


def _contract(spec: str, a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(spec, a, b)`` of two bf16 CUDA operands as one ``bmm`` with
    f32 sums, rounded once to ``out_dtype`` (see the module docstring). Every
    index appears once per operand; indices of both operands kept in the
    output are the batch, indices of both left out are summed."""
    ins, out = spec.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}
    batch = [c for c in out if c in sa and c in sb]
    left = [c for c in out if c in sa and c not in sb]
    right = [c for c in out if c in sb and c not in sa]
    summed = [c for c in sa if c in sb and c not in out]
    if len(batch) + len(left) + len(summed) != len(sa) or len(batch) + len(right) + len(summed) != len(sb):
        raise ValueError(f"spec {spec!r} is not a product of two operands")

    def n(idx):
        return math.prod(size[c] for c in idx)

    am = a.permute([sa.index(c) for c in batch + left + summed]).reshape(n(batch), n(left), n(summed))
    bm = b.permute([sb.index(c) for c in batch + summed + right]).reshape(n(batch), n(summed), n(right))
    if out_dtype == a.dtype and not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        y = torch.bmm(am, bm)
    elif "dtype" in torch.ops.aten.bmm.overloads():
        y = torch.bmm(am, bm, out_dtype=torch.float32).to(out_dtype)
    else:
        raise RuntimeError(f"torch {torch.__version__} has no bmm with an f32 result (aten::bmm.dtype)")
    y = y.reshape([size[c] for c in batch + left + right])
    order = batch + left + right
    return y.permute([order.index(c) for c in out])


def _narrow_einsum(spec: str, a, b, store: torch.dtype, out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(spec, a, b)`` with both operands rounded to ``store``, the
    products summed in f32 and the result in ``out_dtype``; under ``FP8``
    the operands and a result that is not f32 go through :func:`round_fp8`."""
    if store == FP8:
        y = torch.einsum(spec, round_fp8(a), round_fp8(b))
        return y if out_dtype == torch.float32 else round_fp8(y)
    a, b = a.to(store), b.to(store)
    if a.is_cuda:
        return _contract(spec, a, b, out_dtype)
    return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def prec_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, a, b)`` of f32 operands at this thread's matmul
    precision (the JAX package's ``precision=_prec()`` sites): f32, or
    under ``precision_scope(DEFAULT)`` one bf16 pass with an f32 result."""
    if _PRECISION.get() == DEFAULT:
        return _narrow_einsum(spec, a, b, torch.bfloat16, torch.float32)
    if _PRECISION.get() == FP8:
        return _narrow_einsum(spec, a, b, FP8, torch.float32)
    return torch.einsum(spec, a, b)


def prec_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of a 2-D ``a`` and a 1-D or 2-D ``b`` at this thread's
    matmul precision (:func:`prec_einsum`)."""
    return prec_einsum("ij,j->i" if b.dim() == 1 else "ij,jk->ik", a, b)


def einsum_store(spec: str, M: torch.Tensor, x: torch.Tensor, out_f32: bool = False):
    """``einsum(spec, M, x)`` under this thread's storage scope.

    Outside a storage scope: :func:`prec_einsum`. Inside: both operands
    rounded to the storage type, the sum in f32, the result rounded to the
    storage type once, or kept f32 where ``out_f32`` marks a segment
    boundary.
    """
    d = _STORAGE.get()
    if d is None:
        return prec_einsum(spec, M, x)
    return _narrow_einsum(spec, M, x, d, torch.float32 if out_f32 else d)


def toeplitz_blur_matrix(sigma: torch.Tensor, size: int, half_len: int) -> torch.Tensor:
    """(B, size, size) 'same'-conv Gaussian operators for (B,) sigmas.

    Row i holds the truncated normalized kernel centred at i; ``sigma == 0``
    yields the identity.
    """
    dev = sigma.device
    kernel = gaussian_kernel_fixed(sigma, half_len)
    rows = torch.arange(size, device=dev)[:, None]
    cols = torch.arange(size, device=dev)[None, :]
    idx = cols - rows + half_len
    valid = (idx >= 0) & (idx <= 2 * half_len)
    taps = kernel[:, torch.clamp(idx, 0, 2 * half_len)]
    return torch.where(valid, taps, 0.0)


def interp_matrix(
    coords: torch.Tensor,
    in_size: int,
    in_valid: torch.Tensor | None = None,
    out_valid: torch.Tensor | None = None,
    oob_zero: bool = False,
) -> torch.Tensor:
    """(B, out, in_size) linear-interpolation operators at (B, out) ``coords``.

    ``in_valid`` / ``out_valid`` are (B,) logical extents (clamping uses the
    input one; output rows past the output one are zeroed). ``oob_zero``
    zeroes rows whose coordinate is not inside ``(0, valid-1]`` (the
    reference's linear-mode OOB rule) instead of clamping them.
    """
    B, out = coords.shape
    dev = coords.device
    if in_valid is None:
        hi = torch.full((B, 1), in_size - 1, dtype=torch.float32, device=dev)
    else:
        hi = (in_valid - 1).to(torch.float32)[:, None]
    ok = (coords > 0) & (coords <= hi)
    c = torch.clamp(coords, min=torch.zeros_like(hi), max=hi)
    f = torch.clamp(torch.floor(c), min=torch.zeros_like(hi), max=hi - 1.0)
    w = c - f
    fi = f.to(torch.int64)[:, :, None]

    cols = torch.arange(in_size, device=dev)[None, None, :]
    W = (cols == fi).to(torch.float32) * (1.0 - w)[:, :, None] + (cols == fi + 1).to(
        torch.float32
    ) * w[:, :, None]
    if oob_zero:
        W = W * ok[:, :, None]
    if out_valid is not None:
        rows = torch.arange(out, device=dev)[None, :, None]
        W = W * (rows < out_valid[:, None, None])
    return W


_AXIS_SPEC = {0: "boi,bijk->bojk", 1: "boi,bjik->bjok", 2: "boi,bjki->bjko"}


def apply_axis_matrix(vol: torch.Tensor, M: torch.Tensor, axis: int, out_f32: bool = False) -> torch.Tensor:
    """Contract spatial ``axis`` of ``vol`` (B, D, H, W) with ``M`` (B, out,
    in), through :func:`einsum_store` (``out_f32`` as it takes it)."""
    return einsum_store(_AXIS_SPEC[axis], M, vol, out_f32=out_f32)


def interp_matrix_1d(coords: torch.Tensor, in_size: int, out_valid: int | None = None) -> torch.Tensor:
    """Unbatched :func:`interp_matrix` (the SR artifacts' form): (out,
    in_size) at (out,) ``coords``, clamped; rows at or past ``out_valid``
    are zero."""
    valid = None if out_valid is None else torch.full((1,), out_valid, device=coords.device)
    return interp_matrix(coords[None], in_size, out_valid=valid)[0]


def axis_mm(vol: torch.Tensor, M: torch.Tensor, axis: int, out_f32: bool = False) -> torch.Tensor:
    """Unbatched :func:`apply_axis_matrix`: (D, H, W) ``vol``, (out, in) ``M``
    (the JAX package's ``apply_axis_matrix``, ``out_f32`` included)."""
    return apply_axis_matrix(vol[None], M[None], axis, out_f32=out_f32)[0]


def apply_separable(vol: torch.Tensor, Ms) -> torch.Tensor:
    """Apply one operator per spatial axis (order 0, 1, 2)."""
    for axis, M in enumerate(Ms):
        vol = apply_axis_matrix(vol, M, axis)
    return vol


def gaussian_blur_mm(vol: torch.Tensor, stds: torch.Tensor, half_len: int) -> torch.Tensor:
    """Separable Gaussian blur with (B, 3) per-axis stds."""
    Ms = tuple(toeplitz_blur_matrix(stds[:, a], vol.shape[1 + a], half_len) for a in range(3))
    return apply_separable(vol, Ms)


def zoom_mm(
    vol: torch.Tensor, out_shape: tuple[int, int, int], factor: torch.Tensor, in_shape: torch.Tensor
) -> torch.Tensor:
    """``myzoom_torch``-style zoom of (B, d, h, w) to ``out_shape`` with
    (B, 3) factors; ``in_shape`` (B, 3) is the logical input extent."""
    Ms = tuple(
        interp_matrix(zoom_coords(out_shape[a], factor[:, a]), vol.shape[1 + a], in_valid=in_shape[:, a])
        for a in range(3)
    )
    return apply_separable(vol, Ms)
