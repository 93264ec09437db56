"""Hat passes: the CUDA kernels' bindings, their wrappers and plain versions.

Ports of ``fetalsyngen_tpu.ops.warp.hat_pass_pair`` (TPU kernel
``_hat_pair_kernel``, K1) and ``hat_pass`` (TPU kernel ``_hat_kernel``, K2)
for batch-first tensors. For each sample ``b``, row ``r`` of the (D, H) row
grid (``row_i = r // H``, ``row_j = r % H``) and output lane ``l``, rows are
sampled along their last axis at

    pos = ((ci*row_i + cj*row_j) + ck*l) + bias [+ displacement]

edge-clamped, linearly or nearest (rounding half to even), taking ``x[0]``
where ``pos <= 0`` and ``x[S-1]`` where ``pos >= S-1`` (``_hat_pass_jnp``
semantics). ``coefs`` is one (ci, cj, ck, bias) row per sample, (B, 4), or
one per slice ``row_i``, (B, D, 4). The displacement is a (B, D, H, OW)
volume ``disp[b, i, j, l]``, a (B, 3, OW) lane-affine table
``(A0[l]*row_i + A1[l]*row_j) + A2[l]``, or absent.

- :func:`hat_pass_pair` (K1, ``csrc/hat_pass.cu``) samples two operands at
  shared positions, the first linearly, the second nearest (the generator's
  image and labels: per-sample coefficients and a displacement volume; the
  kernel probes' plain passes: per-sample coefficients, no displacement) or
  linearly (the scanner's pairs: a lane-affine table, or per-slice
  coefficients without a displacement).
- :func:`hat_pass` (K2, ``csrc/hat_single.cu``) samples one operand, OW == W:
  per-sample coefficients, linearly or nearest, with or without a
  displacement volume, or linearly with a (B, 3, W) lane-affine table; or
  per-slice coefficients, linearly, without a displacement.

:func:`hat_pass_pair_ref` and :func:`hat_pass_ref` are the plain versions the
kernels are held against; they take every combination. The wrappers take the
plain version only for tensors on the CPU; on a CUDA tensor they launch the
kernel, or raise for a form no caller uses (it has no instantiation).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches of each instantiated form (one per wrapper call, whole
# batch): K1's main-path form, its scanner forms and its form without a
# displacement; K2's per-sample forms, its lane-affine form and its
# per-slice form.
LAUNCHES = {
    "hat_pass_pair": 0, "hat_pass_pair_lane": 0, "hat_pass_pair_slice": 0,
    "hat_pass_pair_nodisp": 0, "hat_pass": 0, "hat_pass_lane": 0, "hat_pass_slice": 0,
}

_MAX_S = 6144  # two staged f32 rows must fit the 48 KB default shared memory

# csrc/hat_common.cuh's CoefMode and DispMode
_COEF_PER_SAMPLE, _COEF_PER_SLICE = 0, 1
_DISP_NONE, _DISP_VOLUME, _DISP_LANE_AFFINE = 0, 1, 2

# (nearest second operand, coef mode, disp mode) of K1's instantiations, and
# (nearest, coef mode, disp mode) of K2's -> their LAUNCHES key
_PAIR_FORMS = {
    (True, _COEF_PER_SAMPLE, _DISP_VOLUME): "hat_pass_pair",
    (False, _COEF_PER_SAMPLE, _DISP_LANE_AFFINE): "hat_pass_pair_lane",
    (False, _COEF_PER_SLICE, _DISP_NONE): "hat_pass_pair_slice",
    (True, _COEF_PER_SAMPLE, _DISP_NONE): "hat_pass_pair_nodisp",
}
_SINGLE_FORMS = {
    **{(n, _COEF_PER_SAMPLE, d): "hat_pass" for n in (False, True) for d in (_DISP_NONE, _DISP_VOLUME)},
    (False, _COEF_PER_SAMPLE, _DISP_LANE_AFFINE): "hat_pass_lane",
    (False, _COEF_PER_SLICE, _DISP_NONE): "hat_pass_slice",
}


def _disp_mode(disp) -> int:
    if disp is None:
        return _DISP_NONE
    return _DISP_LANE_AFFINE if disp.dim() == 3 else _DISP_VOLUME


def positions(coefs: torch.Tensor, R: int, H: int, OW: int, disp=None, lane=None) -> torch.Tensor:
    """(B, R, OW) f32 sample positions of rows ``r`` (``row_i = r // H``,
    ``row_j = r % H``) and lanes ``l``: one eager op per product and sum, in
    the association order the kernels pin. ``coefs``: (B, 4) or (B, R // H,
    4); ``disp``: (B, R, OW) or None; ``lane``: a (B, 3, OW) lane-affine
    table or None."""
    dev = coefs.device
    rows = torch.arange(R, device=dev)
    ri = (rows // H).to(torch.float32)[None, :, None]
    rj = (rows % H).to(torch.float32)[None, :, None]
    lanes = torch.arange(OW, dtype=torch.float32, device=dev)[None, None, :]
    coefs = coefs.to(torch.float32)
    if coefs.dim() == 3:
        c = [coefs[:, rows // H, k, None] for k in range(4)]  # (B, R, 1) each
    else:
        c = [coefs[:, k, None, None] for k in range(4)]  # (B, 1, 1) each
    pos = c[0] * ri + c[1] * rj + c[2] * lanes + c[3]
    if lane is not None:
        A = lane.to(torch.float32)[:, :, None, :]  # (B, 3, 1, OW)
        pos = pos + (A[:, 0] * ri + A[:, 1] * rj + A[:, 2])
    return pos if disp is None else pos + disp


def _positions_of(coefs, B, D, H, OW, disp):
    """:func:`positions` for a (B, D, H, OW) volume or (B, 3, OW) table ``disp``."""
    R = D * H
    if _disp_mode(disp) == _DISP_LANE_AFFINE:
        return positions(coefs, R, H, OW, lane=disp)
    return positions(coefs, R, H, OW, None if disp is None else disp.reshape(B, R, OW))


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


def hat_pass_pair_ref(va, vb, coefs, disp, nearest_b=True):
    """Plain PyTorch paired hat pass (K1's reference).

    ``va`` (linear), ``vb`` (nearest if ``nearest_b``, else linear): (B, D,
    H, S) f32; ``coefs``: (B, 4) or (B, D, 4); ``disp``: (B, D, H, OW),
    (B, 3, OW) or None (then OW = S). Returns two (B, D, H, OW) tensors.
    """
    B, D, H, S = va.shape
    OW = S if disp is None else disp.shape[-1]
    R = D * H
    pos = _positions_of(coefs, B, D, H, OW, disp)
    oa = _sample_ref(va.reshape(B, R, S), pos, nearest=False)
    ob = _sample_ref(vb.reshape(B, R, S), pos, nearest=nearest_b)
    return oa.reshape(B, D, H, OW), ob.reshape(B, D, H, OW)


def hat_pass_ref(x, coefs, disp=None, nearest=False):
    """Plain PyTorch single-operand hat pass (K2's reference).

    ``x``: (B, D, H, S) f32; ``coefs``: (B, 4) or (B, D, 4); ``disp``:
    (B, D, H, S), (B, 3, S) or None. Returns a (B, D, H, S) tensor, sampled
    nearest if ``nearest``.
    """
    B, D, H, S = x.shape
    pos = _positions_of(coefs, B, D, H, S, disp)
    return _sample_ref(x.reshape(B, D * H, S), pos, nearest).reshape(B, D, H, S)


@functools.cache
def _bind(stem: str, symbol: str, n_ptrs: int, n_ints: int):
    """``symbol`` of ``csrc/<stem>.cu``: ``n_ptrs`` pointers, ``n_ints`` ints,
    then the stream; returns a cudaError code."""
    from .build import load_library

    fn = getattr(load_library(stem), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, others, coefs, disp, ow_free):
    """Validate a CUDA launch: ``x`` (B, D, H, S) and ``others`` of its shape,
    (B, 4) or (B, D, 4) ``coefs``, a (B, D, H, OW) or (B, 3, OW) ``disp``
    (OW == S unless ``ow_free``) or None; all f32, contiguous, on ``x``'s
    device. Reads only shapes, dtypes, devices and strides, so it runs on
    tensors of any device."""
    shape = x.shape
    if len(shape) != 4 or any(o.shape != shape for o in others):
        raise ValueError(
            f"volumes must be equal (B, D, H, S), got {[tuple(t.shape) for t in (x, *others)]}"
        )
    B, D, H, S = shape
    if disp is not None:
        ds = disp.shape
        lead = (B, 3) if len(ds) == 3 else (B, D, H)
        if ds[:-1] != lead or not (ow_free or ds[-1] == S):
            want = "OW" if ow_free else str(S)
            raise ValueError(
                f"disp must be (B, D, H, {want}) = ({B}, {D}, {H}, {want}) or (B, 3, {want}), "
                f"got {tuple(ds)}"
            )
    cs = coefs.shape
    if cs != (B, 4) and cs != (B, D, 4):
        raise ValueError(f"coefs must be ({B}, 4) or ({B}, {D}, 4), got {tuple(cs)}")
    if not 2 <= S <= _MAX_S:
        raise ValueError(f"row length S={S} outside [2, {_MAX_S}]")
    if D * H > 2**31 - 1:
        raise ValueError(f"{D * H} rows exceed the kernels' int rows")
    named = [("x", x), *((f"operand {i + 2}", o) for i, o in enumerate(others)), ("coefs", coefs)]
    if disp is not None:
        named.append(("disp", disp))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _call(fn, dev, *args) -> int:
    """``fn(*args, stream)`` on device ``dev`` and its current stream; returns
    the cudaError code."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _form(nearest, coefs, disp, forms, name):
    form = (bool(nearest), _COEF_PER_SLICE if coefs.dim() == 3 else _COEF_PER_SAMPLE, _disp_mode(disp))
    if form not in forms:
        raise ValueError(
            f"{name}: no kernel for (nearest, coef mode, disp mode) = {form}; "
            f"instantiated: {sorted(forms)}"
        )
    return form


def hat_pass_pair(va, vb, coefs, disp, nearest_b=True):
    """Paired hat pass (K1) over a batch; see the module docstring.

    CPU tensors take :func:`hat_pass_pair_ref`. CUDA tensors must be f32 and
    contiguous and form one of the instantiated combinations; the kernel
    launches once for the whole batch on the current stream, without
    synchronising.
    """
    if va.device.type == "cpu":
        return hat_pass_pair_ref(va, vb, coefs, disp, nearest_b)
    if va.device.type != "cuda":
        raise ValueError(f"hat_pass_pair runs on cpu or cuda tensors, got {va.device}")
    _check(va, (vb,), coefs, disp, ow_free=True)
    form = _form(nearest_b, coefs, disp, _PAIR_FORMS, "hat_pass_pair")
    _, coef_mode, disp_mode = form
    B, D, H, S = va.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 samples")
    OW = S if disp is None else disp.shape[-1]
    oa = torch.empty((B, D, H, OW), dtype=torch.float32, device=va.device)
    ob = torch.empty_like(oa)
    rc = _call(
        _bind("hat_pass", "fsg_hat_pass_pair_f32", 6, 8), va.device,
        va.data_ptr(), vb.data_ptr(), None if disp is None else disp.data_ptr(), coefs.data_ptr(),
        oa.data_ptr(), ob.data_ptr(), B, D * H, H, S, OW, int(nearest_b), coef_mode, disp_mode,
    )
    if rc != 0:
        raise RuntimeError(f"hat_pass_pair kernel launch failed: cudaError {rc}")
    LAUNCHES[_PAIR_FORMS[form]] += 1
    return oa, ob


def hat_pass(x, coefs, disp=None, nearest=False):
    """Single-operand hat pass (K2) over a batch; see the module docstring.

    CPU tensors take :func:`hat_pass_ref`. CUDA tensors must be f32 and
    contiguous and form one of the instantiated combinations; the kernel
    launches once for the whole batch on the current stream, without
    synchronising. TMA bulk copies stage the rows of ``x`` from 16-byte
    boundaries, so an ``x`` off 16 bytes (a view into a larger tensor) is
    first copied on the card.
    """
    if x.device.type == "cpu":
        return hat_pass_ref(x, coefs, disp, nearest)
    if x.device.type != "cuda":
        raise ValueError(f"hat_pass runs on cpu or cuda tensors, got {x.device}")
    _check(x, (), coefs, disp, ow_free=False)
    form = _form(nearest, coefs, disp, _SINGLE_FORMS, "hat_pass")
    if x.data_ptr() % 16:
        x = x.clone()
    B, D, H, S = x.shape
    out = torch.empty_like(x)
    rc = _call(
        _bind("hat_single", "fsg_hat_pass_f32", 4, 7), x.device,
        x.data_ptr(), None if disp is None else disp.data_ptr(), coefs.data_ptr(), out.data_ptr(),
        B, D * H, H, S, *form,
    )
    if rc != 0:
        raise RuntimeError(f"hat_pass kernel launch failed: cudaError {rc}")
    LAUNCHES[_SINGLE_FORMS[form]] += 1
    return out


def hat_geometry(shape, nearest=False, coefs_per_slice=False, disp="none"):
    """The launch :func:`hat_pass` makes on the current CUDA device for a
    (B, D, H, S) ``x`` in the form (``nearest``, ``coefs_per_slice``,
    ``disp`` "none", "volume" or "lane"): a dict of tile rows, ring stages,
    grid blocks and dynamic shared-memory bytes."""
    from .build import load_library

    fn = load_library("hat_single").fsg_hat_geometry
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    B, D, H, S = shape
    mode = {"none": _DISP_NONE, "volume": _DISP_VOLUME, "lane": _DISP_LANE_AFFINE}[disp]
    out = (ctypes.c_int * 4)()
    rc = fn(B, D * H, S, int(nearest), int(coefs_per_slice), mode, out)
    if rc != 0:
        raise RuntimeError(f"hat_geometry: {tuple(shape)} {disp}: cudaError {rc}")
    return dict(zip(("tile_rows", "stages", "grid", "smem_bytes"), out))
