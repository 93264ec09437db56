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
``(A0[l]*row_i + A1[l]*row_j) + A2[l]``, or absent. The output rows have OW
lanes: the displacement's, else ``out_len``, else the input rows' S.

- :func:`hat_pass_pair` (K1, ``csrc/hat_pass.cu``) samples two operands at
  shared positions, each linearly or nearest: (linear, nearest) with a
  displacement volume (the generator's image and labels); linearly with a
  lane-affine table or per-slice coefficients (the scanner's pairs); and
  per-sample coefficients without a displacement in all four modes (the
  separable pair warp, the kernel probes' plain passes).
- :func:`hat_pass` (K2, ``csrc/hat_single.cu``) samples one operand:
  per-sample coefficients, linearly or nearest, with or without a
  displacement volume, or linearly with a (B, 3, OW) lane-affine table; or
  per-slice coefficients, linearly, without a displacement.

The operand rows and the outputs are f32, or bf16 (the stream's production
mode, ``ops.linops.storage_scope``); coefficients, displacements and
lane-affine tables are f32 either way, and so is the tap arithmetic: a linear
sample widens its two taps to f32 and rounds its result to bf16 once, a
nearest sample is the gathered value as it is (``_hat_pass_jnp``'s
semantics). Every form has a bf16 twin. The linear bf16 forms without a
displacement volume, K1's and K2's, run a kernel of their own
(``hat_lanes_kernel`` in ``csrc/hat_common.cuh``, a thread keeping its lanes
across rows), the others the ring kernel both dtypes share.

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
# batch): K1's main-path form, its scanner forms and its per-sample forms
# without a displacement in the modes (linear, nearest), (linear, linear),
# (nearest, linear) and (nearest, nearest); K2's per-sample forms, its
# lane-affine form and its per-slice form; then the bf16 forms ("_bf16"),
# where K2's per-sample forms with a displacement volume count apart
# ("hat_pass_field_bf16").
LAUNCHES = {
    "hat_pass_pair": 0, "hat_pass_pair_lane": 0, "hat_pass_pair_slice": 0,
    "hat_pass_pair_nodisp": 0, "hat_pass": 0, "hat_pass_lane": 0, "hat_pass_slice": 0,
    "hat_pass_pair_bf16": 0, "hat_pass_pair_lane_bf16": 0, "hat_pass_bf16": 0, "hat_pass_lane_bf16": 0,
    "hat_pass_slice_bf16": 0,
    "hat_pass_pair_nodisp_ll": 0, "hat_pass_pair_nodisp_nl": 0, "hat_pass_pair_nodisp_nn": 0,
    "hat_pass_pair_slice_bf16": 0, "hat_pass_pair_nodisp_bf16": 0, "hat_pass_pair_nodisp_ll_bf16": 0,
    "hat_pass_pair_nodisp_nl_bf16": 0, "hat_pass_pair_nodisp_nn_bf16": 0, "hat_pass_field_bf16": 0,
}

# The longest row the wrappers take. On the card, the ring's plan()
# (csrc/ring.cuh) refuses a launch whose two stages of its fewest rows (K2:
# 4 for odd S; K1: one row of each operand) do not fit a block's shared
# memory; both kernels plan S = 6143 (test_hat_geometry,
# test_hat_pair_geometry).
_MAX_S = 6144

# csrc/hat_common.cuh's CoefMode and DispMode
_COEF_PER_SAMPLE, _COEF_PER_SLICE = 0, 1
_DISP_NONE, _DISP_VOLUME, _DISP_LANE_AFFINE = 0, 1, 2

# (nearest first operand, nearest second operand, coef mode, disp mode) of
# K1's instantiations, and (nearest, coef mode, disp mode) of K2's -> their
# LAUNCHES key
_PAIR_FORMS = {
    (False, True, _COEF_PER_SAMPLE, _DISP_VOLUME): "hat_pass_pair",
    (False, False, _COEF_PER_SAMPLE, _DISP_LANE_AFFINE): "hat_pass_pair_lane",
    (False, False, _COEF_PER_SLICE, _DISP_NONE): "hat_pass_pair_slice",
    (False, True, _COEF_PER_SAMPLE, _DISP_NONE): "hat_pass_pair_nodisp",
    (False, False, _COEF_PER_SAMPLE, _DISP_NONE): "hat_pass_pair_nodisp_ll",
    (True, False, _COEF_PER_SAMPLE, _DISP_NONE): "hat_pass_pair_nodisp_nl",
    (True, True, _COEF_PER_SAMPLE, _DISP_NONE): "hat_pass_pair_nodisp_nn",
}
_SINGLE_FORMS = {
    **{(n, _COEF_PER_SAMPLE, d): "hat_pass" for n in (False, True) for d in (_DISP_NONE, _DISP_VOLUME)},
    (False, _COEF_PER_SAMPLE, _DISP_LANE_AFFINE): "hat_pass_lane",
    (False, _COEF_PER_SLICE, _DISP_NONE): "hat_pass_slice",
}
# the bf16 twins (csrc/hat_pass.cu, csrc/hat_single.cu)
_PAIR_FORMS_BF16 = {form: f"{key}_bf16" for form, key in _PAIR_FORMS.items()}
_SINGLE_FORMS_BF16 = {
    **{form: f"{key}_bf16" for form, key in _SINGLE_FORMS.items()},
    **{(n, _COEF_PER_SAMPLE, _DISP_VOLUME): "hat_pass_field_bf16" for n in (False, True)},
}
_IO_DTYPES = (torch.float32, torch.bfloat16)

# operands :func:`hat_pass` copied to 16 bytes before a launch
COPIES = {"hat_pass": 0}


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
    """Edge-clamped sample of rows ``x`` (B, R, S) at ``pos`` (B, R, OW), in
    ``x``'s dtype: a linear sample of bf16 rows widens its taps to f32 and
    rounds once."""
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
        g0 = torch.take_along_dim(x, fi, dim=2).to(torch.float32)
        g1 = torch.take_along_dim(x, fi + 1, dim=2).to(torch.float32)
        out = (g0 * (1.0 - w) + g1 * w).to(x.dtype)
    out = torch.where(sat_lo, x[:, :, :1], out)
    return torch.where(sat_hi, x[:, :, S - 1 :], out)


def _out_len(S: int, disp, out_len) -> int:
    """The output rows' length: the displacement's lanes, else ``out_len``,
    else S; raises where ``out_len`` disagrees with the displacement."""
    OW = disp.shape[-1] if disp is not None else (S if out_len is None else int(out_len))
    if out_len is not None and int(out_len) != OW:
        raise ValueError(f"out_len={out_len} but the displacement has {OW} lanes")
    if OW < 1:
        raise ValueError(f"out_len must be positive, got {OW}")
    return OW


def hat_pass_pair_ref(va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False):
    """Plain PyTorch paired hat pass (K1's reference).

    ``va`` (nearest if ``nearest_a``, else linear), ``vb`` (nearest if
    ``nearest_b``, else linear): (B, D, H, S) f32 or bf16, outputs in their
    dtype; ``coefs``: (B, 4) or (B, D, 4); ``disp``: (B, D, H, OW), (B, 3,
    OW) or None (then OW = ``out_len``, or S). Returns two (B, D, H, OW)
    tensors.
    """
    B, D, H, S = va.shape
    OW = _out_len(S, disp, out_len)
    R = D * H
    pos = _positions_of(coefs, B, D, H, OW, disp)
    oa = _sample_ref(va.reshape(B, R, S), pos, nearest=nearest_a)
    ob = _sample_ref(vb.reshape(B, R, S), pos, nearest=nearest_b)
    return oa.reshape(B, D, H, OW), ob.reshape(B, D, H, OW)


def hat_pass_ref(x, coefs, disp=None, nearest=False, out_len=None):
    """Plain PyTorch single-operand hat pass (K2's reference).

    ``x``: (B, D, H, S) f32 or bf16; ``coefs``: (B, 4) or (B, D, 4); ``disp``:
    (B, D, H, OW), (B, 3, OW) or None (then OW = ``out_len``, or S). Returns
    a (B, D, H, OW) tensor of ``x``'s dtype, sampled nearest if ``nearest``.
    """
    B, D, H, S = x.shape
    OW = _out_len(S, disp, out_len)
    pos = _positions_of(coefs, B, D, H, OW, disp)
    return _sample_ref(x.reshape(B, D * H, S), pos, nearest).reshape(B, D, H, OW)


@functools.cache
def _bind(stem: str, symbol: str, n_ptrs: int, n_ints: int):
    """``symbol`` of ``csrc/<stem>.cu``: ``n_ptrs`` pointers, ``n_ints`` ints,
    then the stream; returns a cudaError code."""
    from .build import load_library

    fn = getattr(load_library(stem), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, others, coefs, disp, out_len=None) -> int:
    """Validate a CUDA launch and return its output rows' length OW
    (:func:`_out_len`): ``x`` (B, D, H, S) and ``others`` of its shape,
    (B, 4) or (B, D, 4) ``coefs``, a (B, D, H, OW) or (B, 3, OW) ``disp`` or
    None; the volumes f32 or bf16, all of one dtype, the coefficients and
    the displacement f32; all contiguous, on ``x``'s device. Reads only
    shapes, dtypes, devices and strides, so it runs on tensors of any
    device."""
    shape = x.shape
    if len(shape) != 4 or any(o.shape != shape for o in others):
        raise ValueError(
            f"volumes must be equal (B, D, H, S), got {[tuple(t.shape) for t in (x, *others)]}"
        )
    B, D, H, S = shape
    if disp is not None:
        ds = disp.shape
        if ds[:-1] != ((B, 3) if len(ds) == 3 else (B, D, H)):
            raise ValueError(f"disp must be (B, D, H, OW) = ({B}, {D}, {H}, OW) or (B, 3, OW), got {tuple(ds)}")
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
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in named:
        want = x.dtype if t is x or any(t is o for o in others) else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {str(want).removeprefix('torch.')}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _out_len(S, disp, out_len)


def _call(fn, dev, *args) -> int:
    """``fn(*args, stream)`` on device ``dev`` and its current stream; returns
    the cudaError code."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _form(nearest, coefs, disp, forms, name):
    """The instantiation key of a call: ``nearest`` is K2's mode, or K1's
    (first, second) modes as a tuple; raises for a form without a kernel."""
    modes = tuple(bool(n) for n in nearest) if isinstance(nearest, tuple) else (bool(nearest),)
    form = (*modes, _COEF_PER_SLICE if coefs.dim() == 3 else _COEF_PER_SAMPLE, _disp_mode(disp))
    if form not in forms:
        what = "(nearest a, nearest b, coef mode, disp mode)" if len(modes) == 2 else "(nearest, coef mode, disp mode)"
        raise ValueError(f"{name}: no kernel for {what} = {form}; instantiated: {sorted(forms)}")
    return form


def _instantiated(pair: bool, dtype) -> tuple[dict, str]:
    """The instantiated forms of K1 (``pair``) or K2 on operands of
    ``dtype``, and the wrapper's name for messages."""
    bf16 = dtype == torch.bfloat16
    if pair:
        return (_PAIR_FORMS_BF16 if bf16 else _PAIR_FORMS), f"hat_pass_pair ({dtype})"
    return (_SINGLE_FORMS_BF16 if bf16 else _SINGLE_FORMS), f"hat_pass ({dtype})"


def launch_key(pair: bool, nearest, coefs, disp, dtype, nearest_a=False) -> str:
    """The ``LAUNCHES`` key of the form a call of :func:`hat_pass_pair`
    (``pair``; ``nearest`` its ``nearest_b``) or :func:`hat_pass` with these
    arguments and operands of ``dtype`` launches; raises for a form without
    a kernel."""
    forms, name = _instantiated(pair, dtype)
    return forms[_form((nearest_a, nearest) if pair else nearest, coefs, disp, forms, name)]


def hat_pass_pair(va, vb, coefs, disp, nearest_b=True, out_len=None, nearest_a=False):
    """Paired hat pass (K1) over a batch; see the module docstring.

    CPU tensors take :func:`hat_pass_pair_ref`. CUDA tensors must be
    contiguous, the operands f32 or bf16 (the outputs take their dtype), and
    form one of the instantiated combinations of that dtype; the kernel
    launches once for the whole batch on the current stream, without
    synchronising. ``va`` and ``vb`` may each start at any element (views
    into larger tensors): the kernel stages them from there.
    """
    if va.device.type == "cpu":
        return hat_pass_pair_ref(va, vb, coefs, disp, nearest_b, out_len, nearest_a)
    if va.device.type != "cuda":
        raise ValueError(f"hat_pass_pair runs on cpu or cuda tensors, got {va.device}")
    OW = _check(va, (vb,), coefs, disp, out_len)
    bf16 = va.dtype == torch.bfloat16
    forms, name = _instantiated(True, va.dtype)
    form = _form((nearest_a, nearest_b), coefs, disp, forms, name)
    B, D, H, S = va.shape
    oa = torch.empty((B, D, H, OW), dtype=va.dtype, device=va.device)
    ob = torch.empty_like(oa)
    rc = _call(
        _bind("hat_pass", "fsg_hat_pass_pair_bf16" if bf16 else "fsg_hat_pass_pair_f32", 6, 9), va.device,
        va.data_ptr(), vb.data_ptr(), None if disp is None else disp.data_ptr(), coefs.data_ptr(),
        oa.data_ptr(), ob.data_ptr(), B, D * H, H, S, OW, *form,
    )
    if rc != 0:
        raise RuntimeError(f"hat_pass_pair kernel launch failed: cudaError {rc}")
    LAUNCHES[forms[form]] += 1
    return oa, ob


def hat_pass(x, coefs, disp=None, nearest=False, out_len=None):
    """Single-operand hat pass (K2) over a batch; see the module docstring.

    CPU tensors take :func:`hat_pass_ref`. CUDA tensors must be
    contiguous, ``x`` f32 or bf16 (the output takes its dtype), and form one
    of the instantiated combinations of that dtype; the kernel launches once
    for the whole batch on the current stream, without synchronising. TMA
    bulk copies stage the rows of ``x`` from 16-byte boundaries, so an ``x``
    off 16 bytes (a view into a larger tensor) is first copied on the card
    (``COPIES`` counts those copies).
    """
    if x.device.type == "cpu":
        return hat_pass_ref(x, coefs, disp, nearest, out_len)
    if x.device.type != "cuda":
        raise ValueError(f"hat_pass runs on cpu or cuda tensors, got {x.device}")
    OW = _check(x, (), coefs, disp, out_len)
    bf16 = x.dtype == torch.bfloat16
    forms, name = _instantiated(False, x.dtype)
    form = _form(nearest, coefs, disp, forms, name)
    if x.data_ptr() % 16:
        x = x.clone()
        COPIES["hat_pass"] += 1
    B, D, H, S = x.shape
    out = torch.empty((B, D, H, OW), dtype=x.dtype, device=x.device)
    rc = _call(
        _bind("hat_single", "fsg_hat_pass_bf16" if bf16 else "fsg_hat_pass_f32", 4, 8), x.device,
        x.data_ptr(), None if disp is None else disp.data_ptr(), coefs.data_ptr(), out.data_ptr(),
        B, D * H, H, S, OW, *form,
    )
    if rc != 0:
        raise RuntimeError(f"hat_pass kernel launch failed: cudaError {rc}")
    LAUNCHES[forms[form]] += 1
    return out


def _geometry(stem, symbol, shape, modes, coefs_per_slice, disp, dtype, out_len):
    from .build import load_library

    fn = getattr(load_library(stem), symbol)
    fn.argtypes = [ctypes.c_int] * (7 + len(modes)) + [ctypes.POINTER(ctypes.c_int)]
    B, D, H, S = shape
    mode = {"none": _DISP_NONE, "volume": _DISP_VOLUME, "lane": _DISP_LANE_AFFINE}[disp]
    if dtype not in _IO_DTYPES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    out = (ctypes.c_int * 4)()
    OW = S if out_len is None else int(out_len)
    rc = fn(B, D * H, S, OW, *(int(m) for m in modes), int(coefs_per_slice), mode, int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"{symbol}: {tuple(shape)} {disp}: cudaError {rc}")
    return dict(zip(("tile_rows", "stages", "grid", "smem_bytes"), out))


def hat_geometry(shape, nearest=False, coefs_per_slice=False, disp="none", dtype=torch.float32, out_len=None):
    """The launch :func:`hat_pass` makes on the current CUDA device for a
    (B, D, H, S) ``x`` of ``dtype`` to ``out_len`` lanes (default S) in the
    form (``nearest``, ``coefs_per_slice``, ``disp`` "none", "volume" or
    "lane"): a dict of tile rows, ring stages, grid blocks and dynamic
    shared-memory bytes."""
    return _geometry("hat_single", "fsg_hat_geometry", shape, (nearest,), coefs_per_slice, disp, dtype, out_len)


def hat_pair_geometry(shape, nearest_b=True, coefs_per_slice=False, disp="volume", dtype=torch.float32,
                      out_len=None, nearest_a=False):
    """The launch :func:`hat_pass_pair` makes on the current CUDA device for
    (B, D, H, S) operands of ``dtype`` to ``out_len`` lanes (default S) in
    the form (``nearest_a``, ``nearest_b``, ``coefs_per_slice``, ``disp``
    "none", "volume" or "lane"), as :func:`hat_geometry` gives it."""
    return _geometry("hat_pass", "fsg_hat_pair_geometry", shape, (nearest_a, nearest_b), coefs_per_slice, disp, dtype,
                     out_len)
