"""Kernel probes: the CUDA kernels' bindings, their wrappers and plain versions.

Ports of the repository's TPU cost probes, each a function of its own that
the probe's kernel computes (``csrc/probes.cu`` and ``csrc/hat_single.cu``
describe each one and the Hopper construct it measures):

- :func:`pair_copy` (K5, ``scripts/probe_blocktp.py::_copy_kernel``): two
  f32 arrays copied; the card's copy floor.
- :func:`pair_transpose` (K6, ``_tp_kernel`` there): two (..., H, W) arrays
  to (..., W, H) through padded shared-memory tiles.
- :func:`probe2` (K3, the ``probe2_*`` modes of
  ``scripts/microbench_warp.py``): the paired hat kernel's copy, staging and
  tap constructs.
- :func:`probe` (K4, the ``probe_*`` modes there): the single-operand
  kernel's copy, staging, window-shift and tap constructs.

  K3 and K4 work on tiles of consecutive rows: copy one tile per block;
  the staged modes on a persistent grid whose blocks draw tiles from a
  counter and fill a ring of shared-memory tiles with TMA bulk copies
  (:func:`probe_geometry` reports a launch's tile rows, ring stages, grid
  and shared memory).
- :func:`hat_variant` (K7, ``scripts/profile_kernel_variants.py::
  make_kernel``): the windowed hat sample with a lane-affine table in five
  variants, four of them deliberately wrong, one per construct left out.

``*_ref`` are the plain PyTorch versions the kernels are held against, bit
for bit. The wrappers take the plain version only for tensors on the CPU; on
a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .hat import _bind, _call

# Kernel launches of each probe kernel and mode (one per wrapper call)
PAIR_MODES = ("copy", "stage", "taps")
SINGLE_MODES = ("copy", "stage", "ladder", "tiles", "sweep12")
VARIANTS = (0, 1, 2, 3, 4)
LAUNCHES = {
    "pair_copy": 0, "pair_transpose": 0,
    **{f"probe2_{m}": 0 for m in PAIR_MODES},
    **{f"probe_{m}": 0 for m in SINGLE_MODES},
    **{f"hat_variant_v{v}": 0 for v in VARIANTS},
}

_SMEM = 48 * 1024  # the default dynamic shared memory of a block
_SMEM_MAX = 232448  # the dynamic shared memory a block may opt into on sm_90
_RING_HEADER = 128  # the ring's barriers, ahead of its tiles
SINGLE_PAD = 128  # K4's edge pad
VARIANT_ROWS = 32  # K7's rows per block
VARIANT_CHUNK = 8  # K7's taps per predicated chunk
VARIANT_BIG = 1e9


def _check(name, tensors, same_shape=True):
    """f32, contiguous, on one device (and, if ``same_shape``, one shape)."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operands must be float32, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {t.device} and {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if same_shape and t.shape != first.shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and {tuple(first.shape)} differ")


def _device(name, x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    return x.device.type


def _ring_bytes(n_ops, S):
    """(shared memory of two ring stages of the fewest rows a K3/K4 tile may
    hold, those rows): 4 / gcd(S, 4) rows, a whole number of 16-byte units."""
    rows = 4 // math.gcd(S, 4)
    return _RING_HEADER + 2 * n_ops * rows * S * 4, rows


def _ring_operands(name, xs):
    """K3's and K4's operands on the card: as :func:`_check` wants them,
    16-byte aligned (bulk copies and 16-byte accesses; the outputs come from
    ``torch.empty_like``, whose blocks are aligned), and rows short enough
    for the ring (:func:`_ring_bytes`)."""
    _check(name, xs)
    if any(t.data_ptr() % 16 for t in xs):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    S = xs[0].shape[-1]
    need, rows = _ring_bytes(len(xs), S)
    if need > _SMEM_MAX:
        raise ValueError(f"{name}: S={S} needs {need} bytes of shared memory for two ring stages of "
                         f"{rows}-row tiles, over {_SMEM_MAX}")


def probe_geometry(kernel, shape, mode):
    """The launch K3 (``kernel`` 3) or K4 (4) makes on the current CUDA
    device for (B, D, H, S) operands in ``mode``: a dict of tile rows, ring
    stages (0 for copy), grid blocks and dynamic shared-memory bytes."""
    from .build import load_library

    fn = load_library("probes").fsg_probe_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    modes = PAIR_MODES if kernel == 3 else SINGLE_MODES
    B, D, H, S = shape
    out = (ctypes.c_int * 4)()
    rc = fn(kernel, B, D * H, S, modes.index(mode), out)
    if rc != 0:
        raise RuntimeError(f"probe_geometry: K{kernel} {mode} at {tuple(shape)}: cudaError {rc}")
    return dict(zip(("tile_rows", "stages", "grid", "smem_bytes"), out))


def _launched(name, key, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1


# --- K5: pair copy -----------------------------------------------------------


def pair_copy_ref(xa, xb):
    """Plain pair copy."""
    return xa.clone(), xb.clone()


def _copy_operands(xa, xb):
    """K5's operands on the card: as :func:`_check` wants them and 16-byte
    aligned; returns (numel // 4, numel % 4)."""
    _check("pair_copy", [xa, xb])
    if xa.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("pair_copy: operands must be 16-byte aligned")
    n4, tail = divmod(xa.numel(), 4)
    if n4 > 2**31 - 1:
        raise ValueError(f"pair_copy: {xa.numel()} elements, over the kernel's 4 * (2^31 - 1)")
    return n4, tail


def pair_copy(xa, xb):
    """K5: ``xa`` and ``xb`` (equal shapes, f32) copied by one launch."""
    if xa.device.type == "cpu":
        return pair_copy_ref(xa, xb)
    _device("pair_copy", xa)
    n4, tail = _copy_operands(xa, xb)
    oa, ob = torch.empty_like(xa), torch.empty_like(xb)
    rc = _call(_bind("probes", "fsg_pair_copy_f32", 4, 2), xa.device,
               xa.data_ptr(), xb.data_ptr(), oa.data_ptr(), ob.data_ptr(), n4, tail)
    _launched("pair_copy", "pair_copy", rc)
    return oa, ob


# --- K6: pair transpose ------------------------------------------------------


def pair_transpose_ref(xa, xb):
    """Plain pair transpose of the last two axes, (..., H, W) -> (..., W, H)."""
    return xa.transpose(-1, -2).contiguous(), xb.transpose(-1, -2).contiguous()


def pair_transpose(xa, xb):
    """K6: the last two axes of ``xa`` and ``xb`` (equal shapes, f32, at
    least 2-D) swapped by one launch."""
    if _device("pair_transpose", xa) == "cpu":
        return pair_transpose_ref(xa, xb)
    _check("pair_transpose", [xa, xb])
    *lead, H, W = xa.shape
    N = 1
    for n in lead:
        N *= n
    if not 1 <= N <= 65535:
        raise ValueError(f"pair_transpose: {N} slices outside the grid's [1, 65535]")
    oa = torch.empty((*lead, W, H), dtype=torch.float32, device=xa.device)
    ob = torch.empty_like(oa)
    rc = _call(_bind("probes", "fsg_pair_transpose_f32", 4, 3), xa.device,
               xa.data_ptr(), xb.data_ptr(), oa.data_ptr(), ob.data_ptr(), N, H, W)
    _launched("pair_transpose", "pair_transpose", rc)
    return oa, ob


# --- K3: the paired probes ---------------------------------------------------


def _rows(R, H, dev):
    rows = torch.arange(R, device=dev)
    return (rows // H).to(torch.float32), (rows % H).to(torch.float32)


def _taps(xr, lanes_idx, d0, ntaps, S, m0=0):
    """sum over m < ntaps of max(0, 1 - |d0 - m|) * xr[..., clamp(lanes_idx
    + m + m0, 0, S - 1)], in tap order; ``xr`` (B, R, S)."""
    acc = torch.zeros(xr.shape, dtype=torch.float32, device=xr.device)
    for m in range(ntaps):
        w = torch.clamp_min(1.0 - torch.abs(d0 - float(m)), 0.0)
        idx = torch.clamp(lanes_idx + (m + m0), 0, S - 1)
        acc = acc + w * torch.take_along_dim(xr, idx.expand(xr.shape), dim=2)
    return acc


def probe2_ref(xa, xb, mode, ntaps=0):
    """Plain K3 on two (B, D, H, S) operands; see ``csrc/probes.cu``."""
    if mode == "copy":
        return xa * 2.0, xb * 2.0
    if mode == "stage":
        return xa.clone(), xb.clone()
    if mode != "taps":
        raise ValueError(f"probe2 mode {mode!r} not in {PAIR_MODES}")
    B, D, H, S = xa.shape
    R = D * H
    dev = xa.device
    _, rj = _rows(R, H, dev)
    lanes = torch.arange(S, dtype=torch.float32, device=dev)[None, None, :]
    pos = (0.07 * rj[None, :, None] + lanes) + 0.3
    d0 = (pos - lanes) - (-1.0)
    idx = torch.arange(S, device=dev)[None, None, :]
    out = [_taps(x.reshape(B, R, S), idx, d0, ntaps, S, m0=-1).reshape(B, D, H, S) for x in (xa, xb)]
    return out[0], out[1]


def probe2(xa, xb, mode, ntaps=0):
    """K3 (``mode`` in copy, stage, taps; ``ntaps`` taps) on two (B, D, H, S)
    f32 operands, one launch."""
    if _device("probe2", xa) == "cpu":
        return probe2_ref(xa, xb, mode, ntaps)
    if mode not in PAIR_MODES:
        raise ValueError(f"probe2 mode {mode!r} not in {PAIR_MODES}")
    _ring_operands("probe2", (xa, xb))
    B, D, H, S = xa.shape
    if mode == "taps" and not 1 <= ntaps <= S + 128:
        raise ValueError(f"probe2: ntaps={ntaps} outside [1, S + 128]")
    oa, ob = torch.empty_like(xa), torch.empty_like(xb)
    rc = _call(_bind("probes", "fsg_probe2_f32", 4, 6), xa.device, xa.data_ptr(), xb.data_ptr(), oa.data_ptr(),
               ob.data_ptr(), B, D * H, H, S, PAIR_MODES.index(mode), ntaps)
    _launched("probe2", f"probe2_{mode}", rc)
    return oa, ob


# --- K4: the single-operand probes -------------------------------------------


def _single_geometry(R, S, dev):
    """K4's (pos, window base, lane0) per row and lane, (R, S) each."""
    rows = torch.arange(R, device=dev)
    sub_row = (rows % 8).to(torch.float32)[:, None]
    lanes = torch.arange(S, device=dev)[None, :]
    pos = 0.11 * sub_row + lanes.to(torch.float32)
    n0 = torch.floor(pos - pos).to(torch.int64)
    lane0 = (lanes // 128) * 128
    width = S + 2 * SINGLE_PAD + 128
    base = torch.clamp(SINGLE_PAD + lane0 + n0, 0, width - 384)
    return pos, base, lane0


def probe_ref(x, mode):
    """Plain K4 on a (B, D, H, S) operand, S a multiple of 128; see
    ``csrc/probes.cu``."""
    if mode == "copy":
        return x * 2.0
    if mode == "stage":
        return x.clone()
    if mode not in SINGLE_MODES:
        raise ValueError(f"probe mode {mode!r} not in {SINGLE_MODES}")
    B, D, H, S = x.shape
    R = D * H
    xr = x.reshape(B, R, S)
    pos, base, lane0 = _single_geometry(R, S, x.device)
    lanes = torch.arange(S, device=x.device)[None, :]

    def staged(c):  # the padded row at (R, S) indices c
        return torch.take_along_dim(xr, torch.clamp(c - SINGLE_PAD, 0, S - 1).expand(B, R, S), dim=2)

    if mode == "ladder":
        out = staged(base + lanes - lane0)
    elif mode == "tiles":
        out = staged(torch.div(base, 128, rounding_mode="floor") * 128 + lanes - lane0) + 0.0 * pos
    else:
        d0 = pos - torch.floor(pos)
        out = _taps(xr, base + lanes - lane0 - SINGLE_PAD, d0, 12, S)
    return out.reshape(B, D, H, S)


def probe(x, mode):
    """K4 (``mode`` in copy, stage, ladder, tiles, sweep12) on a (B, D, H, S)
    f32 operand, S a multiple of 128, one launch."""
    if _device("probe", x) == "cpu":
        return probe_ref(x, mode)
    if mode not in SINGLE_MODES:
        raise ValueError(f"probe mode {mode!r} not in {SINGLE_MODES}")
    B, D, H, S = x.shape
    if S % 128:
        raise ValueError(f"probe: S={S} must be a multiple of 128")
    _ring_operands("probe", (x,))
    out = torch.empty_like(x)
    rc = _call(_bind("probes", "fsg_probe_f32", 2, 4), x.device,
               x.data_ptr(), out.data_ptr(), B, D * H, S, SINGLE_MODES.index(mode))
    _launched("probe", f"probe_{mode}", rc)
    return out


# --- K7: the hat kernel's variants -------------------------------------------


def variant_geometry(coefs, table, variant, D, H, S):
    """K7's positions and per-block window: (pos (R, S), rel, saturated-low
    and -high masks, n0 and span per block of 32 rows (R // 32,) int64)."""
    R = D * H
    ri, rj = (v[:, None] for v in _rows(R, H, coefs.device))
    lanes = torch.arange(S, dtype=torch.float32, device=coefs.device)[None, :]
    c = coefs.to(torch.float32)
    pos = ((c[0] * ri + c[1] * rj) + c[2] * lanes) + c[3]
    pos = ((pos + table[0][None, :] * ri) + table[1][None, :] * rj) + table[2][None, :]
    sat_lo, sat_hi = pos <= 0.0, pos >= S - 1.0
    valid = ~(sat_lo | sat_hi)
    rel = pos - lanes
    nb = R // VARIANT_ROWS
    pad = max(128, S)
    if variant in (0, 1, 3):
        mn = torch.where(valid, rel, VARIANT_BIG).reshape(nb, -1).amin(1)
        n0 = torch.clamp(torch.floor(mn).to(torch.int64), -pad, S - 1)
    else:
        n0 = torch.full((nb,), -8, dtype=torch.int64, device=pos.device)
    if variant in (0, 1, 2):
        mx = torch.where(valid, rel, -VARIANT_BIG).reshape(nb, -1).amax(1)
        span = torch.floor(mx).to(torch.int64) - n0 + 2
    else:
        span = torch.full((nb,), 8, dtype=torch.int64, device=pos.device)
    return pos, rel, sat_lo, sat_hi, n0, span


def variant_taps(span, variant) -> torch.Tensor:
    """Taps K7 runs per element over the blocks with spans ``span``: the
    whole chunks of 8 that start below the span, up to maxspan."""
    maxspan = 4 if variant == 4 else 48
    total = torch.zeros_like(span)
    for c0 in range(0, maxspan, VARIANT_CHUNK):
        total += (c0 < span).to(span.dtype) * (min(c0 + VARIANT_CHUNK, maxspan) - c0)
    return total


def hat_variant_ref(x, coefs, table, variant):
    """Plain K7: ``x`` (D, H, S), ``coefs`` (4,), ``table`` (3, S), f32;
    ``variant`` 0-4. See ``csrc/hat_single.cu``."""
    D, H, S = x.shape
    R = D * H
    pos, rel, sat_lo, sat_hi, n0, span = variant_geometry(coefs, table, variant, D, H, S)
    pad = max(128, S)
    maxspan = 4 if variant == 4 else 48
    if variant in (0, 3):
        win = pad + n0
    elif variant == 1:
        win = torch.div(pad + n0, 128, rounding_mode="floor") * 128
    else:
        win = torch.full_like(n0, pad - 64)
    rows = lambda v: v.repeat_interleave(VARIANT_ROWS)[:, None]  # noqa: E731
    d0 = torch.clamp(rel - rows(n0).to(torch.float32), 0.0, maxspan - 1.0)
    xr = x.reshape(1, R, S)
    idx = (rows(win) + torch.arange(S, device=x.device)[None, :] - pad)[None]
    acc = torch.zeros_like(xr)
    for c0 in range(0, maxspan, VARIANT_CHUNK):
        run = (c0 < rows(span))[None]
        for m in range(c0, min(c0 + VARIANT_CHUNK, maxspan)):
            w = torch.clamp_min(1.0 - torch.abs(d0 - float(m)), 0.0)
            tap = torch.take_along_dim(xr, torch.clamp(idx + m, 0, S - 1), dim=2)
            acc = torch.where(run, acc + w * tap, acc)
    out = torch.where(sat_lo, xr[:, :, :1], torch.where(sat_hi, xr[:, :, S - 1 :], acc))
    return out.reshape(D, H, S)


def hat_variant(x, coefs, table, variant):
    """K7 variant ``variant`` (0-4) of the hat kernel on ``x`` (D, H, S),
    D*H a multiple of 32, with ``coefs`` (4,) and a lane-affine ``table``
    (3, S), all f32; one launch."""
    if _device("hat_variant", x) == "cpu":
        return hat_variant_ref(x, coefs, table, variant)
    _check("hat_variant", [x, coefs, table], same_shape=False)
    if variant not in VARIANTS:
        raise ValueError(f"hat_variant: variant {variant} not in {VARIANTS}")
    D, H, S = x.shape
    if tuple(coefs.shape) != (4,) or tuple(table.shape) != (3, S):
        raise ValueError(f"hat_variant: coefs (4,) and table (3, {S}), got "
                         f"{tuple(coefs.shape)} and {tuple(table.shape)}")
    if (D * H) % VARIANT_ROWS or 4 * (S + max(128, S) + S + 128) > _SMEM:
        raise ValueError(f"hat_variant: rows {D * H} must be a multiple of {VARIANT_ROWS}, S={S} must stage in "
                         f"{_SMEM} bytes")
    threads = min(1024, -(-S // 32) * 32)
    out = torch.empty_like(x)
    rc = _call(_bind("hat_single", "fsg_hat_variant_f32", 4, 5), x.device, x.data_ptr(), table.data_ptr(),
               coefs.data_ptr(), out.data_ptr(), D * H, H, S, variant, threads)
    _launched("hat_variant", f"hat_variant_v{variant}", rc)
    return out
